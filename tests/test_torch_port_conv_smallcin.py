"""The bf16 conv at Cin = 3 to 7 (``csrc/conv3d_narrow.cu``'s small-Cin
instances, route ``sm90_smallcin``) and the 6-channel Seg models that run
it, on the CPU.

The kernel does not run here (no nvcc, no card), so its host rules and
its index arithmetic are held in torch: the route of every bf16 Cin, the
packed weight's [Cout, Kpad] layout (also at the wider Cin of the gather
instance, whose A and k tables ``tests/test_torch_port_conv_wide.py``
emulates), the A fragments' (tap,
ci) per register and the kernel's per-block k table, whose gathered A
times the packed weight must equal ``conv3d_plain``. The plain version is
held against the JAX package's conv at these widths and at Cin 12 and
17, the f32 forward of
``SegModelv2_6c`` / ``SegModelv3_6c`` against JAX's at a tiny width, and
the launches per forward of both models at the production depth (which
``chip_smoke.py``'s ``seg_6c`` phase pins on the card) are counted on the
plain path.
"""

import collections
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddpm3d_tpu import models as jmodels
from ddpm3d_tpu.ops.conv3d import conv3d_decomposed
from ddpm3d_tpu.utils.torch_import import torch_state_dict_to_params
from ddpm3d_tpu_torch import models as tmodels
from ddpm3d_tpu_torch.models.nn import GroupNorm32
from ddpm3d_tpu_torch.ops import conv3d as cv
from ddpm3d_tpu_torch.ops import conv3d_s8 as s8_ops
from ddpm3d_tpu_torch.ops import groupnorm as gn_ops
from ddpm3d_tpu_torch.ops import quant
from ddpm3d_tpu_torch.utils.convert import jax_params_to_state_dict


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads for this file's tests and fixtures (the suite's
    workers share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


SMALL_CIN = (3, 4, 5, 6, 7)
# f32 conv against XLA's: the same sums in another order
CONV_RTOL = 1e-5
# bf16 inputs: every product is exact in f32, so only the order of the f32
# sums differs
BF16_F32_SUM_REL = 1e-6
# f32 Seg forward against JAX's: ~20 layers of reordered f32 sums
MODEL_TOL = 1e-4
ALIASES = ("SegModelv2_6c", "SegModelv3_6c")


@pytest.mark.parametrize("cin,route", [
    (1, "sm90_cin1"), (2, "sm90_narrow"), (3, "sm90_smallcin"),
    (4, "sm90_smallcin"), (5, "sm90_smallcin"), (6, "sm90_smallcin"),
    (7, "sm90_smallcin"), (8, "sm90"), (9, "sm90_gather"),
    (10, "sm90_gather"), (11, "sm90_gather"), (12, "sm90_gather"),
    (13, "sm90_gather"), (14, "sm90_gather"), (15, "sm90_gather"),
    (16, "sm90"), (130, "sm90_gather"), (17, "sm90_gather"),
    (20, "sm90_gather"), (36, "sm90_gather"),
])
def test_bf16_route_by_cin(cin, route):
    """bf16 Cin 3 to 7 take the small-Cin instances (resident weight);
    the gather instance every Cin above 8 that is not a multiple of 8.
    The dx of a conv with Cout = Cin runs on dy's Cin, so it takes the
    same route."""
    assert cv.conv3d_route((1, 4, 8, 8, cin), torch.bfloat16, 128) == route
    assert cv.conv3d_route((2, 3, 5, 7, cin), torch.bfloat16, 5) == route


@pytest.mark.parametrize("cin", SMALL_CIN + (9, 12, 15, 17, 20, 36, 130))
def test_pack_weight_narrow_small_cin(cin):
    """[Cout, Kpad]: column k = Cin * tap + ci is the permuted reshape of
    the weight, Kpad = 27 Cin padded to a multiple of 16 (16-byte rows for
    the gather instance's cp.async), zeros from k = 27 Cin on;
    pack_weight_kernel and pack_weight_dx pack it for the route (the
    small-Cin instances' up to Cin = 15, the gather instance's above)."""
    g = torch.Generator().manual_seed(cin)
    w = torch.randn((40, cin, 3, 3, 3), generator=g)
    wp = cv.pack_weight_narrow(w, torch.bfloat16)
    kpad = cv.narrow_k(cin)
    assert kpad % 16 == 0 and 27 * cin <= kpad < 27 * cin + 16
    assert wp.shape == (40, kpad) and wp.dtype == torch.bfloat16
    want = w.bfloat16().permute(0, 2, 3, 4, 1).reshape(40, 27 * cin)
    assert torch.equal(wp[:, :27 * cin], want)
    assert (wp[:, 27 * cin:] == 0).all()
    assert torch.equal(cv.pack_weight_kernel(w, torch.bfloat16), wp)
    wt = torch.randn((cin, 40, 3, 3, 3), generator=g)  # a conv 40 -> Cin
    assert torch.equal(cv.pack_weight_dx(wt, torch.bfloat16),
                       cv.pack_weight_narrow(cv.flip_weight(wt),
                                             torch.bfloat16))


@pytest.mark.parametrize("cin", SMALL_CIN)
def test_narrow_fragments_cover_k_once(cin):
    """Across every fragment, lane position and register, each k below 27
    Cin is loaded once per row (rows g and g + 8) as exactly one (tap, ci),
    k = Cin * tap + ci with ci < Cin; the padding k map to taps from 27 on,
    whose packed weight columns are zero."""
    kpad = cv.narrow_k(cin)
    wp = cv.pack_weight_narrow(torch.ones((8, cin, 3, 3, 3)), torch.float32)
    seen = collections.Counter()
    for ks, tq, reg in itertools.product(range(kpad // 16), range(4),
                                         range(4)):
        k = 16 * ks + 2 * tq + (8 if reg >= 2 else 0)
        for kk, (tap, ci) in zip((k, k + 1),
                                 cv.narrow_fragment_taps(cin, ks, tq, reg)):
            assert 0 <= ci < cin and cin * tap + ci == kk
            if kk < 27 * cin:
                assert tap < 27
                seen[(reg % 2, tap, ci)] += 1
            else:
                assert tap >= 27 and (wp[:, kk] == 0).all()
    assert set(seen.values()) == {1}
    assert len(seen) == 2 * 27 * cin


def _k_table(cin, H, W):
    """The kernel's per-block table: k -> (offset of (tap, ci) from a row's
    voxel in elements, tap), padding k -> (0, 27)."""
    table = []
    for k in range(cv.narrow_k(cin)):
        if k >= 27 * cin:
            table.append((0, 27))
            continue
        tap, ci = divmod(k, cin)
        kd, kh, kw = tap // 9, tap // 3 % 3, tap % 3
        off = (((kd - 1) * H + kh - 1) * W + kw - 1) * cin + ci
        table.append((off, tap))
    return table


@pytest.mark.parametrize("cin", SMALL_CIN)
@pytest.mark.parametrize("B,dhw", [(1, (3, 5, 7)), (2, (2, 4, 3))])
def test_small_cin_kernel_emulated(cin, B, dhw):
    """A assembled as the kernel does, a 64-row slice at a time over the
    flattened voxels: each register's k from narrow_fragment_taps, each
    half from the k table (the element at row * Cin + offset, zero where
    the tap leaves the volume or the k pads), times pack_weight_narrow's
    [Cout, Kpad]: the f32 sums equal the f32 conv of the bf16 values, one
    bf16 rounding of them is conv3d_plain but for sums within one rounding
    of a tie. At even Cin each register's pair is one aligned word."""
    D, H, W = dhw
    cout = 24
    g = torch.Generator().manual_seed(30 + cin)
    x = torch.randn((B, D, H, W, cin), generator=g).bfloat16()
    w = (torch.randn((cout, cin, 3, 3, 3), generator=g)
         / (27 * cin) ** 0.5).bfloat16()
    wp = cv.pack_weight_narrow(w, torch.bfloat16)
    kpad = cv.narrow_k(cin)
    table = _k_table(cin, H, W)
    flat = x.float().reshape(-1)
    M = B * D * H * W
    rows = -(-M // 64) * 64

    def inside(m, tap):
        if m >= M or tap >= 27:
            return False
        d, h, ww = m // (H * W) % D, m // W % H, m % W
        return (0 <= d + tap // 9 - 1 < D and 0 <= h + tap // 3 % 3 - 1 < H
                and 0 <= ww + tap % 3 - 1 < W)

    A = torch.full((rows, kpad), float("nan"))
    for m0 in range(0, rows, 16):  # one warp's 16 rows
        for gg, tq, ks, reg in itertools.product(range(8), range(4),
                                                 range(kpad // 16), range(4)):
            row = m0 + gg + (8 if reg % 2 else 0)
            k = 16 * ks + 2 * tq + (8 if reg >= 2 else 0)
            assert cv.narrow_fragment_taps(cin, ks, tq, reg)[0] == divmod(
                k, cin)
            if cin % 2 == 0 and k < 27 * cin:  # one aligned word: k, k + 1
                assert table[k + 1] == (table[k][0] + 1, table[k][1])
                assert (row * cin + table[k][0]) % 2 == 0
            for kk in (k, k + 1):
                off, tap = table[kk]
                A[row, kk] = (flat[row * cin + off].item()
                              if inside(row, tap) else 0.0)
    assert not torch.isnan(A).any()
    y32 = (A @ wp.float().T)[:M].reshape(B, D, H, W, cout)
    ref32 = cv.conv3d_plain(x.float(), w.float())
    assert (y32 - ref32).abs().max() <= BF16_F32_SUM_REL * ref32.abs().max()
    ref = cv.conv3d_plain(x, w)
    assert (y32.bfloat16() != ref).float().mean() <= 0.01
    assert (y32.bfloat16().float() - ref.float()).abs().max() <= (
        2 ** -8 * ref.float().abs().max())


@pytest.mark.parametrize("cin", [3, 4, 7, 12, 17])
def test_conv3d_plain_matches_jax_conv(cin):
    """conv3d_plain (the CPU path and the card's yardstick) against the JAX
    package's conv at Cin 3, 4, 7, 12 and 17 (ops/conv3d.py: conv3d_decomposed,
    which the JAX Conv3D takes at these widths, plus the bias), in f32 on
    numpy-seeded inputs."""
    rng = np.random.default_rng(cin)
    x = rng.standard_normal((2, 5, 6, 7, cin), dtype=np.float32)
    w = (rng.standard_normal((3, 3, 3, cin, 40), dtype=np.float32)
         / np.sqrt(27 * cin))  # DHWIO, as JAX stores it
    b = rng.standard_normal((40,), dtype=np.float32)
    ref = np.asarray(conv3d_decomposed(jnp.asarray(x), jnp.asarray(w))) + b
    w_t = torch.from_numpy(np.ascontiguousarray(w.transpose(4, 3, 0, 1, 2)))
    out = cv.conv3d(torch.from_numpy(x), w_t, torch.from_numpy(b))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=CONV_RTOL,
                               atol=CONV_RTOL * np.abs(ref).max())


# a tiny 6-channel Seg model: 32 channels (GroupNorm's 32 groups), two
# levels, one res block; the 3-channel conditioner is the alias's default
TINY = dict(in_channels=1, model_channels=32, out_channels=2,
            num_res_blocks=1, attention_resolutions=(), channel_mult=(1, 2),
            dims=3, use_scale_shift_norm=True, resblock_updown=True,
            middle_attention=False)


@pytest.mark.parametrize("name", ALIASES)
def test_seg_6c_f32_matches_jax(name):
    """The f32 forward of each 6-channel alias (x with 1 channel, a
    3-channel conditioner: input convs of Cin 4 and 3) against JAX's, on
    params made on the port's state dict (every param noise, GroupNorm
    gains near 1) and carried to JAX by its importer, so no JAX init
    compiles."""
    rng = np.random.default_rng(14)
    x = rng.standard_normal((1, 8, 16, 16, 1)).astype(np.float32)
    low = rng.standard_normal((1, 8, 16, 16, 3)).astype(np.float32)
    t = np.array([321], np.int32)
    model = getattr(tmodels, name)(**TINY).eval()
    assert model.encoder.input_blocks[0][0].weight.shape[1] == 3
    assert model.input_blocks[0][0].weight.shape[1] == 4
    gains = {f"{n}.weight" for n, m in model.named_modules()
             if isinstance(m, GroupNorm32)}
    sd = {}
    for k, v in model.state_dict().items():
        noise = rng.standard_normal(tuple(v.shape)).astype(np.float32)
        sd[k] = 1.0 + 0.1 * noise if k in gains else 0.05 * noise
    params = torch_state_dict_to_params(sd)
    model.load_state_dict(jax_params_to_state_dict(params), strict=True)
    jm = getattr(jmodels, name)(**TINY)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DDPM3D_INT8", "0")
        ref = np.asarray(jax.jit(lambda p: jm.apply(
            {"params": p}, x, t, low_res=low))(params))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(t).long(),
                    low_res=torch.from_numpy(low)).numpy()
    assert got.shape == ref.shape == (1, 8, 16, 16, 2)
    assert np.abs(ref).max() > 1e-1
    assert np.abs(got - ref).max() <= MODEL_TOL * np.abs(ref).max()


# the card's launches per forward of the full-width 6-channel Seg models at
# the production flags (chip_smoke.py SEG_6C_LAUNCHES / SEG_6C_ROUTES),
# counted on the plain path at the production depth (a narrower torso
# launches the same kernels on the same routes): the Seg models' 101 convs
# and 99 GroupNorms, both input convs (Cin 4 and 3) on sm90_smallcin; in
# int8 both input convs and the head stay K3 (in0_0 and head_conv are
# excluded), the K5 sites are the 1-channel models' (119 add, 134 cat_conv)
SEG_6C_LAUNCHES = {
    "SegModelv2_6c": {"conv3d": 101, "conv3d_s8": 0, "gn_stats": 99,
                      "gn_apply": 99},
    "SegModelv3_6c": {"conv3d": 101, "conv3d_s8": 0, "gn_stats": 99,
                      "gn_apply": 99},
}
SEG_6C_ROUTES = {"sm90": 98, "sm90_smallcin": 2, "f32_head": 1}
SEG_6C_INT8_LAUNCHES = {
    "SegModelv2_6c": {"conv3d": 3, "conv3d_s8": 119, "gn_stats": 99,
                      "gn_apply": 99},
    "SegModelv3_6c": {"conv3d": 3, "conv3d_s8": 134, "gn_stats": 99,
                      "gn_apply": 99},
}
SEG_6C_INT8_ROUTES = {"sm90_smallcin": 2, "f32_head": 1}


@pytest.mark.parametrize("name", ALIASES)
def test_production_seg_6c_launches(name, monkeypatch):
    """Launches per forward of each full-depth 6-channel Seg model, bf16
    and int8, by kernel and by the conv's route (``conv3d_route`` of each
    call, as the card picks): none on sm90_gather."""
    counts, routes = {}, collections.Counter()

    def counting(key, fn):
        def wrapper(*a, **k):
            counts[key] += 1
            if key == "conv3d":
                routes[cv.conv3d_route(a[0].shape, a[0].dtype,
                                       a[1].shape[0])] += 1
            return fn(*a, **k)
        return wrapper

    for mod, fname, key in ((cv, "conv3d", "conv3d"),
                            (s8_ops, "conv3d_s8", "conv3d_s8"),
                            (gn_ops, "channel_stats", "gn_stats"),
                            (gn_ops, "gn_apply", "gn_apply")):
        monkeypatch.setattr(mod, fname, counting(key, getattr(mod, fname)))
    x = torch.zeros((1, 1, 16, 16, 1))
    low = torch.zeros((1, 1, 16, 16, 3))
    t = torch.tensor([10])
    model = getattr(tmodels, name)(
        in_channels=1, model_channels=32, out_channels=2, num_res_blocks=2,
        channel_mult=(1, 1, 2, 3, 4), use_scale_shift_norm=True,
        resblock_updown=True, dtype=torch.bfloat16).eval()
    for int8, want, want_routes in (
            (None, SEG_6C_LAUNCHES, SEG_6C_ROUTES),
            (quant.Int8Config(), SEG_6C_INT8_LAUNCHES, SEG_6C_INT8_ROUTES)):
        model.set_int8(int8)
        counts.update({k: 0 for k in want[name]})
        routes.clear()
        with torch.no_grad():
            model(x, t, low_res=low)
        assert counts == want[name], int8
        assert dict(routes) == want_routes, int8


# csrc/conv3d_narrow.cu:row_at's tap masks: depth offset kd is bits 9 kd ..
# 9 kd + 8 (KD << 9 kd), row offset kh bits 3 kh + 9 i (KH << 3 kh), column
# offset kw bits kw + 3 i (KW << kw)
KD, KH, KW = 0x1FF, 0x1C0E07, 0x1249249


@pytest.mark.parametrize("dhw", [(1, 1, 1), (2, 3, 4), (3, 1, 2), (5, 4, 3)])
def test_row_tap_masks(dhw):
    """A row's 27 tap bits as the AND of the three axis masks equal the
    taps that stay inside the volume, tap = 9 kd + 3 kh + kw, at every
    voxel (edges, one-voxel axes)."""
    D, H, W = dhw
    for d, h, w in itertools.product(range(D), range(H), range(W)):
        md = (KD if d > 0 else 0) | KD << 9 | (KD << 18 if d + 1 < D else 0)
        mh = (KH if h > 0 else 0) | KH << 3 | (KH << 6 if h + 1 < H else 0)
        mw = (KW if w > 0 else 0) | KW << 1 | (KW << 2 if w + 1 < W else 0)
        want = sum(1 << (9 * kd + 3 * kh + kw) for kd, kh, kw in
                   itertools.product(range(3), repeat=3)
                   if 0 <= d + kd - 1 < D and 0 <= h + kh - 1 < H
                   and 0 <= w + kw - 1 < W)
        assert md & mh & mw == want
