"""Host-side rules of the port's redesigned int8 conv (``csrc/conv3d_s8.cu``,
K5), of its 1x1x1 kernel (``csrc/conv1x1_s8.cu``) and of the narrow input
conv (``csrc/conv3d_narrow.cu``): which taps a phase tile runs, the tiles,
work items and shared memory of every int8 site of the production model
(and, for the 1x1x1 kernel, of the Seg models), and the narrow conv's
folded weight layout. Pure
Python on the CPU, against the JAX package where it has the function; the
kernels themselves are held against their plain versions on the card
(tests/test_torch_port_cuda.py, chip_smoke.py).
"""

import collections
import itertools
import os.path as osp
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddpm3d_tpu.ops.conv3d_mxu import conv3d_mxu
from ddpm3d_tpu.ops.phase_up import phase_up_kernels as jax_phase_up_kernels
from ddpm3d_tpu_torch.models import SegUNetModel
from ddpm3d_tpu_torch.models.factory import sr_create_model_and_diffusion
from ddpm3d_tpu_torch.models.nn import init_params
from ddpm3d_tpu_torch.ops import conv3d as cv
from ddpm3d_tpu_torch.ops import conv3d_s8 as s8
from ddpm3d_tpu_torch.ops import quant
from ddpm3d_tpu_torch.ops.phase_up import phase_window_mask, stacked_phase_weight
from ddpm3d_tpu_torch.utils.config import sr_model_and_diffusion_defaults


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads for this file's tests and fixtures (the suite's
    workers share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)

SMALL_HW = 16  # the census runs the model at (1, 16, 16): H, W -> 96 * H / 16


@pytest.fixture(scope="module")
def int8_sites():
    """Every int8 site of one forward of the production model (the flags of
    ``chip_smoke.py:_model``, dynamic scales, the default exclusions) at
    96^3, as (D, H, W, Cin, N, taps, upsample) -> calls; N = 4 * Cout on the
    phase route. Read by forward hooks from a forward at (1, 16, 16) and
    scaled to 96^3: the widths per level do not depend on the volume."""
    args = sr_model_and_diffusion_defaults()
    args.update(
        large_size=96, num_channels=128, num_res_blocks=2, learn_sigma=True,
        use_fp16=False, use_scale_shift_norm=True, resblock_updown=True,
        attention_resolutions="1000", num_head_channels=64,
        diffusion_steps=1000, noise_schedule="linear",
    )
    model, _, _ = sr_create_model_and_diffusion(**args,
                                                int8=quant.Int8Config())
    init_params(model, seed=0, zero_heads=False)
    model.eval()
    sites = collections.Counter()
    scale = 96 // SMALL_HW

    def hook(mod, args, kwargs, out):
        _, _, H, W, cin = args[0].shape
        up = bool(kwargs.get("upsample", False))
        n = mod.weight.shape[0] * (4 if up else 1)
        sites[(96, H * scale, W * scale, cin, n, mod.weight[0, 0].numel(),
               up)] += 1

    for m in model.modules():
        if getattr(m, "site", "") and m.int8_active():
            m.register_forward_hook(hook, with_kwargs=True)
    x = torch.zeros((1, 1, SMALL_HW, SMALL_HW, 1))
    with torch.no_grad():
        model(x, torch.tensor([500]), low_res=x)
    return sites


def test_int8_census(int8_sites):
    """88 int8 launches per forward: 66 3x3x3, 4 up sites on the phase
    route (Cout 128, 128, 256, 384: each 128-column tile inside one phase),
    18 1x1 skips; every Cin and N a multiple of 128."""
    assert sum(int8_sites.values()) == 88
    kinds = collections.Counter()
    for (D, H, W, cin, n, taps, up), calls in int8_sites.items():
        kinds["phase" if up else f"{taps}"] += calls
        assert cin % 128 == 0 and n % 128 == 0
    assert kinds == {"27": 66, "phase": 4, "1": 18}
    couts = sorted(n // 4 for (_, _, _, _, n, _, up), c in int8_sites.items()
                   for _ in range(c) if up)
    assert couts == [128, 128, 256, 384]


@pytest.mark.parametrize("p", range(4))
def test_phase_tap_mask_keeps_exactly_the_phase_taps(p):
    """A 128-column tile inside phase p runs 12 taps: every tap it drops is
    all-zero in the stacked phase weight (so the 27-tap sum is the same),
    every tap it keeps holds the JAX package's 2x2 phase kernel of the same
    weights, not identically zero; the window mask says the same."""
    rng = np.random.default_rng(40 + p)
    cout, cin = 128, 3
    w = rng.standard_normal((3, 3, 3, cin, cout)).astype(np.float32)  # DHWIO
    w_t = torch.from_numpy(np.ascontiguousarray(w.transpose(4, 3, 0, 1, 2)))
    stacked = stacked_phase_weight(w_t)
    window = phase_window_mask(cout)
    assert bool((stacked * (1 - window) == 0).all())
    mine = stacked[p * cout:(p + 1) * cout]
    mask = s8.s8_tap_mask(p * cout, 4 * cout, cout, 27, True)
    assert bin(mask).count("1") == 12
    assert sorted(t for t in range(27) if mask >> t & 1) == s8.phase_taps(p)
    taps = mine.reshape(cout, cin, 27)
    for t in range(27):
        assert bool(taps[:, :, t].abs().sum() > 0) == bool(mask >> t & 1), t
    a, b = divmod(p, 2)
    ref = np.asarray(jax_phase_up_kernels(jnp.asarray(w))[(a, b)])
    got = mine[:, :, :, a:a + 2, b:b + 2].permute(2, 3, 4, 1, 0).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("cout", [24, 64, 128, 200, 384])
def test_phase_tap_mask_covers_every_column(cout):
    """For every 128-column tile of the phase route: the taps of each of its
    columns' phases are in the mask, and no other tap (a tile across
    phases runs their union); the 3x3x3 conv runs all 27, the 1x1 one."""
    n = 4 * cout
    for n0 in range(0, n, cv.SM90_BN):
        mask = s8.s8_tap_mask(n0, n, cout, 27, True)
        need = set()
        for col in range(n0, min(n0 + cv.SM90_BN, n)):
            need |= set(s8.phase_taps(col // cout))
        assert {t for t in range(27) if mask >> t & 1} == need
        assert s8.s8_tap_mask(n0, n, cout, 27, False) == (1 << 27) - 1
        assert s8.s8_tap_mask(n0, n, cout, 1, False) == 1


def test_phase_tiles_run_twelve_taps_at_every_up_site(int8_sites):
    """Every column tile of every up site of the model lies inside one
    phase, so the kernel runs 12 of the 27 taps there, as chip_smoke.py's
    bound counts (48 MACs per input voxel per output channel)."""
    ups = [k for k in int8_sites if k[6]]
    assert sum(int8_sites[k] for k in ups) == 4
    for (D, H, W, cin, n, taps, up) in ups:
        for n0 in range(0, n, cv.SM90_BN):
            assert bin(s8.s8_tap_mask(n0, n, n // 4, taps, up)).count("1") == 12


@pytest.mark.parametrize("B", [1, 2])
def test_s8_tiles_fit_every_site(int8_sites, B):
    """At every 3x3x3 int8 site (batch 1 and 2; the 1x1x1 sites run
    csrc/conv1x1_s8.cu, test_conv1x1_plans_fit_every_site): the tile of
    s8_tile has at most 256 rows, a halo within the kernel's limit and
    TMA's box dimensions, a halo ring of 2-4 stages, shared memory within
    the block's 232448 bytes, and follows the bf16 kernel's rules."""
    for (D, H, W, cin, n, taps, up) in int8_sites:
        if taps == 1:
            continue
        tile = s8.s8_tile(B, D, H, W, n)
        td, th, tw = tile
        assert td * th * tw <= cv.SM90_MAX_ROWS
        assert td <= D and th <= H and tw <= W
        assert cv.sm90_halo(tile) <= cv.SM90_MAX_HALO
        assert max(td, th, tw) + 2 <= 256
        stages, stage = s8.s8_halo_stages(tile)
        assert 2 <= stages <= s8.S8_MAX_HALO_STAGES
        assert stage >= td * th * tw * 128  # the epilogue's staged rows
        assert s8.s8_smem_bytes(tile) <= cv.SM90_SMEM_LIMIT
        assert tile == cv.sm90_tile(B, D, H, W, n)
        # f32 output runs the 128-row instance only
        t32 = s8.s8_tile(B, D, H, W, n, torch.float32)
        assert t32[0] * t32[1] * t32[2] <= cv.SM90_MAX_ROWS // 2
        assert s8.s8_smem_bytes(t32) <= cv.SM90_SMEM_LIMIT


def test_s8_smem_matches_the_kernel_layout():
    """At 8x4x8: two 600-voxel halo stages of 76.8 KB (128 bytes a voxel),
    four 16 KB weight stages, 16 barriers, the 256-row table and 1 KB of
    alignment slack."""
    assert s8.s8_halo_stages((8, 4, 8)) == (2, 76800)
    assert s8.s8_smem_bytes((8, 4, 8)) == (
        1024 + 2 * 76800 + 4 * 16384 + 8 * 16 + 1024)
    assert s8.s8_smem_bytes((14, 2, 8)) <= cv.SM90_SMEM_LIMIT


@pytest.mark.parametrize("B,dhw,n,taps", [
    (2, (5, 7, 9), 130, 27), (1, (6, 12, 12), 512, 27),
    (1, (96, 6, 6), 4 * 384, 27),
])
def test_s8_work_items_cover_the_output_once(B, dhw, n, taps):
    """The work items of one launch (``decode_tile``, the same order as the
    bf16 kernel's) cover every output voxel and 128-column tile once; the
    3x3x3 box starts one voxel before the tile (TMA's zero fill is the SAME
    padding). The 1x1x1 cases moved to
    test_conv1x1_work_items_cover_the_output_once."""
    D, H, W = dhw
    tile = s8.s8_tile(B, D, H, W, n)
    td, th, tw = tile
    total = cv.sm90_tiles(B, D, H, W, n, tile)
    seen = collections.Counter()
    for q in range(total):
        b, d0, h0, w0, n0 = cv.sm90_tile_origin(q, B, D, H, W, n, tile)
        assert 0 <= b < B and n0 < n and n0 % cv.SM90_BN == 0
        assert d0 < D and h0 < H and w0 < W
        for d, h, w in itertools.product(range(d0, min(d0 + td, D)),
                                         range(h0, min(h0 + th, H)),
                                         range(w0, min(w0 + tw, W))):
            seen[(b, d, h, w, n0)] += 1
    assert len(seen) == B * D * H * W * -(-n // cv.SM90_BN)
    assert set(seen.values()) == {1}


# ------------------------------------------------- csrc/conv1x1_s8.cu --

C1_SRC = osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))),
                  "ddpm3d_tpu_torch", "csrc", "conv1x1_s8.cu")


@pytest.fixture(scope="module")
def seg_1x1_sites():
    """The 1x1x1 int8 sites of one forward of each full-width Seg fusion
    (128 channels, (1, 1, 2, 3, 4), 2 res blocks, bf16, dynamic scales), as
    {fusion: Counter((D, H, W, Cin, N))} at 96^3, read by forward hooks
    from a forward at (1, 16, 16) as :func:`int8_sites` reads the
    production model's."""
    out = {}
    scale = 96 // SMALL_HW
    for fusion in ("add", "cat_conv", "midcat"):
        model = SegUNetModel(
            in_channels=1, cond_channels=1, model_channels=128,
            out_channels=2, num_res_blocks=2, channel_mult=(1, 1, 2, 3, 4),
            use_scale_shift_norm=True, resblock_updown=True, fusion=fusion,
            dtype=torch.bfloat16).eval()
        model.set_int8(quant.Int8Config())
        sites = collections.Counter()

        def hook(mod, args, kwargs, y, sites=sites):
            _, _, H, W, cin = args[0].shape
            if mod.weight[0, 0].numel() == 1:
                sites[(96, H * scale, W * scale, cin,
                       mod.weight.shape[0])] += 1

        for m in model.modules():
            if getattr(m, "site", "") and m.int8_active():
                m.register_forward_hook(hook, with_kwargs=True)
        x = torch.zeros((1, 1, SMALL_HW, SMALL_HW, 1))
        with torch.no_grad():
            model(x, torch.tensor([10]), low_res=x)
        out[fusion] = sites
    return out


def _all_1x1_sites(int8_sites, seg_1x1_sites) -> set:
    """Every distinct (D, H, W, Cin, N) 1x1x1 site of the production model
    and of the three Seg fusions."""
    main = {k[:5] for k in int8_sites if k[5] == 1}
    return main.union(*seg_1x1_sites.values())


def _c1_fits(plan) -> bool:
    """The slab, C1_MIN_STAGES row stages and the output buffers fit."""
    return (1024 + plan.chunks * s8.C1_CHUNK
            + s8.C1_MIN_STAGES * s8.C1_CHUNK + s8.C1_OUT_BYTES
            + 8 * s8.C1_BARS) <= cv.SM90_SMEM_LIMIT


def _check_work_items(plan, B: int, V: int, n: int) -> int:
    """Every (row tile, column tile) once, every row of [0, B V) in exactly
    one row tile, the blocks within the grid; returns how many row tiles
    straddle two samples (the epilogue's per-row scale)."""
    seen = collections.Counter(
        (rt, ct) for blk, rt, ct in s8.conv1x1_work_items(plan))
    assert set(seen) == set(itertools.product(range(plan.row_tiles),
                                              range(plan.col_tiles)))
    assert set(seen.values()) == {1}
    assert plan.col_tiles * s8.C1_BN >= n > (plan.col_tiles - 1) * s8.C1_BN
    assert plan.row_tiles * s8.C1_ROWS >= B * V
    assert (plan.row_tiles - 1) * s8.C1_ROWS < B * V
    assert plan.grid <= max(cv.SM90_SMS, plan.col_tiles)
    blocks = {blk for blk, _, _ in s8.conv1x1_work_items(plan)}
    assert blocks == set(range(plan.grid))  # no block without a tile
    straddles = 0
    for rt in range(plan.row_tiles):
        r0, r1 = rt * s8.C1_ROWS, min((rt + 1) * s8.C1_ROWS, B * V) - 1
        straddles += r0 // V != r1 // V
    return straddles


@pytest.mark.parametrize("B", [1, 2])
def test_conv1x1_plans_fit_every_site(int8_sites, seg_1x1_sites, B):
    """At every 1x1x1 int8 site of the production model and of the Seg
    fusions (14 + 4 more distinct shapes), batch 1 and 2, bf16 and f32 out:
    the work items cover every output row and column tile once; shared
    memory is within the block's 232448 bytes; the weight slab is resident
    at every site with Cin <= 512 and exactly where it fits beside four
    row stages and the output buffers, and streamed (two 16 KB chunks a
    stage) elsewhere; 4 to 8 stages; TMA stores (16-byte rows of y)."""
    sites = _all_1x1_sites(int8_sites, seg_1x1_sites)
    assert len({k for k in int8_sites if k[5] == 1}) == 14
    for (D, H, W, cin, n) in sites:
        V = D * H * W
        for dt in (torch.bfloat16, torch.float32):
            plan = s8.conv1x1_plan(B, V, cin, n, dt)
            assert plan.smem_bytes <= cv.SM90_SMEM_LIMIT
            assert plan.resident == _c1_fits(plan)
            if cin <= 512:
                assert plan.resident
            assert plan.stage_bytes == s8.C1_CHUNK * (1 if plan.resident
                                                      else 2)
            assert s8.C1_MIN_STAGES <= plan.stages <= s8.C1_MAX_STAGES
            assert plan.tma_out
            assert plan.passes == (2 if dt == torch.bfloat16 else 4)
            _check_work_items(plan, B, V, n)
    # the byte-heavy sites fill the card: 96^2 and 48^2 run 132 blocks
    for (D, H, W, cin, n) in sites:
        if H >= 48:
            assert s8.conv1x1_plan(B, D * H * W, cin, n).grid == cv.SM90_SMS


@pytest.mark.parametrize("B,dhw,n,cin", [
    (1, (96, 12, 12), 384, 768), (2, (4, 6, 6), 256, 128),
    (2, (5, 7, 9), 200, 48), (1, (96, 6, 6), 512, 1024),
])
def test_conv1x1_work_items_cover_the_output_once(B, dhw, n, cin):
    """The work items of one launch (each block's column tile b % nt and
    row tiles b // nt, + bpc, ...) cover every output row and 128-column
    tile once, including row tiles that straddle two samples (batch 2 with
    D H W not a multiple of 128: 144 and 315 rows a sample)."""
    V = dhw[0] * dhw[1] * dhw[2]
    plan = s8.conv1x1_plan(B, V, cin, n)
    straddles = _check_work_items(plan, B, V, n)
    assert straddles == (1 if B == 2 and V % s8.C1_ROWS else 0)


def test_conv1x1_smem_matches_the_kernel_layout():
    """The planner's constants are the kernel's, and its layout: at Cin 256
    a resident 32 KB slab, eight 16 KB row stages, 2 x 4 output buffers of
    8 KB, 17 barriers and 1 KB of alignment slack; at Cin 1024 (a 128 KB
    slab does not fit beside four stages) five 32 KB stages of rows and
    weights; at Cin 768 a resident 96 KB slab beside four stages."""
    with open(C1_SRC) as f:
        src = f.read()
    const = {k: int(v) for k, v in re.findall(
        r"constexpr int (k\w+) = (\d+);", src)}
    assert const["kRows"] == s8.C1_ROWS and const["kBN"] == s8.C1_BN
    assert const["kBK"] == s8.C1_BK
    assert const["kMinStages"] == s8.C1_MIN_STAGES
    assert const["kMaxStages"] == s8.C1_MAX_STAGES
    assert const["kConsumers"] == s8.C1_CONSUMERS
    assert const["kOutBufs"] == s8.C1_OUT_BUFS
    assert "kPassBytes = 64 * 128;" in src
    assert "kBars = 2 * kMaxStages + 1;" in src
    plan = s8.conv1x1_plan(1, 96 ** 3, 256, 128)
    assert plan.resident and plan.stages == 8 and plan.slab_bytes == 32768
    assert (plan.ring_off, plan.out_off, plan.bar_off) == (
        32768, 32768 + 8 * 16384, 32768 + 8 * 16384 + 65536)
    assert plan.smem_bytes == 1024 + 32768 + 8 * 16384 + 65536 + 8 * 17
    plan = s8.conv1x1_plan(1, 96 * 36, 1024, 512)
    assert not plan.resident and plan.stages == 5
    assert (plan.ring_off, plan.out_off, plan.bar_off) == (
        0, 5 * 32768, 5 * 32768 + 65536)
    assert plan.smem_bytes == 1024 + 5 * 32768 + 65536 + 8 * 17
    plan = s8.conv1x1_plan(1, 96 * 144, 768, 384)
    assert plan.resident and plan.stages == 4
    assert plan.smem_bytes == 1024 + 98304 + 4 * 16384 + 65536 + 8 * 17


def _im2col_narrow(x: np.ndarray) -> np.ndarray:
    """[B, D, H, W, 2] -> [B, D, H, W, 64]: column k = 2 * tap + ci of the
    zero-padded input at tap (kd, kh, kw) = divmod(tap, 9), ..., zeros from
    k = 54: the A rows the narrow kernel gathers."""
    B, D, H, W, cin = x.shape
    xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (1, 1), (0, 0)))
    cols = np.zeros((B, D, H, W, cv.NARROW_K), np.float32)
    for tap in range(27):
        kd, kh, kw = tap // 9, (tap // 3) % 3, tap % 3
        cols[..., tap * cin:(tap + 1) * cin] = \
            xp[:, kd:kd + D, kh:kh + H, kw:kw + W]
    return cols


def test_pack_weight_narrow_im2col_matches_the_conv():
    """The narrow kernel's arithmetic on the CPU: its im2col rows times
    pack_weight_narrow's [Cout, 64] weight, plus the bias, equal the plain
    conv and the JAX package's Pallas conv (interpret mode) at Cin = 2."""
    rng = np.random.default_rng(41)
    x = rng.standard_normal((1, 4, 6, 8, 2), dtype=np.float32)
    w = (rng.standard_normal((3, 3, 3, 2, 32), dtype=np.float32)
         / np.sqrt(54)).astype(np.float32)  # DHWIO
    b = rng.standard_normal((32,), dtype=np.float32)
    w_t = torch.from_numpy(np.ascontiguousarray(w.transpose(4, 3, 0, 1, 2)))
    packed = cv.pack_weight_narrow(w_t, torch.float32)
    assert tuple(packed.shape) == (32, cv.NARROW_K)
    assert bool((packed[:, 54:] == 0).all())
    assert cv.pack_weight_kernel(w_t, torch.bfloat16).shape == (32, 64)
    assert cv.pack_weight_kernel(w_t, torch.float32).shape == (32, 54)
    got = (torch.from_numpy(_im2col_narrow(x)) @ packed.t()
           + torch.from_numpy(b)).numpy()
    plain = cv.conv3d_plain(torch.from_numpy(x), w_t, torch.from_numpy(b))
    ref = np.asarray(conv3d_mxu(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(b), interpret=True))
    np.testing.assert_allclose(got, plain.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_narrow_dx_packs_for_its_own_route():
    """The dx of a conv maps Cout -> Cin: its weight is packed for the route
    of dy (Cout channels), narrow only where Cout = 2 (bf16 [Cin, 64], f32
    [Cin, 54])."""
    w = torch.randn((2, 16, 3, 3, 3))
    assert cv.pack_weight_dx(w, torch.bfloat16).shape == (16, 64)
    assert cv.pack_weight_dx(w, torch.float32).shape == (16, 54)
    w = torch.randn((128, 2, 3, 3, 3))
    assert cv.pack_weight_dx(w, torch.bfloat16).shape == (27, 2, 128)
