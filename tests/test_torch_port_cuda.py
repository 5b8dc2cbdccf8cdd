"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: they skip where there is no NVIDIA GPU (the kernels are
built by nvcc on first use and have no CPU or interpret mode). Run them on
a GPU machine with
``python -m pytest --noconftest tests/test_torch_port_cuda.py`` (the repo's
conftest imports jax);
``chip_smoke.py`` checks the same kernels at the main path's full shapes.
"""

import numpy as np
import pytest
import torch

from ddpm3d_tpu_torch import ops
from ddpm3d_tpu_torch.models import SuperResModel
from ddpm3d_tpu_torch.models import factory
from ddpm3d_tpu_torch.models.nn import init_params
from ddpm3d_tpu_torch.ops import conv3d as cv
from ddpm3d_tpu_torch.ops import conv3d_fused as fo
from ddpm3d_tpu_torch.ops import groupnorm as gn
from ddpm3d_tpu_torch.training import train_loop as tl

pytestmark = pytest.mark.cuda

# bf16 outputs may differ by one bf16 rounding where f32 sums differ in order
TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-5}
# a bf16 model served fused against unfused: the fused path folds each GN
# from the f32 conv sums, the unfused one from the bf16-rounded output, so
# each of the ~10 convs in sequence rounds slightly different inputs to bf16
# (2^-8 each); the differences compound over the depth
BF16_FUSED_MODEL_TOL = 3e-2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel(out, ref):
    return ((out.float() - ref.float()).abs().max()
            / ref.float().abs().max().clamp_min(1e-30)).item()


@pytest.mark.parametrize("shape,cout", [
    ((2, 5, 7, 9, 32), 16),      # ragged tiles on every axis, 2 batches
    ((1, 6, 12, 12, 256), 130),  # Cout past one 128-column tile, ragged
    ((1, 4, 8, 8, 2), 128),      # Cin = 2 (unaligned staging)
    ((1, 4, 8, 8, 40), 2),       # Cout = 2
    ((1, 8, 6, 6, 1024), 64),    # W = 6 plane, deep Cin
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_conv3d_kernel_matches_plain(dev, shape, cout, dtype):
    g = torch.Generator(device=dev).manual_seed(0)
    cin = shape[-1]
    x = torch.randn(shape, generator=g, device=dev).to(dtype)
    w = torch.randn((cout, cin, 3, 3, 3), generator=g, device=dev) / (27 * cin) ** 0.5
    b = torch.randn((cout,), generator=g, device=dev)
    before = ops.launch_counts()["conv3d"]
    key = "conv3d." + cv.conv3d_route(shape, dtype, cout)
    routed = ops.route_counts()[key]
    out = cv.conv3d(x, w, b)
    assert ops.launch_counts()["conv3d"] == before + 1
    assert ops.route_counts()[key] == routed + 1
    ref = cv.conv3d_plain(x, w.to(dtype), b)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == ref.shape
    assert _rel(out, ref) <= TOL[dtype]


@pytest.mark.parametrize("N,C", [(4096, 128), (1000, 96), (216, 1024)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gn_kernels_match_plain(dev, N, C, dtype):
    g = torch.Generator(device=dev).manual_seed(1)
    x = (torch.randn((2, N, C), generator=g, device=dev) * 3 + 1).to(dtype)
    st = gn.channel_stats(x)
    st_ref = gn.channel_stats_plain(x)
    assert _rel(st, st_ref) <= 1e-5
    gg = torch.randn((2, C), generator=g, device=dev)
    bb = torch.randn((2, C), generator=g, device=dev)
    for silu in (False, True):
        y = gn.gn_apply(x, gg, bb, silu)
        assert _rel(y, gn.gn_apply_plain(x, gg, bb, silu)) <= TOL[dtype]


def test_kernels_are_batch_invariant(dev):
    """Each volume's result is bit-identical alone or in a batch: the conv's
    per-voxel sums and the GN partial sums are ordered by N alone."""
    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn((2, 6, 16, 16, 128), generator=g, device=dev).bfloat16()
    w = cv.pack_weight(torch.randn((128, 128, 3, 3, 3), generator=g,
                                   device=dev) * 0.02, torch.bfloat16)
    routed = ops.route_counts()["conv3d.sm90"]
    both = cv.conv3d_kernel(x, w)
    assert torch.equal(both[1:], cv.conv3d_kernel(x[1:].contiguous(), w))
    assert ops.route_counts()["conv3d.sm90"] == routed + 2
    x3 = x.reshape(2, -1, 128)
    assert torch.equal(gn.channel_stats(x3)[1:],
                       gn.channel_stats(x3[1:].contiguous()))


@pytest.mark.parametrize("shape,cout,dtype", [
    ((2, 5, 7, 9, 32), 16, torch.bfloat16),    # ragged tiles, 2 batches
    ((1, 6, 12, 12, 256), 130, torch.bfloat16),  # dx: 130 -> 256
    ((1, 8, 6, 6, 1024), 64, torch.bfloat16),  # dx: 64 -> 1024 on W = 6
    ((1, 4, 8, 8, 128), 2, torch.float32),     # the head: dx is f32 2 -> 128
    ((1, 4, 8, 8, 40), 16, torch.float32),
])
def test_conv3d_backward_matches_plain(dev, shape, cout, dtype):
    """dx through the kernel (flipped, in/out-swapped weight) and the
    library filter gradient, each against its plain version."""
    g = torch.Generator(device=dev).manual_seed(4)
    cin = shape[-1]
    x = torch.randn(shape, generator=g, device=dev).to(dtype)
    w = torch.randn((cout, cin, 3, 3, 3), generator=g, device=dev) / (27 * cin) ** 0.5
    dy = torch.randn(shape[:-1] + (cout,), generator=g, device=dev).to(dtype)
    before = ops.launch_counts()["conv3d_dx"]
    key = "conv3d_dx." + cv.conv3d_route(dy.shape, dtype, cin)
    routed = ops.route_counts()[key]
    dx = cv.conv3d_dx(dy, w)
    assert ops.launch_counts()["conv3d_dx"] == before + 1
    assert ops.route_counts()[key] == routed + 1
    dw = cv.conv3d_dw(x, dy)
    dx_ref = cv.conv3d_dx_plain(dy, w)
    dw_ref = cv.conv3d_dw_plain(x, dy)
    torch.cuda.synchronize()
    assert dx.shape == x.shape and dx.dtype == dtype
    assert dw.shape == w.shape and dw.dtype == dtype
    assert _rel(dx, dx_ref) <= TOL[dtype]
    assert _rel(dw, dw_ref) <= TOL[dtype]


# reduced-depth versions of the main path's bf16 torso families (every
# volume's plane, every Cout > 128 column tiling, W = 12 and W = 6, Cin up
# to 1024) and a batch of 2 with ragged tiles on every axis
SM90_SHAPES = [
    ((1, 8, 96, 96, 128), 128),
    ((1, 8, 48, 48, 256), 128),
    ((1, 8, 24, 24, 128), 256),
    ((1, 8, 24, 24, 512), 256),
    ((1, 6, 12, 12, 256), 384),
    ((1, 6, 12, 12, 768), 384),
    ((1, 4, 6, 6, 1024), 512),
    ((1, 9, 6, 6, 384), 512),
    ((2, 5, 7, 9, 64), 128),
]


@pytest.mark.parametrize("shape,cout", SM90_SHAPES)
def test_conv3d_sm90_matches_plain(dev, shape, cout):
    """csrc/conv3d_sm90.cu against the plain version at bf16, forward and
    dx, counted on its own route; repeated calls give the same bits."""
    g = torch.Generator(device=dev).manual_seed(5)
    cin = shape[-1]
    x = torch.randn(shape, generator=g, device=dev).bfloat16()
    w = torch.randn((cout, cin, 3, 3, 3), generator=g, device=dev) / (27 * cin) ** 0.5
    b = torch.randn((cout,), generator=g, device=dev)
    dy = torch.randn(shape[:-1] + (cout,), generator=g, device=dev).bfloat16()
    before = ops.route_counts()
    wp = cv.pack_weight(w, torch.bfloat16)
    out = cv.conv3d_kernel(x, wp, b)
    dx = cv.conv3d_dx(dy, w)
    after = ops.route_counts()
    assert after["conv3d.sm90"] == before["conv3d.sm90"] + 1
    assert after["conv3d_dx.sm90"] == before["conv3d_dx.sm90"] + 1
    assert after["conv3d.ndhwc"] == before["conv3d.ndhwc"]
    assert after["conv3d_dx.ndhwc"] == before["conv3d_dx.ndhwc"]
    ref = cv.conv3d_plain(x, w.bfloat16(), b)
    dx_ref = cv.conv3d_dx_plain(dy, w)
    torch.cuda.synchronize()
    assert out.shape == ref.shape and dx.shape == x.shape
    assert _rel(out, ref) <= TOL[torch.bfloat16]
    assert _rel(dx, dx_ref) <= TOL[torch.bfloat16]
    assert torch.equal(out, cv.conv3d_kernel(x, wp, b))
    assert torch.equal(dx, cv.conv3d_dx(dy, w))


@pytest.mark.parametrize("rows", [256, 128])
@pytest.mark.parametrize("shape,cout", [
    ((2, 5, 7, 9, 64), 128), ((2, 6, 12, 12, 256), 384)])
def test_conv3d_sm90_both_instances_match_plain(dev, shape, cout, rows):
    """The kernel's 256- and 128-row instances on the same ragged batch-2
    inputs (the launch given each tile size directly)."""
    from ddpm3d_tpu_torch.ops import _build

    g = torch.Generator(device=dev).manual_seed(6)
    B, D, H, W, cin = shape
    x = torch.randn(shape, generator=g, device=dev).bfloat16()
    w = torch.randn((cout, cin, 3, 3, 3), generator=g, device=dev) / (27 * cin) ** 0.5
    b = torch.randn((cout,), generator=g, device=dev)
    wp = cv.pack_weight(w, torch.bfloat16)
    y = torch.empty((B, D, H, W, cout), dtype=torch.bfloat16, device=dev)
    tile = cv.pick_tile_sm90(D, H, W, rows)
    assert 64 * rows // 128 < tile[0] * tile[1] * tile[2] <= rows
    err = _build.fn("conv3d_sm90_launch")(
        x.data_ptr(), wp.data_ptr(), b.data_ptr(), y.data_ptr(),
        B, D, H, W, cin, cout, *tile, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "conv3d_sm90_launch")
    ref = cv.conv3d_plain(x, w.bfloat16(), b)
    torch.cuda.synchronize()
    assert _rel(y, ref) <= TOL[torch.bfloat16]


def test_conv3d_sm90_rejects_unaligned_pointers(dev):
    """TMA needs 16-byte-aligned global addresses: a view that starts
    mid-row raises instead of running another kernel."""
    x = torch.zeros((1, 2, 4, 4, 72), device=dev, dtype=torch.bfloat16)
    xv = x.view(-1)[8:8 + 2 * 4 * 4 * 64].view(1, 2, 4, 4, 64)
    assert xv.is_contiguous() and xv.data_ptr() % 16 == 0
    wp = cv.pack_weight(torch.zeros((8, 64, 3, 3, 3), device=dev),
                        torch.bfloat16)
    cv.conv3d_kernel(xv, wp)  # aligned: runs
    xu = x.view(-1)[1:1 + 2 * 4 * 4 * 64].view(1, 2, 4, 4, 64)
    with pytest.raises(ValueError, match="16-byte"):
        cv.conv3d_kernel(xu, wp)


def _tiny_model(dtype, seed=3):
    model = SuperResModel(
        in_channels=1, model_channels=32, out_channels=2, num_res_blocks=1,
        channel_mult=(1, 2), use_scale_shift_norm=True, resblock_updown=True,
        middle_attention=False, dtype=dtype)
    init_params(model, seed=seed, zero_heads=False)
    return model


def _batch(seed, shape=(2, 4, 16, 16, 1)):
    rng = np.random.default_rng(seed)
    x0 = torch.from_numpy(np.clip(rng.standard_normal(shape), -1, 1).astype(np.float32))
    low = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
    noise = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
    return x0, low, noise


def test_every_parameter_gets_a_finite_gradient(dev):
    """One bf16 training step's backward on the card: every parameter has a
    finite gradient, and dx went through the kernel."""
    model = _tiny_model(torch.bfloat16).to(dev).train()
    sched, cfg = factory.create_gaussian_diffusion(steps=1000, learn_sigma=True)
    x0, low, noise = (a.to(dev) for a in _batch(5))
    ops.reset_launch_counts()
    tl.compute_grads(model, sched.to(dev), cfg, x0, {"low_res": low},
                     torch.tensor([3, 700], device=dev),
                     torch.ones(2, device=dev), noise=noise)
    torch.cuda.synchronize()
    for name, p in model.named_parameters():
        assert p.grad is not None, name
        assert bool(torch.isfinite(p.grad).all()), name
    counts = ops.launch_counts()
    assert counts["conv3d_dx"] == counts["conv3d"] - 1 > 0  # not the input conv


def test_packed_weight_cache_follows_optimizer_step(dev):
    """An inference forward after an optimizer update uses the new weights,
    not the packed copy of the old ones."""
    model = _tiny_model(torch.bfloat16).to(dev)
    sched, cfg = factory.create_gaussian_diffusion(steps=1000, learn_sigma=True)
    x0, low, noise = (a.to(dev) for a in _batch(6))
    t = torch.tensor([10, 500], device=dev)
    with torch.no_grad():
        before = model.eval()(x0, t, low_res=low)  # packs every conv weight
    params = list(model.parameters())
    state = tl.TrainState(step=0, model=model.train(),
                          optimizer=tl.make_optimizer(params, 1e-2, 0.0),
                          ema_params=[])
    tl.compute_grads(model, sched.to(dev), cfg, x0, {"low_res": low}, t,
                     torch.ones(2, device=dev), noise=noise)
    tl.apply_update(state, t, {"loss": torch.ones(2, device=dev)},
                    torch.ones(2, device=dev), 1e-2, 0, ())
    fresh = _tiny_model(torch.bfloat16).to(dev)
    fresh.load_state_dict(model.state_dict())
    with torch.no_grad():
        after = model.eval()(x0, t, low_res=low)
        ref = fresh.eval()(x0, t, low_res=low)
    torch.cuda.synchronize()
    assert not torch.equal(after, before)
    assert torch.equal(after, ref)


def test_training_gradients_match_cpu(dev):
    """One small f32 training step's loss and gradients on the card against
    the plain path on the CPU, per tensor within 1e-3 of the largest entry
    (with a floor for gradients that are zero in exact arithmetic: a conv
    bias before a one-channel-per-group GroupNorm)."""
    sched, cfg = factory.create_gaussian_diffusion(steps=1000, learn_sigma=True)
    x0, low, noise = _batch(7)
    t, w = torch.tensor([3, 870]), torch.ones(2)
    grads, losses = [], []
    for d in ("cpu", dev):
        model = _tiny_model(torch.float32).to(d)
        terms = tl.compute_grads(
            model, sched.to(d), cfg, x0.to(d), {"low_res": low.to(d)},
            t.to(d), w.to(d), noise=noise.to(d))
        losses.append(terms["loss"].cpu())
        grads.append({n: p.grad.cpu() for n, p in model.named_parameters()})
    torch.testing.assert_close(losses[1], losses[0], rtol=1e-4, atol=0)
    floor = 1e-3 * max(g.abs().max().item() for g in grads[0].values())
    for name, ref in grads[0].items():
        err = (grads[1][name] - ref).abs().max().item()
        assert err <= 1e-3 * max(ref.abs().max().item(), floor), name


def test_model_kernel_path_matches_cpu(dev):
    """A small f32 model: kernels on the card against the plain path on
    the CPU."""
    model = SuperResModel(
        in_channels=1, model_channels=32, out_channels=2, num_res_blocks=1,
        channel_mult=(1, 2), use_scale_shift_norm=True, resblock_updown=True,
        middle_attention=False).eval()
    init_params(model, seed=3, zero_heads=False)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 4, 16, 16, 1), np.float32))
    t = torch.tensor([10, 900])
    with torch.no_grad():
        ref = model(x, t, low_res=x)
        ops.reset_launch_counts()
        out = model.to(dev)(x.to(dev), t.to(dev), low_res=x.to(dev)).cpu()
    counts = ops.launch_counts()
    assert counts["conv3d"] > 0 and counts["gn_stats"] == counts["gn_apply"] > 0
    assert _rel(out, ref) <= 1e-4


# every flag combination of the fused conv: (prologue, silu, skip, stats)
FUSED_FLAGS = [(pro, silu, skip, stats)
               for pro, silu in ((False, True), (True, True), (True, False))
               for skip in (False, True) for stats in (False, True)]


def _fused_inputs(dev, seed, shape, cout, dtype, shift=0.3):
    g = torch.Generator(device=dev).manual_seed(seed)
    B, cin = shape[0], shape[-1]
    x = torch.randn(shape, generator=g, device=dev).to(dtype)
    w = torch.randn((cout, cin, 3, 3, 3), generator=g, device=dev) / (27 * cin) ** 0.5
    b = torch.randn((cout,), generator=g, device=dev)
    pg = 1 + 0.3 * torch.randn((B, cin), generator=g, device=dev)
    pb = shift + 0.3 * torch.randn((B, cin), generator=g, device=dev)
    skip = torch.randn(shape[:-1] + (cout,), generator=g, device=dev).to(dtype)
    return x, w, b, pg, pb, skip


def _check_fused_stats(st, ref_st, ref_out):
    """The first sum may cancel to near 0, so its error is held against the
    sum of |y|; the sum of squares against itself. Both differ from the
    plain sums by the summation order and by the tensor cores' f32
    accumulation (about 6e-8 x Cin relative, chip_smoke.py STATS_S2_TOL)."""
    abs_sum = ref_out.float().abs().sum(dim=(1, 2, 3))
    assert ((st[:, 0] - ref_st[:, 0]).abs() <= 1e-4 * abs_sum).all()
    assert ((st[:, 1] - ref_st[:, 1]).abs() <= 1e-4 * ref_st[:, 1]).all()


@pytest.mark.parametrize("shape,cout", [
    ((2, 5, 7, 9, 32), 16),      # ragged tiles, 2 batches, per-sample (g, b)
    ((1, 6, 12, 12, 256), 130),  # Cout past one 128-column tile, ragged
    ((1, 4, 8, 8, 2), 128),      # Cin = 2 (unaligned staging)
    ((1, 4, 8, 8, 40), 2),       # Cout = 2
    ((1, 8, 6, 6, 1024), 64),    # W = 6 plane, deep Cin
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_conv3d_fused_kernel_matches_plain(dev, shape, cout, dtype):
    """Every flag combination: output at the kernel tolerance, stats as in
    _check_fused_stats; one launch per call, on the route of
    conv3d_fused_route (bf16: csrc/conv3d_sm90.cu; bf16 with Cin % 8 != 0
    raises)."""
    x, w, b, pg, pb, skip = _fused_inputs(dev, 8, shape, cout, dtype)
    if dtype == torch.bfloat16 and shape[-1] % 8:
        with pytest.raises(ValueError, match="Cin % 8"):
            fo.conv3d_fused(x, w, b, prologue_g=pg, prologue_b=pb)
        return
    key = "conv3d_fused." + fo.conv3d_fused_route(shape, dtype)
    for pro, silu, use_skip, stats in FUSED_FLAGS:
        kw = dict(prologue_silu=silu, want_stats=stats,
                  skip=skip if use_skip else None)
        if pro:
            kw.update(prologue_g=pg, prologue_b=pb)
        before = ops.launch_counts()["conv3d_fused"]
        routed = ops.route_counts()[key]
        got = fo.conv3d_fused(x, w, b, **kw)
        assert ops.launch_counts()["conv3d_fused"] == before + 1
        assert ops.route_counts()[key] == routed + 1
        ref = fo.conv3d_fused_plain(x, w, b, **kw)
        torch.cuda.synchronize()
        out, ref_out = (got[0], ref[0]) if stats else (got, ref)
        assert out.dtype == dtype and out.shape == ref_out.shape
        assert _rel(out, ref_out) <= TOL[dtype], (pro, silu, use_skip, stats)
        if stats:
            assert got[1].shape == (shape[0], 2, cout)
            _check_fused_stats(got[1], ref[1], ref_out)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv3d_fused_masks_the_padding(dev, dtype):
    """A large prologue shift makes silu(0 * g + b) far from 0: the halo
    past every volume edge must stay 0 (conv after normalize), as in the
    plain version, which normalizes before padding; so must the channels
    past Cin of a ragged 64-channel chunk (Cin = 40)."""
    for seed, shape in ((9, (1, 3, 5, 6, 32)), (12, (2, 7, 5, 13, 40))):
        x, w, b, pg, pb, _ = _fused_inputs(dev, seed, shape, 32, dtype,
                                           shift=4.0)
        out = fo.conv3d_fused(x, w, b, prologue_g=pg, prologue_b=pb)
        ref = fo.conv3d_fused_plain(x, w, b, prologue_g=pg, prologue_b=pb)
        torch.cuda.synchronize()
        assert _rel(out, ref) <= TOL[dtype], shape


@pytest.mark.parametrize("shape,cout", [
    ((1, 96, 6, 6, 1024), 512),   # the model's deepest fused site
    ((1, 12, 24, 24, 256), 128),  # 256-row tiles, two chunks
    ((2, 9, 12, 12, 384), 130),   # three column tiles, ragged, batch 2
])
def test_conv3d_fused_sm90_at_model_widths(dev, shape, cout):
    """The sm90 fused instance at the model's widths (both tile sizes,
    several chunks and column tiles): output and stats as above, and the
    stats equal bit for bit between two runs."""
    x, w, b, pg, pb, skip = _fused_inputs(dev, 13, shape, cout,
                                          torch.bfloat16)
    kw = dict(prologue_g=pg, prologue_b=pb, skip=skip, want_stats=True)
    out, st = fo.conv3d_fused(x, w, b, **kw)
    again = fo.conv3d_fused(x, w, b, **kw)[1]
    ref, ref_st = fo.conv3d_fused_plain(x, w, b, **kw)
    torch.cuda.synchronize()
    assert _rel(out, ref) <= TOL[torch.bfloat16]
    _check_fused_stats(st, ref_st, ref)
    assert torch.equal(st, again)


def test_conv3d_fused_rejects_what_it_cannot_take(dev):
    """bf16 with Cin % 8 != 0 (no TMA row), a misaligned x, and an int
    dtype raise; nothing falls back."""
    w = torch.zeros((8, 12, 3, 3, 3), device=dev)
    with pytest.raises(ValueError, match="Cin % 8"):
        fo.conv3d_fused(torch.zeros((1, 2, 4, 4, 12), device=dev,
                                    dtype=torch.bfloat16), w)
    x = torch.zeros((1, 2, 4, 4, 72), device=dev, dtype=torch.bfloat16)
    xu = x.view(-1)[8:8 + 2 * 4 * 4 * 64].view(1, 2, 4, 4, 64)
    assert xu.is_contiguous() and xu.data_ptr() % 16 == 0
    w = torch.zeros((8, 64, 3, 3, 3), device=dev)
    fo.conv3d_fused(xu, w)  # aligned: runs
    xu = x.view(-1)[1:1 + 2 * 4 * 4 * 64].view(1, 2, 4, 4, 64)
    with pytest.raises(ValueError, match="16-byte"):
        fo.conv3d_fused(xu, w)
    with pytest.raises(TypeError):
        fo.conv3d_fused(torch.zeros((1, 2, 4, 4, 64), device=dev,
                                    dtype=torch.float16), w)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("N,C", [(96 * 12 * 12, 256), (96 * 6 * 6, 1024),
                                 (33, 64)])
def test_gn_stats_is_deterministic_and_batch_invariant(dev, dtype, N, C):
    """K1 in one launch: two runs agree bit for bit, volume 1 of a batch of
    2 equals it alone (the split plan depends on N only), and the sums
    match the plain version within 1e-5."""
    g = torch.Generator(device=dev).manual_seed(14)
    x = (torch.randn((2, N, C), generator=g, device=dev) * 2 + 0.5).to(dtype)
    before = ops.launch_counts()["gn_stats"]
    st = gn.channel_stats(x)
    assert ops.launch_counts()["gn_stats"] == before + 1
    assert torch.equal(st, gn.channel_stats(x))
    assert torch.equal(st[1:], gn.channel_stats(x[1:].contiguous()))
    assert _rel(st, gn.channel_stats_plain(x)) <= 1e-5


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_conv3d_fused_is_deterministic_and_batch_invariant(dev, dtype):
    """The stats are ordered by the volume's shape alone: two runs agree
    bit for bit, and volume 0 of a batch of 2 equals it alone."""
    x, w, b, pg, pb, skip = _fused_inputs(dev, 10, (2, 6, 40, 40, 128), 128,
                                          dtype)
    kw = dict(prologue_g=pg, prologue_b=pb, skip=skip, want_stats=True)
    out1, st1 = fo.conv3d_fused(x, w, b, **kw)
    out2, st2 = fo.conv3d_fused(x, w, b, **kw)
    one, st_one = fo.conv3d_fused(
        x[:1].contiguous(), w, b, prologue_g=pg[:1], prologue_b=pb[:1],
        skip=skip[:1].contiguous(), want_stats=True)
    torch.cuda.synchronize()
    assert torch.equal(out1, out2) and torch.equal(st1, st2)
    assert torch.equal(out1[:1], one) and torch.equal(st1[:1], st_one)


def test_fused_model_matches_unfused(dev):
    """A small model served fused on the card against the plain fused path
    on the CPU (f32, within 1e-4) and against the unfused card forward
    (f32 within 1e-4; bf16 within BF16_FUSED_MODEL_TOL); two convs per
    fusable ResBlock go through the fused kernel."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal((2, 4, 16, 16, 1), np.float32))
    t = torch.tensor([10, 900])
    for dtype in (torch.float32, torch.bfloat16):
        unfused = _tiny_model(dtype).eval()
        fused = SuperResModel(
            in_channels=1, model_channels=32, out_channels=2,
            num_res_blocks=1, channel_mult=(1, 2), use_scale_shift_norm=True,
            resblock_updown=True, middle_attention=False, dtype=dtype,
            fused=True).eval()
        fused.load_state_dict(unfused.state_dict(), strict=True)
        n_fused = sum(m.fusable() for m in fused.modules()
                      if hasattr(m, "fusable"))
        with torch.no_grad():
            cpu = fused(x, t, low_res=x)
            ref = unfused.to(dev)(x.to(dev), t.to(dev), low_res=x.to(dev))
            ops.reset_launch_counts()
            out = fused.to(dev)(x.to(dev), t.to(dev), low_res=x.to(dev))
        torch.cuda.synchronize()
        assert ops.launch_counts()["conv3d_fused"] == 2 * n_fused > 0
        if dtype == torch.float32:
            assert _rel(out.cpu(), cpu) <= 1e-4
        assert _rel(out, ref) <= (1e-4 if dtype == torch.float32
                                  else BF16_FUSED_MODEL_TOL)


# the int8 conv: (shape, N, taps, upsample); N = 4 * Cout on the phase route
S8_CASES = [
    ((2, 5, 7, 9, 32), 16, 27, False),      # ragged tiles, Cin 32, batch 2
    ((1, 4, 6, 6, 128), 128, 27, False),    # W = 6 planes
    ((2, 3, 12, 12, 256), 130, 27, False),  # W = 12, N past one tile, ragged
    ((1, 2, 8, 96, 128), 64, 27, False),    # W = 96
    ((2, 4, 12, 12, 256), 128, 1, False),   # the 1x1x1 skip
    ((1, 3, 6, 6, 128), 4 * 64, 27, True),  # stacked phases of an up site
    ((2, 3, 6, 12, 32), 4 * 24, 27, True),  # phases, batch 2, Cin 32
    ((1, 3, 5, 6, 48), 24, 27, False),      # Cin % 128 != 0: a ragged chunk
    ((1, 4, 16, 32, 256), 128, 1, False),   # a 1x1 site's 256-row tiles
    ((1, 3, 8, 8, 128), 4 * 128, 27, True),   # phase site, Cout 128: 12 taps
    ((1, 2, 6, 12, 384), 4 * 384, 27, True),  # phase site, Cout 384
]


def _s8_case(dev, g, shape, n, taps, up):
    """int8 x and weight of one case, and per-channel weight scales and a
    bias: the phase route's weight is zero outside each phase's 2x2 window
    (it is :func:`stacked_phase_weight`'s layout; the kernel's phase tiles
    run only those taps)."""
    from ddpm3d_tpu_torch.ops.phase_up import phase_window_mask

    cin = shape[-1]
    k = 3 if taps == 27 else 1
    xq = torch.randint(-127, 128, shape, generator=g, device=dev,
                       dtype=torch.int8)
    wq = torch.randint(-127, 128, (n, cin, k, k, k), generator=g, device=dev,
                       dtype=torch.int8)
    if up:
        wq = wq * phase_window_mask(n // 4).to(dev, torch.int8)
    s_w = 1e-4 + 1e-3 * torch.rand((n,), generator=g, device=dev)
    bias = torch.randn((n // 4 if up else n,), generator=g, device=dev)
    return xq, wq, s_w, bias


@pytest.mark.parametrize("shape,n,taps,up", S8_CASES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_conv3d_s8_kernel_matches_plain(dev, shape, n, taps, up, dtype):
    """K5 against its plain version, dynamic (per-sample scales) and static,
    with and without bias: equal bit for bit (exact int32 sums, the same
    f32 epilogue ops, no FMA contraction); one launch per call; the same
    bits on a repeat."""
    from ddpm3d_tpu_torch.ops import conv3d_s8 as s8

    g = torch.Generator(device=dev).manual_seed(12)
    B = shape[0]
    xq, wq, s_w, bias = _s8_case(dev, g, shape, n, taps, up)
    wp = s8.pack_weight_s8(wq)
    for static in (False, True):
        s_x = (torch.full((B,), 0.02, device=dev) if static else
               0.01 + 0.02 * torch.rand((B,), generator=g, device=dev))
        for b in (None, bias):
            before = ops.launch_counts()["conv3d_s8"]
            got = s8.conv3d_s8(xq, wq, s_x, s_w, b, dtype, up, w_packed=wp)
            assert ops.launch_counts()["conv3d_s8"] == before + 1
            ref = s8.conv3d_s8_plain(xq, wq, s_x, s_w, b, dtype, up)
            torch.cuda.synchronize()
            assert got.dtype == dtype and got.shape == ref.shape
            assert torch.equal(got, ref), (static, b is not None)
            again = s8.conv3d_s8(xq, wq, s_x, s_w, b, dtype, up, w_packed=wp)
            assert torch.equal(got, again)


@pytest.mark.parametrize("case", [S8_CASES[2], S8_CASES[4], S8_CASES[6]])
def test_conv3d_s8_is_batch_invariant(dev, case):
    """Each volume's K5 result is bit-identical alone or in a batch (its
    own scale, the same tiles and sums)."""
    from ddpm3d_tpu_torch.ops import conv3d_s8 as s8

    shape, n, taps, up = case
    g = torch.Generator(device=dev).manual_seed(14)
    xq, wq, s_w, bias = _s8_case(dev, g, shape, n, taps, up)
    s_x = 0.01 + 0.02 * torch.rand((shape[0],), generator=g, device=dev)
    both = s8.conv3d_s8(xq, wq, s_x, s_w, bias, torch.bfloat16, up)
    for i in range(shape[0]):
        one = s8.conv3d_s8(xq[i:i + 1].contiguous(), wq, s_x[i:i + 1], s_w,
                           bias, torch.bfloat16, up)
        assert torch.equal(both[i:i + 1], one)


def test_conv3d_s8_rejects_what_tma_cannot_stage(dev):
    """TMA needs 16-byte row strides and addresses: Cin % 16 != 0 and a
    misaligned view raise instead of running another kernel."""
    from ddpm3d_tpu_torch.ops import conv3d_s8 as s8

    g = torch.Generator(device=dev).manual_seed(15)
    xq, wq, s_w, _ = _s8_case(dev, g, (1, 3, 5, 6, 40), 24, 27, False)
    s_x = torch.full((1,), 0.02, device=dev)
    with pytest.raises(ValueError, match="multiple of 16"):
        s8.conv3d_s8(xq, wq, s_x, s_w)
    xq, wq, s_w, _ = _s8_case(dev, g, (1, 2, 4, 4, 32), 16, 27, False)
    flat = torch.zeros(xq.numel() + 1, device=dev, dtype=torch.int8)
    xv = flat[1:].view(xq.shape)
    xv.copy_(xq)
    with pytest.raises(ValueError, match="16-byte"):
        s8.conv3d_s8(xv, wq, s_x, s_w)


@pytest.mark.parametrize("shape,cout", [
    ((1, 96, 24, 24, 2), 128),  # the input conv at 96 x 24^2
    ((2, 5, 7, 9, 2), 32),      # ragged volume, batch 2, Cout < 128
    ((1, 4, 8, 8, 2), 130),     # Cout past one 128-column tile, ragged
])
def test_conv3d_narrow_matches_plain(dev, shape, cout):
    """The Cin = 2 input conv on csrc/conv3d_narrow.cu (counted on its own
    route) against the plain version within one bf16 rounding; the same
    bits on a repeat; per-volume results batch-invariant."""
    g = torch.Generator(device=dev).manual_seed(16)
    x = torch.randn(shape, generator=g, device=dev).bfloat16()
    w = torch.randn((cout, 2, 3, 3, 3), generator=g, device=dev) / 54 ** 0.5
    b = torch.randn((cout,), generator=g, device=dev)
    before = ops.route_counts()
    wp = cv.pack_weight_kernel(w, torch.bfloat16)
    out = cv.conv3d_kernel(x, wp, b)
    after = ops.route_counts()
    assert after["conv3d.sm90_narrow"] == before["conv3d.sm90_narrow"] + 1
    assert after["conv3d.ndhwc"] == before["conv3d.ndhwc"]
    ref = cv.conv3d_plain(x, w.bfloat16(), b)
    torch.cuda.synchronize()
    assert out.shape == ref.shape and out.dtype == torch.bfloat16
    assert _rel(out, ref) <= TOL[torch.bfloat16]
    assert torch.equal(out, cv.conv3d_kernel(x, wp, b))
    if shape[0] > 1:
        assert torch.equal(out[1:], cv.conv3d_kernel(x[1:].contiguous(), wp, b))


@pytest.mark.parametrize("shape,cout", [
    ((2, 5, 7, 9, 128), 1),      # ragged volume, 2 batches, each instance
    ((2, 5, 7, 9, 128), 2),
    ((2, 5, 7, 9, 128), 4),
    ((2, 5, 7, 9, 128), 8),
    ((1, 7, 35, 6, 40), 2),      # two H windows, W = 6, Cin not a chunk
    ((1, 3, 9, 40, 36), 3),      # three W windows, Cout padded to 4
    ((1, 96, 24, 24, 128), 2),   # the head at 96 x 24^2: many segments
])
def test_conv3d_head_matches_plain(dev, shape, cout):
    """The f32 head conv on csrc/conv3d_head.cu (counted on its own route)
    against the plain version within the f32 tolerance; the same bits on a
    repeat; per-volume results batch-invariant."""
    g = torch.Generator(device=dev).manual_seed(17)
    cin = shape[-1]
    x = torch.randn(shape, generator=g, device=dev)
    w = torch.randn((cout, cin, 3, 3, 3), generator=g, device=dev) / (27 * cin) ** 0.5
    b = torch.randn((cout,), generator=g, device=dev)
    assert cv.conv3d_route(shape, torch.float32, cout) == "f32_head"
    before = ops.route_counts()
    wp = cv.pack_weight_kernel(w, torch.float32)
    out = cv.conv3d_kernel(x, wp, b)
    after = ops.route_counts()
    assert after["conv3d.f32_head"] == before["conv3d.f32_head"] + 1
    assert after["conv3d.ndhwc"] == before["conv3d.ndhwc"]
    ref = cv.conv3d_plain(x, w, b)
    torch.cuda.synchronize()
    assert out.shape == ref.shape and out.dtype == torch.float32
    assert _rel(out, ref) <= TOL[torch.float32]
    assert torch.equal(out, cv.conv3d_kernel(x, wp, b))
    if shape[0] > 1:
        assert torch.equal(out[1:], cv.conv3d_kernel(x[1:].contiguous(), wp, b))


@pytest.mark.parametrize("shape,cout", [
    ((2, 5, 7, 9, 2), 128),      # the head's dx width, ragged, 2 batches
    ((1, 4, 8, 8, 2), 16),       # Cout < 4 x 16 columns
    ((1, 4, 8, 8, 2), 130),      # Cout past one 128-column tile, ragged
    ((1, 96, 12, 12, 2), 128),
])
def test_conv3d_f32_narrow_matches_plain(dev, shape, cout):
    """f32 convs with Cin = 2 (the head's dx, an f32 model's input conv) on
    csrc/conv3d_head.cu, counted on their own route, against the plain
    version; the same bits on a repeat; batch-invariant; and the dx of a
    128 -> 2 conv through conv3d_dx on the same route."""
    g = torch.Generator(device=dev).manual_seed(18)
    x = torch.randn(shape, generator=g, device=dev)
    w = torch.randn((cout, 2, 3, 3, 3), generator=g, device=dev) / 54 ** 0.5
    b = torch.randn((cout,), generator=g, device=dev)
    before = ops.route_counts()
    wp = cv.pack_weight_kernel(w, torch.float32)
    out = cv.conv3d_kernel(x, wp, b)
    dx = cv.conv3d_dx(x, w.transpose(0, 1).flip(2, 3, 4).contiguous())
    after = ops.route_counts()
    assert after["conv3d.f32_narrow"] == before["conv3d.f32_narrow"] + 1
    assert after["conv3d_dx.f32_narrow"] == before["conv3d_dx.f32_narrow"] + 1
    assert after["conv3d.ndhwc"] == before["conv3d.ndhwc"]
    ref = cv.conv3d_plain(x, w, b)
    torch.cuda.synchronize()
    assert out.shape == ref.shape and out.dtype == torch.float32
    assert _rel(out, ref) <= TOL[torch.float32]
    assert _rel(dx, ref - b) <= TOL[torch.float32]
    assert torch.equal(out, cv.conv3d_kernel(x, wp, b))
    if shape[0] > 1:
        assert torch.equal(out[1:], cv.conv3d_kernel(x[1:].contiguous(), wp, b))


def test_f32_head_kernels_reject_what_they_cannot_take(dev):
    """The head kernel stages 16-byte rows: a misaligned view raises; the
    f32 narrow kernel takes 8-byte voxels: a view one float in raises."""
    g = torch.Generator(device=dev).manual_seed(19)
    w = torch.randn((2, 8, 3, 3, 3), generator=g, device=dev)
    wp = cv.pack_weight_kernel(w, torch.float32)
    flat = torch.randn(2 * 3 * 4 * 8 + 1, generator=g, device=dev)
    with pytest.raises(ValueError, match="16-byte"):
        cv.conv3d_kernel(flat[1:].view(1, 2, 3, 4, 8), wp)
    w2 = torch.randn((16, 2, 3, 3, 3), generator=g, device=dev)
    with pytest.raises(ValueError, match="8-byte"):
        cv.conv3d_kernel(flat[1:1 + 48].view(1, 2, 3, 4, 2),
                         cv.pack_weight_kernel(w2, torch.float32))
    with pytest.raises(ValueError, match="does not fit"):
        cv.conv3d_kernel(flat[:2 * 3 * 4 * 8].view(1, 2, 3, 4, 8),
                         cv.pack_weight(w, torch.float32))


def test_step_noise_is_batch_invariant_on_the_card(dev):
    """On one device type the seeded chain's noise does not depend on the
    batch: ids [0, 1] draw what [0] and [1] draw alone. The CUDA draw
    differs from the CPU one (Philox against MT19937): the intended
    divergence of ROADMAP Queue 3."""
    from ddpm3d_tpu_torch.diffusion.sampling import step_noise

    both = step_noise(7, [0, 1], 5, (4, 8, 8, 1), dev)
    assert torch.equal(both[0:1], step_noise(7, [0], 5, (4, 8, 8, 1), dev))
    assert torch.equal(both[1:2], step_noise(7, [1], 5, (4, 8, 8, 1), dev))
    cpu = step_noise(7, [0, 1], 5, (4, 8, 8, 1), torch.device("cpu"))
    assert not torch.equal(both.cpu(), cpu)


def test_int8_model_matches_cpu(dev):
    """A small f32 model served in int8: every quantized site's card output
    equals the plain int8 conv on the CPU on the same input, one launch per
    site; the whole forward within the int8 network's discontinuity
    (chip_smoke.py INT8_MODEL_MEAN_TOL says why); bf16 finite."""
    from ddpm3d_tpu_torch.ops import quant

    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.standard_normal((2, 4, 16, 16, 1), np.float32))
    t = torch.tensor([10, 900])
    for dtype in (torch.float32, torch.bfloat16):
        model = SuperResModel(
            in_channels=1, model_channels=32, out_channels=2,
            num_res_blocks=1, channel_mult=(1, 2), use_scale_shift_norm=True,
            resblock_updown=True, middle_attention=False, dtype=dtype,
            int8=quant.Int8Config()).eval()
        init_params(model, seed=3, zero_heads=False)
        sites = [m for m in model.modules()
                 if getattr(m, "site", "") and m.int8_active()]
        io = []
        handles = [m.register_forward_hook(
            lambda mod, args, kwargs, out: io.append(
                (mod, args[0].cpu(), out.cpu(), kwargs.get("upsample"))),
            with_kwargs=True) for m in sites]
        with torch.no_grad():
            cpu = model(x, t, low_res=x)
            card_model = model.to(dev)
            ops.reset_launch_counts()
            out = card_model(x.to(dev), t.to(dev), low_res=x.to(dev)).cpu()
            torch.cuda.synchronize()
            assert ops.launch_counts()["conv3d_s8"] == len(sites)
            card_model.cpu()
            for mod, xin, yout, up in io[len(sites):]:  # the card's calls
                y = mod(xin, upsample=True) if up else mod(xin)
                assert torch.equal(y, yout), mod.site
        for h in handles:
            h.remove()
        assert bool(torch.isfinite(out).all())
        if dtype == torch.float32:
            mean_rel = ((out - cpu).abs().mean() / cpu.abs().mean()).item()
            assert mean_rel <= 5e-2


# f32 models through the kernels against the CPU's plain path (TF32 off):
# sums reordered (chip_smoke.py MODEL_TOL); the guidance gradient goes
# through a forward and a backward (chip_smoke.py GRAD_TOL)
MODEL_TOL, GRAD_TOL = 1e-4, 1e-3


@pytest.mark.parametrize("dims", [2, 3])
def test_attention_models_match_cpu(dev, dims):
    """A UNet with attention at every stage (2-D, both qkv orders over its
    blocks' calls) and the 3-D SuperResModel with middle attention, f32,
    card against CPU; the 3-D model's GroupNorms (the attention's among
    them) launch the GN kernels."""
    from ddpm3d_tpu_torch.models import UNetModel

    rng = np.random.default_rng(21)
    t = torch.tensor([10, 900])
    if dims == 2:
        model = UNetModel(
            in_channels=3, model_channels=32, out_channels=3,
            num_res_blocks=1, attention_resolutions=(1, 2),
            channel_mult=(1, 2), dims=2, num_heads=2,
            use_scale_shift_norm=True, use_new_attention_order=True).eval()
        x = torch.from_numpy(rng.standard_normal((2, 16, 16, 3), np.float32))
        kw = {}
    else:
        model = SuperResModel(
            in_channels=1, model_channels=32, out_channels=2,
            num_res_blocks=1, channel_mult=(1, 2), num_head_channels=16,
            use_scale_shift_norm=True, resblock_updown=True,
            middle_attention=True).eval()
        x = torch.from_numpy(rng.standard_normal((2, 4, 16, 16, 1),
                                                 np.float32))
        kw = {"low_res": x}
    init_params(model, seed=5, zero_heads=False)
    with torch.no_grad():
        ref = model(x, t, **kw)
        ops.reset_launch_counts()
        out = model.to(dev)(x.to(dev), t.to(dev),
                            **{k: v.to(dev) for k, v in kw.items()}).cpu()
    assert _rel(out, ref) <= MODEL_TOL
    if dims == 3:
        n_gn = sum(isinstance(m, type(model.out[0])) for m in model.modules())
        assert ops.launch_counts()["gn_stats"] == n_gn


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("new_order", [False, True])
def test_attention_block_matches_cpu(dev, dtype, new_order):
    """The attention block at the production middle's width (512 channels,
    8 heads) over 2 x 288 tokens, card against CPU: f32 logits and softmax
    on both, so bf16 differs by the products' roundings only."""
    from ddpm3d_tpu_torch.models import AttentionBlock

    block = AttentionBlock(512, 8, new_order)
    init_params(block, seed=6, zero_heads=False)
    g = torch.Generator().manual_seed(7)
    x = torch.randn((2, 8, 6, 6, 512), generator=g).to(dtype)
    with torch.no_grad():
        ref = block(x)
        out = block.to(dev)(x.to(dev)).cpu()
    assert out.dtype == dtype
    assert _rel(out, ref) <= TOL[dtype]


@pytest.mark.parametrize("dims", [2, 3])
def test_guidance_gradient_matches_cpu(dev, dims):
    """grad_x log p(y | x) through a frozen classifier (attention pool in
    2-D; adaptive pool in 3-D, whose backward runs the conv dx kernel),
    f32, card against CPU; no weight gradient is formed."""
    from ddpm3d_tpu_torch.models import EncoderUNetModel
    from ddpm3d_tpu_torch.scripts.classifier_sample import guidance

    shape = (2, 16, 16, 3) if dims == 2 else (2, 4, 16, 16, 3)
    clf = EncoderUNetModel(
        in_channels=3, model_channels=64, out_channels=10, num_res_blocks=1,
        attention_resolutions=(2,), channel_mult=(1, 2), dims=dims,
        num_head_channels=32, use_scale_shift_norm=True,
        resblock_updown=True,
        pool="attention" if dims == 2 else "adaptive",
        image_size=shape[1:-1]).eval()
    init_params(clf, seed=8, zero_heads=False)
    clf.requires_grad_(False)
    g = torch.Generator().manual_seed(9)
    x = torch.randn(shape, generator=g)
    t, y = torch.tensor([100, 700]), torch.tensor([3, 8])
    with torch.no_grad():
        ref = guidance(clf, y, 2.0)(x, t)
        clf.to(dev)
        ops.reset_launch_counts()
        out = guidance(clf, y.to(dev), 2.0)(x.to(dev), t.to(dev)).cpu()
    assert ref.abs().max() > 0
    assert _rel(out, ref) <= GRAD_TOL
    assert all(p.grad is None for p in clf.parameters())
    if dims == 3:
        assert ops.launch_counts()["conv3d_dx"] > 0


@pytest.mark.parametrize("batch", [1, 2])
def test_ndhwc_conv_takes_bf16_cin1(dev, batch):
    """The Seg encoder's input conv: bf16 with Cin = 1 (2-byte rows: the
    Cin = 1 instance of csrc/conv3d_narrow.cu, route sm90_cin1, a register
    of A pairing taps 2j and 2j + 1) against conv3d_plain at the full
    patch, batch 1 and 2; batch-invariant."""
    g = torch.Generator(device=dev).manual_seed(batch)
    x = torch.randn((batch, 96, 96, 96, 1), generator=g,
                    device=dev).bfloat16()
    w = torch.randn((128, 1, 3, 3, 3), generator=g, device=dev) / 27 ** 0.5
    b = torch.randn((128,), generator=g, device=dev) * 0.1
    assert cv.conv3d_route(x.shape, x.dtype, 128) == "sm90_cin1"
    wp = cv.pack_weight_kernel(w, x.dtype)
    assert wp.shape == (128, 32)
    ops.reset_launch_counts()
    out = cv.conv3d_kernel(x, wp, b)
    assert ops.route_counts()["conv3d.sm90_cin1"] == 1
    assert ops.route_counts()["conv3d.ndhwc"] == 0
    ref = cv.conv3d_plain(x, w.bfloat16(), b)
    assert _rel(out, ref) <= TOL[torch.bfloat16]
    assert torch.equal(out[-1:], cv.conv3d_kernel(x[-1:].contiguous(), wp, b))


@pytest.mark.parametrize("shape,cout", [
    ((2, 5, 7, 9, 1), 40),      # ragged volume, batch 2, Cout < 128
    ((1, 4, 8, 8, 1), 130),     # Cout past one 128-column tile, ragged
    ((1, 1, 1, 3, 1), 16),      # every tap but a few in the padding
])
def test_conv3d_cin1_matches_plain(dev, shape, cout):
    """The Cin = 1 instance at ragged shapes: one bf16 rounding of the
    plain version, the same bits on a repeat."""
    g = torch.Generator(device=dev).manual_seed(20)
    x = torch.randn(shape, generator=g, device=dev).bfloat16()
    w = torch.randn((cout, 1, 3, 3, 3), generator=g, device=dev) / 27 ** 0.5
    b = torch.randn((cout,), generator=g, device=dev)
    wp = cv.pack_weight_kernel(w, torch.bfloat16)
    out = cv.conv3d_kernel(x, wp, b)
    ref = cv.conv3d_plain(x, w.bfloat16(), b)
    torch.cuda.synchronize()
    assert _rel(out, ref) <= TOL[torch.bfloat16]
    assert torch.equal(out, cv.conv3d_kernel(x, wp, b))


@pytest.fixture(scope="module")
def f32_model_shapes():
    """The distinct convs of the full-width f32 model at [1, 8, 32, 32, 1]
    (chip_smoke.py's model phase): forward convs and dx (Cout -> Cin) on
    the f32 route, and the fused sites with their flags."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels have no CPU mode")
    from ddpm3d_tpu_torch.models.nn import Conv3x3x3

    shapes = {"conv": set(), "dx": set(), "fused": set()}

    def hook(mod, args, kwargs):
        _, D, H, W, cin = args[0].shape
        cout = mod.weight.shape[0]
        if kwargs.get("fused"):
            shapes["fused"].add((D, H, W, cin, cout,
                                 kwargs.get("prologue_g") is not None,
                                 bool(kwargs.get("prologue_silu", True)),
                                 kwargs.get("skip") is not None,
                                 bool(kwargs.get("want_stats", False))))
            return
        if cv.conv3d_route(args[0].shape, torch.float32, cout) == "f32":
            shapes["conv"].add((D, H, W, cin, cout))
        if cin != 2 and cv.conv3d_route((1, D, H, W, cout), torch.float32,
                                        cin) == "f32":
            shapes["dx"].add((D, H, W, cout, cin))

    x = torch.zeros((1, 8, 32, 32, 1), device="cuda")
    for fused in (False, True):
        model = _production_f32(fused).cuda()
        for m in model.modules():
            if isinstance(m, Conv3x3x3):
                m.register_forward_pre_hook(hook, with_kwargs=True)
        with torch.no_grad():
            model(x, torch.tensor([500], device="cuda"), low_res=x)
        del model
    torch.cuda.empty_cache()
    return {k: sorted(v) for k, v in shapes.items()}


def _production_f32(fused):
    """test_DDPM_3d_tpu.sh's model in f32 (weights random from a seed)."""
    from ddpm3d_tpu_torch.utils.config import sr_model_and_diffusion_defaults

    args = sr_model_and_diffusion_defaults()
    args.update(large_size=96, num_channels=128, num_res_blocks=2,
                learn_sigma=True, use_fp16=False, use_scale_shift_norm=True,
                resblock_updown=True, attention_resolutions="1000",
                num_head_channels=64, diffusion_steps=1000,
                noise_schedule="linear")
    model = factory.sr_create_model_and_diffusion(**args, fused=fused)[0]
    init_params(model, seed=0, zero_heads=False)
    return model.eval()


@pytest.mark.parametrize("batch", [1, 2])
def test_conv3d_f32_at_the_f32_model_shapes(dev, f32_model_shapes, batch):
    """csrc/conv3d_f32.cu at every distinct forward and dx shape of the f32
    model, batch 1 and 2, against the plain version (f32, 1e-5), counted on
    the f32 route; the dx through conv3d_dx with the flipped weight."""
    g = torch.Generator(device=dev).manual_seed(21 + batch)
    assert f32_model_shapes["conv"] and f32_model_shapes["dx"]
    for what, cases in (("conv3d", f32_model_shapes["conv"]),
                        ("conv3d_dx", f32_model_shapes["dx"])):
        for D, H, W, cin, cout in cases:
            x = torch.randn((batch, D, H, W, cin), generator=g, device=dev)
            before = ops.route_counts()[f"{what}.f32"]
            if what == "conv3d":
                w = torch.randn((cout, cin, 3, 3, 3), generator=g,
                                device=dev) / (27 * cin) ** 0.5
                b = torch.randn((cout,), generator=g, device=dev)
                out = cv.conv3d_kernel(x, cv.pack_weight_kernel(
                    w, torch.float32), b)
                ref = cv.conv3d_plain(x, w, b)
            else:  # x is dy (the forward's Cout = cin here)
                w = torch.randn((cin, cout, 3, 3, 3), generator=g,
                                device=dev) / (27 * cout) ** 0.5
                out = cv.conv3d_dx(x, w)
                ref = cv.conv3d_dx_plain(x, w)
            assert ops.route_counts()[f"{what}.f32"] == before + 1
            torch.cuda.synchronize()
            assert out.shape == ref.shape
            assert _rel(out, ref) <= TOL[torch.float32], (what, D, H, W,
                                                          cin, cout)


def test_conv3d_fused_f32_at_the_f32_model_sites(dev, f32_model_shapes):
    """The f32 fused instance at every distinct fused site of the f32
    model with the site's flags: output (1e-5), stats as the next GroupNorm
    folds them (1e-4), bit for bit twice and alone against in a batch of 2
    (the second volume other data)."""
    assert f32_model_shapes["fused"]
    for i, (D, H, W, cin, cout, pro, silu, use_skip, stats) in enumerate(
            f32_model_shapes["fused"]):
        x, w, b, pg, pb, skip = _fused_inputs(dev, 30 + i, (2, D, H, W, cin),
                                              cout, torch.float32)
        kw2 = dict(prologue_silu=silu, want_stats=stats,
                   skip=skip if use_skip else None)
        if pro:
            kw2.update(prologue_g=pg, prologue_b=pb)
        kw1 = {k: (v[:1].contiguous() if torch.is_tensor(v) else v)
               for k, v in kw2.items()}
        x1 = x[:1].contiguous()
        before = ops.route_counts()["conv3d_fused.f32"]
        got = fo.conv3d_fused(x1, w, b, **kw1)
        again = fo.conv3d_fused(x1, w, b, **kw1)
        both = fo.conv3d_fused(x, w, b, **kw2)
        assert ops.route_counts()["conv3d_fused.f32"] == before + 3
        ref = fo.conv3d_fused_plain(x1, w, b, **kw1)
        torch.cuda.synchronize()
        if not stats:
            got, again, both, ref = ((t,) for t in (got, again, both, ref))
        assert _rel(got[0], ref[0]) <= TOL[torch.float32]
        for a, c, z in zip(got, again, both):
            assert torch.equal(a, c) and torch.equal(a, z[:1])
        if stats:
            _check_fused_stats(got[1], ref[1], ref[0])
            ones = torch.ones(cout, device=dev)
            zeros = torch.zeros(cout, device=dev)
            N = D * H * W
            fold = gn.fold_gn_affine(got[1], N, ones, zeros)
            fold_ref = gn.fold_gn_affine(ref[1], N, ones, zeros)
            for k_, r_ in zip(fold, fold_ref):
                assert _rel(k_, r_) <= 1e-4


def test_seg_forward_launches_by_route(dev):
    """One bf16 forward of each production-depth Seg model (tests/
    test_torch_port_seg_train.py:SEG_LAUNCHES, counted there on the plain
    path) launches its kernels on the routes the CPU count says, and its
    f32 forward on the card matches the CPU's."""
    from ddpm3d_tpu_torch.models import SegUNetModel

    want = {"conv3d": 101, "gn_stats": 99, "gn_apply": 99, "conv3d_s8": 0}
    routes = {"conv3d.sm90": 98, "conv3d.sm90_narrow": 1,
              "conv3d.sm90_cin1": 1, "conv3d.f32_head": 1}
    x = torch.randn((1, 4, 32, 32, 1), generator=torch.Generator()
                    .manual_seed(0))
    t = torch.tensor([300])
    for fusion in ("add", "cat_conv", "midcat"):
        kw = dict(in_channels=1, cond_channels=1, model_channels=32,
                  out_channels=2, num_res_blocks=2,
                  channel_mult=(1, 1, 2, 3, 4), use_scale_shift_norm=True,
                  resblock_updown=True, fusion=fusion)
        model = SegUNetModel(dtype=torch.bfloat16, **kw).to(dev).eval()
        init_params(model, seed=1, zero_heads=False)
        ops.reset_launch_counts()
        with torch.no_grad():
            model(x.to(dev), t.to(dev), low_res=x.to(dev))
        counts = ops.launch_counts()
        assert {k: counts[k] for k in want} == want, fusion
        assert {k: v for k, v in ops.route_counts().items() if v} == routes
        cpu = SegUNetModel(**kw).eval()
        init_params(cpu, seed=1, zero_heads=False)
        card = SegUNetModel(**kw).eval()
        card.load_state_dict(cpu.state_dict())
        card.to(dev)
        with torch.no_grad():
            ref = cpu(x, t, low_res=x)
            out = card(x.to(dev), t.to(dev), low_res=x.to(dev)).cpu()
        assert _rel(out, ref) <= 1e-4, fusion
