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
from ddpm3d_tpu_torch.models.nn import init_params
from ddpm3d_tpu_torch.ops import conv3d as cv
from ddpm3d_tpu_torch.ops import groupnorm as gn

pytestmark = pytest.mark.cuda

# bf16 outputs may differ by one bf16 rounding where f32 sums differ in order
TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-5}


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
    out = cv.conv3d(x, w, b)
    assert ops.launch_counts()["conv3d"] == before + 1
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
    both = cv.conv3d_kernel(x, w)
    assert torch.equal(both[1:], cv.conv3d_kernel(x[1:].contiguous(), w))
    x3 = x.reshape(2, -1, 128)
    assert torch.equal(gn.channel_stats(x3)[1:],
                       gn.channel_stats(x3[1:].contiguous()))


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
