"""Stride-1 SAME 3x3x3 convolution on channels-last volumes.

Counterpart of ``ddpm3d_tpu/ops/conv3d_mxu.py:conv3d_mxu`` (the Pallas TPU
kernel ``_conv_kernel``). The Hopper kernel is ``csrc/conv3d.cu``: an
implicit GEMM that stages a haloed input tile in shared memory once per Cin
chunk and runs all 27 taps out of it on bf16 tensor cores (``mma.sync``), or
on CUDA cores for f32. It is bound by operations at every shape of the
model; its source note says what the design does about that.

:func:`conv3d` is differentiable (:class:`Conv3dFunction`, the counterpart of
the custom VJP ``_conv3d_mxu_fwd``/``_conv3d_mxu_bwd``):
  * dx is the SAME kernel run on dy with the spatially flipped, in/out-swapped
    weight (:func:`pack_weight_dx`), exact for SAME padding at stride 1;
  * dw is the filter-gradient conv, which the JAX package leaves to XLA: on
    the card PyTorch's library call (:func:`conv3d_dw_library`), on the CPU
    the same call in f32 (:func:`conv3d_dw_plain`). It is not the port of a
    TPU kernel;
  * db is the f32 sum of dy over batch and space.

Every public function dispatches on the tensor's device: a CPU tensor takes
the plain version (:func:`conv3d_plain`: PyTorch's convolution in f32 with
TF32 off, rounded once to x's dtype, the kernel's arithmetic); a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build

# kernel launches on the main path (see ops.launch_counts): forward convs
# and the dx convs of the backward
launches = 0
dx_launches = 0

MAX_ROWS = 128   # output voxels per block (csrc/conv3d.cu kMaxRows)
MAX_HALO = 640   # staged halo voxels per block (kMaxHalo)


def pack_weight(weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(Cout, Cin, 3, 3, 3) -> the kernel's [27, Cout, Cin] layout, in
    ``dtype`` (tap-major, Cin contiguous)."""
    cout, cin = weight.shape[:2]
    return (
        weight.detach().to(dtype).permute(2, 3, 4, 0, 1)
        .reshape(27, cout, cin).contiguous()
    )


def flip_weight(weight: torch.Tensor) -> torch.Tensor:
    """The dx conv's weight: ``wt[ci, co, a, b, c] = w[co, ci, 2-a, 2-b,
    2-c]`` (``conv3d_mxu.py:_conv3d_mxu_bwd``)."""
    return weight.flip(2, 3, 4).transpose(0, 1)


def pack_weight_dx(weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(Cout, Cin, 3, 3, 3) -> the kernel's [27, Cin, Cout] layout of the
    flipped, in/out-swapped weight: the dx conv maps Cout -> Cin."""
    return pack_weight(flip_weight(weight), dtype)


@functools.lru_cache(maxsize=64)
def pick_tile(D: int, H: int, W: int) -> Tuple[int, int, int]:
    """Output tile (TD, TH, TW) of at most MAX_ROWS voxels for a DxHxW
    volume: fewest tiles first (every tile costs a full block of math),
    then the smallest halo (input bytes staged per tile)."""
    best = None
    for tw in range(1, min(W, MAX_ROWS) + 1):
        for th in range(1, min(H, MAX_ROWS // tw) + 1):
            td = min(D, MAX_ROWS // (tw * th))
            halo = (td + 2) * (th + 2) * (tw + 2)
            if halo > MAX_HALO:
                continue
            tiles = -(-D // td) * -(-H // th) * -(-W // tw)
            key = (tiles, halo, -tw)
            if best is None or key < best[0]:
                best = (key, (td, th, tw))
    return best[1]


@contextlib.contextmanager
def _full_f32():
    """cuDNN without TF32 (a no-op on the CPU), so f32 convs stay f32."""
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


def _ncdhw(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 4, 1, 2, 3)


def conv3d_plain(
    x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Plain PyTorch version: x [B, D, H, W, Cin], weight (Cout, Cin, 3, 3,
    3), bias [Cout]; zero padding, products and sums in f32, bias in f32,
    result rounded once to x's dtype (channels-last, contiguous)."""
    with _full_f32():
        y = F.conv3d(_ncdhw(x.float()), weight.float(),
                     None if bias is None else bias.float(), padding=1)
    return y.permute(0, 2, 3, 4, 1).to(x.dtype).contiguous()


def check_kernel_inputs(x: torch.Tensor, w_packed: torch.Tensor,
                        what: str) -> int:
    """Raise unless the conv kernels take ``x`` [B, D, H, W, Cin] (a CUDA
    tensor, bf16 or f32) with ``w_packed``; returns Cout."""
    if x.device.type != "cuda":
        raise RuntimeError(f"{what} kernel takes CUDA tensors, got {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{what} kernel takes bf16 or f32, got {x.dtype}")
    if x.dim() != 5:
        raise ValueError(f"expected [B, D, H, W, C], got {tuple(x.shape)}")
    cin = x.shape[-1]
    if w_packed.shape[0] != 27 or w_packed.shape[2] != cin:
        raise ValueError(
            f"packed weight {tuple(w_packed.shape)} does not fit Cin={cin}")
    if w_packed.dtype != x.dtype or w_packed.device != x.device:
        raise ValueError("packed weight must match x's dtype and device")
    return w_packed.shape[1]


def _launch(
    x: torch.Tensor,
    w_packed: torch.Tensor,
    bias: Optional[torch.Tensor],
) -> torch.Tensor:
    """Run ``csrc/conv3d.cu`` once on CUDA tensors (callers count it)."""
    cout = check_kernel_inputs(x, w_packed, "conv3d")
    B, D, H, W, cin = x.shape
    x = x.contiguous()
    w_packed = w_packed.contiguous()
    b = None
    if bias is not None:
        b = bias.detach().to(device=x.device, dtype=torch.float32).contiguous()
    y = torch.empty((B, D, H, W, cout), dtype=x.dtype, device=x.device)
    td, th, tw = pick_tile(D, H, W)
    err = _build.fn("conv3d_ndhwc_launch")(
        x.data_ptr(), w_packed.data_ptr(), b.data_ptr() if b is not None else None,
        y.data_ptr(), B, D, H, W, cin, cout, td, th, tw,
        1 if x.dtype == torch.bfloat16 else 0,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "conv3d_ndhwc_launch")
    return y


def conv3d_kernel(
    x: torch.Tensor,
    w_packed: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Launch ``csrc/conv3d.cu`` on CUDA tensors. ``w_packed`` comes from
    :func:`pack_weight` in x's dtype; bias is cast to f32."""
    global launches
    y = _launch(x, w_packed, bias)
    launches += 1
    return y


def conv3d_dx_kernel(dy: torch.Tensor, w_packed_dx: torch.Tensor) -> torch.Tensor:
    """dx of the conv: ``csrc/conv3d.cu`` on dy [B, D, H, W, Cout] with
    :func:`pack_weight_dx` in dy's dtype (no bias); the result has Cin
    channels."""
    global dx_launches
    dx = _launch(dy, w_packed_dx, None)
    dx_launches += 1
    return dx


def conv3d_dx_plain(dy: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Plain version of the dx conv: :func:`conv3d_plain` of dy with the
    flipped, in/out-swapped weight in dy's dtype."""
    return conv3d_plain(dy, flip_weight(weight).to(dy.dtype))


def conv3d_dx(dy: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """dx of :func:`conv3d` for a torch-layout ``weight`` (Cout, Cin, 3, 3,
    3), computed in dy's dtype."""
    if dy.device.type == "cpu":
        return conv3d_dx_plain(dy, weight)
    if dy.device.type != "cuda":
        raise RuntimeError(f"conv3d_dx: unsupported device {dy.device}")
    return conv3d_dx_kernel(dy, pack_weight_dx(weight, dy.dtype))


def _filter_grad(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """PyTorch's filter-gradient conv on NCDHW views of the channels-last
    tensors (both in one dtype), TF32 off."""
    cin, cout = x.shape[-1], dy.shape[-1]
    w_shape = torch.empty((cout, cin, 3, 3, 3), dtype=x.dtype, device=x.device)
    with _full_f32():
        _, dw, _ = torch.ops.aten.convolution_backward(
            _ncdhw(dy), _ncdhw(x), w_shape, None, [1, 1, 1], [1, 1, 1],
            [1, 1, 1], False, [0, 0, 0], 1, [False, True, False],
        )
    return dw


def conv3d_dw_plain(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Plain filter gradient ``dw[co, ci, kd, kh, kw] = sum over (b, d, h,
    w) of x_pad[b, d+kd, h+kh, w+kw, ci] * dy[b, d, h, w, co]``, computed in
    f32 and rounded once to x's dtype."""
    return _filter_grad(x.float(), dy.float()).to(x.dtype)


def conv3d_dw_library(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """The filter gradient in x's dtype by PyTorch's filter-gradient conv
    (the JAX package's "XLA filter-gradient conv",
    ``conv3d_mxu.py:_conv3d_mxu_bwd``): what the card runs for dw."""
    return _filter_grad(x, dy.to(x.dtype))


def conv3d_dw(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Filter gradient (Cout, Cin, 3, 3, 3) in x's dtype."""
    if x.device.type == "cpu":
        return conv3d_dw_plain(x, dy)
    if x.device.type != "cuda":
        raise RuntimeError(f"conv3d_dw: unsupported device {x.device}")
    return conv3d_dw_library(x, dy)


class Conv3dFunction(torch.autograd.Function):
    """Differentiable stride-1 SAME 3x3x3 conv over the kernel. The weight
    is the f32 parameter; forward and dx run in x's dtype; dw comes back in
    x's dtype cast to the parameter's dtype, db in f32 (as
    ``_conv3d_mxu_bwd``)."""

    @staticmethod
    def forward(ctx, x, weight, bias, w_packed):
        ctx.save_for_backward(x, weight)
        ctx.has_bias = bias is not None
        if x.device.type == "cpu":
            return conv3d_plain(x, weight.to(x.dtype), bias)
        if x.device.type != "cuda":
            raise RuntimeError(f"conv3d: unsupported device {x.device}")
        if w_packed is None:
            w_packed = pack_weight(weight, x.dtype)
        return conv3d_kernel(x, w_packed, bias)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        dy = dy.to(x.dtype)
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = conv3d_dx(dy, weight)
        if ctx.needs_input_grad[1]:
            dw = conv3d_dw(x, dy).to(weight.dtype)
        if ctx.has_bias and ctx.needs_input_grad[2]:
            db = dy.float().sum(dim=(0, 1, 2, 3))
        return dx, dw, db, None


def conv3d(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    w_packed: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Stride-1 SAME 3x3x3 conv of channels-last ``x`` [B, D, H, W, Cin] with
    a torch-layout ``weight`` (Cout, Cin, 3, 3, 3). The weight is used in x's
    dtype; ``w_packed`` may carry the kernel's layout prepared ahead
    (:func:`pack_weight`). Differentiable in x, weight and bias."""
    if tuple(weight.shape[2:]) != (3, 3, 3):
        raise ValueError(f"3x3x3 kernels only, got {tuple(weight.shape)}")
    return Conv3dFunction.apply(x, weight, bias, w_packed)
