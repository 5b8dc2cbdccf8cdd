"""Stride-1 SAME 3x3x3 convolution on channels-last volumes.

Counterpart of ``ddpm3d_tpu/ops/conv3d_mxu.py:conv3d_mxu`` (the Pallas TPU
kernel ``_conv_kernel``). The Hopper kernel is ``csrc/conv3d.cu``: an
implicit GEMM that stages a haloed input tile in shared memory once per Cin
chunk and runs all 27 taps out of it on bf16 tensor cores (``mma.sync``), or
on CUDA cores for f32. It is bound by operations at every shape of the
model; its source note says what the design does about that.

:func:`conv3d` dispatches on the tensor's device: a CPU tensor takes
:func:`conv3d_plain` (the same arithmetic as 27 shifted-slice matmuls with
f32 accumulation); a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build

# kernel launches on the main path (see ops.launch_counts)
launches = 0

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


def conv3d_plain(
    x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Plain PyTorch version: x [B, D, H, W, Cin], weight (Cout, Cin, 3, 3,
    3), bias [Cout]; zero padding, f32 accumulation over the 27 taps, bias
    in f32, result in x's dtype."""
    B, D, H, W, _ = x.shape
    w = weight.float().permute(2, 3, 4, 1, 0)  # kd, kh, kw, Cin, Cout
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1, 1, 1))
    acc = None
    for kd in range(3):
        for kh in range(3):
            for kw in range(3):
                term = xp[:, kd:kd + D, kh:kh + H, kw:kw + W, :] @ w[kd, kh, kw]
                acc = term if acc is None else acc + term
    if bias is not None:
        acc = acc + bias.float()
    return acc.to(x.dtype)


def conv3d_kernel(
    x: torch.Tensor,
    w_packed: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Launch ``csrc/conv3d.cu`` on CUDA tensors. ``w_packed`` comes from
    :func:`pack_weight` in x's dtype; bias is cast to f32."""
    global launches
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"conv3d kernel takes bf16 or f32, got {x.dtype}")
    if x.dim() != 5:
        raise ValueError(f"expected [B, D, H, W, C], got {tuple(x.shape)}")
    B, D, H, W, cin = x.shape
    if w_packed.shape[0] != 27 or w_packed.shape[2] != cin:
        raise ValueError(
            f"packed weight {tuple(w_packed.shape)} does not fit Cin={cin}")
    if w_packed.dtype != x.dtype or w_packed.device != x.device:
        raise ValueError("packed weight must match x's dtype and device")
    cout = w_packed.shape[1]
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
    launches += 1
    return y


def conv3d(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    w_packed: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Stride-1 SAME 3x3x3 conv of channels-last ``x`` [B, D, H, W, Cin] with
    a torch-layout ``weight`` (Cout, Cin, 3, 3, 3). The weight is used in x's
    dtype; ``w_packed`` may carry the kernel's layout prepared ahead
    (:func:`pack_weight`)."""
    if tuple(weight.shape[2:]) != (3, 3, 3):
        raise ValueError(f"3x3x3 kernels only, got {tuple(weight.shape)}")
    if x.device.type == "cpu":
        return conv3d_plain(x, weight.to(x.dtype), bias)
    if x.device.type != "cuda":
        raise RuntimeError(f"conv3d: unsupported device {x.device}")
    if w_packed is None:
        w_packed = pack_weight(weight, x.dtype)
    return conv3d_kernel(x, w_packed, bias)
