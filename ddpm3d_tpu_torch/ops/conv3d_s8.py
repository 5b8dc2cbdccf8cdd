"""int8 (W8A8) convolution: s8 x s8 -> s32 and the dequantize epilogue.

Counterpart of ``ddpm3d_tpu/ops/conv3d_s8.py:conv3d_s8`` (the Pallas TPU
kernel ``_conv_kernel`` / ``_conv_kernel_im2col``) and of the integer conv
inside ``ops/quant.py:conv3d_folded_int8``:

  acc = sum over taps of xq @ wq            int32, exact
  y   = float(acc) * (s_x[b] * s_w[n]) + bias[n]   f32, rounded once

for a stride-1 SAME 3x3x3 or a 1x1x1 kernel on channels-last int8 volumes.
``s_x`` is one scale per sample ([B]: dynamic per sample, or a static
scale repeated), ``s_w`` one per output channel. With ``upsample=True`` the
weight holds the four phase kernels of ``conv(nearest_up2_HW(x))`` stacked
along Cout (:func:`..phase_up.stacked_phase_weight`): the result is the
upsampled [B, D, 2H, 2W, Cout] output, and the bias is added after the
rounding to the output dtype, as the JAX package's up sites add it.

The Hopper kernel is ``csrc/conv3d_s8.cu`` (int8 ``mma.sync`` tensor cores;
its source note says what bounds it and what the design does about that).
A CPU tensor takes :func:`conv3d_s8_plain` (the integer sums in float64,
exact since every partial sum is an integer below 2^53, then the same f32
epilogue ops), which the kernel equals bit for bit; a CUDA tensor launches
the kernel or raises.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import _build
from .conv3d import pick_tile

# kernel launches on the main path (see ops.launch_counts)
launches = 0


def pack_weight_s8(wq: torch.Tensor) -> torch.Tensor:
    """(N, Cin, k, k, k) int8 -> the kernel's [k^3, N, Cin] layout."""
    n, cin, *ks = wq.shape
    taps = ks[0] * ks[1] * ks[2]
    return wq.permute(2, 3, 4, 0, 1).reshape(taps, n, cin).contiguous()


def interleave_phases(y: torch.Tensor) -> torch.Tensor:
    """[B, D, H, W, 4 * C] stacked phases (p = 2a + b) -> the upsampled
    [B, D, 2H, 2W, C] with ``out[2i + a, 2j + b] = y_ab[i, j]``."""
    B, D, H, W, n = y.shape
    c = n // 4
    y = y.reshape(B, D, H, W, 2, 2, c).permute(0, 1, 2, 4, 3, 5, 6)
    return y.reshape(B, D, 2 * H, 2 * W, c).contiguous()


def _check(xq, wq, s_x, s_w, bias, out_dtype, upsample):
    """Shapes and types both versions take; returns (Cout, taps)."""
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError(f"int8 operands expected, got {xq.dtype}, {wq.dtype}")
    if xq.dim() != 5:
        raise ValueError(f"expected [B, D, H, W, C], got {tuple(xq.shape)}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"output dtype bf16 or f32, got {out_dtype}")
    n = wq.shape[-2] if wq.dim() == 3 else wq.shape[0]
    taps = wq.shape[0] if wq.dim() == 3 else wq[0, 0].numel()
    cin = wq.shape[-1] if wq.dim() == 3 else wq.shape[1]
    if cin != xq.shape[-1] or taps not in (27, 1):
        raise ValueError(f"weight {tuple(wq.shape)} does not fit x "
                         f"{tuple(xq.shape)} (3x3x3 or 1x1x1 kernels)")
    if upsample and (taps != 27 or n % 4):
        raise ValueError("the phase route takes 4 * Cout stacked 3x3x3 kernels")
    if tuple(s_x.shape) != (xq.shape[0],) or tuple(s_w.shape) != (n,):
        raise ValueError(f"scales must be [B] and [N], got "
                         f"{tuple(s_x.shape)}, {tuple(s_w.shape)}")
    cout = n // 4 if upsample else n
    if bias is not None and tuple(bias.shape) != (cout,):
        raise ValueError(f"bias must be [{cout}], got {tuple(bias.shape)}")
    return cout, taps


def _int_sums(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """acc [B, D, H, W, N] (float64, exact) of the SAME conv of int8 ``xq``
    with int8 ``wq`` (N, Cin, k, k, k): one float64 matmul per tap, which
    runs on either device (no float64 convolution needed)."""
    B, D, H, W, cin = xq.shape
    k = wq.shape[-1]
    p = k // 2
    xp = F.pad(xq.double(), (0, 0, p, p, p, p, p, p))
    w = wq.double()
    acc = None
    for kd in range(k):
        for kh in range(k):
            for kw in range(k):
                xs = xp[:, kd:kd + D, kh:kh + H, kw:kw + W].reshape(-1, cin)
                term = xs @ w[:, :, kd, kh, kw].t()
                acc = term if acc is None else acc.add_(term)
    return acc.reshape(B, D, H, W, -1)


def conv3d_s8_plain(
    xq: torch.Tensor,
    wq: torch.Tensor,
    s_x: torch.Tensor,
    s_w: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    out_dtype: torch.dtype = torch.bfloat16,
    upsample: bool = False,
) -> torch.Tensor:
    """Plain PyTorch version. ``xq`` [B, D, H, W, Cin] int8, ``wq`` (N, Cin,
    k, k, k) int8 (k = 3 or 1), ``s_x`` [B] and ``s_w`` [N] f32. The integer
    sums exactly in float64, then ``acc -> f32``, ``* (s_x * s_w)``, ``+
    bias`` in f32 and one rounding to ``out_dtype``; with ``upsample`` the
    phases interleave and the bias is added in ``out_dtype`` after it."""
    _check(xq, wq, s_x, s_w, bias, out_dtype, upsample)
    acc = _int_sums(xq, wq)
    scale = s_x.float()[:, None, None, None, None] * s_w.float()
    y = acc.float() * scale
    if not upsample:
        if bias is not None:
            y = y + bias.float()
        return y.to(out_dtype).contiguous()
    y = interleave_phases(y.to(out_dtype))
    return y if bias is None else y + bias.to(out_dtype)


def _ready(t: torch.Tensor, dev, dtype=torch.float32) -> torch.Tensor:
    """``t`` as the kernel takes it (on ``dev``, ``dtype``, contiguous),
    without a torch call where it already is: each costs host time."""
    if t.device != dev or t.dtype != dtype or not t.is_contiguous():
        t = t.detach().to(device=dev, dtype=dtype).contiguous()
    return t


def conv3d_s8_kernel(
    xq: torch.Tensor,
    w_packed: torch.Tensor,
    s_x: torch.Tensor,
    s_w: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    out_dtype: torch.dtype = torch.bfloat16,
    upsample: bool = False,
) -> torch.Tensor:
    """Launch ``csrc/conv3d_s8.cu`` on CUDA tensors. ``w_packed`` comes from
    :func:`pack_weight_s8`."""
    global launches
    if xq.device.type != "cuda":
        raise RuntimeError(f"conv3d_s8 kernel takes CUDA tensors, got {xq.device}")
    if w_packed.device != xq.device or w_packed.dim() != 3:
        raise ValueError("packed [taps, N, Cin] weight on x's device expected")
    cout, taps = _check(xq, w_packed, s_x, s_w, bias, out_dtype, upsample)
    B, D, H, W, cin = xq.shape
    dev = xq.device
    xq, w_packed = _ready(xq, dev, torch.int8), _ready(w_packed, dev, torch.int8)
    sx, sw = _ready(s_x, dev), _ready(s_w, dev)
    b = None
    if bias is not None:  # the phase route adds the bias rounded to out_dtype
        b = _ready(bias.detach().to(out_dtype) if upsample else bias, dev)
    shape = (B, D, 2 * H, 2 * W, cout) if upsample else (B, D, H, W, cout)
    y = torch.empty(shape, dtype=out_dtype, device=dev)
    td, th, tw = pick_tile(D, H, W)
    err = _build.fn("conv3d_s8_launch")(
        xq.data_ptr(), w_packed.data_ptr(), sx.data_ptr(), sw.data_ptr(),
        None if b is None else b.data_ptr(), y.data_ptr(),
        B, D, H, W, cin, w_packed.shape[1], taps, int(upsample), td, th, tw,
        1 if out_dtype == torch.bfloat16 else 0,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "conv3d_s8_launch")
    launches += 1
    return y


def conv3d_s8(
    xq: torch.Tensor,
    wq: torch.Tensor,
    s_x: torch.Tensor,
    s_w: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    out_dtype: torch.dtype = torch.bfloat16,
    upsample: bool = False,
    w_packed: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The int8 conv of ``xq`` with the torch-layout ``wq`` (N, Cin, k, k, k);
    ``w_packed`` may carry the kernel's layout prepared ahead. CPU tensors
    take the plain version, CUDA tensors the kernel."""
    if xq.device.type == "cpu":
        return conv3d_s8_plain(xq, wq, s_x, s_w, bias, out_dtype, upsample)
    if xq.device.type != "cuda":
        raise RuntimeError(f"conv3d_s8: unsupported device {xq.device}")
    if w_packed is None:
        w_packed = pack_weight_s8(wq)
    return conv3d_s8_kernel(xq, w_packed, s_x, s_w, bias, out_dtype, upsample)
