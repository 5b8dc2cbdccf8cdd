"""Fused ResBlock convolution: GroupNorm/FiLM/SiLU prologue, stride-1 SAME
3x3x3 conv, bias/skip epilogue and the per-channel sums of its output.

Counterpart of ``ddpm3d_tpu/ops/conv3d_fused.py:conv3d_fused`` (the Pallas
TPU kernel ``_fused_kernel``):

  prologue  xn = silu?(x * g[b, ci] + b[b, ci])   f32, halo stays 0, x's dtype
  conv      acc = sum over 27 taps of xn @ W       f32 accumulation
  epilogue  y = acc + bias (+ skip)                 f32, stored in x's dtype
  stats     (sum y, sum y^2) per (batch, channel)   of the f32 y, [B, 2, Cout]

(g, b) is the folded GroupNorm(+FiLM) affine (:func:`.groupnorm.
fold_gn_affine`); the stats fold the NEXT GroupNorm the same way, so a chain
of fused ResBlocks never re-reads an activation to normalize it.

The Hopper kernel is the fused instance of ``csrc/conv3d.cu``'s conv
template (``conv3d_fused_launch``); its source note says what bounds it and
what the design does about that. Inference only, like the JAX kernel (no
VJP): :func:`conv3d_fused` raises when autograd would record it. A CPU
tensor takes :func:`conv3d_fused_plain`; a CUDA tensor launches the kernel
or raises.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import _build
from .conv3d import (
    _full_f32, _ncdhw, check_kernel_inputs, pack_weight, pick_tile)

# kernel launches on the main path (see ops.launch_counts)
launches = 0

STATS_GROUP = 64  # tiles per first-level stats sum (csrc/conv3d.cu kStatsGroup)


def conv3d_fused_plain(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    prologue_g: Optional[torch.Tensor] = None,
    prologue_b: Optional[torch.Tensor] = None,
    prologue_silu: bool = True,
    skip: Optional[torch.Tensor] = None,
    want_stats: bool = False,
):
    """Plain PyTorch version, the kernel's arithmetic: the prologue in f32
    before padding (so the halo stays 0), rounded to x's dtype; the conv in
    f32 (TF32 off) with the weight in x's dtype; ``+bias +skip`` in f32;
    stats of that f32 result; the output rounded once to x's dtype."""
    xin = x
    if prologue_g is not None:
        h = (x.float() * prologue_g.float()[:, None, None, None, :]
             + prologue_b.float()[:, None, None, None, :])
        if prologue_silu:
            h = h * torch.sigmoid(h)
        xin = h.to(x.dtype)
    with _full_f32():
        y = F.conv3d(_ncdhw(xin.float()), weight.to(x.dtype).float(),
                     None if bias is None else bias.float(), padding=1)
    y = y.permute(0, 2, 3, 4, 1)
    if skip is not None:
        y = y + skip.float()
    out = y.to(x.dtype).contiguous()
    if not want_stats:
        return out
    stats = torch.stack([y.sum(dim=(1, 2, 3)), (y * y).sum(dim=(1, 2, 3))],
                        dim=1)
    return out, stats


def conv3d_fused_kernel(
    x: torch.Tensor,
    w_packed: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    prologue_g: Optional[torch.Tensor] = None,
    prologue_b: Optional[torch.Tensor] = None,
    prologue_silu: bool = True,
    skip: Optional[torch.Tensor] = None,
    want_stats: bool = False,
):
    """Launch the fused kernel on CUDA tensors. ``w_packed`` comes from
    :func:`.conv3d.pack_weight` in x's dtype; bias, g and b are cast to
    f32, skip to x's dtype."""
    global launches
    _, cout = check_kernel_inputs(x, w_packed, "conv3d_fused", "ndhwc")
    B, D, H, W, cin = x.shape

    def f32(t, shape, what):
        if t is None:
            return None
        t = t.detach().to(device=x.device, dtype=torch.float32).contiguous()
        if tuple(t.shape) != shape:
            raise ValueError(
                f"{what} must be {list(shape)}, got {tuple(t.shape)}")
        return t

    x = x.contiguous()
    w_packed = w_packed.contiguous()
    b = f32(bias, (cout,), "bias")
    g = f32(prologue_g, (B, cin), "prologue_g")
    gb = f32(prologue_b, (B, cin), "prologue_b")
    sk = None
    if skip is not None:
        if tuple(skip.shape) != (B, D, H, W, cout):
            raise ValueError(f"skip must be {[B, D, H, W, cout]}, got "
                             f"{tuple(skip.shape)}")
        sk = skip.detach().to(device=x.device, dtype=x.dtype).contiguous()
        if sk.data_ptr() % 16:
            sk = sk.clone()
    y = torch.empty((B, D, H, W, cout), dtype=x.dtype, device=x.device)
    td, th, tw = pick_tile(D, H, W)
    part = part2 = stats = None
    if want_stats:
        tiles = -(-D // td) * -(-H // th) * -(-W // tw)
        groups = -(-tiles // STATS_GROUP)
        part = torch.empty((B * tiles * 2 * cout,), dtype=torch.float32,
                           device=x.device)
        part2 = torch.empty((B * groups * 2 * cout,), dtype=torch.float32,
                            device=x.device)
        stats = torch.empty((B, 2, cout), dtype=torch.float32, device=x.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = _build.fn("conv3d_fused_launch")(
        x.data_ptr(), w_packed.data_ptr(), ptr(b), ptr(g), ptr(gb),
        int(prologue_silu), ptr(sk), y.data_ptr(), ptr(part), ptr(part2),
        ptr(stats), B, D, H, W, cin, cout, td, th, tw,
        1 if x.dtype == torch.bfloat16 else 0,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "conv3d_fused_launch")
    launches += 1
    return (y, stats) if want_stats else y


def conv3d_fused(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    prologue_g: Optional[torch.Tensor] = None,    # [B, Cin] f32
    prologue_b: Optional[torch.Tensor] = None,    # [B, Cin] f32
    prologue_silu: bool = True,
    skip: Optional[torch.Tensor] = None,          # [B, D, H, W, Cout]
    want_stats: bool = False,
    w_packed: Optional[torch.Tensor] = None,
):
    """Fused normalize -> conv -> skip (+stats) of channels-last ``x`` [B,
    D, H, W, Cin] with a torch-layout ``weight`` (Cout, Cin, 3, 3, 3) used in
    x's dtype (``w_packed`` may carry the kernel's layout prepared ahead).

    Returns ``out`` [B, D, H, W, Cout] in x's dtype, or ``(out, stats)``
    with stats [B, 2, Cout] f32 the per-channel (sum, sum of squares) of the
    f32 output: what :func:`.groupnorm.fold_gn_affine` takes for the next
    GroupNorm. Inference only: raises if autograd would record the call.
    """
    if tuple(weight.shape[2:]) != (3, 3, 3):
        raise ValueError(f"3x3x3 kernels only, got {tuple(weight.shape)}")
    if (prologue_g is None) != (prologue_b is None):
        raise ValueError("pass prologue_g and prologue_b together")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, weight, bias, prologue_g, prologue_b, skip)):
        raise RuntimeError(
            "conv3d_fused is inference-only (the kernel has no backward): "
            "call it under torch.no_grad() or torch.inference_mode()")
    kw = dict(prologue_g=prologue_g, prologue_b=prologue_b,
              prologue_silu=prologue_silu, skip=skip, want_stats=want_stats)
    if x.device.type == "cpu":
        return conv3d_fused_plain(x, weight, bias, **kw)
    if x.device.type != "cuda":
        raise RuntimeError(f"conv3d_fused: unsupported device {x.device}")
    if w_packed is None:
        w_packed = pack_weight(weight, x.dtype)
    return conv3d_fused_kernel(x, w_packed, bias, **kw)
