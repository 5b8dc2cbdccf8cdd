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

Two Hopper kernels compute it, chosen by :func:`conv3d_fused_route`:
  * ``"sm90"``, bf16 with Cin % 8 == 0 (every fused site of the model): the
    fused instance of ``csrc/conv3d_sm90.cu`` (``conv3d_sm90_fused_launch``;
    wgmma fed by TMA, the prologue in the producer warpgroup), on the tile
    of :func:`fused_tile`, and its stats finish;
  * ``"f32"``, f32: the fused instance of ``csrc/conv3d_f32.cu``'s FFMA
    conv (``conv3d_f32_fused_launch``; weight :func:`.conv3d.
    pack_weight_f32`, tile :func:`.conv3d.pick_tile_f32`), and its stats
    finish.
bf16 with another Cin raises. Each source note says what bounds its kernel
and what the design does about that. Inference only, like the JAX kernel
(no VJP): :func:`conv3d_fused` raises when autograd would record it. A CPU
tensor takes :func:`conv3d_fused_plain`; a CUDA tensor launches a kernel
or raises.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build
from .conv3d import (
    F32_TW, SM90_MAX_HALO, SM90_MAX_ROWS, SM90_SMS, _full_f32, _ncdhw,
    check_kernel_inputs, pack_weight, pack_weight_f32, pick_tile_f32,
    sm90_halo, sm90_tile, sm90_tiles)

# kernel launches on the main path (see ops.launch_counts), and the same
# launches by route (see ops.route_counts): "conv3d_fused.<route>"
launches = 0
route_launches: Dict[str, int] = {}
ROUTES = ("sm90", "f32")

STATS_GROUP = 64  # tiles per first-level stats sum (csrc/conv3d_f32.cu
                  # kStatsGroup)
# the sm90 route's stats pass the 8 consumer warps' sums through the
# output's halo stage, past the tile's staged rows (256 bytes a row)
FUSED_STATS_BYTES = 8 * 2 * 128 * 4


def fused_stage_fits(tile: Tuple[int, int, int]) -> bool:
    """Whether a halo stage of ``tile`` (128 bytes a voxel, rounded up to
    1 KB) holds the staged output rows and the stats sums past them."""
    stage = -(-sm90_halo(tile) * 128 // 1024) * 1024
    return stage >= math.prod(tile) * 256 + FUSED_STATS_BYTES


def conv3d_fused_route(x_shape, dtype: torch.dtype) -> str:
    """Which kernel takes a fused conv of x [..., Cin] in ``dtype``:
    ``"sm90"`` (``csrc/conv3d_sm90.cu``) for bf16 with Cin % 8 == 0, whose
    rows TMA can stage; ``"f32"`` (``csrc/conv3d_f32.cu``) for f32. Raises
    for bf16 with another Cin (no fused kernel takes it)."""
    cin = x_shape[-1]
    if dtype == torch.bfloat16:
        if cin % 8:
            raise ValueError(
                f"the bf16 fused conv takes Cin % 8 == 0, got Cin={cin}")
        return "sm90"
    if dtype == torch.float32:
        return "f32"
    raise TypeError(f"conv3d_fused takes bf16 or f32, got {dtype}")


@functools.lru_cache(maxsize=256)
def fused_tile(D: int, H: int, W: int, cout: int,
               sms: int = SM90_SMS) -> Tuple[int, int, int]:
    """The sm90 route's output tile, a function of (D, H, W, Cout) and the
    SM count alone, so that a volume's per-tile stats, and the order in
    which they are added, do not depend on the batch. It starts from the
    conv's tile for one volume (:func:`.conv3d.sm90_tile` at B = 1) and
    keeps its instance (256- or 128-row m-tiles) and its number of waves,
    but takes the smallest halo among the tiles that do: every halo voxel
    is staged and rewritten by the prologue once per work item (at the
    96 x 6^2 level, 3 x 6 x 6 rather than 32 x 2 x 2: 320 halo voxels
    for 108 rows, not 544 for 128)."""
    base = sm90_tile(1, D, H, W, cout, sms)
    cap = SM90_MAX_ROWS if math.prod(base) > SM90_MAX_ROWS // 2 \
        else SM90_MAX_ROWS // 2
    waves = -(-sm90_tiles(1, D, H, W, cout, base) // sms)
    # ties keep the conv's tile (if its stage holds the stats)
    best = ((sm90_halo(base) if fused_stage_fits(base)
             else SM90_MAX_HALO + 1, 0), base)
    # no narrower W run than the conv's (8 voxels keep ldmatrix free of
    # bank conflicts)
    for tw in range(min(8, base[2]), min(W, cap) + 1):
        for th in range(1, min(H, cap // tw) + 1):
            for td in range(1, min(D, cap // (tw * th)) + 1):
                tile = (td, th, tw)
                rows = td * th * tw
                if rows * 2 <= cap and cap == SM90_MAX_ROWS:
                    continue  # the 128-row instance
                halo = sm90_halo(tile)
                if (halo > SM90_MAX_HALO or not fused_stage_fits(tile)
                        or -(-sm90_tiles(1, D, H, W, cout, tile) // sms)
                        > waves):
                    continue
                best = min(best, ((halo, 1), tile))
    return best[1]


def pack_weight_fused(weight: torch.Tensor,
                      dtype: torch.dtype) -> torch.Tensor:
    """The layout the fused kernel of ``dtype`` takes: [27, Cout, Cin]
    (:func:`.conv3d.pack_weight`) in bf16, [27, Cin, Cout]
    (:func:`.conv3d.pack_weight_f32`) in f32."""
    if dtype == torch.float32:
        return pack_weight_f32(weight)
    return pack_weight(weight, dtype)


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
    :func:`pack_weight_fused` in x's dtype; bias, g and b are cast to f32,
    skip to x's dtype."""
    global launches
    route = conv3d_fused_route(x.shape, x.dtype)
    _, cout = check_kernel_inputs(
        x, w_packed, "conv3d_fused", "f32" if route == "f32" else "ndhwc")
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
    stream = torch.cuda.current_stream(x.device).cuda_stream

    def ptr(t):
        return None if t is None else t.data_ptr()

    if route == "sm90":
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        td, th, tw = fused_tile(D, H, W, cout, sms)
        # 16-byte loads of x, the weight, (g, b) and the skip
        for t in (x, w_packed):
            if t.data_ptr() % 16:
                raise ValueError("conv3d_fused takes a 16-byte-aligned x "
                                 "and weight")
        g, gb, sk = (t if t is None or t.data_ptr() % 16 == 0 else
                     t.clone() for t in (g, gb, sk))
        part = stats = None
        if want_stats:
            tiles = -(-D // td) * -(-H // th) * -(-W // tw)
            part = torch.empty((B * tiles * 2 * cout,), dtype=torch.float32,
                               device=x.device)
            stats = torch.empty((B, 2, cout), dtype=torch.float32,
                                device=x.device)
        name = "conv3d_sm90_fused_launch"
        err = _build.fn(name)(
            x.data_ptr(), w_packed.data_ptr(), ptr(b), ptr(g), ptr(gb),
            int(prologue_silu), ptr(sk), y.data_ptr(), ptr(part), ptr(stats),
            B, D, H, W, cin, cout, td, th, tw, stream)
    else:
        td, th = pick_tile_f32(D, H, W)
        part = part2 = stats = None
        if want_stats:
            tiles = -(-D // td) * -(-H // th) * -(-W // F32_TW)
            groups = -(-tiles // STATS_GROUP)
            part = torch.empty((B * tiles * 2 * cout,), dtype=torch.float32,
                               device=x.device)
            part2 = torch.empty((B * groups * 2 * cout,), dtype=torch.float32,
                                device=x.device)
            stats = torch.empty((B, 2, cout), dtype=torch.float32,
                                device=x.device)
        name = "conv3d_f32_fused_launch"
        err = _build.fn(name)(
            x.data_ptr(), w_packed.data_ptr(), ptr(b), ptr(g), ptr(gb),
            int(prologue_silu), ptr(sk), y.data_ptr(), ptr(part), ptr(part2),
            ptr(stats), B, D, H, W, cin, cout, td, th, stream)
    _build.check(err, name)
    launches += 1
    key = f"conv3d_fused.{route}"
    route_launches[key] = route_launches.get(key, 0) + 1
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
        w_packed = pack_weight_fused(weight, x.dtype)
    return conv3d_fused_kernel(x, w_packed, bias, **kw)
