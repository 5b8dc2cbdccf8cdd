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

The Hopper kernels: the 3x3x3 conv and the phase route run
``csrc/conv3d_s8.cu`` (route "sm90": ``wgmma`` s8 fed by TMA, the design of
the bf16 ``csrc/conv3d_sm90.cu`` with 128-channel chunks, phase tiles that
run only their 12 taps, :func:`s8_tap_mask`); the 1x1x1 conv runs
``csrc/conv1x1_s8.cu`` (route "conv1x1": a streaming s8 GEMM over rows,
its weight tile resident in shared memory, :func:`conv1x1_plan`). Each
source note says what bounds the kernel and what its design does about
that. Both take Cin a multiple of 16 (TMA's 16-byte row strides) and
16-byte-aligned operands: every site of the model has Cin a multiple of
128. A CPU tensor takes :func:`conv3d_s8_plain` (the integer sums in
float64, exact since every partial sum is an integer below 2^53, then the
same f32 epilogue ops), which the kernels equal bit for bit; a CUDA tensor
launches a kernel or raises.
"""

from __future__ import annotations

from typing import Iterator, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..utils import tracing
from . import _build
from .conv3d import (SM90_BN, SM90_MAX_ROWS, SM90_SMEM_LIMIT, SM90_SMS,
                     SM90_STAGES, pick_tile_sm90, sm90_halo, sm90_tile)

# the kernels; each launch counts as "launch.conv3d_s8" and
# "route.conv3d_s8.<route>" (ops.launch_counts, ops.route_counts): "sm90"
# (csrc/conv3d_s8.cu, 3x3x3 and phase sites), "conv1x1" (csrc/conv1x1_s8.cu,
# 1x1x1 sites)
ROUTES = ("sm90", "conv1x1")

# csrc/conv3d_s8.cu: a Cin chunk is 128 int8 channels (kBK), one 128-byte
# row per voxel; a ring of 2 to 4 halo stages (kMaxHaloStages)
S8_BK = 128
S8_MAX_HALO_STAGES = 4
S8_CIN_ALIGN = 16  # TMA: row strides a multiple of 16 bytes


def s8_tile(B: int, D: int, H: int, W: int, n: int,
            out_dtype: torch.dtype = torch.bfloat16,
            sms: int = SM90_SMS) -> Tuple[int, int, int]:
    """The output tile of one launch of the 3x3x3 kernel: the sm90 tile
    rules (:func:`.conv3d.sm90_tile`) over N GEMM columns; f32 output takes
    the kernel's 128-row instance (its 256-row one is built for bf16 output
    only)."""
    if out_dtype == torch.float32:
        return pick_tile_sm90(D, H, W, SM90_MAX_ROWS // 2)
    return sm90_tile(B, D, H, W, n, sms)


def _s8_fixed_smem() -> int:
    """Shared memory besides the halo ring: 1024 of alignment slack, the
    16 KB weight stages, the barriers and the row table."""
    return (1024 + SM90_STAGES * SM90_BN * S8_BK
            + 8 * (2 * S8_MAX_HALO_STAGES + 2 * SM90_STAGES) + 4 * 256)


def s8_halo_stages(tile: Tuple[int, int, int]) -> Tuple[int, int]:
    """(stages, bytes per stage) of the halo ring (the launch's
    ``hstages``, ``halo_bytes``): 128 bytes per halo voxel rounded up to
    1024, as many stages as the block's shared memory holds, at most 4
    (the kernel needs 2). The epilogue stages 128 bytes per output row in
    a halo stage, which always holds them."""
    stage = -(-sm90_halo(tile) * S8_BK // 1024) * 1024
    return (min(S8_MAX_HALO_STAGES,
                (SM90_SMEM_LIMIT - _s8_fixed_smem()) // stage), stage)


def s8_smem_bytes(tile: Tuple[int, int, int]) -> int:
    """Dynamic shared memory of one block (the launch's ``smem``)."""
    stages, stage = s8_halo_stages(tile)
    return _s8_fixed_smem() + stages * stage


# csrc/conv1x1_s8.cu: tiles of 128 rows x 128 columns, 128-channel chunks
# (16 KB each, for rows and for weights), a ring of 4 to 8 stages, two
# consumer warpgroups with four 8 KB pass buffers each, 2 * 8 + 1 barriers
C1_ROWS = 128
C1_BN = 128
C1_BK = 128
C1_CHUNK = C1_ROWS * C1_BK
C1_MIN_STAGES, C1_MAX_STAGES = 4, 8
C1_CONSUMERS = 2
C1_OUT_BUFS = 4
C1_PASS_BYTES = 64 * 128
C1_OUT_BYTES = C1_CONSUMERS * C1_OUT_BUFS * C1_PASS_BYTES
C1_BARS = 2 * C1_MAX_STAGES + 1


class Conv1x1Plan(NamedTuple):
    """One launch of ``csrc/conv1x1_s8.cu`` (its ``Shape`` and launch)."""
    chunks: int          # 128-channel chunks of Cin
    col_tiles: int       # nt: 128-column tiles of N
    row_tiles: int       # mt: 128-row tiles of M
    blocks_per_col: int  # bpc: blocks on one column tile
    grid: int            # nt * bpc blocks
    resident: bool       # the weight slab loaded once, or streamed
    stages: int          # the ring's stages
    stage_bytes: int     # 16 KB, 32 KB when streamed (rows + weights)
    slab_bytes: int      # chunks * 16 KB when resident, else 0
    ring_off: int        # shared memory from the 1024-aligned base: the
    out_off: int         # slab at 0, the ring, the output buffers, the
    bar_off: int         # barriers
    smem_bytes: int      # the launch's dynamic shared memory
    passes: int          # 128-byte column passes of a tile's epilogue
    tma_out: bool        # the epilogue stores by TMA (16-byte rows of y)


def conv1x1_plan(B: int, V: int, cin: int, n: int,
                 out_dtype: torch.dtype = torch.bfloat16,
                 sms: int = SM90_SMS) -> Conv1x1Plan:
    """The plan of ``conv1x1_s8_launch`` for x [B * V, Cin] -> y [B * V, N]:
    the weight slab resident where ``C1_MIN_STAGES`` row stages fit beside
    it and the output buffers (Cin <= 768), else streamed beside the rows
    in each stage; as many stages as fit, at most ``C1_MAX_STAGES``; block
    b on column tile b % nt and row tiles b // nt, + bpc, ..."""
    M = B * V
    chunks = -(-cin // C1_BK)
    nt, mt = -(-n // C1_BN), -(-M // C1_ROWS)
    fixed = 1024 + C1_OUT_BYTES + 8 * C1_BARS
    slab = chunks * C1_CHUNK
    stages = (SM90_SMEM_LIMIT - fixed - slab) // C1_CHUNK
    resident = stages >= C1_MIN_STAGES
    if resident:
        stage_bytes, ring_off = C1_CHUNK, slab
    else:
        stage_bytes, ring_off, slab = 2 * C1_CHUNK, 0, 0
        stages = (SM90_SMEM_LIMIT - fixed) // stage_bytes
    stages = min(stages, C1_MAX_STAGES)
    out_off = ring_off + stages * stage_bytes
    bar_off = out_off + C1_OUT_BYTES
    bpc = max(1, min(mt, sms // nt))
    esize = 2 if out_dtype == torch.bfloat16 else 4
    return Conv1x1Plan(
        chunks=chunks, col_tiles=nt, row_tiles=mt,
        blocks_per_col=bpc, grid=nt * bpc, resident=resident, stages=stages,
        stage_bytes=stage_bytes, slab_bytes=slab, ring_off=ring_off,
        out_off=out_off, bar_off=bar_off,
        smem_bytes=1024 + bar_off + 8 * C1_BARS,
        passes=C1_BN * esize // 128, tma_out=n * esize % 16 == 0)


def conv1x1_work_items(plan: Conv1x1Plan) -> Iterator[Tuple[int, int, int]]:
    """(block, row tile, column tile) in each block's order, as the
    kernel's producer and consumers walk them."""
    for blk in range(plan.grid):
        for rt in range(blk // plan.col_tiles, plan.row_tiles,
                        plan.blocks_per_col):
            yield blk, rt, blk % plan.col_tiles


def phase_taps(p: int) -> List[int]:
    """The taps (kd * 9 + kh * 3 + kw) of phase p = 2a + b in the stacked
    3x3x3 window: kernel rows a..a+1, columns b..b+1, every depth."""
    a, b = divmod(p, 2)
    return [kd * 9 + kh * 3 + kw for kd in range(3)
            for kh in (a, a + 1) for kw in (b, b + 1)]


def s8_tap_mask(n0: int, n: int, cout: int, taps: int, upsample: bool) -> int:
    """The kernel's ``tap_mask``: the taps (bit kd * 9 + kh * 3 + kw) that
    the 128-column tile at ``n0`` runs. A phase-route tile runs the taps of
    the phases its columns fall in (12 where it lies inside one phase);
    the 1x1x1 conv its one tap."""
    if taps == 1:
        return 1
    if not upsample:
        return (1 << 27) - 1
    last = min(n0 + SM90_BN, n) - 1
    mask = 0
    for p in range(n0 // cout, last // cout + 1):
        for t in phase_taps(p):
            mask |= 1 << t
    return mask


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
    """Launch the int8 conv on CUDA tensors: ``csrc/conv1x1_s8.cu`` for a
    1x1x1 weight, ``csrc/conv3d_s8.cu`` for the 3x3x3 conv and the phase
    route. ``w_packed`` comes from :func:`pack_weight_s8`. Raises unless Cin
    is a multiple of 16 and both operands start 16-byte aligned (TMA)."""
    if xq.device.type != "cuda":
        raise RuntimeError(f"conv3d_s8 kernel takes CUDA tensors, got {xq.device}")
    if w_packed.device != xq.device or w_packed.dim() != 3:
        raise ValueError("packed [taps, N, Cin] weight on x's device expected")
    cout, taps = _check(xq, w_packed, s_x, s_w, bias, out_dtype, upsample)
    B, D, H, W, cin = xq.shape
    if cin % S8_CIN_ALIGN:
        raise ValueError(f"conv3d_s8 takes Cin a multiple of {S8_CIN_ALIGN} "
                         f"(TMA's 16-byte row strides), got {cin}")
    dev = xq.device
    xq, w_packed = _ready(xq, dev, torch.int8), _ready(w_packed, dev, torch.int8)
    if xq.data_ptr() % 16 or w_packed.data_ptr() % 16:
        raise ValueError("conv3d_s8 takes 16-byte-aligned x and weight")
    sx, sw = _ready(s_x, dev), _ready(s_w, dev)
    b = None
    if bias is not None:  # the phase route adds the bias rounded to out_dtype
        b = _ready(bias.detach().to(out_dtype) if upsample else bias, dev)
    shape = (B, D, 2 * H, 2 * W, cout) if upsample else (B, D, H, W, cout)
    y = torch.empty(shape, dtype=out_dtype, device=dev)
    n = w_packed.shape[1]
    b_ptr = None if b is None else b.data_ptr()
    bf16 = 1 if out_dtype == torch.bfloat16 else 0
    stream = torch.cuda.current_stream(dev).cuda_stream
    if taps == 1:
        route, entry = "conv1x1", "conv1x1_s8_launch"
        err = _build.fn(entry)(
            xq.data_ptr(), w_packed.data_ptr(), sx.data_ptr(), sw.data_ptr(),
            b_ptr, y.data_ptr(), B, D * H * W, cin, n, bf16, stream)
    else:
        route, entry = "sm90", "conv3d_s8_launch"
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        err = _build.fn(entry)(
            xq.data_ptr(), w_packed.data_ptr(), sx.data_ptr(), sw.data_ptr(),
            b_ptr, y.data_ptr(), B, D, H, W, cin, n, taps, int(upsample),
            *s8_tile(B, D, H, W, n, out_dtype, sms), bf16, stream)
    _build.check(err, entry)
    tracing.count("launch.conv3d_s8")
    tracing.count(f"route.conv3d_s8.{route}")
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
