"""Stride-1 SAME 3x3x3 convolution on channels-last volumes.

Counterpart of ``ddpm3d_tpu/ops/conv3d_mxu.py:conv3d_mxu`` (the Pallas TPU
kernel ``_conv_kernel``). Hand-written Hopper kernels compute it, on the
route :func:`conv3d_route` picks:
  * ``"sm90"``, ``csrc/conv3d_sm90.cu``: bf16 with Cin % 8 == 0, every conv
    of the model's torso. A warp-specialised implicit GEMM: TMA stages a
    haloed input tile once per 64-channel Cin chunk and the weights of each
    tap through a ring of mbarrier-guarded stages, and two warpgroups run
    all 27 taps on ``wgmma`` with A gathered from the halo by ``ldmatrix``;
  * ``"sm90_narrow"``, ``csrc/conv3d_narrow.cu``: bf16 with Cin = 2, the
    model's input conv. The 27 taps fold into one 64-wide K (k = 2 * tap +
    ci, :func:`pack_weight_narrow`), A is gathered into registers straight
    from device memory, four ``wgmma`` per 64 rows;
  * ``"sm90_cin1"``, the same source's Cin = 1 instance: the Seg encoder's
    input conv. K = tap, 27 of one 32-wide chunk, two ``wgmma`` per 64
    rows; a register of A pairs taps 2j and 2j + 1 of one voxel;
  * ``"f32_head"``, ``csrc/conv3d_head.cu``: f32 with Cout <= 8, the model's
    head conv (128 -> 2). FFMA; a block walks a segment of D under a 32 x TW
    window of (H, W), staging each input plane once and keeping rolling
    accumulators for the three output planes it feeds
    (:func:`pack_weight_head`, :func:`head_plan`);
  * ``"f32_narrow"``, ``csrc/conv3d_head.cu``: f32 with Cin = 2, the head's
    dx (2 -> 128) and an f32 model's input conv. FFMA with the taps folded
    into K = 54 (:func:`pack_weight_f32_narrow`);
  * ``"f32"``, ``csrc/conv3d_f32.cu``: the other f32 convs (the torso of
    f32 models and their dx). FFMA on 16 x 8-voxel tiles of 128 channels,
    the halo staged once per 8-channel chunk, the weights
    (:func:`pack_weight_f32`, [27, Cin, Cout]) streamed in tap rows through
    a ring of cp.async stages (:func:`pick_tile_f32`);
  * ``"ndhwc"``, ``csrc/conv3d.cu``: bf16 with any other Cin, ``mma.sync``.
Each source note says what bounds its kernel and what its design does about
that (the narrow bf16 conv is bound by the bytes it stores, the others by
operations).

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
tensor launches a kernel or raises.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build

# kernel launches on the main path (see ops.launch_counts): forward convs
# and the dx convs of the backward, over both routes
launches = 0
dx_launches = 0
# the same launches by route (see ops.route_counts): "conv3d.<route>" and
# "conv3d_dx.<route>" for each of ROUTES
route_launches: Dict[str, int] = {}
ROUTES = ("sm90", "sm90_narrow", "sm90_cin1", "f32_head", "f32_narrow",
          "f32", "ndhwc")

MAX_ROWS = 128   # output voxels per block (csrc/conv3d.cu kMaxRows)
MAX_HALO = 640   # staged halo voxels per block (kMaxHalo)

# csrc/conv3d_sm90.cu
SM90_MAX_ROWS = 256    # output voxels per tile (kMaxRows); 128-row tiles
                       # run the kernel's kMT = 1 instance
SM90_SMS = 132         # SMs of an H100 SXM, for host-side planning on the CPU
SM90_MAX_HALO = 640    # (TD+2)(TH+2)(TW+2), at most (kMaxHalo)
SM90_BK = 64           # Cin chunk (kBK)
SM90_BN = 128          # output channels per tile (kBN)
SM90_STAGES = 4        # weight ring (kStages)
SM90_SMEM_LIMIT = 232448  # dynamic shared memory a block may use (H100)

# csrc/conv3d_narrow.cu: the taps folded into one K chunk (the packed
# weight's row, 32 * Cin): Cin = 2 and Cin = 1
NARROW_K = 64
NARROW_K1 = 32

# csrc/conv3d_f32.cu
F32_THREADS = 256     # threads per block, two blocks per SM
F32_BN = 128          # output channels per tile (kBN)
F32_BK = 8            # Cin chunk (kBK)
F32_TW = 8            # tile voxels along W, a thread's rows (kTW)
F32_LINES = 16        # (d, h) lines per tile, TD * TH (kLines)
F32_STAGES = 3        # weight ring, in units of one tap row (kStages)
F32_MAX_HALO = 540    # (TD+2)(TH+2)(TW+2), at most (kMaxHalo)
F32_HALO_PITCH = 548  # the transposed halo's row per channel (kHP)
F32_WARPS = F32_THREADS // 32

# csrc/conv3d_head.cu
HEAD_MAX_COUT = 8     # the head kernel's widest instance (COP)
HEAD_TH = 32          # window rows, one per lane (kHeadTH)
HEAD_WARPS = 4        # W strips per window (kHeadThreads / 32)
HEAD_CK = 16          # Cin chunk of a staged plane (kHeadCK)
HEAD_STAGES = 2       # staged chunks in the plane ring (kHeadStages)
HEAD_BLOCKS_PER_SM = 2  # __launch_bounds__(128, 2)
F32_NARROW_K = 54     # the f32 narrow kernel's folded K (kNK), no padding


def pack_weight(weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(Cout, Cin, 3, 3, 3) -> the kernel's [27, Cout, Cin] layout, in
    ``dtype`` (tap-major, Cin contiguous)."""
    cout, cin = weight.shape[:2]
    return (
        weight.detach().to(dtype).permute(2, 3, 4, 0, 1)
        .reshape(27, cout, cin).contiguous()
    )


def narrow_k(cin: int) -> int:
    """The narrow kernel's folded K for Cin = 1 or 2 (its packed row)."""
    return NARROW_K if cin == 2 else NARROW_K1


def pack_weight_narrow(weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(Cout, Cin, 3, 3, 3) with Cin = 1 or 2 -> the narrow kernel's [Cout,
    narrow_k(Cin)] layout in ``dtype``: column k = Cin * tap + ci with tap =
    9 kd + 3 kh + kw, zeros from k = 27 * Cin on."""
    cout, cin = weight.shape[:2]
    w = weight.detach().to(dtype).permute(0, 2, 3, 4, 1).reshape(cout, 27 * cin)
    return F.pad(w, (0, narrow_k(cin) - 27 * cin)).contiguous()


def narrow_fragment_taps(cin: int, ks: int, tq: int, reg: int):
    """What ``csrc/conv3d_narrow.cu`` loads into register ``reg`` (0..3) of
    A fragment ``ks`` for lane position ``tq`` (lane % 4): the (tap, ci) of
    its low and high bf16 halves. Cin = 2: tap 8 ks + tq (+ 4 for reg 2,
    3), channels 0 and 1 (one word); Cin = 1: taps 16 ks + 2 tq and the
    next (+ 8 for reg 2, 3), two voxels apart (two 2-byte loads). Rows:
    reg 0 and 2 hold row g, 1 and 3 row g + 8 (g = lane / 4)."""
    if cin == 2:
        t = 8 * ks + tq + (4 if reg >= 2 else 0)
        return (t, 0), (t, 1)
    t = 16 * ks + 2 * tq + (8 if reg >= 2 else 0)
    return (t, 0), (t + 1, 0)


def pack_weight_f32(weight: torch.Tensor) -> torch.Tensor:
    """(Cout, Cin, 3, 3, 3) -> the f32 kernel's [27, Cin, Cout] f32 layout
    (tap = 9 kd + 3 kh + kw, Cout contiguous): one tap's [Cin chunk][128
    columns] tile is the [k][n] the kernel's inner loop reads, so it streams
    by 16-byte copies without a transpose."""
    cout, cin = weight.shape[:2]
    return (weight.detach().float().permute(2, 3, 4, 1, 0)
            .reshape(27, cin, cout).contiguous())


def pack_weight_f32_narrow(weight: torch.Tensor) -> torch.Tensor:
    """(Cout, 2, 3, 3, 3) -> the f32 narrow kernel's [Cout, 54] f32 layout:
    column k = 2 * tap + ci with tap = 9 kd + 3 kh + kw (the kernel stages
    it as [54][128] column tiles)."""
    cout, cin = weight.shape[:2]
    return (weight.detach().float().permute(0, 2, 3, 4, 1)
            .reshape(cout, 27 * cin).contiguous())


def pack_weight_head(weight: torch.Tensor) -> torch.Tensor:
    """(Cout, Cin, 3, 3, 3) -> the head kernel's [Cin / 4, 27, 4, Cout] f32
    layout: 4-channel group, tap = 9 kd + 3 kh + kw, channel in the group,
    output channel (the kernel pads Cout to its instance's width in shared
    memory). Cin % 4 == 0."""
    cout, cin = weight.shape[:2]
    if cin % 4:
        raise ValueError(f"the head kernel takes Cin % 4 == 0, got {cin}")
    w = weight.detach().float().permute(1, 2, 3, 4, 0).reshape(
        cin // 4, 4, 27, cout)
    return w.transpose(1, 2).contiguous()


def pack_weight_kernel(weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The layout that the kernel of :func:`conv3d_route` takes for a conv
    with this (Cout, Cin, 3, 3, 3) weight in ``dtype``."""
    route = conv3d_route(weight.shape[1:2], dtype, weight.shape[0])
    if route in ("sm90_narrow", "sm90_cin1"):
        return pack_weight_narrow(weight, dtype)
    if route == "f32":
        return pack_weight_f32(weight)
    if route == "f32_narrow":
        return pack_weight_f32_narrow(weight)
    if route == "f32_head":
        return pack_weight_head(weight)
    return pack_weight(weight, dtype)


def packed_cout(w_packed: torch.Tensor) -> int:
    """Cout of a weight in any kernel layout: [27, Cout, Cin]
    (:func:`pack_weight`, bf16), [27, Cin, Cout] (:func:`pack_weight_f32`,
    f32), [Cout, K] (the narrow layouts) or [Cin / 4, 27, 4, Cout]
    (:func:`pack_weight_head`)."""
    if w_packed.dim() == 2:
        return w_packed.shape[0]
    if w_packed.dim() == 3:
        return w_packed.shape[2 if w_packed.dtype == torch.float32 else 1]
    if w_packed.dim() == 4:
        return w_packed.shape[3]
    raise ValueError(f"not a packed conv weight: {tuple(w_packed.shape)}")


def flip_weight(weight: torch.Tensor) -> torch.Tensor:
    """The dx conv's weight: ``wt[ci, co, a, b, c] = w[co, ci, 2-a, 2-b,
    2-c]`` (``conv3d_mxu.py:_conv3d_mxu_bwd``)."""
    return weight.flip(2, 3, 4).transpose(0, 1)


def pack_weight_dx(weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(Cout, Cin, 3, 3, 3) -> the kernel's layout (:func:`pack_weight_kernel`)
    of the flipped, in/out-swapped weight: the dx conv maps Cout -> Cin."""
    return pack_weight_kernel(flip_weight(weight), dtype)


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


@functools.lru_cache(maxsize=64)
def pick_tile_f32(D: int, H: int, W: int) -> Tuple[int, int]:
    """(TD, TH) of ``csrc/conv3d_f32.cu``'s TD x TH x 8 output tile (TD * TH
    = 16 lines, one per 16 threads) for a DxHxW volume: fewest tiles first
    (every tile costs 128 rows of math), then the smallest halo (input
    bytes staged per chunk). A function of the volume alone, so a volume's
    per-tile stats do not depend on the batch."""
    best = None
    for th in (1, 2, 4, 8, 16):
        td = F32_LINES // th
        halo = (td + 2) * (th + 2) * (F32_TW + 2)
        tiles = -(-D // td) * -(-H // th) * -(-W // F32_TW)
        key = (tiles, halo, th)
        if best is None or key < best[0]:
            best = (key, (td, th))
    return best[1]


def f32_tiles(B: int, D: int, H: int, W: int,
              tile: Tuple[int, int]) -> int:
    """Spatial tiles of one f32 launch (``gridDim.x``; the 128-column tiles
    are ``gridDim.y``)."""
    td, th = tile
    return B * -(-D // td) * -(-H // th) * -(-W // F32_TW)


def f32_tile_origin(q: int, B: int, D: int, H: int, W: int,
                    tile: Tuple[int, int]) -> Tuple[int, int, int, int]:
    """Spatial tile q -> (b, d0, h0, w0), as the kernel's ``decode_tile``:
    W fastest, then H, D, batch."""
    td, th = tile
    nD, nH, nW = -(-D // td), -(-H // th), -(-W // F32_TW)
    q, iw = divmod(q, nW)
    q, ih = divmod(q, nH)
    b, idd = divmod(q, nD)
    return b, idd * td, ih * th, iw * F32_TW


def f32_thread_rows(tid: int, tile: Tuple[int, int]):
    """The output rows of thread ``tid`` in its tile, as (dz, hy, wx) for
    its 8 rows (one line of 8 voxels along W), and its 8 columns of the
    128-column tile: the kernel's mapping. A warp covers 8 lines x 32
    columns: line 8 (warp / 4) + lane / 4, columns c..c+3 and c+16..c+19
    with c = 32 (warp % 4) + 4 (lane % 4)."""
    _, th = tile
    warp, lane = divmod(tid, 32)
    line = (warp // 4) * 8 + lane // 4
    c = (warp % 4) * 32 + (lane % 4) * 4
    rows = [(line // th, line % th, i) for i in range(F32_TW)]
    cols = [c + j for j in range(4)] + [c + 16 + j for j in range(4)]
    return rows, cols


def f32_smem_bytes(fused: bool) -> int:
    """Dynamic shared memory of one f32 block (``kSmemPlain`` /
    ``kSmemFused``): the staged halo (F32_MAX_HALO voxels x 8 floats), the
    transposed one (8 rows of F32_HALO_PITCH floats), the ring of
    F32_STAGES units of 3 taps x 8 x 128 floats and the halo's voxel table
    (one int a voxel); fused, also the [warp][2][128] stats sums (its
    epilogue's [128][132] tile reuses the halo and the ring)."""
    plain = 4 * (F32_MAX_HALO * F32_BK + F32_BK * F32_HALO_PITCH
                 + F32_STAGES * 3 * F32_BK * F32_BN + F32_MAX_HALO)
    if not fused:
        return plain
    return plain + 4 * F32_WARPS * 2 * F32_BN


def head_cop(cout: int) -> int:
    """The head kernel's instance for ``cout`` output channels: Cout padded
    to 1, 2, 4 or 8 (COP)."""
    return next(c for c in (1, 2, 4, 8) if c >= cout)


def head_tile(cout: int) -> Tuple[int, int]:
    """The head kernel's (H, W) window: 32 rows (one per lane) x 4 strips
    of R outputs along W, R = 4 up to COP = 2, 8 / COP above (HeadCfg)."""
    cop = head_cop(cout)
    r = 4 if cop <= 2 else 8 // cop
    return HEAD_TH, HEAD_WARPS * r


def head_smem_bytes(cin: int, cout: int) -> int:
    """Dynamic shared memory of one head block: the padded weight (Cin
    chunks x 4 groups x 27 taps x 4 x COP floats) and the ring's two plane
    buffers of (TH + 2) rows, each of (TW + 2) x 16 + 4 floats."""
    cop = head_cop(cout)
    th, tw = head_tile(cout)
    chunks = -(-cin // HEAD_CK)
    buf = (th + 2) * ((tw + 2) * HEAD_CK + 4)
    return 4 * (chunks * (HEAD_CK // 4) * 27 * 4 * cop + HEAD_STAGES * buf)


def conv3d_route(x_shape, dtype: torch.dtype, cout: int) -> str:
    """Which kernel takes a conv of x [..., Cin] to ``cout`` channels in
    ``dtype``: ``"sm90"`` (``csrc/conv3d_sm90.cu``) for bf16 with Cin % 8 ==
    0, whose rows TMA can stage (16-byte strides); ``"sm90_narrow"``
    (``csrc/conv3d_narrow.cu``) for bf16 with Cin = 2, the input conv, and
    ``"sm90_cin1"`` (its Cin = 1 instance) for bf16 with Cin = 1, the Seg
    encoder's input conv; ``"f32_narrow"`` (``csrc/conv3d_head.cu``) for f32
    with Cin = 2, the head's dx; ``"f32_head"`` (``csrc/conv3d_head.cu``)
    for f32 with Cout <= 8, Cin % 4 == 0 (16-byte rows) and a weight that
    fits the block's shared memory, the head conv; ``"f32"``
    (``csrc/conv3d_f32.cu``) for the other f32 convs; ``"ndhwc"``
    (``csrc/conv3d.cu``) for bf16 with any other Cin."""
    cin = x_shape[-1]
    if dtype == torch.bfloat16:
        if cin % 8 == 0:
            return "sm90"
        if cin == 2:
            return "sm90_narrow"
        if cin == 1:
            return "sm90_cin1"
    elif dtype == torch.float32:
        if cin == 2:
            return "f32_narrow"
        if (cout <= HEAD_MAX_COUT and cin % 4 == 0
                and head_smem_bytes(cin, cout) <= SM90_SMEM_LIMIT):
            return "f32_head"
        return "f32"
    return "ndhwc"


@functools.lru_cache(maxsize=64)
def head_plan(D: int, H: int, W: int, cout: int,
              sms: int = SM90_SMS) -> Tuple[int, int, int]:
    """(nH, nW, nseg) of a head launch: the (H, W) windows and the D
    segments of one volume. Segments are chosen so that windows x segments
    fill the card's ``sms`` SMs twice (two blocks each) without passing the
    volume's depth; they depend on the volume alone (not the batch), so a
    volume's sums do not depend on the batch."""
    th, tw = head_tile(cout)
    n_h, n_w = -(-H // th), -(-W // tw)
    nseg = max(1, min(D, HEAD_BLOCKS_PER_SM * sms // (n_h * n_w)))
    return n_h, n_w, nseg


def head_block(q: int, B: int, D: int, H: int, W: int, cout: int,
               sms: int = SM90_SMS) -> Tuple[int, int, int, int, int, bool]:
    """Block q of a head launch -> (b, d0, d1, h0, w0, up), as the kernel
    decodes ``blockIdx.x``: W window fastest, then H window, D segment,
    batch. The block stores output planes d0 .. d1 - 1 of its window,
    walking up (even segments) or down (odd ones)."""
    n_h, n_w, nseg = head_plan(D, H, W, cout, sms)
    th, tw = head_tile(cout)
    q, iw = divmod(q, n_w)
    q, ih = divmod(q, n_h)
    b, seg = divmod(q, nseg)
    return (b, seg * D // nseg, (seg + 1) * D // nseg, ih * th, iw * tw,
            seg % 2 == 0)


def sm90_halo(tile: Tuple[int, int, int], pad: int = 1) -> int:
    """Voxels of the haloed input tile (TD+2p)(TH+2p)(TW+2p): p = 1 for the
    3x3x3 conv; p = 0 (no halo) for the int8 kernel's 1x1x1 instance."""
    td, th, tw = tile
    return (td + 2 * pad) * (th + 2 * pad) * (tw + 2 * pad)


def sm90_smem_bytes(tile: Tuple[int, int, int]) -> int:
    """Dynamic shared memory of one block of ``csrc/conv3d_sm90.cu``
    (``smem_bytes``): 1024 of alignment slack, two halo stages of 128 bytes
    per voxel each rounded up to 1024, the weight ring of 16 KB stages, the
    6 + 2 * stages mbarriers (``kBars``) and the 4-byte row table."""
    halo_bytes = -(-sm90_halo(tile) * SM90_BK * 2 // 1024) * 1024
    return (1024 + 2 * halo_bytes + SM90_STAGES * SM90_BN * SM90_BK * 2
            + 8 * (6 + 2 * SM90_STAGES) + 4 * SM90_MAX_ROWS)


@functools.lru_cache(maxsize=64)
def pick_tile_sm90(D: int, H: int, W: int, rows: int = SM90_MAX_ROWS,
                   pad: int = 1) -> Tuple[int, int, int]:
    """Output tile (TD, TH, TW) of ``csrc/conv3d_sm90.cu`` (and of
    ``csrc/conv3d_s8.cu``, whose tiles follow the same rules; ``pad`` 0 for
    its 1x1x1 instance) for a DxHxW volume: at most ``rows`` (256 or 128)
    voxels and SM90_MAX_HALO halo voxels; fewest tiles first (every tile
    costs ``rows`` rows of math), then the smallest halo, then the widest
    TW (8 consecutive voxels keep ldmatrix free of bank conflicts)."""
    best = None
    for tw in range(1, min(W, rows) + 1):
        for th in range(1, min(H, rows // tw) + 1):
            td = min(D, rows // (tw * th))
            halo = sm90_halo((td, th, tw), pad)
            if halo > SM90_MAX_HALO:
                continue
            tiles = -(-D // td) * -(-H // th) * -(-W // tw)
            key = (tiles, halo, -tw)
            if best is None or key < best[0]:
                best = (key, (td, th, tw))
    return best[1]


@functools.lru_cache(maxsize=256)
def sm90_tile(B: int, D: int, H: int, W: int, cout: int,
              sms: int = SM90_SMS, pad: int = 1) -> Tuple[int, int, int]:
    """The tile of one launch: 256-row tiles, unless 128-row ones fill the
    card's ``sms`` SMs so much better that waves x rows per tile drop by a
    quarter (the small volumes, where 256-row tiles leave SMs idle)."""
    def cost(tile, rows):
        return -(-sm90_tiles(B, D, H, W, cout, tile) // sms) * rows

    big = pick_tile_sm90(D, H, W, SM90_MAX_ROWS, pad)
    small = pick_tile_sm90(D, H, W, SM90_MAX_ROWS // 2, pad)
    if cost(small, SM90_MAX_ROWS // 2) <= 0.75 * cost(big, SM90_MAX_ROWS):
        return small
    return big


def sm90_tiles(B: int, D: int, H: int, W: int, cout: int,
               tile: Tuple[int, int, int]) -> int:
    """Work items of one launch (``Shape::total``): spatial tiles times
    128-column tiles. The grid is min(this, SMs); block i takes items i,
    i + grid, ..."""
    td, th, tw = tile
    spatial = B * -(-D // td) * -(-H // th) * -(-W // tw)
    return spatial * -(-cout // SM90_BN)


def sm90_tile_origin(q: int, B: int, D: int, H: int, W: int, cout: int,
                     tile: Tuple[int, int, int]) -> Tuple[int, int, int, int, int]:
    """Work item q -> (b, d0, h0, w0, n0), as the kernel's ``decode_tile``:
    column tile slowest, then batch, D, H, W. The halo box of chunk c is
    loaded at (64 c, w0 - 1, h0 - 1, d0 - 1, b)."""
    td, th, tw = tile
    nD, nH, nW = -(-D // td), -(-H // th), -(-W // tw)
    spatial = B * nD * nH * nW
    n0 = (q // spatial) * SM90_BN
    i = q % spatial
    i, iw = divmod(i, nW)
    i, ih = divmod(i, nH)
    b, idd = divmod(i, nD)
    return b, idd * td, ih * th, iw * tw, n0


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


def check_kernel_inputs(x: torch.Tensor, w_packed: torch.Tensor, what: str,
                        route: Optional[str] = None) -> Tuple[str, int]:
    """Raise unless the conv kernels take ``x`` [B, D, H, W, Cin] (a CUDA
    tensor, bf16 or f32) with ``w_packed`` in the layout of ``route``
    (default: :func:`conv3d_route`'s, as :func:`pack_weight_kernel` packs;
    ``"ndhwc"`` for :func:`pack_weight`'s, ``"f32"`` for
    :func:`pack_weight_f32`'s); returns (route, Cout)."""
    if x.device.type != "cuda":
        raise RuntimeError(f"{what} kernel takes CUDA tensors, got {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{what} kernel takes bf16 or f32, got {x.dtype}")
    if x.dim() != 5:
        raise ValueError(f"expected [B, D, H, W, C], got {tuple(x.shape)}")
    cin = x.shape[-1]
    if w_packed.dtype != x.dtype or w_packed.device != x.device:
        raise ValueError("packed weight must match x's dtype and device")
    cout = packed_cout(w_packed)
    route = route or conv3d_route(x.shape, x.dtype, cout)
    expect = {
        "sm90_narrow": (cout, NARROW_K),
        "sm90_cin1": (cout, NARROW_K1),
        "f32_narrow": (cout, F32_NARROW_K),
        "f32_head": (cin // 4, 27, 4, cout),
        "f32": (27, cin, cout),
    }.get(route, (27, cout, cin))
    if tuple(w_packed.shape) != expect:
        raise ValueError(
            f"packed weight {tuple(w_packed.shape)} does not fit Cin={cin} "
            f"on route {route} (expected {expect})")
    return route, cout


def _launch(
    x: torch.Tensor,
    w_packed: torch.Tensor,
    bias: Optional[torch.Tensor],
    what: str,
) -> torch.Tensor:
    """Run the kernel of :func:`conv3d_route` once on CUDA tensors and count
    it under ``what`` ("conv3d" or "conv3d_dx") and its route."""
    route, cout = check_kernel_inputs(x, w_packed, what)
    B, D, H, W, cin = x.shape
    x = x.contiguous()
    w_packed = w_packed.contiguous()
    b = None
    if bias is not None:
        b = bias.detach().to(device=x.device, dtype=torch.float32).contiguous()
    y = torch.empty((B, D, H, W, cout), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    b_ptr = b.data_ptr() if b is not None else None
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    if route == "sm90":
        if x.data_ptr() % 16 or w_packed.data_ptr() % 16:
            raise ValueError("conv3d_sm90 takes 16-byte-aligned x and weight")
        name = "conv3d_sm90_launch"
        err = _build.fn(name)(
            x.data_ptr(), w_packed.data_ptr(), b_ptr, y.data_ptr(),
            B, D, H, W, cin, cout, *sm90_tile(B, D, H, W, cout, sms), stream)
    elif route in ("sm90_narrow", "sm90_cin1"):
        if x.data_ptr() % (2 * cin) or w_packed.data_ptr() % 16:
            raise ValueError(f"conv3d_narrow takes {2 * cin}-byte-aligned x "
                             "and a 16-byte-aligned weight")
        name = "conv3d_narrow_launch"
        err = _build.fn(name)(
            x.data_ptr(), w_packed.data_ptr(), b_ptr, y.data_ptr(),
            B, D, H, W, cin, cout, stream)
    elif route == "f32_head":
        if x.data_ptr() % 16:
            raise ValueError("conv3d_head takes 16-byte-aligned x")
        name = "conv3d_head_launch"
        err = _build.fn(name)(
            x.data_ptr(), w_packed.data_ptr(), b_ptr, y.data_ptr(),
            B, D, H, W, cin, cout, head_plan(D, H, W, cout, sms)[2], stream)
    elif route == "f32_narrow":
        if x.data_ptr() % 8:
            raise ValueError("conv3d_f32_narrow takes 8-byte-aligned x")
        name = "conv3d_f32_narrow_launch"
        err = _build.fn(name)(
            x.data_ptr(), w_packed.data_ptr(), b_ptr, y.data_ptr(),
            B, D, H, W, cout, stream)
    elif route == "f32":
        name = "conv3d_f32_launch"
        err = _build.fn(name)(
            x.data_ptr(), w_packed.data_ptr(), b_ptr, y.data_ptr(),
            B, D, H, W, cin, cout, *pick_tile_f32(D, H, W), stream)
    else:
        name = "conv3d_ndhwc_launch"
        err = _build.fn(name)(
            x.data_ptr(), w_packed.data_ptr(), b_ptr, y.data_ptr(),
            B, D, H, W, cin, cout, *pick_tile(D, H, W), 1, stream)
    _build.check(err, name)
    key = f"{what}.{route}"
    route_launches[key] = route_launches.get(key, 0) + 1
    return y


def conv3d_kernel(
    x: torch.Tensor,
    w_packed: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Launch the conv kernel (:func:`conv3d_route`) on CUDA tensors.
    ``w_packed`` comes from :func:`pack_weight_kernel` in x's dtype; bias
    is cast to f32."""
    global launches
    y = _launch(x, w_packed, bias, "conv3d")
    launches += 1
    return y


def conv3d_dx_kernel(dy: torch.Tensor, w_packed_dx: torch.Tensor) -> torch.Tensor:
    """dx of the conv: the conv kernel (:func:`conv3d_route`) on dy [B, D,
    H, W, Cout] with :func:`pack_weight_dx` in dy's dtype (no bias); the
    result has Cin channels."""
    global dx_launches
    dx = _launch(dy, w_packed_dx, None, "conv3d_dx")
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
            w_packed = pack_weight_kernel(weight, x.dtype)
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
    (:func:`pack_weight_kernel`). Differentiable in x, weight and bias."""
    if tuple(weight.shape[2:]) != (3, 3, 3):
        raise ValueError(f"3x3x3 kernels only, got {tuple(weight.shape)}")
    return Conv3dFunction.apply(x, weight, bias, w_packed)
