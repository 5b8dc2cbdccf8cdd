"""Host-side rules and CPU emulations of the two kernels redesigned in
``csrc/conv3d_sm90.cu`` (the bf16 fused ResBlock conv, K4) and
``csrc/groupnorm.cu`` (GroupNorm stats, K1), against the plain versions
and the JAX package.

The kernels run only on the card (tests/test_torch_port_cuda.py,
chip_smoke.py). Here numpy walks what they do, in their order: K4's tile
plan (``ops/conv3d_fused.py:fused_tile`` with the conv's work items), the
TMA halo stage with its 128-byte swizzle, the producer warpgroup's prologue
over it (each thread's 16-byte piece, the un-swizzled channel index, the
inside-the-volume mask), the 27 taps over the rewritten stage, and the
per-tile stats in the order of the epilogue and of ``fused_stats_finish``;
K1's split plan and its fixed-order sums. The JAX side runs its Pallas
kernels as tests/test_torch_port_fused.py does (interpret mode), its stats
through ``models/nn.py:channel_stats``.
"""

import collections
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddpm3d_tpu.models import nn as jnn
from ddpm3d_tpu.ops.conv3d_fused import conv3d_fused as jax_conv3d_fused
from ddpm3d_tpu_torch.ops import conv3d as cv
from ddpm3d_tpu_torch.ops import conv3d_fused as fo
from ddpm3d_tpu_torch.ops import groupnorm as gn


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads for this file's tests and fixtures (the suite's
    workers share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)

# the five volumes of the production model at 96^3 and the fused sites'
# output widths there
VOLUMES = [(96, 96, 96), (96, 48, 48), (96, 24, 24), (96, 12, 12), (96, 6, 6)]
COUTS = [128, 256, 384, 512]
BK = cv.SM90_BK            # Cin chunk: one 128-byte swizzle row
PIECES = BK // 8           # 16-byte pieces per staged voxel
PROLOGUE_THREADS = 96      # producer warps 1-3 (kPrologueThreads)
STATS_WARPS = 8            # consumer warps (4 * kConsumers)
# the emulation's f32 sums against the plain version's: summation order
# and one bf16 rounding of the output (the card's own tolerances,
# chip_smoke.py TOL / STATS_*_TOL)
OUT_TOL = 1e-2
STATS_TOL = 1e-4


def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).bfloat16() \
        .float().numpy()


def _f32_fma(a, b, c):
    """fmaf(a, b, c) in f32 (the product of two f32 is exact in f64)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


# ------------------------------------------------------------- tile plan --

@pytest.mark.parametrize("dhw", VOLUMES + [(5, 6, 13), (7, 5, 13)])
@pytest.mark.parametrize("cout", COUTS + [136])
def test_fused_tile_fits_the_kernel(dhw, cout):
    """The sm90 route's tile (a function of the volume, Cout and the SM
    count, never of the batch) keeps the conv's instance (256- or 128-row
    m-tiles) and number of waves, stages no larger a halo than the conv's
    tile and no narrower a W run, and fits the kernel: rows, halo, shared
    memory, and a halo stage that holds the staged output rows and the 8
    warps' stats sums (8 KB) past them."""
    D, H, W = dhw
    tile = fo.fused_tile(D, H, W, cout)
    conv = cv.sm90_tile(1, D, H, W, cout)
    half = cv.SM90_MAX_ROWS // 2
    assert (np.prod(tile) > half) == (np.prod(conv) > half)
    sms = cv.SM90_SMS
    assert -(-cv.sm90_tiles(1, D, H, W, cout, tile) // sms) <= \
        -(-cv.sm90_tiles(1, D, H, W, cout, conv) // sms)
    assert cv.sm90_halo(tile) <= cv.sm90_halo(conv)
    assert tile[2] >= min(8, conv[2])
    assert np.prod(tile) <= cv.SM90_MAX_ROWS
    assert cv.sm90_halo(tile) <= cv.SM90_MAX_HALO
    assert cv.sm90_smem_bytes(tile) <= cv.SM90_SMEM_LIMIT
    halo_bytes = -(-cv.sm90_halo(tile) * BK * 2 // 1024) * 1024
    assert fo.fused_stage_fits(tile)
    assert halo_bytes >= (np.prod(tile) * 2 * cv.SM90_BN
                          + STATS_WARPS * 2 * cv.SM90_BN * 4)


def test_fused_tile_at_the_deepest_level():
    """At 96 x 6^2 (Cin 1024 -> 512) the fused tile stages 320 halo voxels
    for 108 rows where the conv's 32 x 2 x 2 stages 544 for 128, in the
    same single wave of 128-row work items."""
    assert cv.sm90_tile(1, 96, 6, 6, 512) == (32, 2, 2)
    assert fo.fused_tile(96, 6, 6, 512) == (3, 6, 6)
    assert cv.sm90_tiles(1, 96, 6, 6, 512, (3, 6, 6)) <= cv.SM90_SMS


@pytest.mark.parametrize("dhw,cout", [
    ((96, 24, 24), 256), ((5, 6, 13), 136), ((96, 6, 6), 512),
    ((7, 5, 13), 128)])
def test_fused_work_items_cover_the_output_once_at_any_batch(dhw, cout):
    """At batch 1 and 2 the work items on the fused tile cover every output
    voxel and 128-column tile once, and volume 0's items are the same tiles
    in the same order (its per-tile partials, row b * T + t, do not depend
    on the batch)."""
    D, H, W = dhw
    tile = fo.fused_tile(D, H, W, cout)
    td, th, tw = tile
    T = -(-D // td) * -(-H // th) * -(-W // tw)
    items = {}
    for B in (1, 2):
        total = cv.sm90_tiles(B, D, H, W, cout, tile)
        seen = collections.Counter()
        vol0 = []
        for q in range(total):
            b, d0, h0, w0, n0 = cv.sm90_tile_origin(q, B, D, H, W, cout, tile)
            spatial = q % (B * T)
            assert spatial // T == b
            if b == 0:
                vol0.append((spatial % T, d0, h0, w0, n0))
            for d, h, w in itertools.product(range(d0, min(d0 + td, D)),
                                             range(h0, min(h0 + th, H)),
                                             range(w0, min(w0 + tw, W))):
                seen[(b, d, h, w, n0)] += 1
        assert len(seen) == B * D * H * W * -(-cout // cv.SM90_BN)
        assert set(seen.values()) == {1}
        items[B] = vol0
    assert items[1] == items[2]


# ------------------------------------------------------- K4 emulation --

def _tma_halo(x, b, d0, h0, w0, c, tile):
    """The halo box of chunk c, as TMA writes it: [halo voxels, 8 pieces,
    8 channels], zero outside the volume and past Cin, 16-byte piece j of
    voxel v at physical piece j ^ (v & 7) (the 128-byte swizzle)."""
    _, D, H, W, cin = x.shape
    td, th, tw = tile
    box = np.zeros((td + 2, th + 2, tw + 2, BK), np.float32)
    c0, c1 = c * BK, min(cin, (c + 1) * BK)
    lo = [max(0, o - 1) for o in (d0, h0, w0)]
    hi = [min(n, o + t + 1) for n, o, t in ((D, d0, td), (H, h0, th),
                                            (W, w0, tw))]
    box[lo[0] - d0 + 1:hi[0] - d0 + 1, lo[1] - h0 + 1:hi[1] - h0 + 1,
        lo[2] - w0 + 1:hi[2] - w0 + 1, :c1 - c0] = \
        x[b, lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2], c0:c1]
    flat = box.reshape(-1, PIECES, 8)
    v = np.arange(flat.shape[0])
    stage = np.empty_like(flat)
    for j in range(PIECES):
        stage[v, j ^ (v & 7)] = flat[v, j]
    return stage


def _unswizzle(stage, tile):
    v = np.arange(stage.shape[0])
    flat = np.empty_like(stage)
    for j in range(PIECES):
        flat[v, j] = stage[v, j ^ (v & 7)]
    td, th, tw = tile
    return flat.reshape(td + 2, th + 2, tw + 2, BK)


def _prologue(v, g, b, silu):
    h = (v * g).astype(np.float32)
    h = (h + b).astype(np.float32)
    if silu:
        h = (h * (np.float32(1) / (np.float32(1) + np.exp(-h)))).astype(
            np.float32)
    return _bf16(h)


def _prologue_stage(stage, x_shape, pg, pb, silu, b, d0, h0, w0, c, tile):
    """``prologue_stage``: thread u of PROLOGUE_THREADS rewrites logical
    piece j = u % 8 of voxels u // 8, + 12, ... (incremental halo
    coordinates), where the voxel lies in the volume and the channels are
    below Cin."""
    _, D, H, W, cin = x_shape
    td, th, tw = tile
    HD, HH, HW = td + 2, th + 2, tw + 2
    lanes = PROLOGUE_THREADS // PIECES
    for u in range(PROLOGUE_THREADS):
        j = u & 7
        ci = c * BK + 8 * j
        if ci >= cin:
            continue
        gj, bj = pg[b, ci:ci + 8], pb[b, ci:ci + 8]
        v = u >> 3
        hx, hy, hz = v % HW, (v // HW) % HH, v // (HW * HH)
        while v < HD * HH * HW:
            d, h, w = d0 + hz - 1, h0 + hy - 1, w0 + hx - 1
            if 0 <= d < D and 0 <= h < H and 0 <= w < W:
                p = j ^ (v & 7)
                stage[v, p] = _prologue(stage[v, p], gj, bj, silu)
            v += lanes
            hx += lanes
            while hx >= HW:
                hx -= HW
                hy += 1
                if hy == HH:
                    hy, hz = 0, hz + 1
    return stage


def _tile_partial(vals, valid, kmt):
    """The epilogue's sums of one tile and column tile, in its order:
    thread (warpgroup, warp, g) adds rows (cwg kMT + mi) 64 + 16 wq + g +
    8 h over mi, h; a butterfly over g; the 8 warps in order. vals
    [kMT * 128, 128] f32, valid [kMT * 128] bool -> [2, 128]."""
    warps = []
    for cwg in range(2):
        for wq in range(4):
            lanes = []
            for g in range(8):
                s = np.zeros(vals.shape[1], np.float32)
                q = np.zeros(vals.shape[1], np.float32)
                for mi in range(kmt):
                    for h in range(2):
                        r = (cwg * kmt + mi) * 64 + wq * 16 + g + 8 * h
                        if valid[r]:
                            s = (s + vals[r]).astype(np.float32)
                            q = _f32_fma(vals[r], vals[r], q)
                lanes.append(np.stack([s, q]))
            for off in (1, 2, 4):  # shuffles xor 4, 8, 16: g ^ 1, 2, 4
                lanes = [(lanes[g] + lanes[g ^ off]).astype(np.float32)
                         for g in range(8)]
            assert all(np.array_equal(lanes[0], a) for a in lanes)
            warps.append(lanes[0])
    out = warps[0]
    for w in warps[1:]:
        out = (out + w).astype(np.float32)
    return out


def _finish(part):
    """``fused_stats_finish`` for one volume: part [T, 2, Cout] -> [2,
    Cout]; lane l of 32 adds tiles l, l + 32, ..., then the lanes in
    order."""
    lanes = []
    for lane in range(32):
        acc = np.zeros(part.shape[1:], np.float32)
        for t in range(lane, part.shape[0], 32):
            acc = (acc + part[t]).astype(np.float32)
        lanes.append(acc)
    out = lanes[0]
    for a in lanes[1:]:
        out = (out + a).astype(np.float32)
    return out


def _emulate_fused(x, w, bias, pg, pb, silu, skip, tile, checked=None):
    """The bf16 fused kernel on the host: every work item stages its halo
    chunks, rewrites them with the prologue (when pg is given), runs the 27
    taps, adds bias and skip in f32 and rounds once; the stats in the
    kernel's order. x, skip bf16-valued f32 [B, D, H, W, *]; w the torch
    layout (Cout, Cin, 3, 3, 3), bf16-valued. Returns (y, stats, part).
    ``checked`` collects (b, tile origin, chunk, stage) of each rewritten
    stage for the caller."""
    B, D, H, W, cin = x.shape
    cout = w.shape[0]
    td, th, tw = tile
    rows = td * th * tw
    kmt = 1 if rows <= cv.SM90_MAX_ROWS // 2 else 2
    T = -(-D // td) * -(-H // th) * -(-W // tw)
    chunks = -(-cin // BK)
    wt = np.zeros((27, -(-cout // cv.SM90_BN) * cv.SM90_BN, chunks * BK),
                  np.float64)
    wt[:, :cout, :cin] = w.transpose(2, 3, 4, 0, 1).reshape(27, cout, cin)
    y = np.zeros((B, D, H, W, cout), np.float32)
    part = np.zeros((B * T, 2, cout), np.float32)
    for q in range(cv.sm90_tiles(B, D, H, W, cout, tile)):
        b, d0, h0, w0, n0 = cv.sm90_tile_origin(q, B, D, H, W, cout, tile)
        acc = np.zeros((td, th, tw, cv.SM90_BN), np.float64)
        for c in range(chunks):
            stage = _tma_halo(x, b, d0, h0, w0, c, tile)
            if pg is not None:
                stage = _prologue_stage(stage, x.shape, pg, pb, silu, b, d0,
                                        h0, w0, c, tile)
                if checked is not None:
                    checked.append((b, (d0, h0, w0), c, stage.copy()))
            box = _unswizzle(stage, tile).astype(np.float64)
            for tap, (kd, kh, kw) in enumerate(
                    itertools.product(range(3), repeat=3)):
                a = box[kd:kd + td, kh:kh + th, kw:kw + tw]
                acc += a @ wt[tap, n0:n0 + cv.SM90_BN,
                              c * BK:(c + 1) * BK].T
        vals = np.zeros((kmt * 128, cv.SM90_BN), np.float32)
        vals[:rows] = acc.reshape(rows, -1).astype(np.float32)
        ncol = min(cv.SM90_BN, cout - n0)
        vals[:rows, :ncol] = (vals[:rows, :ncol] + bias[n0:n0 + ncol]) \
            .astype(np.float32)
        valid = np.zeros(kmt * 128, bool)
        dz, hy, wx = np.unravel_index(np.arange(rows), (td, th, tw))
        inside = (d0 + dz < D) & (h0 + hy < H) & (w0 + wx < W)
        valid[:rows] = inside
        r_in = np.nonzero(inside)[0]
        vox = (d0 + dz[r_in], h0 + hy[r_in], w0 + wx[r_in])
        if skip is not None:
            vals[r_in, :ncol] = (vals[r_in, :ncol]
                                 + skip[(b,) + vox][:, n0:n0 + ncol]) \
                .astype(np.float32)
        y[(b,) + vox + (slice(n0, n0 + ncol),)] = _bf16(vals[r_in, :ncol])
        tile_sums = _tile_partial(vals, valid, kmt)
        part[q % (B * T), :, n0:n0 + ncol] = tile_sums[:, :ncol]
    stats = np.stack([_finish(part[b * T:(b + 1) * T]) for b in range(B)])
    return y, stats, part


def _fused_case(seed, B, dhw, cin, cout):
    rng = np.random.default_rng(seed)
    D, H, W = dhw
    x = _bf16(rng.normal(0.5, 2.0, (B, D, H, W, cin)))
    w = _bf16(rng.normal(size=(cout, cin, 3, 3, 3)) / np.sqrt(27 * cin))
    bias = (rng.normal(size=cout) * 0.1).astype(np.float32)
    pg = (0.5 * (1 + 0.1 * rng.normal(size=(B, cin)))).astype(np.float32)
    pb = (3.0 + 0.1 * rng.normal(size=(B, cin))).astype(np.float32)
    skip = _bf16(rng.normal(size=(B, D, H, W, cout)))
    return x, w, bias, pg, pb, skip


def _stats_close(st, ref_st, ref_out):
    abs_sum = np.abs(ref_out).sum(axis=(1, 2, 3))
    assert (np.abs(st[:, 0] - ref_st[:, 0]) <= STATS_TOL * abs_sum).all()
    assert (np.abs(st[:, 1] - ref_st[:, 1]) <= STATS_TOL * ref_st[:, 1]).all()


@pytest.mark.parametrize("dhw,cin,cout,silu", [
    ((5, 6, 13), 80, 136, True),   # ragged edges, a ragged chunk, Cout > 128
    ((7, 5, 13), 64, 24, False),   # ragged Cout inside one column tile
])
def test_fused_kernel_emulation_matches_plain(dhw, cin, cout, silu):
    """The producer's prologue on the swizzled stage equals the plain
    version's normalized input (padding and channels past Cin stay 0,
    though the shift makes silu(b) ~ 3), and the whole walk matches
    ``conv3d_fused_plain`` in bf16: output within OUT_TOL, stats within
    STATS_TOL."""
    x, w, bias, pg, pb, skip = _fused_case(3, 2, dhw, cin, cout)
    tile = fo.fused_tile(*dhw, cout)
    checked = []
    y, stats, _ = _emulate_fused(x, w, bias, pg, pb, silu, skip, tile,
                                 checked)
    # the plain prologue, padded: what every rewritten stage must hold
    xn = torch.from_numpy(x) * torch.from_numpy(pg)[:, None, None, None] \
        + torch.from_numpy(pb)[:, None, None, None]
    if silu:
        xn = xn * torch.sigmoid(xn)
    xn = np.pad(xn.bfloat16().float().numpy(),
                ((0, 0), (1, 1), (1, 1), (1, 1), (0, BK * -(-cin // BK) - cin)))
    td, th, tw = tile
    for b, (d0, h0, w0), c, stage in checked:
        want = xn[b, d0:d0 + td + 2, h0:h0 + th + 2, w0:w0 + tw + 2,
                  c * BK:(c + 1) * BK]
        got = _unswizzle(stage, tile)[:want.shape[0], :want.shape[1],
                                      :want.shape[2]]
        assert np.array_equal(got == 0, want == 0)
        np.testing.assert_allclose(got, want, rtol=2 ** -8, atol=0)
    tkw = dict(prologue_g=torch.from_numpy(pg), prologue_b=torch.from_numpy(pb),
               prologue_silu=silu, skip=torch.from_numpy(skip).bfloat16(),
               want_stats=True)
    ref, ref_st = fo.conv3d_fused_plain(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(w), torch.from_numpy(bias),
        **tkw)
    ref = ref.float().numpy()
    assert np.abs(y - ref).max() <= OUT_TOL * np.abs(ref).max()
    _stats_close(stats, ref_st.numpy(), ref)


def test_fused_kernel_emulation_matches_jax():
    """The emulated walk at (2, 5, 6, 16, 128) -> 256 (two column tiles,
    ragged tiles, per-sample prologue) against JAX's fused Pallas kernel
    interpreted in f32: output within OUT_TOL (the kernel rounds the
    normalized input and the output to bf16), stats within STATS_TOL of the
    f32 output's."""
    x, w, bias, pg, pb, skip = _fused_case(4, 2, (5, 6, 16), 128, 256)
    pb = (pb - 3.0).astype(np.float32)  # a folded GroupNorm's shift
    tile = fo.fused_tile(5, 6, 16, 256)
    y, stats, _ = _emulate_fused(x, w, bias, pg, pb, True, skip, tile)
    ref, ref_st = jax_conv3d_fused(
        jnp.asarray(x), jnp.asarray(w.transpose(2, 3, 4, 1, 0)),
        jnp.asarray(bias), prologue_g=jnp.asarray(pg),
        prologue_b=jnp.asarray(pb), skip=jnp.asarray(skip), want_stats=True,
        interpret=True)
    ref = np.asarray(ref)
    assert np.abs(y - ref).max() <= OUT_TOL * np.abs(ref).max()
    abs_sum = np.abs(ref).sum(axis=(1, 2, 3))
    ref_st = np.asarray(ref_st)
    assert (np.abs(stats[:, 0] - ref_st[:, 0]) <= 1e-2 * abs_sum).all()
    assert (np.abs(stats[:, 1] - ref_st[:, 1]) <= 1e-2 * ref_st[:, 1]).all()


def test_fused_stats_emulation_is_batch_invariant():
    """Volume 0's per-tile partials and stats in the kernel's order are
    equal bit for bit alone and at batch 2, and match the plain stats."""
    x, w, bias, pg, pb, skip = _fused_case(5, 2, (5, 6, 13), 64, 136)
    tile = fo.fused_tile(5, 6, 13, 136)
    T = cv.sm90_tiles(1, 5, 6, 13, 136, tile) // 2
    y2, st2, part2 = _emulate_fused(x, w, bias, pg, pb, True, skip, tile)
    y1, st1, part1 = _emulate_fused(x[:1], w, bias, pg[:1], pb[:1], True,
                                    skip[:1], tile)
    assert np.array_equal(part2[:T], part1)
    assert np.array_equal(st2[:1], st1) and np.array_equal(y2[:1], y1)
    tkw = dict(prologue_g=torch.from_numpy(pg), prologue_b=torch.from_numpy(pb),
               skip=torch.from_numpy(skip).bfloat16(), want_stats=True)
    ref, ref_st = fo.conv3d_fused_plain(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(w),
        torch.from_numpy(bias), **tkw)
    _stats_close(st2, ref_st.numpy(), ref.float().numpy())


# ------------------------------------------------------- K1 emulation --

@pytest.mark.parametrize("n", [96 ** 3, 96 * 48 * 48, 96 * 36, 1000, 33, 7])
def test_gn_stats_plan_depends_on_n_only(n):
    """Rows per split come from N alone (not the batch, not C or the
    dtype); every row lies in one split; at most 256 splits."""
    rows = gn.rows_per_split(n)
    plans = {(gn.stats_plan(n, c, dt)[:2]) for c in (32, 128, 1024)
             for dt in (torch.bfloat16, torch.float32)}
    assert plans == {(rows, -(-n // rows))}
    S = -(-n // rows)
    assert (S - 1) * rows < n <= S * rows
    assert S <= gn.STATS_SPLITS


def _gn_stats_emulated(x, dtype):
    """``gn_stats_kernel`` for x [B, N, C] (values of ``dtype``): per split
    and column slice, thread (lane, rp) adds rows r0 + rp, + rph, ... (the
    square by fmaf), the rp threads are added in order; the last block adds
    the splits: row lane l of RL adds splits l, l + RL, ..., then the lanes
    in order."""
    B, N, C = x.shape
    v = 8 if dtype == torch.bfloat16 else 4
    rows, S, CS = gn.stats_plan(N, C, dtype)
    cw = gn.STATS_LANES * v
    out = np.zeros((B, 2, C), np.float32)
    for b in range(B):
        for cs in range(CS):
            c0 = cs * cw
            vl = min(gn.STATS_LANES, (C - c0) // v)
            W = vl * v
            rph = gn.STATS_THREADS // vl
            parts = []
            for split in range(S):
                r0, r1 = split * rows, min(N, (split + 1) * rows)
                xs = x[b, r0:r1, c0:c0 + W]
                sums = []
                for rp in range(rph):
                    s = np.zeros(W, np.float32)
                    q = np.zeros(W, np.float32)
                    for r in range(rp, r1 - r0, rph):
                        s = (s + xs[r]).astype(np.float32)
                        q = _f32_fma(xs[r], xs[r], q)
                    sums.append(np.stack([s, q]))
                tot = sums[0]
                for a in sums[1:]:
                    tot = (tot + a).astype(np.float32)
                parts.append(tot)
            items = 2 * W // 4
            RL = gn.STATS_THREADS // items
            lanes = []
            for lane in range(RL):
                acc = np.zeros((2, W), np.float32)
                for sp in range(lane, S, RL):
                    acc = (acc + parts[sp]).astype(np.float32)
                lanes.append(acc)
            tot = lanes[0]
            for a in lanes[1:]:
                tot = (tot + a).astype(np.float32)
            out[b, :, c0:c0 + W] = tot
    return out


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("N,C", [(9000, 64), (300, 160)])
def test_gn_stats_emulation_matches_plain_and_jax(dtype, N, C):
    """K1's fixed-order sums (256 splits at N = 9000; a narrow second
    column slice at C = 160) match ``channel_stats_plain`` and JAX's
    ``channel_stats`` within 1e-5 of the sums of |x| and x^2, and volume
    1's are equal bit for bit alone and at batch 2."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(0.5, 2.0, (2, N, C)).astype(np.float32))
    x = x.to(dtype).float().numpy()
    st = _gn_stats_emulated(x, dtype)
    assert np.array_equal(st[1:], _gn_stats_emulated(x[1:], dtype))
    scale = np.stack([np.abs(x).sum(1), (x * x).sum(1)], axis=1)
    ref = gn.channel_stats_plain(torch.from_numpy(x)).numpy()
    assert (np.abs(st - ref) <= 1e-5 * scale).all()
    ref_jax = np.asarray(jnn.channel_stats(jnp.asarray(x.reshape(2, N, 1, 1, C))))
    assert (np.abs(st - ref_jax) <= 1e-5 * scale).all()
