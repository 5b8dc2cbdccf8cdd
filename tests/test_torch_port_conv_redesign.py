"""The host side of the f32 conv (``csrc/conv3d_f32.cu``) and of the Cin = 1
input conv (``csrc/conv3d_narrow.cu``'s Cin = 1 instance), on the CPU.

Neither kernel runs here (no nvcc, no card), so their index arithmetic is
emulated in torch: the f32 kernel's tiles, thread rows, halo gather per
8-channel chunk and tap row, read against :func:`pack_weight_f32`'s
[27, Cin, Cout] layout; the narrow kernel's A fragments, register by
register, against :func:`pack_weight_narrow`'s folded K. Each emulation
must equal ``conv3d_plain``. Also the f32 kernel's host arithmetic (tile,
shared memory, two blocks per SM) at every distinct shape of the f32 model,
whose output voxels the tiles must cover exactly once, and the f32 model's
routes (forward and dx) on the CPU.
"""

import collections
import itertools

import numpy as np
import pytest
import torch

from ddpm3d_tpu_torch.models.factory import sr_create_model_and_diffusion
from ddpm3d_tpu_torch.models.nn import Conv3x3x3
from ddpm3d_tpu_torch.ops import conv3d as cv
from ddpm3d_tpu_torch.utils.config import sr_model_and_diffusion_defaults


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads for this file's tests and fixtures (the suite's
    workers share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


# f32: the emulation sums in another order than F.conv3d, both in f32
F32_REL = 1e-6
# bf16 inputs: every product is exact in f32, so only the order of the f32
# sums differs
BF16_F32_SUM_REL = 1e-6
# the f32 model's volumes: the production 96^3 levels (D stays, H = W
# halve) and the chip check's [8, 32, 32] levels
VOLUMES = [(96, 96, 96), (96, 48, 48), (96, 24, 24), (96, 12, 12),
           (96, 6, 6), (8, 32, 32), (8, 16, 16), (8, 8, 8), (8, 4, 4),
           (8, 2, 2)]
SM_SHARED = 233472  # shared memory of one H100 SM (228 KB)
SM_RESERVED = 1024  # per block, reserved by the runtime


def _inputs(seed, shape, cout, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    cin = shape[-1]
    x = torch.randn(shape, generator=g).to(dtype)
    w = (torch.randn((cout, cin, 3, 3, 3), generator=g)
         / (27 * cin) ** 0.5).to(dtype)
    return x, w


def _emulate_f32(x, wp, cout):
    """``conv3d_f32_kernel``'s arithmetic, as its indices say: per spatial
    tile (``f32_tile_origin``) and 128-column tile, the halo of each
    8-channel chunk as [voxel][8] (zero outside the volume and past Cin),
    per tap row (kd, kh) of the chunk each thread's A values at halo voxels
    base + i + kw and B from the packed weight's [tap][ci][co]; the rows
    stored where ``f32_thread_rows`` says. Returns the output and how often
    each output element was stored."""
    B, D, H, W, cin = x.shape
    tile = cv.pick_tile_f32(D, H, W)
    td, th = tile
    HH, HW = th + 2, cv.F32_TW + 2
    nD, nH, nW = -(-D // td), -(-H // th), -(-W // cv.F32_TW)
    chunks = -(-cin // cv.F32_BK)
    cpad = chunks * cv.F32_BK
    # the zero padding: one voxel before, up to a whole tile after
    xp = torch.zeros((B, nD * td + 2, nH * th + 2, nW * cv.F32_TW + 2, cpad))
    xp[:, 1:D + 1, 1:H + 1, 1:W + 1, :cin] = x
    wpad = torch.zeros((27, cpad, cout))
    wpad[:, :cin] = wp
    y = torch.zeros((B, D, H, W, cout))
    stored = torch.zeros((B, D, H, W, cout), dtype=torch.int32)
    # per row (line dz * TH + hy, voxel i) and tap: its halo voxel
    hidx = torch.empty((27, cv.F32_LINES * cv.F32_TW), dtype=torch.long)
    for line, i in itertools.product(range(cv.F32_LINES), range(cv.F32_TW)):
        dz, hy = divmod(line, th)
        for kd, kh, kw in itertools.product(range(3), repeat=3):
            hidx[9 * kd + 3 * kh + kw, line * cv.F32_TW + i] = (
                ((dz + kd) * HH + hy + kh) * HW + i + kw)
    for q in range(cv.f32_tiles(B, D, H, W, tile)):
        b, d0, h0, w0 = cv.f32_tile_origin(q, B, D, H, W, tile)
        halo = xp[b, d0:d0 + td + 2, h0:h0 + th + 2,
                  w0:w0 + HW].reshape(-1, cpad)
        for n0 in range(0, cout, cv.F32_BN):
            n1 = min(cout, n0 + cv.F32_BN)
            acc = torch.zeros((cv.F32_LINES * cv.F32_TW, n1 - n0))
            for c in range(chunks):
                ks = slice(c * cv.F32_BK, (c + 1) * cv.F32_BK)
                for tap in range(27):
                    acc += halo[hidx[tap], ks] @ wpad[tap, ks, n0:n1]
            for tid in range(cv.F32_THREADS):
                rows, cols = cv.f32_thread_rows(tid, tile)
                for i, (dz, hy, wx) in enumerate(rows):
                    d, h, w = d0 + dz, h0 + hy, w0 + wx
                    if d >= D or h >= H or w >= W:
                        continue
                    for col in cols:
                        if n0 + col < n1:
                            r = (dz * th + hy) * cv.F32_TW + wx
                            y[b, d, h, w, n0 + col] = acc[r, col]
                            stored[b, d, h, w, n0 + col] += 1
    return y, stored


@pytest.mark.parametrize("shape,cout", [
    ((2, 5, 7, 9, 12), 20),    # ragged tiles on every axis, Cin not a chunk
    ((1, 3, 4, 16, 16), 136),  # two column tiles, the second ragged
])
def test_f32_packing_and_indexing_emulated(shape, cout):
    """pack_weight_f32's [27, Cin, Cout] read by the kernel's halo, tap and
    thread-row indices equals conv3d_plain (f32, <= 1e-6 of max |ref|), and
    every output element is stored exactly once."""
    x, w = _inputs(0, shape, cout)
    wp = cv.pack_weight_f32(w)
    assert wp.shape == (27, shape[-1], cout) and wp.dtype == torch.float32
    assert cv.packed_cout(wp) == cout
    y, stored = _emulate_f32(x, wp, cout)
    ref = cv.conv3d_plain(x, w)
    assert (stored == 1).all()
    assert (y - ref).abs().max() <= F32_REL * ref.abs().max()


def test_f32_dx_packing_emulated():
    """The dx packing (pack_weight_dx on the f32 route: the flipped,
    in/out-swapped weight in the same layout) run through the emulation is
    conv3d_dx_plain."""
    x, w = _inputs(1, (1, 4, 5, 10, 24), 16)
    dy = torch.randn((1, 4, 5, 10, 16), generator=torch.Generator()
                     .manual_seed(2))
    assert cv.conv3d_route(dy.shape, torch.float32, 24) == "f32"
    wpd = cv.pack_weight_dx(w, torch.float32)
    assert wpd.shape == (27, 16, 24)
    dx, stored = _emulate_f32(dy, wpd, 24)
    ref = cv.conv3d_dx_plain(dy, w)
    assert (stored == 1).all()
    assert (dx - ref).abs().max() <= F32_REL * ref.abs().max()


@pytest.mark.parametrize("cin", [1, 2])
def test_narrow_fragments_hold_the_packed_k(cin):
    """Each A register of the narrow kernel holds k = 16 ks + 2 tq (+ 8 for
    registers 2 and 3) and the next k, as wgmma's fragment layout reads
    them, and the (tap, ci) it loads there is the packed K's k = Cin * tap
    + ci: at Cin = 1 a register pairs taps 2j and 2j + 1 of one voxel, at
    Cin = 2 it is one tap's two channels. Every k below 27 * Cin is loaded
    once per row; the padding k are never loaded from a tap."""
    kk = cv.narrow_k(cin)
    seen = collections.Counter()
    for ks, tq, reg in itertools.product(range(kk // 16), range(4), range(4)):
        lo, hi = cv.narrow_fragment_taps(cin, ks, tq, reg)
        k = 16 * ks + 2 * tq + (8 if reg >= 2 else 0)
        assert cin * lo[0] + lo[1] == k and cin * hi[0] + hi[1] == k + 1
        if cin == 1:
            assert hi[0] == lo[0] + 1 and lo[0] % 2 == 0
        else:
            assert hi[0] == lo[0]
        seen[(reg % 2, k)] += 1
        seen[(reg % 2, k + 1)] += 1
    assert set(seen.values()) == {1}
    assert len(seen) == 2 * kk


@pytest.mark.parametrize("cin", [1, 2])
@pytest.mark.parametrize("B,dhw", [(1, (3, 5, 7)), (2, (2, 4, 3))])
def test_narrow_packing_emulated(cin, B, dhw):
    """pack_weight_narrow's [Cout, 32 Cin] with A assembled register by
    register from what the kernel loads (zero outside the volume and for
    taps past 27), a 64-row slice at a time over the flattened voxels: the
    f32 sums equal the f32 conv of the bf16 values (products exact), and
    one bf16 rounding of them is conv3d_plain but for sums within one
    rounding of a bf16 tie."""
    D, H, W = dhw
    cout = 40
    x, w = _inputs(3 + cin, (B, D, H, W, cin), cout, torch.bfloat16)
    wp = cv.pack_weight_narrow(w, torch.bfloat16)
    assert wp.shape == (cout, cv.narrow_k(cin))
    assert (wp[:, 27 * cin:] == 0).all()
    xp = torch.zeros((B, D + 2, H + 2, W + 2, cin))
    xp[:, 1:-1, 1:-1, 1:-1] = x.float()
    M = B * D * H * W
    rows = -(-M // 64) * 64
    A = torch.full((rows, cv.narrow_k(cin)), float("nan"))

    def tap_value(m, tap, ci):
        if m >= M or tap >= 27:
            return 0.0
        b, rem = divmod(m, D * H * W)
        d, rem = divmod(rem, H * W)
        h, ww = divmod(rem, W)
        kd, kh, kw = tap // 9, tap // 3 % 3, tap % 3
        return xp[b, d + kd, h + kh, ww + kw, ci].item()

    for m0 in range(0, rows, 16):  # one warp's 16 rows
        for g, tq in itertools.product(range(8), range(4)):
            for ks, reg in itertools.product(range(cv.narrow_k(cin) // 16),
                                             range(4)):
                row = m0 + g + (8 if reg % 2 else 0)
                k = 16 * ks + 2 * tq + (8 if reg >= 2 else 0)
                lo, hi = cv.narrow_fragment_taps(cin, ks, tq, reg)
                A[row, k] = tap_value(row, *lo)
                A[row, k + 1] = tap_value(row, *hi)
    assert not torch.isnan(A).any()
    y32 = (A @ wp.float().T)[:M].reshape(B, D, H, W, cout)
    ref32 = cv.conv3d_plain(x.float(), w.float())
    assert (y32 - ref32).abs().max() <= BF16_F32_SUM_REL * ref32.abs().max()
    ref = cv.conv3d_plain(x, w)
    assert (y32.bfloat16() != ref).float().mean() <= 0.01
    assert (y32.bfloat16().float() - ref.float()).abs().max() <= (
        2 ** -8 * ref.float().abs().max())


@pytest.mark.parametrize("dhw", VOLUMES)
def test_f32_tiles_fit_and_cover_once(dhw):
    """At every volume of the f32 model: TD * TH = 16 lines of 8, the halo
    fits the kernel's buffers, the plain and fused instances' shared
    memory lets two blocks share an SM, the tiles do not depend on the
    batch, and at batch 1 and 2 the tiles' thread rows store every output
    voxel of every 128-column tile exactly once."""
    D, H, W = dhw
    tile = cv.pick_tile_f32(D, H, W)
    td, th = tile
    assert td * th == cv.F32_LINES
    assert (td + 2) * (th + 2) * (cv.F32_TW + 2) <= cv.F32_MAX_HALO
    for fused in (False, True):
        smem = cv.f32_smem_bytes(fused)
        assert smem <= cv.SM90_SMEM_LIMIT
        assert 2 * (smem + SM_RESERVED) <= SM_SHARED
    by_line = collections.defaultdict(list)  # the threads' (line, columns)
    for tid in range(cv.F32_THREADS):
        rows, cols = cv.f32_thread_rows(tid, tile)
        assert [r[2] for r in rows] == list(range(cv.F32_TW))
        by_line[rows[0][:2]] += cols
    assert len(by_line) == cv.F32_LINES
    for cols in by_line.values():  # 16 threads, 128 columns, each once
        assert sorted(cols) == list(range(cv.F32_BN))
    lines = np.array(sorted(by_line))
    for B in (1, 2):
        seen = np.zeros((B, D, H, W), np.int32)
        for q in range(cv.f32_tiles(B, D, H, W, tile)):
            b, d0, h0, w0 = cv.f32_tile_origin(q, B, D, H, W, tile)
            assert d0 % td == h0 % th == w0 % cv.F32_TW == 0
            for dz, hy in lines:
                d, h = d0 + dz, h0 + hy
                if d < D and h < H:
                    seen[b, d, h, w0:w0 + cv.F32_TW] += 1
        assert (seen == 1).all()


def test_f32_smem_matches_the_kernel_layout():
    """The staged halo (540 voxels x 8 floats), the transposed one (8 rows
    of 548), three 12 KB tap-row units and the 540-entry voxel table
    (73,840 bytes); fused, also the 8 warps' [2][128] stats sums; the fused
    epilogue's [128][132] tile fits over the halo and the ring. At 96^3
    the 4 x 4 x 8 tile (a 360-voxel halo, 6912 tiles)."""
    assert cv.f32_smem_bytes(False) == 4 * (540 * 8 + 8 * 548 + 3 * 3072
                                            + 540) == 73840
    assert cv.f32_smem_bytes(True) == 73840 + 8 * 2 * 128 * 4
    assert 128 * 132 <= 540 * 8 + 8 * 548 + 3 * 3072
    assert cv.F32_HALO_PITCH >= cv.F32_MAX_HALO
    assert cv.pick_tile_f32(96, 96, 96) == (4, 4)
    assert cv.f32_tiles(1, 96, 96, 96, (4, 4)) == 6912
    assert cv.pick_tile_f32(96, 6, 6) == (8, 2)


def test_f32_warp_lines_hit_distinct_banks():
    """At the 4 x 4 x 8 tile a warp's 8 lines read one transposed halo row
    at 8 bases that fall in distinct 4-byte banks (8-byte loads: bank
    pairs), for every tap row: the A loads are conflict-free."""
    tile = (4, 4)
    th = tile[1]
    hh, hw = th + 2, cv.F32_TW + 2
    for warp in range(cv.F32_WARPS):
        lines = {cv.f32_thread_rows(warp * 32 + lane, tile)[0][0][:2]
                 for lane in range(32)}
        assert len(lines) == 8
        for kd, kh in itertools.product(range(3), repeat=2):
            for j in range(0, hw, 2):
                banks = [(((dz + kd) * hh + hy + kh) * hw + j) % 32 // 2
                         for dz, hy in lines]
                assert len(set(banks)) == 8


@pytest.fixture(scope="module")
def f32_model_convs():
    """Every conv of one f32 forward of the production model, (D, H, W,
    Cin, Cout) -> calls, from a forward at (1, 16, 16) with uninitialised
    weights (only shapes matter)."""
    args = sr_model_and_diffusion_defaults()
    args.update(
        large_size=96, num_channels=128, num_res_blocks=2, learn_sigma=True,
        use_fp16=False, use_scale_shift_norm=True, resblock_updown=True,
        attention_resolutions="1000", num_head_channels=64,
        diffusion_steps=1000, noise_schedule="linear",
    )
    model, _, _ = sr_create_model_and_diffusion(**args)
    convs = collections.Counter()

    def hook(mod, inputs):
        assert inputs[0].dtype == torch.float32
        _, D, H, W, cin = inputs[0].shape
        convs[(D, H, W, cin, mod.weight.shape[0])] += 1

    for m in model.modules():
        if isinstance(m, Conv3x3x3):
            m.register_forward_pre_hook(hook)
    x = torch.zeros((1, 1, 16, 16, 1))
    with torch.no_grad():
        model(x, torch.tensor([500]), low_res=x)
    return convs


def test_f32_model_routes(f32_model_convs):
    """The f32 model's 72 convs: 70 on the f32 kernel, the Cin = 2 input
    conv on f32_narrow, the head on f32_head; the dx of a training step
    (no input-conv dx): 70 on the f32 kernel, the head's on f32_narrow."""
    fwd, dx = collections.Counter(), collections.Counter()
    for (D, H, W, cin, cout), n in f32_model_convs.items():
        fwd[cv.conv3d_route((1, D, H, W, cin), torch.float32, cout)] += n
        if cin != 2:
            dx[cv.conv3d_route((1, D, H, W, cout), torch.float32, cin)] += n
    assert fwd == {"f32": 70, "f32_narrow": 1, "f32_head": 1}
    assert dx == {"f32": 70, "f32_narrow": 1}
