"""Host-side rules of the port's 3x3x3 conv (ddpm3d_tpu_torch.ops.conv3d):
which kernel takes which conv (``csrc/conv3d_sm90.cu`` for the torso,
``csrc/conv3d_narrow.cu`` for the bf16 Cin = 2 input conv,
``csrc/conv3d_head.cu`` for the f32 head conv and its dx), the tiles and
work items of the Hopper kernel ``csrc/conv3d_sm90.cu``, and the windows
and D segments of the head kernel. Pure Python, on the CPU; the kernels
themselves are held against their plain versions on the card
(tests/test_torch_port_cuda.py, chip_smoke.py).
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

# the five volumes of the production model at 96^3 (D stays, H = W halve)
VOLUMES = [(96, 96, 96), (96, 48, 48), (96, 24, 24), (96, 12, 12), (96, 6, 6)]
SMALL_HW = 16  # the model is run at (1, 16, 16): H, W -> 96 * H / 16


@pytest.fixture(scope="module")
def main_path_convs():
    """Every conv of one bf16 forward of the production model (the flags
    of ``chip_smoke.py:_model``) at 96^3, as (D, H, W, Cin, Cout, dtype) ->
    calls. Read by forward pre-hooks from a forward at (1, 16, 16) with
    uninitialised weights (only shapes matter) and scaled to 96^3: the
    widths per level do not depend on the volume."""
    args = sr_model_and_diffusion_defaults()
    args.update(
        large_size=96, num_channels=128, num_res_blocks=2, learn_sigma=True,
        use_fp16=True, use_scale_shift_norm=True, resblock_updown=True,
        attention_resolutions="1000", num_head_channels=64,
        diffusion_steps=1000, noise_schedule="linear",
    )
    model, _, _ = sr_create_model_and_diffusion(**args)
    convs = collections.Counter()

    def hook(mod, inputs):
        _, _, H, W, cin = inputs[0].shape
        scale = 96 // SMALL_HW
        convs[(96, H * scale, W * scale, cin, mod.weight.shape[0],
               inputs[0].dtype)] += 1

    for m in model.modules():
        if isinstance(m, Conv3x3x3):
            m.register_forward_pre_hook(hook)
    x = torch.zeros((1, 1, SMALL_HW, SMALL_HW, 1))
    with torch.no_grad():
        model(x, torch.tensor([500]), low_res=x)
    return convs


def test_main_path_takes_the_sm90_kernel(main_path_convs):
    """70 of the forward's 72 convs (22 distinct bf16 torso shapes) take the
    sm90 kernel, the Cin = 2 input conv the narrow one, the f32 head conv
    the head kernel; none is left on csrc/conv3d.cu."""
    assert sum(main_path_convs.values()) == 72
    routes = collections.Counter()
    by_route = collections.defaultdict(set)
    for (D, H, W, cin, cout, dt), n in main_path_convs.items():
        route = cv.conv3d_route((1, D, H, W, cin), dt, cout)
        routes[route] += n
        by_route[route].add((cin, cout, dt))
    assert routes == {"sm90": 70, "sm90_narrow": 1, "f32_head": 1}
    assert by_route["sm90_narrow"] == {(2, 128, torch.bfloat16)}
    assert by_route["f32_head"] == {(128, 2, torch.float32)}
    torso = [k for k in main_path_convs
             if cv.conv3d_route((1,) + k[:3] + (k[3],), k[5], k[4]) == "sm90"]
    assert len(torso) == 22
    assert {k[:3] for k in torso} == set(VOLUMES)


def test_training_dx_takes_the_sm90_kernel(main_path_convs):
    """The dx of a training step runs the conv on dy (Cout channels) with
    the swapped weight (Cout -> Cin): every torso dx takes the sm90 kernel,
    the head's f32 dx (2 -> 128) the f32 narrow one; the input conv has no
    dx (its input needs no grad)."""
    routes = collections.Counter()
    for (D, H, W, cin, cout, dt), n in main_path_convs.items():
        if cin == 2:
            continue
        routes[cv.conv3d_route((1, D, H, W, cout), dt, cin)] += n
    assert routes == {"sm90": 70, "f32_narrow": 1}


@pytest.mark.parametrize("shape,dtype,cout,route", [
    ((1, 4, 8, 8, 128), torch.bfloat16, 128, "sm90"),
    ((2, 5, 7, 9, 8), torch.bfloat16, 16, "sm90"),  # smallest aligned Cin
    ((1, 4, 8, 8, 128), torch.bfloat16, 2, "sm90"),  # a bf16 head
    ((1, 4, 8, 8, 2), torch.bfloat16, 128, "sm90_narrow"),  # the input conv
    ((1, 4, 8, 8, 1), torch.bfloat16, 128, "sm90_cin1"),  # Seg encoder input
    ((1, 4, 8, 8, 2), torch.float32, 128, "f32_narrow"),  # f32 input conv
    ((1, 4, 8, 8, 2), torch.float32, 2, "f32_narrow"),  # Cin = 2 goes first
    ((1, 4, 8, 8, 128), torch.float32, 2, "f32_head"),  # the head conv
    ((1, 4, 8, 8, 40), torch.float32, 8, "f32_head"),  # widest instance
    ((1, 4, 8, 8, 40), torch.float32, 9, "f32"),  # past the head's Cout
    ((1, 4, 8, 8, 6), torch.float32, 2, "f32"),  # rows not 16-byte strided
    ((1, 4, 8, 8, 1024), torch.float32, 8, "f32"),  # weight past the smem
    ((1, 4, 8, 8, 3), torch.bfloat16, 8, "ndhwc"),  # other narrow Cin
    ((1, 4, 8, 8, 130), torch.bfloat16, 8, "ndhwc"),  # rows not 16-byte strided
    ((1, 4, 8, 8, 128), torch.float32, 128, "f32"),  # f32 models' torso
])
def test_conv3d_route(shape, dtype, cout, route):
    assert cv.conv3d_route(shape, dtype, cout) == route


@pytest.mark.parametrize("rows", [256, 128])
@pytest.mark.parametrize("dhw", VOLUMES + [
    (8, 48, 48), (6, 12, 12), (4, 6, 6), (5, 7, 9), (97, 13, 11), (1, 1, 1),
    (3, 300, 2),
])
def test_conv3d_sm90_tiles_fit_the_kernel(dhw, rows):
    """pick_tile_sm90's tile fits the kernel's row, halo, TMA box and shared
    memory limits, and never exceeds the volume; a tile of at most 128 rows
    runs the kernel's 128-row instance."""
    tile = cv.pick_tile_sm90(*dhw, rows)
    td, th, tw = tile
    assert td * th * tw <= rows <= cv.SM90_MAX_ROWS
    assert cv.sm90_halo(tile) <= cv.SM90_MAX_HALO
    assert max(td, th, tw) + 2 <= 256  # a TMA box dimension
    assert cv.sm90_smem_bytes(tile) <= cv.SM90_SMEM_LIMIT
    assert td <= dhw[0] and th <= dhw[1] and tw <= dhw[2]


def test_conv3d_sm90_tiles_at_the_main_volumes():
    """The production volumes get tiles of 256 (or 252) rows, TW = 8 where
    the plane allows it (conflict-free ldmatrix)."""
    tiles = [cv.pick_tile_sm90(*v) for v in VOLUMES]
    assert tiles == [(8, 4, 8), (8, 4, 8), (8, 4, 8), (7, 6, 6), (7, 6, 6)]
    assert [cv.sm90_tiles(1, *v, 128, t) for v, t in zip(VOLUMES, tiles)] == [
        3456, 864, 216, 56, 14]


def test_conv3d_sm90_tile_choice_on_the_main_path(main_path_convs):
    """Per launch (forward and dx), 256-row tiles unless 128-row ones cut
    waves x rows per tile by a quarter on 132 SMs: always 256 at 96^3,
    96x48^2 and 96x24^2; 128 for every 96x6^2 forward conv."""
    def cost(tile, co):
        rows = 128 if tile[0] * tile[1] * tile[2] <= 128 else 256
        return -(-cv.sm90_tiles(1, D, H, W, co, tile) // 132) * rows

    for (D, H, W, cin, cout, dt) in main_path_convs:
        if cv.conv3d_route((1, D, H, W, cin), dt, cout) != "sm90":
            continue
        for co in (cout, cin):  # the forward, then the dx (Cout = Cin)
            tile = cv.sm90_tile(1, D, H, W, co)
            big = cv.pick_tile_sm90(D, H, W)
            small = cv.pick_tile_sm90(D, H, W, 128)
            assert tile == (small if cost(small, co) <= 0.75 * cost(big, co)
                            else big)
            if H >= 24:
                assert tile == big
        if H == 6:
            assert cv.sm90_tile(1, D, H, W, cout) == small


def test_conv3d_sm90_smem_matches_the_kernel_layout():
    """At 8x4x8: two 600-voxel halo stages of 76.8 KB, four 16 KB weight
    stages, 14 barriers (the fused instance's hnorm pair among them), the
    256-row table and 1 KB of alignment slack; the largest halo still fits
    the block's shared memory."""
    assert cv.sm90_smem_bytes((8, 4, 8)) == (
        1024 + 2 * 76800 + 4 * 16384 + 112 + 1024)
    assert cv.sm90_halo((14, 2, 8)) == cv.SM90_MAX_HALO
    assert cv.sm90_smem_bytes((14, 2, 8)) <= cv.SM90_SMEM_LIMIT


@pytest.mark.parametrize("B,dhw,cout", [
    (1, (96, 24, 24), 256), (2, (5, 7, 9), 128), (1, (6, 12, 12), 384),
    (1, (4, 6, 6), 130),
])
def test_conv3d_sm90_work_items_cover_the_output_once(B, dhw, cout):
    """The work items' tiles (``decode_tile``) cover every output voxel and
    128-column tile exactly once; each halo box starts one voxel before its
    tile, so TMA's zero fill is the SAME padding."""
    D, H, W = dhw
    tile = cv.pick_tile_sm90(D, H, W)
    td, th, tw = tile
    total = cv.sm90_tiles(B, D, H, W, cout, tile)
    seen = collections.Counter()
    for q in range(total):
        b, d0, h0, w0, n0 = cv.sm90_tile_origin(q, B, D, H, W, cout, tile)
        assert 0 <= b < B and n0 < cout and n0 % cv.SM90_BN == 0
        assert d0 % td == h0 % th == w0 % tw == 0
        assert d0 < D and h0 < H and w0 < W
        for d, h, w in itertools.product(range(d0, min(d0 + td, D)),
                                         range(h0, min(h0 + th, H)),
                                         range(w0, min(w0 + tw, W))):
            seen[(b, d, h, w, n0)] += 1
    n_col = -(-cout // cv.SM90_BN)
    assert len(seen) == B * D * H * W * n_col
    assert set(seen.values()) == {1}


@pytest.mark.parametrize("cout", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("B,dhw", [(1, v) for v in VOLUMES] + [
    (2, (5, 7, 9)), (1, (97, 13, 11)), (2, (1, 1, 1)), (1, (96, 6, 6)),
    (1, (3, 70, 33)),
])
def test_head_blocks_cover_the_output_once(B, dhw, cout):
    """The head kernel's blocks (``head_block``, the kernel's decode of
    blockIdx.x) store every output voxel exactly once: windows tile (H, W),
    segments tile D and never come out empty; the segments alternate
    direction and do not depend on the batch; the block's shared memory
    fits at the model's Cin."""
    D, H, W = dhw
    n_h, n_w, nseg = cv.head_plan(D, H, W, cout)
    th, tw = cv.head_tile(cout)
    assert 1 <= nseg <= D and n_h * th >= H and n_w * tw >= W
    seen = np.zeros((B, D, H, W), np.int32)
    for q in range(B * nseg * n_h * n_w):
        b, d0, d1, h0, w0, up = cv.head_block(q, B, D, H, W, cout)
        assert d0 < d1 and h0 < H and w0 < W
        assert up == ((q // (n_h * n_w)) % nseg % 2 == 0)
        seen[b, d0:d1, h0:h0 + th, w0:w0 + tw] += 1
    assert (seen == 1).all()
    assert cv.head_smem_bytes(128, cout) <= cv.SM90_SMEM_LIMIT


def test_head_plan_fills_the_card_at_the_main_volume():
    """At 96^3 the head runs 3 x 6 windows of 32 x 16 and 14 segments of 6
    or 7 planes: 252 blocks, two per SM on 132 SMs, with 107,072 bytes of
    shared memory each (27,648 of weight, two 39,712-byte plane buffers)."""
    assert cv.head_tile(2) == (32, 16)
    assert cv.head_plan(96, 96, 96, 2) == (3, 6, 14)
    assert cv.head_smem_bytes(128, 2) == 27648 + 2 * 39712
    lengths = {d1 - d0 for d0, d1 in (
        cv.head_block(q, 1, 96, 96, 96, 2)[1:3] for q in range(252))}
    assert lengths == {6, 7}
