"""Patch grids and whole-volume reconstruction (Hann blending).

Own numpy copy of ``ddpm3d_tpu/data/patches.py``:
  * training grid: XY stride 76 (20-voxel overlap) with an 80 % overlap
    guard, Z = {0, D-96};
  * inference grid: fixed XY starts ([0, 52, 104] for 200/96/3),
    Z = {0, D-96};
  * zero-padded patch extraction and 3-D Hann-window overlap blending,
    through the native C++ tier (:mod:`..native`) unless ``$DDPM3D_NATIVE``
    turns it off; the numpy bodies below are their plain versions.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def train_xy_starts(dim_size: int, patch_size: int, overlap: int = 20) -> List[int]:
    """Training-time XY starts (reference image_datasets.py:200-242)."""
    stride = patch_size - overlap
    max_overlap = int(patch_size * 0.8)
    starts = [0]
    pos = stride
    while pos + patch_size <= dim_size:
        prev_end = starts[-1] + patch_size
        if max(0, prev_end - pos) > max_overlap:
            pos += stride
            continue
        starts.append(pos)
        pos += stride
    last_end = starts[-1] + patch_size
    if last_end < dim_size:
        last_start = dim_size - patch_size
        if last_start > starts[-1]:
            prev_end = starts[-1] + patch_size
            if max(0, prev_end - last_start) <= max_overlap:
                starts.append(last_start)
    return starts


def train_z_starts(dim_size: int, patch_size: int) -> List[int]:
    """Training-time Z starts (reference image_datasets.py:244-262)."""
    max_overlap = int(patch_size * 0.8)
    starts = [0]
    if dim_size > patch_size:
        second = dim_size - patch_size
        if max(0, patch_size - second) <= max_overlap:
            starts.append(second)
    return starts


def test_xy_starts(dim_size: int, patch_size: int, num_patches: int = 3) -> List[int]:
    """Inference-time fixed XY starts (reference scripts/test.py:280-291)."""
    if dim_size == 200 and patch_size == 96 and num_patches == 3:
        return [0, 52, 104]
    if num_patches == 1:
        return [0]
    step = (dim_size - patch_size) / (num_patches - 1)
    starts = [int(i * step) for i in range(num_patches)]
    starts[-1] = min(starts[-1], dim_size - patch_size)
    return starts


def test_z_starts(dim_size: int, patch_size: int) -> List[int]:
    """Inference-time Z starts (reference scripts/test.py:293-299)."""
    if dim_size <= patch_size:
        return [0]
    return [0, dim_size - patch_size]


def patch_grid(
    x_starts: Sequence[int], y_starts: Sequence[int], z_starts: Sequence[int]
) -> List[Tuple[int, int, int]]:
    """x-major, then y, then z (the reference's loop nesting)."""
    return [(x, y, z) for x in x_starts for y in y_starts for z in z_starts]


def extract_patches_zxy(
    vol_zxy: np.ndarray,
    grid: Sequence[Tuple[int, int, int]],
    patch_size: int,
) -> np.ndarray:
    """Cut (Z, X, Y)-indexed patches, zero-padded at the high ends to a full
    ``patch_size^3`` cube. Returns [P, Z, X, Y] float32."""
    from .. import native

    if native.available():
        return native.extract_patches(
            np.asarray(vol_zxy, np.float32), list(grid), patch_size)
    return extract_patches_zxy_plain(vol_zxy, grid, patch_size)


def extract_patches_zxy_plain(
    vol_zxy: np.ndarray,
    grid: Sequence[Tuple[int, int, int]],
    patch_size: int,
) -> np.ndarray:
    """numpy version of :func:`extract_patches_zxy`."""
    Z, X, Y = vol_zxy.shape
    out = np.zeros((len(grid), patch_size, patch_size, patch_size), np.float32)
    for i, (x0, y0, z0) in enumerate(grid):
        patch = vol_zxy[z0:min(z0 + patch_size, Z), x0:min(x0 + patch_size, X),
                        y0:min(y0 + patch_size, Y)]
        out[i, : patch.shape[0], : patch.shape[1], : patch.shape[2]] = patch
    return out


def hann_window_3d(size: int) -> np.ndarray:
    """Separable 3-D Hann window normalised to max 1. hanning(n) is zero at
    both ends, so un-overlapped volume borders get zero weight."""
    h = np.hanning(size)
    w = h[:, None, None] * h[None, :, None] * h[None, None, :]
    return (w / w.max()).astype(np.float32)


def blend_patches_hann(
    patches_xyz: np.ndarray,
    grid: Sequence[Tuple[int, int, int]],
    out_shape_xyz: Tuple[int, int, int],
    patch_size: int,
    window: np.ndarray = None,
) -> np.ndarray:
    """Hann-weighted overlap-add of [P, X, Y, Z] patches (grid order) into
    the (X, Y, Z) volume; voxels whose accumulated weight is 0 stay 0.
    ``window`` defaults to :func:`hann_window_3d`."""
    if window is None:
        window = hann_window_3d(patch_size)
    from .. import native

    if native.available():
        return native.blend_hann(
            np.asarray(patches_xyz, np.float32), list(grid),
            tuple(out_shape_xyz), patch_size, window)
    return blend_patches_hann_plain(
        patches_xyz, grid, out_shape_xyz, patch_size, window)


def blend_patches_hann_plain(
    patches_xyz: np.ndarray,
    grid: Sequence[Tuple[int, int, int]],
    out_shape_xyz: Tuple[int, int, int],
    patch_size: int,
    window: np.ndarray = None,
) -> np.ndarray:
    """numpy version of :func:`blend_patches_hann`."""
    if window is None:
        window = hann_window_3d(patch_size)
    X, Y, Z = out_shape_xyz
    acc = np.zeros(out_shape_xyz, np.float32)
    weight = np.zeros(out_shape_xyz, np.float32)
    for patch, (x0, y0, z0) in zip(patches_xyz, grid):
        xe, ye, ze = min(x0 + patch_size, X), min(y0 + patch_size, Y), min(z0 + patch_size, Z)
        hx, wy, dz = xe - x0, ye - y0, ze - z0
        w = window[:hx, :wy, :dz]
        acc[x0:xe, y0:ye, z0:ze] += patch[:hx, :wy, :dz] * w
        weight[x0:xe, y0:ye, z0:ze] += w
    return np.divide(acc, weight, out=np.zeros_like(acc), where=weight > 0)


def blend_patches_count(
    patches_xyz: np.ndarray,
    grid: Sequence[Tuple[int, int, int]],
    out_shape_xyz: Tuple[int, int, int],
    patch_size: int,
) -> Tuple[np.ndarray, int]:
    """Plain count averaging of overlapping patches. Returns (volume,
    number of voxels covered by no patch)."""
    X, Y, Z = out_shape_xyz
    acc = np.zeros(out_shape_xyz, np.float32)
    count = np.zeros(out_shape_xyz, np.float32)
    for patch, (x0, y0, z0) in zip(patches_xyz, grid):
        xe, ye, ze = min(x0 + patch_size, X), min(y0 + patch_size, Y), min(z0 + patch_size, Z)
        acc[x0:xe, y0:ye, z0:ze] += patch[: xe - x0, : ye - y0, : ze - z0]
        count[x0:xe, y0:ye, z0:ze] += 1.0
    uncovered = int((count == 0).sum())
    out = np.divide(acc, count, out=np.zeros_like(acc), where=count > 0)
    return out, uncovered
