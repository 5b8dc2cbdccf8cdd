"""Training data: deterministic patch grids over low/high-dose volumes.

Own copy of ``ddpm3d_tpu/data/dataset.py`` (numpy only): recursive file
discovery, the per-volume overlapping patch index, ``/4`` normalisation,
the shard-by-rank file split, the legacy random-crop mode, an infinite
shuffled batch generator whose order comes from ``np.random.default_rng
(seed)`` (so batches equal the JAX package's for the same seed and files)
and a prefetch thread; the whole-volume dataset; and the 2-D PIL crops of
the upstream image path (PIL is imported only when a crop is called).
Batches are NDHWC float32 numpy arrays.
"""

from __future__ import annotations

import math
import os
import queue as queue_mod
import threading
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np

from . import tiff_io
from .patches import patch_grid, train_xy_starts, train_z_starts

_IMAGE_EXTS = {"jpg", "jpeg", "png", "gif", "tif", "tiff", "npz", "npy"}


def list_image_files_recursively(data_dir: str) -> List[str]:
    """Image files under ``data_dir``, sorted per directory, recursing into
    subdirectories in place."""
    results = []
    for entry in sorted(os.listdir(data_dir)):
        full_path = os.path.join(data_dir, entry)
        ext = entry.split(".")[-1]
        if "." in entry and ext.lower() in _IMAGE_EXTS:
            results.append(full_path)
        elif os.path.isdir(full_path):
            results.extend(list_image_files_recursively(full_path))
    return results


def load_volume_pair(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """A volume file -> (low, high) (D, H, W) float32. A 3-D volume
    conditions on itself; a 4-D (C, D, H, W) stack gives channel 0 (low
    dose) and channel 1 (high dose). ``.npz`` (``arr_0``) and ``.npy`` follow
    the same convention."""
    ext = os.path.splitext(path)[1].lower()
    if ext in (".tif", ".tiff"):
        vol = tiff_io.imread(path)
    elif ext == ".npz":
        vol = np.load(path)["arr_0"]
    elif ext == ".npy":
        vol = np.load(path)
    else:
        raise ValueError(f"unsupported file type: {ext}")
    vol = np.asarray(vol)
    if vol.ndim == 3:
        return vol.astype(np.float32), vol.astype(np.float32)
    if vol.ndim == 4 and vol.shape[0] >= 2:
        return vol[0].astype(np.float32), vol[1].astype(np.float32)
    raise ValueError(f"unsupported volume shape {vol.shape} in {path}")


class PatchDataset:
    """Overlapping patches of low/high-dose volumes. Item i is (high,
    {"low_res": low}), both (D, H, W, 1) float32 and already divided by
    ``normalize_divisor``. The grid is planned on the (H, W, D) sizes;
    ``random_crop`` makes one entry per volume with a fresh corner per
    item, zero-padded to the full cube."""

    def __init__(
        self,
        resolution: int,
        image_paths: Sequence[str],
        shard: int = 0,
        num_shards: int = 1,
        normalize_divisor: float = 4.0,
        cache_volumes: bool = True,
        random_crop: bool = False,
        seed: int = 0,
    ):
        self.resolution = resolution
        self.local_paths = list(image_paths)[shard:][::num_shards]
        self.normalize_divisor = normalize_divisor
        self.cache_volumes = cache_volumes
        self.random_crop = random_crop
        self._rng = np.random.default_rng(seed)
        self._cache: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        self.patch_info: List[Tuple[int, int, int, int]] = []
        if random_crop:
            self.patch_info = [(i, -1, -1, -1)
                               for i in range(len(self.local_paths))]
            return
        for file_idx, path in enumerate(self.local_paths):
            try:
                low, _ = self._volume(file_idx)
            except Exception as e:  # skip unreadable files, as the reference
                print(f"Error processing {path}: {e}")
                continue
            D, H, W = low.shape
            r = resolution
            if H < r or W < r or D < r:
                print(f"Warning: volume {path} too small ({H}x{W}x{D}), skipped")
                continue
            for x0, y0, z0 in patch_grid(train_xy_starts(H, r),
                                         train_xy_starts(W, r),
                                         train_z_starts(D, r)):
                self.patch_info.append((file_idx, x0, y0, z0))
        if not cache_volumes:
            self._cache.clear()

    def _volume(self, file_idx: int) -> Tuple[np.ndarray, np.ndarray]:
        if file_idx in self._cache:
            return self._cache[file_idx]
        low, high = load_volume_pair(self.local_paths[file_idx])
        low = low / self.normalize_divisor
        high = high / self.normalize_divisor
        if self.cache_volumes:
            self._cache[file_idx] = (low, high)
        return low, high

    def __len__(self) -> int:
        return len(self.patch_info)

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
        file_idx, x0, y0, z0 = self.patch_info[idx]
        low, high = self._volume(file_idx)
        r = self.resolution
        D, H, W = low.shape
        if self.random_crop:
            sxy, sz = min(r, H, W), min(r, D)
            x0 = self._rng.integers(0, max(H - sxy, 0) + 1)
            y0 = self._rng.integers(0, max(W - sxy, 0) + 1)
            z0 = self._rng.integers(0, max(D - sz, 0) + 1)
            xe, ye, ze = x0 + sxy, y0 + sxy, z0 + sz
        else:
            xe, ye, ze = min(x0 + r, H), min(y0 + r, W), min(z0 + r, D)

        def cut(vol):
            # vol is (D, H, W); grid coordinates are in (H, W, D) space
            patch = vol[z0:ze, x0:xe, y0:ye]
            out = np.zeros((r, r, r), np.float32)
            out[: patch.shape[0], : patch.shape[1], : patch.shape[2]] = patch
            return out[..., None]

        return cut(high), {"low_res": cut(low)}


class WholeVolumeDataset:
    """Whole volumes, no patching: item i is (high, {"low_res": low}), both
    (D, H, W, 1) float32 divided by ``normalize_divisor``; this rank's
    files are ``image_paths[shard::num_shards]``."""

    def __init__(
        self,
        image_paths: Sequence[str],
        shard: int = 0,
        num_shards: int = 1,
        normalize_divisor: float = 1.0,
    ):
        self.local_paths = list(image_paths)[shard::num_shards]
        self.normalize_divisor = normalize_divisor

    def __len__(self) -> int:
        return len(self.local_paths)

    def __getitem__(self, idx: int):
        low, high = load_volume_pair(self.local_paths[idx])
        low = low / self.normalize_divisor
        high = high / self.normalize_divisor
        return high[..., None], {"low_res": low[..., None]}


def load_data(
    *,
    data_dir: str,
    batch_size: int,
    image_size: int,
    shard: int = 0,
    num_shards: int = 1,
    deterministic: bool = False,
    seed: int = 0,
    drop_last: bool = True,
    random_crop: bool = False,
) -> Iterator[Tuple[np.ndarray, Dict[str, np.ndarray]]]:
    """Infinite generator of (high [B, D, H, W, 1], {"low_res": low})
    batches, reshuffled every epoch by ``np.random.default_rng(seed)``."""
    if not data_dir:
        raise ValueError("unspecified data directory")
    dataset = PatchDataset(
        image_size, list_image_files_recursively(data_dir), shard=shard,
        num_shards=num_shards, random_crop=random_crop, seed=seed,
    )
    if len(dataset) == 0:
        raise ValueError(f"no usable patches found under {data_dir}")
    rng = np.random.default_rng(seed)
    while True:
        order = (np.arange(len(dataset)) if deterministic
                 else rng.permutation(len(dataset)))
        for i in range(0, len(order), batch_size):
            idxs = order[i:i + batch_size]
            if len(idxs) < batch_size and drop_last:
                continue
            items = [dataset[int(j)] for j in idxs]
            yield (np.stack([h for h, _ in items]),
                   {"low_res": np.stack([kw["low_res"] for _, kw in items])})


def _resize_to(pil_image, smaller: int):
    """Halve with BOX filtering while the short side is at least twice
    ``smaller``, then bicubic so the short side is ``smaller``; as an
    array."""
    from PIL import Image

    while min(*pil_image.size) >= 2 * smaller:
        pil_image = pil_image.resize(
            tuple(x // 2 for x in pil_image.size), resample=Image.BOX)
    scale = smaller / min(*pil_image.size)
    pil_image = pil_image.resize(
        tuple(round(x * scale) for x in pil_image.size),
        resample=Image.BICUBIC)
    return np.array(pil_image)


def center_crop_arr(pil_image, image_size: int) -> np.ndarray:
    """2-D centre crop to ``image_size``^2 after a progressive downsample
    to a short side of ``image_size``."""
    arr = _resize_to(pil_image, image_size)
    cy = (arr.shape[0] - image_size) // 2
    cx = (arr.shape[1] - image_size) // 2
    return arr[cy:cy + image_size, cx:cx + image_size]


def random_crop_arr(
    pil_image, image_size: int,
    min_crop_frac: float = 0.8, max_crop_frac: float = 1.0,
    rng=None,
) -> np.ndarray:
    """2-D random crop to ``image_size``^2 after a downsample to a short
    side drawn from [image_size / max_crop_frac, image_size /
    min_crop_frac]; draws come from ``rng`` (a numpy Generator)."""
    rng = rng or np.random.default_rng()
    min_s = math.ceil(image_size / max_crop_frac)
    max_s = math.ceil(image_size / min_crop_frac)
    arr = _resize_to(pil_image, int(rng.integers(min_s, max_s + 1)))
    cy = int(rng.integers(0, arr.shape[0] - image_size + 1))
    cx = int(rng.integers(0, arr.shape[1] - image_size + 1))
    return arr[cy:cy + image_size, cx:cx + image_size]


def prefetch(iterator, size: int = 2):
    """Pull items from ``iterator`` on a daemon thread, ``size`` ahead, so
    volume IO overlaps the training step."""
    q: queue_mod.Queue = queue_mod.Queue(maxsize=size)
    sentinel = object()

    def producer():
        try:
            for item in iterator:
                q.put(item)
        finally:
            q.put(sentinel)

    threading.Thread(target=producer, daemon=True).start()
    while True:
        item = q.get()
        if item is sentinel:
            return
        yield item
