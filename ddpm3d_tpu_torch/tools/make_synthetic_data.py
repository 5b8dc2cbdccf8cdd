"""Generate synthetic 2-channel (low/high dose) PET-like TIFF volumes for
smoke tests and benchmarks.

Port of ``tools/make_synthetic_data.py``: the same flags, the same arrays
for the same ``--seed`` (``make_volume`` draws from one
``np.random.default_rng``), written through the port's TIFF writer.

    python -m ddpm3d_tpu_torch.tools.make_synthetic_data OUT_DIR \\
        [--volumes N] [--shape Z H W] [--seed S]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..data import tiff_io


def make_volume(rng: np.random.Generator, shape) -> np.ndarray:
    """Smooth blobby 'anatomy' + Poisson-ish noise on the low-dose channel:
    [2, Z, H, W] f32, (low, high)."""
    Z, H, W = shape
    zz, yy, xx = np.meshgrid(
        np.linspace(-1, 1, Z), np.linspace(-1, 1, H), np.linspace(-1, 1, W),
        indexing="ij",
    )
    high = np.zeros(shape, np.float32)
    for _ in range(6):
        cz, cy, cx = rng.uniform(-0.7, 0.7, 3)
        s = rng.uniform(0.1, 0.4)
        a = rng.uniform(0.5, 2.0)
        high += a * np.exp(
            -(((zz - cz) ** 2 + (yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s))
        ).astype(np.float32)
    low = high + rng.normal(0, 0.25, shape).astype(np.float32) * np.sqrt(
        np.maximum(high, 0.05)
    )
    return np.stack([low, high]).astype(np.float32)


def create_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out_dir")
    ap.add_argument("--volumes", type=int, default=2)
    ap.add_argument("--shape", type=int, nargs=3, default=[100, 200, 200])
    ap.add_argument("--seed", type=int, default=0)
    return ap


def main(argv=None) -> list:
    """Writes ``synthetic_{i:03d}.tif`` for each volume; returns the paths."""
    args = create_argparser().parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    rng = np.random.default_rng(args.seed)
    paths = []
    for i in range(args.volumes):
        vol = make_volume(rng, tuple(args.shape))
        path = os.path.join(args.out_dir, f"synthetic_{i:03d}.tif")
        tiff_io.imwrite(path, vol)
        print(f"wrote {path} shape={vol.shape}")
        paths.append(path)
    return paths


if __name__ == "__main__":
    main()
