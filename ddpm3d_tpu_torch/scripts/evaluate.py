"""Evaluate a denoised volume: PSNR / SSIM / MAE / RMSE against a reference.

Port of ``scripts/evaluate.py`` (the JAX CLI's flags, plus ``--device``):
reads ``.tif`` / ``.tiff`` (:mod:`..data.tiff_io`), ``.npz`` (its first
array) or ``.npy``, and prints one JSON line. The metrics run in float64
on ``--device``, the card unless ``cpu`` is given.

    python -m ddpm3d_tpu_torch.scripts.evaluate --reference clean.tif \\
        --test denoised.npz
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..data import tiff_io
from ..utils.metrics import volume_report


def load_any(path: str) -> np.ndarray:
    if path.endswith((".tif", ".tiff")):
        return np.asarray(tiff_io.imread(path), np.float32)
    if path.endswith(".npz"):
        z = np.load(path)
        return np.asarray(z[z.files[0]], np.float32)
    if path.endswith(".npy"):
        return np.asarray(np.load(path), np.float32)
    raise ValueError(f"unsupported file type: {path}")


def create_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reference", required=True, help="ground-truth volume")
    ap.add_argument("--test", required=True, help="volume under evaluation")
    ap.add_argument(
        "--test_layout", default="auto", choices=["auto", "zhw", "hwz"],
        help="axis order of --test (denoised .npz outputs are (H,W,Z); "
             "TIFFs are (Z,H,W))")
    ap.add_argument("--data_range", type=float, default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu: where the metrics run")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = create_argparser().parse_args(argv)
    device = resolve_device(args.device)
    ref = load_any(args.reference)
    test = load_any(args.test)
    layout = args.test_layout
    if layout == "auto":
        layout = "hwz" if args.test.endswith(".npz") else "zhw"
    if layout == "hwz":
        test = test.transpose(2, 0, 1)  # -> (Z, H, W)
    if ref.shape != test.shape:
        raise SystemExit(
            f"shape mismatch: reference {ref.shape} vs test {test.shape}")
    report = volume_report(torch.from_numpy(ref).to(device),
                           torch.from_numpy(np.ascontiguousarray(test)).to(
                               device),
                           data_range=args.data_range)
    report["shape"] = list(ref.shape)
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
