"""The serving CLI's patch split on several GPUs against one GPU.

Run from the repository root on a machine with N NVIDIA GPUs:

    python3 serving_split_study.py [--gpus N] [--seed S]

Writes a synthetic (130, 200, 200) volume (18 patches of 96^3, the largest
production grid) and a ``.pt`` of random full-width weights (the
``test_DDPM_3d_tpu.sh`` model, from ``--seed``), then runs the serving CLI
with DPM-Solver++(2M) over a 25-step respacing under ``torchrun --standalone
--nproc_per_node K`` for K = 1, N, N, 1 in turn. Every run's volume must
equal the first bit for bit (noise is keyed on the global patch index, and
the kernels do not depend on the batch's composition). Prints one JSON line
per run (launcher wall seconds, the CLI's sampling seconds) and, last, a
summary with the card's name and power limit. Exits non-zero on any
failure. Imports no JAX; the kernels build on first use as in
``chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

FLAGS = [  # test_DDPM_3d_tpu.sh, one draw, DPM-Solver++(2M) over ddim25
    "--large_size", "96", "--num_channels", "128", "--learn_sigma", "True",
    "--use_fp16", "True", "--use_scale_shift_norm", "True",
    "--resblock_updown", "True", "--attention_resolutions", "1000",
    "--num_head_channels", "64", "--diffusion_steps", "1000",
    "--noise_schedule", "linear", "--batch_size", "1",
    "--use_dpm_solver", "True", "--timestep_respacing", "ddim25",
]
TIMEOUT_S = 900


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--gpus", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available() or torch.cuda.device_count() < args.gpus:
        raise SystemExit(f"needs {args.gpus} CUDA devices")
    from ddpm3d_tpu_torch.data import tiff_io
    from ddpm3d_tpu_torch.models.factory import sr_create_model_and_diffusion
    from ddpm3d_tpu_torch.models.nn import init_params
    from ddpm3d_tpu_torch.ops import _build
    from ddpm3d_tpu_torch.scripts import test as cli
    from ddpm3d_tpu_torch.utils.config import (
        args_to_dict, sr_model_and_diffusion_defaults)

    _build.build_all()  # once, before the launches share the build
    repo = os.path.dirname(os.path.abspath(__file__))
    runs, first = [], None
    with tempfile.TemporaryDirectory() as tmp:
        vol_path = os.path.join(tmp, "vol.tif")
        tiff_io.imwrite(vol_path, np.random.default_rng(args.seed).gamma(
            2.0, 0.5, (130, 200, 200)).astype(np.float32))
        model, _, _ = sr_create_model_and_diffusion(**args_to_dict(
            cli.create_argparser().parse_args(FLAGS),
            sr_model_and_diffusion_defaults().keys()))
        init_params(model, seed=args.seed, zero_heads=False)
        ckpt = os.path.join(tmp, "model000000.pt")
        torch.save(model.state_dict(), ckpt)
        del model
        for i, k in enumerate((1, args.gpus, args.gpus, 1)):
            out = os.path.join(tmp, f"out{i}")
            cmd = [sys.executable, "-m", "torch.distributed.run",
                   "--standalone", "--nproc_per_node", str(k), "-m",
                   "ddpm3d_tpu_torch.scripts.test", *FLAGS,
                   "--base_samples", vol_path, "--model_path", ckpt,
                   "--save_dir", out, "--seed", str(args.seed)]
            t0 = time.monotonic()
            proc = subprocess.run(cmd, cwd=repo, capture_output=True,
                                  text=True, timeout=TIMEOUT_S)
            wall = time.monotonic() - t0
            if proc.returncode != 0:
                print(proc.stdout[-4000:], proc.stderr[-4000:],
                      file=sys.stderr)
                raise SystemExit(f"FAILED: {k} GPUs exited {proc.returncode}")
            result = np.load(os.path.join(out, "denoised_vol.npz"))["arr_0"]
            log = open(os.path.join(out, "log.txt")).read().splitlines()
            sampling_s = float(next(
                l for l in log if l.startswith("Full image denoising:"))
                .rsplit("(sampling ", 1)[1].split("s wall")[0])
            if first is None:
                first = result
            run = {"gpus": k, "wall_s": wall, "sampling_s": sampling_s,
                   "result_shape": list(result.shape),
                   "finite": bool(np.isfinite(result).all()),
                   "bit_equal_to_first": bool(np.array_equal(result, first)),
                   "files": sorted(os.listdir(out))}
            print(json.dumps(run), flush=True)
            runs.append(run)
    if not all(r["finite"] and r["bit_equal_to_first"] for r in runs):
        raise SystemExit("FAILED: the volumes differ across GPU counts")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    one = [r["sampling_s"] for r in runs if r["gpus"] == 1]
    many = [r["sampling_s"] for r in runs if r["gpus"] == args.gpus]
    print(json.dumps({"gpus": args.gpus, "patches": 18, "steps": 25,
                      "sampling_s_1": one, f"sampling_s_{args.gpus}": many,
                      "speedup": float(np.median(one) / np.median(many)),
                      "bit_equal": True}))


if __name__ == "__main__":
    main()
