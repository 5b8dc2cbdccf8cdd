"""Data-parallel training on several GPUs against one GPU.

Run from the repository root on a machine with N NVIDIA GPUs:

    python3 train_ddp_study.py [--gpus N] [--batch B] [--steps S] [--seed S]

Runs ``TrainLoop`` at the production flags (``test_DDPM_3d_tpu.sh``'s model,
the training CLI's defaults: AdamW lr 1e-4, EMA 0.9999, bf16 torso) on the
same S synthetic global batches of B 96^3 patches and the same seed, in
turns: one GPU with ``microbatch 1`` (B pieces, one process), N GPUs under
``torchrun --standalone --nproc_per_node N`` (B / N rows a rank, batch-1
pieces too), then both again (1, N, N, 1). Each N-GPU run's parameters are
held against the one-GPU run's as ``tests/test_torch_port_ddp.py`` holds two
gloo ranks against one process: the norm of the difference over the norm
of the one-GPU update, at most 1e-2. Prints one JSON line per run (step ms
by the host clock around each synchronized step, samples/s over the steps
after the first) and, last, the
summary with the card's name and power limit. Exits non-zero on any
failure. ``--device cpu --small`` rehearses the same flow on gloo processes
with a tiny model. Imports no JAX.
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

FLAGS = [  # test_DDPM_3d_tpu.sh's model flags
    "--large_size", "96", "--num_channels", "128", "--learn_sigma", "True",
    "--use_fp16", "True", "--use_scale_shift_norm", "True",
    "--resblock_updown", "True", "--attention_resolutions", "1000",
    "--num_head_channels", "64", "--diffusion_steps", "1000",
    "--noise_schedule", "linear",
]
SMALL = ["--large_size", "32", "--num_channels", "32", "--num_res_blocks",
         "1", "--use_fp16", "False"]
UPDATE_TOL = 1e-2
TIMEOUT_S = 900


def worker(args) -> None:
    """One run (one rank of it under torchrun): the loop, the steps, and on
    rank 0 the final params and the step times under ``args.out``."""
    from ddpm3d_tpu_torch import resolve_device
    from ddpm3d_tpu_torch.models.factory import sr_create_model_and_diffusion
    from ddpm3d_tpu_torch.models.nn import init_params
    from ddpm3d_tpu_torch.parallel import (
        barrier, destroy, maybe_initialize_distributed, rank_rows)
    from ddpm3d_tpu_torch.scripts import train as train_cli
    from ddpm3d_tpu_torch.training import TrainLoop
    from ddpm3d_tpu_torch.utils import logger
    from ddpm3d_tpu_torch.utils.config import (
        args_to_dict, sr_model_and_diffusion_defaults)

    rank, world = maybe_initialize_distributed(args.device)
    try:
        device = resolve_device(args.device)
        logger.configure(os.path.join(args.out, f"log_w{world}_r{rank}"),
                         format_strs=[])
        flags = FLAGS + (SMALL if args.small else [])
        cli = train_cli.create_argparser().parse_args(
            flags + ["--data_dir", "unused"])
        model, sched, cfg = sr_create_model_and_diffusion(
            **args_to_dict(cli, sr_model_and_diffusion_defaults().keys()))
        init_params(model, seed=args.seed)
        loop = TrainLoop(
            model=model, sched=sched, cfg=cfg, data=iter(()),
            batch_size=args.batch, microbatch=1, lr=cli.lr,
            ema_rate=cli.ema_rate, log_interval=cli.log_interval,
            save_interval=cli.save_interval, weight_decay=cli.weight_decay,
            seed=args.seed, device=device)
        size = cli.large_size
        rng = np.random.default_rng(args.seed)
        ms = []
        for _ in range(args.steps):
            x = np.clip(rng.normal(0.0, 0.5, (args.batch, size, size, size, 1)),
                        -1, 1).astype(np.float32)
            low = rng.normal(0.0, 0.5, x.shape).astype(np.float32)
            rows = lambda a: rank_rows(torch.from_numpy(a), rank, world)
            barrier()
            t0 = time.perf_counter()
            loop.run_step(rows(x), {"low_res": rows(low)})
            if device.type == "cuda":
                torch.cuda.synchronize()
            barrier()
            ms.append((time.perf_counter() - t0) * 1e3)
        if rank == 0:
            torch.save({n: p.detach().cpu()
                        for n, p in loop.model.named_parameters()},
                       os.path.join(args.out, f"params_w{world}.pt"))
            with open(os.path.join(args.out, f"times_w{world}.json"), "w") as f:
                json.dump(ms, f)
    finally:
        destroy()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--gpus", type=int, default=4)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true",
                    help="a tiny model at 32^3 (a CPU rehearsal)")
    ap.add_argument("--worker", metavar="OUT", dest="out",
                    help="run as one run's process, writing under OUT")
    args = ap.parse_args()
    if args.out:
        return worker(args)
    if args.device == "cuda" and (not torch.cuda.is_available()
                                  or torch.cuda.device_count() < args.gpus):
        raise SystemExit(f"needs {args.gpus} CUDA devices")
    if args.device == "cuda":
        from ddpm3d_tpu_torch.ops import _build

        _build.build_all()  # once, before the runs share the build
    repo = os.path.dirname(os.path.abspath(__file__))
    common = [os.path.join(repo, "train_ddp_study.py"), "--batch",
              str(args.batch), "--steps", str(args.steps), "--seed",
              str(args.seed), "--device", args.device] + (
                  ["--small"] if args.small else [])
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        for n in (1, args.gpus, args.gpus, 1):
            out = os.path.join(tmp, f"run{len(runs)}")
            os.makedirs(out)
            cmd = [sys.executable] + (
                [] if n == 1 else ["-m", "torch.distributed.run",
                                   "--standalone", "--nproc_per_node", str(n)])
            t0 = time.monotonic()
            proc = subprocess.run(cmd + common + ["--worker", out], cwd=repo,
                                  capture_output=True, text=True,
                                  timeout=TIMEOUT_S)
            wall = time.monotonic() - t0
            if proc.returncode != 0:
                print(proc.stdout[-4000:], proc.stderr[-4000:],
                      file=sys.stderr)
                raise SystemExit(f"the {n}-process run exited "
                                 f"{proc.returncode}")
            ms = json.load(open(os.path.join(out, f"times_w{n}.json")))
            params = torch.load(os.path.join(out, f"params_w{n}.pt"),
                                weights_only=True)
            line = {"gpus": n, "batch": args.batch, "steps": args.steps,
                    "step_ms": ms, "wall_s": wall,
                    "samples_per_s": args.batch * (len(ms) - 1)
                    / (sum(ms[1:]) / 1e3)}
            runs.append((line, params))
            print(json.dumps(line), flush=True)
    ref = runs[0][1]
    from ddpm3d_tpu_torch.models.factory import sr_create_model_and_diffusion
    from ddpm3d_tpu_torch.models.nn import init_params
    from ddpm3d_tpu_torch.scripts import train as train_cli
    from ddpm3d_tpu_torch.utils.config import (
        args_to_dict, sr_model_and_diffusion_defaults)

    cli = train_cli.create_argparser().parse_args(
        FLAGS + (SMALL if args.small else []) + ["--data_dir", "unused"])
    init, _, _ = sr_create_model_and_diffusion(
        **args_to_dict(cli, sr_model_and_diffusion_defaults().keys()))
    init_params(init, seed=args.seed)
    init = dict(init.named_parameters())
    ratios = []
    for _, params in runs[1:]:
        diff = sum(float(((params[k] - r).double() ** 2).sum())
                   for k, r in ref.items())
        upd = sum(float(((r - init[k].detach()).double() ** 2).sum())
                  for k, r in ref.items())
        ratios.append((diff / upd) ** 0.5)
    one = [line["samples_per_s"] for line, _ in runs if line["gpus"] == 1]
    many = [line["samples_per_s"] for line, _ in runs if line["gpus"] > 1]
    smi = "cpu" if args.device == "cpu" else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    summary = {"gpus": args.gpus, "batch": args.batch, "steps": args.steps,
               "update_diff_ratio": ratios, "samples_per_s_1": one,
               "samples_per_s_n": many,
               "speedup": float(np.median(many) / np.median(one)),
               "device": smi}
    print(json.dumps(summary))
    if max(ratios) > UPDATE_TOL:
        raise SystemExit(f"params differ from one GPU's: {ratios}")


if __name__ == "__main__":
    main()
