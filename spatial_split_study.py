"""One patch's H axis split over GPUs (the spatial mesh axis) against one
GPU, through ``denoise_patches`` under ``torchrun``.

Run from the repository root on a machine with N NVIDIA GPUs:

    python3 spatial_split_study.py [--layouts 1x1,1x2,1x3,2x2] [--seed S]

Each layout ``DxS`` is a (data, spatial) mesh of D * S ranks
(:func:`ddpm3d_tpu_torch.parallel.make_mesh`); the layouts that need more
GPUs than the machine has are skipped. Every run samples the same
``--patches`` 96^3 patches (2 by default, so that the two data groups of
2x2 each take one) with DPM-Solver++(2M) over ddim25 on the
``test_DDPM_3d_tpu.sh`` model (bf16, random weights from ``--seed``),
unfused and fused, in the order given and then the first layout again.
Each rank prints one JSON line per path: the sampling wall seconds, the
CUDA-event ms of one forward, the host's ms to issue it, the device busy
ms of that forward by torch.profiler (all kernels, and the NCCL kernels
alone: the halo exchanges and all-reduces, waiting for the peer
included), the spatial group's collectives per forward, and each
collective alone: the host's ms to issue one, and its wall ms. Every
run's volume must agree with the first layout's (mean |diff| / mean
|first| <= 1e-2 in bf16: the GroupNorm sums add in another order; a wrong
halo moves the volume by far more). The summary line gives each layout's
wall speed-up over the first, and the last line the card's name and power
limit.

``--device cpu --small`` rehearses it on CPU processes (gloo; a 32-channel
model at 48^3, a 3-step chain); device numbers are then null. Imports no
JAX; the kernels build on first use as in ``chip_smoke.py``.
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

FLAGS = dict(  # test_DDPM_3d_tpu.sh
    large_size=96, num_channels=128, num_res_blocks=2, learn_sigma=True,
    use_fp16=True, use_scale_shift_norm=True, resblock_updown=True,
    attention_resolutions="1000", num_head_channels=64, diffusion_steps=1000,
    noise_schedule="linear", timestep_respacing="ddim25")
# --small: the factory's widths and depths at 32 channels, (1, 2), 48^3
SMALL = dict(model_channels=32, out_channels=2, num_res_blocks=1,
             channel_mult=(1, 2), use_scale_shift_norm=True,
             resblock_updown=True, middle_attention=False,
             dtype=torch.bfloat16)
VOLUME_TOL = 1e-2
TIMEOUT_S = 1200


def _model(args, fused: bool):
    from ddpm3d_tpu_torch.models import SuperResModel
    from ddpm3d_tpu_torch.models.factory import (
        create_gaussian_diffusion, sr_create_model_and_diffusion)
    from ddpm3d_tpu_torch.models.nn import init_params
    from ddpm3d_tpu_torch.utils.config import sr_model_and_diffusion_defaults

    if args.small:
        model = SuperResModel(in_channels=1, fused=fused, **SMALL)
        sched, cfg = create_gaussian_diffusion(
            steps=1000, learn_sigma=True, noise_schedule="linear",
            timestep_respacing="ddim3")
        size = 48
    else:
        flags = sr_model_and_diffusion_defaults()
        flags.update(FLAGS)
        model, sched, cfg = sr_create_model_and_diffusion(**flags,
                                                          fused=fused)
        size = FLAGS["large_size"]
    init_params(model, seed=args.seed, zero_heads=False)
    return model.eval(), sched, cfg, size


def _forward_numbers(model, mesh, size: int, device) -> dict:
    """One batch-1 forward of this rank's rows under the mesh's group:
    CUDA-event ms, host issue ms, device busy ms and the NCCL kernels' ms
    (torch.profiler), and the group's collectives."""
    from ddpm3d_tpu_torch.parallel import spatial_rows
    from ddpm3d_tpu_torch.utils import tracing

    g = torch.Generator().manual_seed(1)
    x = spatial_rows(mesh, torch.randn((1, size, size, size, 1),
                                       generator=g)).contiguous().to(device)
    t = torch.tensor([500], device=device)
    group = mesh.spatial
    model.set_spatial(group)
    try:
        with torch.inference_mode():
            def fwd():
                return model(x, t, low_res=x)

            fwd()
            before = tracing.counters("spatial.")
            fwd()
            calls = {k.split(".", 1)[1]: v - before.get(k, 0)
                     for k, v in tracing.counters("spatial.").items()}
            if device.type != "cuda":
                t0 = time.perf_counter()
                fwd()
                return {"forward_ms": (time.perf_counter() - t0) * 1e3,
                        "host_issue_ms": None, "device_ms": None,
                        "nccl_ms": None, "calls_per_forward": calls}
            from torch.profiler import ProfilerActivity, profile

            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fwd()
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
            t0 = time.perf_counter()
            fwd()
            host = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fwd()
                torch.cuda.synchronize()
            device_ms = nccl_ms = 0.0
            for ev in prof.key_averages():
                us = getattr(ev, "device_time_total", 0.0) or 0.0
                device_ms += us / 1e3
                if "nccl" in ev.key.lower():
                    nccl_ms += us / 1e3
            return {"forward_ms": ms, "host_issue_ms": host,
                    "device_ms": device_ms, "nccl_ms": nccl_ms,
                    "calls_per_forward": calls}
    finally:
        model.set_spatial(None)


def _collective_costs(mesh, size: int, device, reps: int = 50) -> dict:
    """Each collective of a forward alone, ``reps`` times in a row: the
    host's ms to issue one call, and the wall ms of one call once the card
    is done (synchronized), on a top-level activation shard ([1, size,
    size / S, size, 128] bf16, the halo with its concatenation) and on a
    GroupNorm's [1, 2, 128] f32 sums. Empty without a spatial axis."""
    from ddpm3d_tpu_torch.parallel import barrier

    group = mesh.spatial
    if group.size == 1:
        return {}
    act = torch.zeros((1, size, size // group.size, size, 128),
                      dtype=torch.bfloat16, device=device)
    sums = torch.zeros((1, 2, 128), device=device)
    calls = {"halo": lambda: group.halo(act),
             "all_reduce_sum": lambda: group.all_reduce_sum(sums)}
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))
    out = {}
    for name, fn in calls.items():
        for _ in range(5):
            fn()
        sync()
        barrier()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host = (time.perf_counter() - t0) * 1e3 / reps
        sync()
        out[name] = {"host_ms": host,
                     "wall_ms": (time.perf_counter() - t0) * 1e3 / reps}
    return out


def worker(args) -> None:
    """One rank of a layout: both paths' volumes and numbers."""
    from ddpm3d_tpu_torch import resolve_device
    from ddpm3d_tpu_torch.inference.pipeline import denoise_patches
    from ddpm3d_tpu_torch.parallel import (
        barrier, destroy, make_mesh, maybe_initialize_distributed)

    rank, world_size = maybe_initialize_distributed(args.device)
    device = resolve_device(args.device)
    mesh = make_mesh(args.n_data, args.n_spatial, device=device)
    for path in ("unfused", "fused"):
        model, sched, cfg, size = _model(args, fused=path == "fused")
        model.to(device)
        low = np.random.default_rng(args.seed).gamma(
            2.0, 0.5, (args.patches, size, size, size)).astype(np.float32)
        numbers = _forward_numbers(model, mesh, size, device)
        numbers["collective_costs"] = _collective_costs(mesh, size, device)
        barrier()
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.monotonic()
        volume = denoise_patches(model, sched, cfg, low, seed=args.seed,
                                 use_dpm_solver=True, device=device,
                                 mesh=mesh)
        wall = time.monotonic() - t0
        line = {"layout": f"{args.n_data}x{args.n_spatial}", "path": path,
                "rank": rank, "world": world_size, "patches": args.patches,
                "steps": sched.num_timesteps, "sampling_wall_s": wall,
                **numbers}
        print(json.dumps(line), flush=True)
        if rank == 0:
            np.save(os.path.join(args.out, f"{path}.npy"), volume)
            with open(os.path.join(args.out, f"{path}.json"), "w") as f:
                json.dump(line, f)
        del model
    destroy()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layouts", default="1x1,1x2,1x3,2x2")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--patches", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--n_data", type=int, default=1)
    ap.add_argument("--n_spatial", type=int, default=1)
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    if args.worker:
        worker(args)
        return
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("needs a CUDA device (or --device cpu)")
        available = torch.cuda.device_count()
        from ddpm3d_tpu_torch.ops import _build

        _build.build_all()  # once, before the launches share the build
    else:
        available = os.cpu_count() or 1
    layouts = [tuple(int(v) for v in s.split("x"))
               for s in args.layouts.split(",")]
    layouts = [l for l in layouts if l[0] * l[1] <= available]
    order = layouts + layouts[:1]
    repo = os.path.dirname(os.path.abspath(__file__))
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, (n_data, n_spatial) in enumerate(order):
            out = os.path.join(tmp, f"run{i}")
            os.makedirs(out)
            cmd = [sys.executable, "-m", "torch.distributed.run",
                   "--standalone", "--nproc_per_node", str(n_data * n_spatial),
                   os.path.abspath(__file__), "--worker", "--n_data",
                   str(n_data), "--n_spatial", str(n_spatial), "--out", out,
                   "--seed", str(args.seed), "--patches", str(args.patches),
                   "--device", args.device] + (["--small"] if args.small
                                               else [])
            t0 = time.monotonic()
            proc = subprocess.run(cmd, cwd=repo, capture_output=True,
                                  text=True, timeout=TIMEOUT_S,
                                  env=dict(os.environ, OMP_NUM_THREADS="2"))
            if proc.returncode != 0:
                print(proc.stdout[-4000:], proc.stderr[-4000:],
                      file=sys.stderr)
                raise SystemExit(f"FAILED: layout {n_data}x{n_spatial} "
                                 f"exited {proc.returncode}")
            print(proc.stdout, end="", flush=True)
            run = {"layout": f"{n_data}x{n_spatial}",
                   "launcher_wall_s": time.monotonic() - t0}
            for path in ("unfused", "fused"):
                run[path] = json.load(open(os.path.join(out, f"{path}.json")))
                run[path + "_volume"] = np.load(os.path.join(out,
                                                             f"{path}.npy"))
            runs.append(run)
    first, failed = runs[0], []
    summary = {"patches": args.patches, "layouts": {}}
    for run in runs:
        entry = summary["layouts"].setdefault(run["layout"], {})
        for path in ("unfused", "fused"):
            vol, ref = run[path + "_volume"], first[path + "_volume"]
            d = np.abs(vol - ref)
            rel = float(d.mean() / np.abs(ref).mean())
            if not (np.isfinite(vol).all() and rel <= VOLUME_TOL):
                failed.append((run["layout"], path, rel))
            entry.setdefault(path, []).append({
                **{k: run[path][k] for k in (
                    "forward_ms", "host_issue_ms", "device_ms", "nccl_ms",
                    "calls_per_forward", "collective_costs")},
                "sampling_wall_s": run[path]["sampling_wall_s"],
                "speedup": first[path]["sampling_wall_s"]
                / run[path]["sampling_wall_s"],
                "volume_mean_rel_diff": rel,
                "volume_max_abs_diff": float(d.max())})
    print(json.dumps(summary), flush=True)
    if failed:
        raise SystemExit(f"FAILED: volumes differ from {first['layout']}: "
                         f"{failed}")
    if args.device == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
