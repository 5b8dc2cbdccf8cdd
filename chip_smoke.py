"""On-card smoke test of the PyTorch/CUDA port (``ddpm3d_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (each failure exits non-zero before the final line):
  1. build   — compile the kernels of ``ddpm3d_tpu_torch/csrc`` (parallel
               nvcc), print the build seconds and ptxas reports;
  2. kernels — every kernel against its plain PyTorch version on the card at
               every distinct shape of the main path (read by hooks from one
               bf16 96^3 forward): error vs tolerance; at the main sites
               also kernel / plain / library time (CUDA events, median) and
               the bound;
  3. model   — the full-width model (128 ch, (1,1,2,3,4), 2 res blocks) in
               f32 at a small spatial size, kernel path on the card against
               the plain path on the CPU;
  4. denoise — ``denoise_volume`` at 128 ch / 96^3 patches / bf16 on a
               synthetic volume with a short respaced chain; the launch
               counters are zeroed just before and read just after; then a
               torch.profiler breakdown of one forward by kernel family.
Then one ``{"kernels": [...]}`` line, the card's name and power limit, and
as the last line ``{"ok": true, "device": {...}}``.

Weights are random, made from ``--seed``. Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

H100_BF16_FLOPS = 989e12   # dense tensor-core bf16 (NVIDIA data sheet, SXM)
H100_F32_FLOPS = 67e12     # f32 on CUDA cores
H100_BYTES = 3.35e12       # HBM3 bytes/s

KERNELS = {
    "conv3d": dict(
        route="cuda", source="ddpm3d_tpu_torch/csrc/conv3d.cu",
        replaces="ddpm3d_tpu/ops/conv3d_mxu.py:203"),
    "gn_stats": dict(
        route="cuda", source="ddpm3d_tpu_torch/csrc/groupnorm.cu",
        replaces="ddpm3d_tpu/ops/groupnorm.py:116"),
    "gn_apply": dict(
        route="cuda", source="ddpm3d_tpu_torch/csrc/groupnorm.cu",
        replaces="ddpm3d_tpu/ops/groupnorm.py:149"),
}

# relative tolerance = max|kernel - plain| / max|plain|: bf16 outputs may
# differ by one bf16 rounding (2^-8) where the f32 sums differ in order;
# f32 outputs only by summation order.
TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-5}
MODEL_TOL = 1e-4  # f32 forward, ~70 layers of reordered f32 sums


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps: int = 5, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(flops: float, nbytes: float, dtype) -> tuple:
    peak = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_F32_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / H100_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def rel_err(out: torch.Tensor, ref: torch.Tensor) -> tuple:
    err = (out.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    return err, err / max(scale, 1e-30)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"FAILED: {what}")


def phase_build() -> None:
    from ddpm3d_tpu_torch.ops import _build

    t0 = time.monotonic()
    paths = _build.build_all()
    emit({"phase": "build", "seconds": round(time.monotonic() - t0, 3),
          "libs": sorted(paths)})
    for name, path in paths.items():
        with open(path + ".log") as f:
            for line in f:
                if "registers" in line or "spill" in line:
                    print(f"ptxas[{name}]: {line.strip()}")


def main_path_shapes(model) -> tuple:
    """Every distinct conv and GroupNorm call of one bf16 96^3 batch-1
    forward, read by forward pre-hooks: conv (D, H, W, Cin, Cout, dtype)
    and GN (N, C, dtype, film, silu)."""
    from ddpm3d_tpu_torch.models.nn import Conv3x3x3, GroupNorm32

    convs, gns = set(), set()

    def conv_hook(mod, args):
        _, D, H, W, cin = args[0].shape
        convs.add((D, H, W, cin, mod.weight.shape[0], args[0].dtype))

    def gn_hook(mod, args, kwargs):
        x = args[0]
        gns.add((int(np.prod(x.shape[1:-1])), x.shape[-1], x.dtype,
                 kwargs.get("film_scale") is not None,
                 bool(kwargs.get("apply_silu", False))))

    handles = []
    for m in model.modules():
        if isinstance(m, Conv3x3x3):
            handles.append(m.register_forward_pre_hook(conv_hook))
        elif isinstance(m, GroupNorm32):
            handles.append(m.register_forward_pre_hook(gn_hook,
                                                       with_kwargs=True))
    x = torch.randn((1, 96, 96, 96, 1), device="cuda")
    with torch.no_grad():
        model(x, torch.tensor([500], device="cuda"), low_res=x)
    for h in handles:
        h.remove()
    return sorted(convs, key=str), sorted(gns, key=str)


# shapes that are also timed (the rest are only checked): main-path sites
CONV_TIMED = [  # (D, H, W, Cin, Cout, dtype)
    (96, 96, 96, 128, 128, torch.bfloat16),   # level-0 ResBlock conv
    (96, 48, 48, 256, 128, torch.bfloat16),   # level-1 decoder in_conv
    (96, 6, 6, 1024, 512, torch.bfloat16),    # level-4 decoder in_conv
    (96, 96, 96, 2, 128, torch.bfloat16),     # input conv (Cin = 2)
    (96, 96, 96, 128, 2, torch.float32),      # head conv (f32, Cout = 2)
]
GN_TIMED = [  # (N, C, dtype, film, silu)
    (96 ** 3, 128, torch.bfloat16, False, True),   # ResBlock in_norm
    (96 ** 3, 128, torch.bfloat16, True, True),    # out_norm + FiLM
    (96 ** 3, 128, torch.float32, False, True),    # f32 head norm
    (96 * 6 * 6, 1024, torch.bfloat16, False, True),
]


def phase_kernels(gen: torch.Generator, conv_shapes, gn_shapes) -> dict:
    """Each kernel against its plain version at every distinct shape of the
    main path; the shapes of CONV_TIMED / GN_TIMED are timed too."""
    from ddpm3d_tpu_torch.ops import conv3d as cv
    from ddpm3d_tpu_torch.ops import groupnorm as gn

    dev = torch.device("cuda")
    for case in CONV_TIMED:
        check(case in conv_shapes, f"timed conv {case} is on the main path")
    for case in GN_TIMED:
        check(case in gn_shapes, f"timed GN {case} is on the main path")
    summary = {}
    checked = {"conv3d": 0, "gn_stats": 0, "gn_apply": 0}

    for case in CONV_TIMED + [c for c in conv_shapes if c not in CONV_TIMED]:
        D, H, W, cin, cout, dt = case
        B = 1
        x = torch.randn((B, D, H, W, cin), generator=gen, device=dev).to(dt)
        w = (torch.randn((cout, cin, 3, 3, 3), generator=gen, device=dev)
             * (27 * cin) ** -0.5)
        b = torch.randn((cout,), generator=gen, device=dev) * 0.1
        wp = cv.pack_weight(w, dt)
        wd = w.to(dt)
        out = cv.conv3d_kernel(x, wp, b)
        ref = cv.conv3d_plain(x, wd, b)
        torch.cuda.synchronize()
        err, rel = rel_err(out, ref)
        check(bool(torch.isfinite(out.float()).all()), "conv3d output finite")
        line = dict(kernel="conv3d", shape=[B, D, H, W, cin], cout=cout,
                    dtype=str(dt).split(".")[-1], tile=list(cv.pick_tile(D, H, W)),
                    max_abs_err=err, rel_err=rel, tol=TOL[dt])
        if case in CONV_TIMED:
            ms = time_ms(lambda: cv.conv3d_kernel(x, wp, b))
            plain_ms = time_ms(lambda: cv.conv3d_plain(x, wd, b), reps=3,
                               warmup=1)
            xn = x.permute(0, 4, 1, 2, 3)  # NCDHW view of the same bytes
            lib_ms = time_ms(lambda: F.conv3d(xn, wd, b.to(dt), padding=1))
            vox = B * D * H * W
            isz = x.element_size()
            flops = 2.0 * 27 * cin * cout * vox
            nbytes = vox * (cin + cout) * isz + wp.numel() * isz + cout * 4
            bms, by = bound(flops, nbytes, dt)
            line.update(kernel_ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                        bound_ms=bms, bound_by=by, tflops=flops / ms / 1e9)
        emit(line)
        check(rel <= TOL[dt], f"conv3d {line['shape']}->{cout} rel err {rel}")
        checked["conv3d"] += 1
        summary.setdefault("conv3d", line)
        del x, out, ref

    for case in GN_TIMED + [c for c in gn_shapes if c not in GN_TIMED]:
        N, C, dt, film, silu = case
        B = 1
        x = (torch.randn((B, N, C), generator=gen, device=dev) * 2 + 0.5).to(dt)
        scale = 1 + 0.1 * torch.randn((C,), generator=gen, device=dev)
        shift = 0.1 * torch.randn((C,), generator=gen, device=dev)
        fs = fh = None
        if film:
            fs = 0.1 * torch.randn((B, C), generator=gen, device=dev)
            fh = 0.1 * torch.randn((B, C), generator=gen, device=dev)
        st = gn.channel_stats(x)
        st_ref = gn.channel_stats_plain(x)
        g, bb = gn.fold_gn_affine(st_ref, N, scale, shift,
                                  film_scale=fs, film_shift=fh)
        y = gn.gn_apply(x, g, bb, silu)
        y_ref = gn.gn_apply_plain(x, g, bb, silu)
        full = gn.group_norm(x, scale, shift, film_scale=fs, film_shift=fh,
                             apply_silu=silu)
        torch.cuda.synchronize()
        s_err, s_rel = rel_err(st, st_ref)
        a_err, a_rel = rel_err(y, y_ref)
        f_err, f_rel = rel_err(full, y_ref)
        isz = x.element_size()
        cases = (
            ("gn_stats", s_err, s_rel, 1e-5,
             lambda: gn.channel_stats(x), lambda: gn.channel_stats_plain(x),
             B * N * C * isz + B * 2 * C * 4, 3.0 * B * N * C),
            ("gn_apply", a_err, a_rel, TOL[dt],
             lambda: gn.gn_apply(x, g, bb, silu),
             lambda: gn.gn_apply_plain(x, g, bb, silu),
             2 * B * N * C * isz + 2 * B * C * 4, 6.0 * B * N * C),
        )
        for name, err, rel, tol, kfn, pfn, nbytes, flops in cases:
            line = dict(kernel=name, shape=[B, N, C],
                        dtype=str(dt).split(".")[-1], film=film, silu=silu,
                        max_abs_err=err, rel_err=rel, tol=tol)
            if case in GN_TIMED:
                ms = time_ms(kfn)
                bms, by = bound(flops, nbytes, torch.float32)
                line.update(kernel_ms=ms, plain_ms=time_ms(pfn),
                            library_ms=None, bound_ms=bms, bound_by=by,
                            gb_per_s=nbytes / ms / 1e6)
            emit(line)
            check(rel <= tol, f"{name} {line['shape']} rel err {rel}")
            checked[name] += 1
            summary.setdefault(name, line)
        check(f_rel <= TOL[dt], f"group_norm end to end rel err {f_rel}")
        del x, y, y_ref, full
    for name, n in checked.items():
        summary[name] = dict(summary[name], shapes_checked=n)
    return summary


def _model(use_fp16: bool, seed: int):
    from ddpm3d_tpu_torch.models.factory import sr_create_model_and_diffusion
    from ddpm3d_tpu_torch.models.nn import init_params
    from ddpm3d_tpu_torch.utils.config import sr_model_and_diffusion_defaults

    args = sr_model_and_diffusion_defaults()
    args.update(  # test_DDPM_3d_tpu.sh
        large_size=96, num_channels=128, num_res_blocks=2, learn_sigma=True,
        use_fp16=use_fp16, use_scale_shift_norm=True, resblock_updown=True,
        attention_resolutions="1000", num_head_channels=64,
        diffusion_steps=1000, noise_schedule="linear",
    )
    args["timestep_respacing"] = "3"
    model, sched, cfg = sr_create_model_and_diffusion(**args)
    init_params(model, seed=seed, zero_heads=False)
    return model.eval(), sched, cfg


def phase_model(seed: int) -> None:
    model, _, _ = _model(use_fp16=False, seed=seed)
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((1, 8, 32, 32, 1), np.float32))
    low = torch.from_numpy(rng.standard_normal((1, 8, 32, 32, 1), np.float32))
    t = torch.tensor([517])
    with torch.no_grad():
        ref = model(x, t, low_res=low)
        model.cuda()
        out = model(x.cuda(), t.cuda(), low_res=low.cuda()).cpu()
    err, rel = rel_err(out, ref)
    emit({"phase": "model", "shape": list(x.shape), "channels": 128,
          "dtype": "float32", "max_abs_err": err, "rel_err": rel,
          "tol": MODEL_TOL, "ref_abs_max": ref.abs().max().item()})
    check(ref.abs().max().item() > 1e-3, "model output is non-trivial")
    check(rel <= MODEL_TOL, f"full-width model kernel path rel err {rel}")


def phase_denoise(model, sched, cfg, seed: int) -> dict:
    from ddpm3d_tpu_torch import ops
    from ddpm3d_tpu_torch.inference.pipeline import denoise_volume

    shape = (96, 144, 144)  # (Z, H, W): 2 x 2 patches of 96^3
    vol = np.random.default_rng(seed).gamma(2.0, 0.5, shape).astype(np.float32)
    batch = 2
    with torch.no_grad():  # warm-up: kernel libraries, weight packing
        z = torch.zeros((batch, 96, 96, 96, 1), device="cuda")
        model(z, torch.zeros((batch,), dtype=torch.long, device="cuda"),
              low_res=z)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.monotonic()
    result, stats = denoise_volume(
        model, sched, cfg, vol, seed=seed, patch_size=96, num_xy_patches=2,
        batch_size=batch,
    )
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = ops.launch_counts()
    steps = sched.num_timesteps
    n_patches = 4
    forwards = steps * -(-n_patches // batch)
    line = {
        "phase": "denoise", "volume_zhw": list(shape), "patches": n_patches,
        "patch": 96, "channels": 128, "dtype": "bfloat16", "steps": steps,
        "batch": batch, "wall_s": wall, "sample_wall_s": stats["sample_wall_s"],
        "ms_per_step": stats["sample_wall_s"] * 1e3 / steps,
        "ms_per_forward": stats["sample_wall_s"] * 1e3 / forwards,
        "volume_voxels_per_s": float(np.prod(shape)) / stats["sample_wall_s"],
        "patch_voxel_steps_per_s":
            n_patches * 96 ** 3 * steps / stats["sample_wall_s"],
        "launches": counts,
        "launches_per_forward": {k: v / forwards for k, v in counts.items()},
        "finite": bool(np.isfinite(result).all()),
        "result_shape": list(result.shape),
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
    }
    emit(line)
    check(line["finite"], "denoised volume is finite")
    check(tuple(result.shape) == (144, 144, 96), "result is (H, W, Z)")
    check(float(np.abs(result).max()) > 0, "result is non-trivial")
    for name in KERNELS:
        check(counts[name] > 0, f"kernel {name} launched on the main path")
    check(counts["conv3d"] == 72 * forwards, "72 convs per forward")
    check(counts["gn_stats"] == 71 * forwards, "71 GroupNorms per forward")
    return counts


def phase_profile(model) -> None:
    """Device time of one bf16 96^3 forward at batch 1, by kernel family
    (torch.profiler), against the forward's CUDA-event time."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn((1, 96, 96, 96, 1), device="cuda")
    t = torch.tensor([500], device="cuda")
    with torch.no_grad():
        fwd_ms = time_ms(lambda: model(x, t, low_res=x), reps=3, warmup=1)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            model(x, t, low_res=x)
            torch.cuda.synchronize()
    families = {"conv3d_bf16": "conv3d_bf16_kernel",
                "conv3d_f32": "conv3d_f32_kernel",
                "gn_stats": ("gn_partial_kernel", "gn_finish_kernel"),
                "gn_apply": "gn_apply_kernel"}
    by_family = {k: 0.0 for k in families}
    other = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", 0.0)
        if not us:
            continue
        fam = next((k for k, pat in families.items()
                    if any(p in ev.key for p in
                           ((pat,) if isinstance(pat, str) else pat))), None)
        if fam:
            by_family[fam] += us / 1e3
        else:
            other[ev.key[:60]] = other.get(ev.key[:60], 0.0) + us / 1e3
    top = dict(sorted(other.items(), key=lambda kv: -kv[1])[:6])
    device_ms = sum(by_family.values()) + sum(other.values())
    emit({"phase": "profile", "forward_ms": fwd_ms, "batch": 1,
          "device_ms": device_ms, "kernel_ms": by_family,
          "other_ms": sum(other.values()), "top_other_ms": top,
          "idle_share": max(0.0, 1 - device_ms / fwd_ms)})


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        raise SystemExit(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})
    gen = torch.Generator(device="cuda").manual_seed(args.seed)

    phase_build()
    model, sched, cfg = _model(use_fp16=True, seed=args.seed)
    model.cuda()
    summary = phase_kernels(gen, *main_path_shapes(model))
    phase_model(args.seed)
    counts = phase_denoise(model, sched, cfg, args.seed)
    phase_profile(model)

    kernels = []
    for name, meta in KERNELS.items():
        s = summary[name]
        kernels.append(dict(
            name=name, **meta, launches=counts[name],
            max_abs_err=s["max_abs_err"], ms=s["kernel_ms"],
            plain_ms=s["plain_ms"], bound_ms=s["bound_ms"],
            bound_by=s["bound_by"], library_ms=s["library_ms"],
            shapes_checked=s["shapes_checked"],
        ))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
