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
               the bound; each conv on its route (``conv3d_route``: the
               bf16 torso on ``csrc/conv3d_sm90.cu``, the Cin = 2 input
               conv on ``csrc/conv3d_narrow.cu``, the f32 head on
               ``csrc/conv3d_head.cu``), each timed beside the previous
               kernel (``csrc/conv3d.cu``) on the same inputs; the head
               also beside the parent's head instance when
               ``--parent-conv`` names a previous ``csrc/conv3d.cu``; K1
               (GN stats, one launch) also bit for bit twice and alone
               against in a batch of 2, timed beside ``torch.var_mean``
               and, with ``--parent-gn``, a previous
               ``csrc/groupnorm.cu``;
  3. backward — at every distinct conv and GroupNorm shape of one bf16 96^3
               training step (read by hooks): the conv dx kernel, the
               library filter gradient and the GroupNorm Function's backward
               against their plain versions; each timed, and summed per step;
               at the main sites also the plain and library (cuDNN) times,
               the head's dx (f32 2 -> 128 on ``csrc/conv3d_head.cu``) also
               beside ``F.conv3d`` and the previous kernel;
  4. model   — the full-width model (128 ch, (1,1,2,3,4), 2 res blocks) in
               f32 at a small spatial size, kernel path on the card against
               the plain path on the CPU (its input conv and head on the
               f32 routes of ``csrc/conv3d_head.cu``): the forward, then one
               training loss and every parameter gradient;
  5. denoise — ``denoise_volume`` at 128 ch / 96^3 patches / bf16 on a
               synthetic volume with a short respaced chain; the launch
               counters are zeroed just before and read just after, and
               the conv launches per forward are checked by route; then a
               torch.profiler breakdown of one forward by kernel family;
  6. fused   — the fused serving path (``fused=True``, the same weights):
               ``conv3d_fused`` (bf16: the fused instance of
               ``csrc/conv3d_sm90.cu``) against its plain version at every
               distinct fused-conv shape of one bf16 96^3 forward (read by
               hooks), with its stats checked as the next GroupNorm folds
               them, output and stats bit for bit twice and alone against
               in a batch of 2, and five sites timed beside the unfused
               sequence they replace and, with ``--parent-conv``, the
               previous kernel (the parent's bf16 fused ``csrc/conv3d.cu``);
               the full-width f32 fused model on the card against the CPU
               and the unfused card forward (in the model phase);
               ``denoise_fused``, the denoise phase again on the fused
               model, against the unfused volume and with exact launch
               counts; ``profile_fused``, its one-forward breakdown;
  7. int8    — the int8 (W8A8) serving path (``int8=Int8Config()``, the
               same weights): ``conv3d_s8`` against its plain version at
               every distinct quantized-conv shape of one bf16 96^3 int8
               forward (read by hooks; 3^3, 1^3 and the stacked phases of
               the up sites), each at batch 1 and 2, dynamic and static,
               with and without bias, bf16 and f32 out, checked for
               equality; six sites timed beside K3 and the plain version
               (the 1x1 skip beside ``torch._int_mm``), and beside the
               previous K5 when ``--parent-s8`` names its source; the
               widest phase site also beside a 27-tap build of the same
               kernel (``-DCONV3D_S8_ALL_TAPS``); ``model_int8``, the
               full-width f32 int8 model on the card against the CPU, every
               site's output equal to the plain int8 conv on its own input;
               ``denoise_int8``, the denoise phase on the int8 model with
               dynamic scales, exact launches per forward and the volume
               against the bf16 one; ``denoise_int8_static``, per-time-bin
               scales from ``INT8_SCALES_PROD.json`` over its 25-step
               respacing; ``profile_int8``, one forward by family;
  8. train   — the training CLI (``ddpm3d_tpu_torch.scripts.train``) at the
               production flags on a synthetic (2, 96, 200, 200) low/high
               pair: 6 bf16 steps at batch 1 with the launch counters zeroed
               just before; step time, peak memory, losses, launches per
               step, save time; the saved ``model*.pt`` loaded into a serving
               model with ``strict=True``; then a profile of one step.
Then the card's name and power limit, one ``{"kernels": [...]}`` line, and
as the last line ``{"ok": true, "device": {...}}``.

Weights are random, made from ``--seed``. Imports no JAX. The build
phase fails on a spill in the Hopper kernels (the wgmma ones, the fused
K4's instances among them, ``csrc/conv3d_head.cu`` and
``csrc/groupnorm.cu``), on a serialized wgmma and on an FFMA in K5's SASS
(its epilogue must not contract the multiply and add).
"""

from __future__ import annotations

import argparse
import collections
import copy
import csv
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch
import torch.nn.functional as F

H100_BF16_FLOPS = 989e12   # dense tensor-core bf16 (NVIDIA data sheet, SXM)
H100_INT8_OPS = 1979e12    # dense tensor-core int8
H100_F32_FLOPS = 67e12     # f32 on CUDA cores
H100_BYTES = 3.35e12       # HBM3 bytes/s

KERNELS = {
    "conv3d": dict(
        route="cuda", source="ddpm3d_tpu_torch/csrc/conv3d_sm90.cu",
        replaces="ddpm3d_tpu/ops/conv3d_mxu.py:203"),
    "conv3d_dx": dict(
        route="cuda", source="ddpm3d_tpu_torch/csrc/conv3d_sm90.cu",
        replaces="ddpm3d_tpu/ops/conv3d_mxu.py:267"),
    "gn_stats": dict(
        route="cuda", source="ddpm3d_tpu_torch/csrc/groupnorm.cu",
        replaces="ddpm3d_tpu/ops/groupnorm.py:116"),
    "gn_apply": dict(
        route="cuda", source="ddpm3d_tpu_torch/csrc/groupnorm.cu",
        replaces="ddpm3d_tpu/ops/groupnorm.py:149"),
    "conv3d_fused": dict(
        route="cuda", source="ddpm3d_tpu_torch/csrc/conv3d_sm90.cu",
        replaces="ddpm3d_tpu/ops/conv3d_fused.py:230"),
    "conv3d_s8": dict(
        route="cuda", source="ddpm3d_tpu_torch/csrc/conv3d_s8.cu",
        replaces="ddpm3d_tpu/ops/conv3d_s8.py:369"),
    # K3's other instances, by conv3d_route: the bf16 Cin = 2 input conv,
    # the f32 head conv and its dx (their launches are those of their routes)
    "conv3d_narrow": dict(
        route="cuda", source="ddpm3d_tpu_torch/csrc/conv3d_narrow.cu",
        replaces="ddpm3d_tpu/ops/conv3d_mxu.py:203"),
    "conv3d_head": dict(
        route="cuda", source="ddpm3d_tpu_torch/csrc/conv3d_head.cu",
        replaces="ddpm3d_tpu/ops/conv3d_mxu.py:203"),
    "conv3d_head_dx": dict(
        route="cuda", source="ddpm3d_tpu_torch/csrc/conv3d_head.cu",
        replaces="ddpm3d_tpu/ops/conv3d_mxu.py:267"),
}
# the route (ops.route_counts) whose launches are each instance's
ROUTE_OF = {"conv3d_narrow": "conv3d.sm90_narrow",
            "conv3d_head": "conv3d.f32_head",
            "conv3d_head_dx": "conv3d_dx.f32_narrow"}
TRAIN_KERNELS = ("conv3d", "conv3d_dx", "gn_stats", "gn_apply")

# relative tolerance = max|kernel - plain| / max|plain|: bf16 outputs may
# differ by one bf16 rounding (2^-8) where the f32 sums differ in order;
# f32 outputs only by summation order.
TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-5}
MODEL_TOL = 1e-4  # f32 forward, ~70 layers of reordered f32 sums
GRAD_TOL = 1e-3   # f32 loss and gradients, per tensor: forward and backward
# the fused conv's stats as the next GroupNorm uses them: (g, b) folded from
# the kernel's sums against (g, b) from the plain sums, relative to the
# largest entry; and the sum of squares alone, per entry (no cancellation).
# Summation order alone would give ~1e-6. The kernel's f32 outputs carry a
# one-sided error against the plain f32 conv that grows with the depth of
# the sum (measured on an H100: s2 about 6e-8 x Cin, 6e-5 at Cin = 1024,
# the model's widest fused conv; the fold about 2.3e-5 there), as the
# tensor cores' f32 accumulation does not round each partial sum to
# nearest. 1e-4 holds up to Cin ~ 1600 and stops a wrong sum, a wrong tile
# or a missed voxel, which move the stats by far more.
STATS_FOLD_TOL = 1e-4
STATS_S2_TOL = 1e-4
# the bf16 model served fused against unfused on the same input (the first
# forward of the denoise chain), max |diff| / max |unfused|: the fused path
# folds each GroupNorm from the f32 conv sums and adds the residual before
# rounding, the unfused one from the bf16-rounded output and after it, so
# each of the ~70 layers rounds slightly different values to bf16 (2^-8);
# the differences compound over the depth
FUSED_FORWARD_TOL = 5e-2
# the denoised volumes, mean |fused - unfused| / mean |unfused|. Not the max:
# at t = 999 the x0 recovery multiplies the model's difference by
# sqrt(1/acp - 1) ~ 158 before clipping to [-1, 1], so single voxels may
# move across the whole clip range while the volume agrees
DENOISE_FUSED_TOL = 5e-2
# the bf16 model served in int8 against unfused bf16 (same weights, volume
# and noise), the first forward (max-based) and the volume (mean-based):
# not an equivalence but the quantization error of random weights through
# ~70 quantized layers, measured at 4.7e-2 and 2.5e-2 on an H100 80GB HBM3
# at 700 W; about 3x margin, which a wrong scale, bias or tap breaks
INT8_FORWARD_TOL = 0.15
DENOISE_INT8_TOL = 0.1
# launches per forward of the production model on each serving path
FORWARD_LAUNCHES = {
    "denoise": {"conv3d": 72, "conv3d_dx": 0, "conv3d_fused": 0,
                "conv3d_s8": 0, "gn_stats": 71, "gn_apply": 71},
    # 27 fusable ResBlocks x 2; input conv, head conv, 8 up/down blocks x 2;
    # 16 + the head's GN applied; 17 unfused GNs + 14 fused blocks that
    # enter without stats (5 in the encoder, 9 in the decoder)
    "denoise_fused": {"conv3d": 18, "conv3d_dx": 0, "conv3d_fused": 54,
                      "conv3d_s8": 0, "gn_stats": 31, "gn_apply": 17},
    # the 90 conv sites of INT8_SCALES_PROD.json less in0_0 and head_conv:
    # 66 3x3x3 + the 4 up blocks' in_conv (one phase-route launch each) +
    # 18 1x1 skips; the two excluded convs stay K3
    "denoise_int8": {"conv3d": 2, "conv3d_dx": 0, "conv3d_fused": 0,
                     "conv3d_s8": 88, "gn_stats": 71, "gn_apply": 71},
}
FORWARD_LAUNCHES["denoise_int8_static"] = FORWARD_LAUNCHES["denoise_int8"]
# the conv3d launches per forward by kernel route (ops.route_counts): the
# bf16 torso convs on csrc/conv3d_sm90.cu, the Cin = 2 input conv on
# csrc/conv3d_narrow.cu, the f32 head conv on csrc/conv3d_head.cu, none on
# csrc/conv3d.cu; fused: 8 up/down blocks x 2 on sm90, and every fused
# conv on the sm90 fused instance (conv3d_fused.sm90), none on conv3d.cu
def _routes(sm90, narrow, head, dx_sm90=0, dx_f32_narrow=0, fused_sm90=0):
    counts = {f"{what}.{route}": 0 for what in ("conv3d", "conv3d_dx")
              for route in ("sm90", "sm90_narrow", "f32_head", "f32_narrow",
                            "ndhwc")}
    counts.update({"conv3d_fused.sm90": fused_sm90, "conv3d_fused.ndhwc": 0})
    counts.update({"conv3d.sm90": sm90, "conv3d.sm90_narrow": narrow,
                   "conv3d.f32_head": head, "conv3d_dx.sm90": dx_sm90,
                   "conv3d_dx.f32_narrow": dx_f32_narrow})
    return counts


FORWARD_ROUTES = {
    "denoise": _routes(70, 1, 1),
    "denoise_fused": _routes(16, 1, 1, fused_sm90=54),
    "denoise_int8": _routes(0, 1, 1),
}
FORWARD_ROUTES["denoise_int8_static"] = FORWARD_ROUTES["denoise_int8"]
# per training step: the forward's, and the dx of every conv but the input
# conv (70 bf16 torso dx on sm90, the f32 head's 2 -> 128 dx on f32_narrow)
STEP_ROUTES = _routes(70, 1, 1, dx_sm90=70, dx_f32_narrow=1)
# the production training flags (test_DDPM_3d_tpu.sh model flags with the
# training CLI's defaults: batch 1, lr 1e-4, EMA 0.9999, AdamW)
TRAIN_FLAGS = [
    "--large_size", "96", "--num_channels", "128", "--learn_sigma", "True",
    "--use_fp16", "True", "--use_scale_shift_norm", "True",
    "--resblock_updown", "True", "--attention_resolutions", "1000",
    "--num_head_channels", "64", "--diffusion_steps", "1000",
    "--noise_schedule", "linear",
]
TRAIN_STEPS = 6


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


def warm_card(seconds: float = 1.0) -> None:
    """Run bf16 tensor-core work for about ``seconds`` so that the first
    kernel timed meets the card at its loaded clock, as the later ones do."""
    x = torch.randn((1, 96, 96, 96, 128), device="cuda").bfloat16()
    w = torch.randn((128, 128, 3, 3, 3), device="cuda").bfloat16() * 0.02
    xn = x.permute(0, 4, 1, 2, 3)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    while time.monotonic() - t0 < seconds:
        for _ in range(10):
            F.conv3d(xn, w, padding=1)
        torch.cuda.synchronize()


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


# the wgmma sources (conv3d_sm90 holds K3 and the fused K4's instances)
WGMMA_SOURCES = ("conv3d_sm90", "conv3d_s8", "conv3d_narrow")
# sources whose kernels must not spill: the wgmma ones, the f32 head's and
# the GroupNorm kernels
NO_SPILL_SOURCES = WGMMA_SOURCES + ("conv3d_head", "groupnorm")
# study builds compiled beside the package's sources (chip_smoke's own
# names): K5 with every phase tile running all 27 taps, and the previous
# K5 / csrc/conv3d.cu / csrc/groupnorm.cu when --parent-s8 / --parent-conv
# / --parent-gn names its source
VARIANTS = {"s8_all_taps": ("ddpm3d_tpu_torch/csrc/conv3d_s8.cu",
                            ("-DCONV3D_S8_ALL_TAPS",))}


def phase_build(parent_s8=None, parent_conv=None, parent_gn=None) -> dict:
    """Build every source and the study variants in parallel; check the
    ptxas reports and K5's SASS. Returns {variant: ctypes library}."""
    from ddpm3d_tpu_torch.ops import _build

    variants = dict(VARIANTS)
    if parent_s8:
        variants["s8_parent"] = (parent_s8, ())
    if parent_conv:
        variants["conv_parent"] = (parent_conv, ())
    if parent_gn:
        variants["gn_parent"] = (parent_gn, ())
    root = os.path.dirname(os.path.abspath(__file__))
    variants = {k: (os.path.join(root, src), flags)
                for k, (src, flags) in variants.items()}
    t0 = time.monotonic()
    libs = _build.build_variants(variants)
    paths = _build.build_all()
    emit({"phase": "build", "seconds": round(time.monotonic() - t0, 3),
          "libs": sorted(paths), "variants": sorted(libs)})
    for name, path in paths.items():
        with open(path + ".log") as f:
            for line in f:
                if "registers" in line or "spill" in line:
                    print(f"ptxas[{name}]: {line.strip()}")
                if name in NO_SPILL_SOURCES:
                    check("spill" not in line or " 0 bytes spill stores, 0 "
                          "bytes spill loads" in line,
                          f"{name} spills: {line.strip()}")
                if name in WGMMA_SOURCES:
                    # ptxas must not have serialized the wgmma pipeline
                    check("serialized" not in line,
                          f"{name} wgmma serialized: {line.strip()}")
    # K5 equals its plain version only if the multiply and the add of its
    # epilogue stay two roundings: no FFMA anywhere in its code
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", paths["conv3d_s8"]],
                          capture_output=True, text=True, check=True).stdout
    # (GMMA: the wgmma opcodes, IGMMA for int8)
    counts = {op: sass.count(op) for op in ("FFMA", "FMUL", "FADD", "GMMA")}
    emit({"phase": "build_sass", "lib": "conv3d_s8", "counts": counts})
    check(counts["GMMA"] > 0 and counts["FMUL"] > 0,
          "conv3d_s8 SASS has its wgmma and its epilogue multiply")
    check(counts["FFMA"] == 0, f"conv3d_s8 SASS contracts an FMA: {counts}")
    return libs


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
    (96 * 6 * 6, 512, torch.bfloat16, True, True),  # level-4 out_norm
]


def _ndhwc_conv(x, wp, bias, lib=None):
    """csrc/conv3d.cu's instance for x's dtype on the same inputs (``wp``
    from ``pack_weight``): the kernel that carried every conv before the
    sm90 and head routes (its bf16 and f32 BN = 64 instances are
    unchanged), timed beside the new kernels in one run; with ``lib``, the
    same entry point of another build (the parent's source)."""
    from ddpm3d_tpu_torch.ops import _build
    from ddpm3d_tpu_torch.ops import conv3d as cv

    B, D, H, W, cin = x.shape
    y = torch.empty((B, D, H, W, wp.shape[1]), dtype=x.dtype, device=x.device)
    launch = (_build.fn("conv3d_ndhwc_launch") if lib is None
              else _build.variant_fn(lib, "conv3d_ndhwc_launch"))
    err = launch(
        x.data_ptr(), wp.data_ptr(),
        None if bias is None else bias.data_ptr(), y.data_ptr(),
        B, D, H, W, cin, wp.shape[1], *cv.pick_tile(D, H, W),
        1 if x.dtype == torch.bfloat16 else 0,
        torch.cuda.current_stream().cuda_stream)
    _build.check(err, "conv3d_ndhwc_launch")
    return y


def _parent_gn_stats(lib, x):
    """K1 of a previous ``csrc/groupnorm.cu`` (two launches: row-split
    partials of max(64, ceil(N / 1024)) rows, then a one-block-per-slice
    finish; its entry point ``gn_stats_launch(x, part, stats, B, N, C,
    rows, dtype, stream)``) on the same input."""
    import ctypes

    from ddpm3d_tpu_torch.ops import _build

    B, N, C = x.shape
    rows = max(64, -(-N // 1024))
    S = -(-N // rows)
    part = torch.empty((B * S * 2 * C,), dtype=torch.float32, device=x.device)
    stats = torch.empty((B, 2, C), dtype=torch.float32, device=x.device)
    fn = lib.gn_stats_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _build.check(fn(x.data_ptr(), part.data_ptr(), stats.data_ptr(), B, N, C,
                    rows, 1 if x.dtype == torch.bfloat16 else 0,
                    torch.cuda.current_stream().cuda_stream),
                 "gn_stats_launch (parent)")
    return stats


def _conv_tile(cv, x, cout, route):
    """The output tile the conv's launch uses (sm90: 256 or 128 rows; the
    head: its (H, W) window and D segments per volume; the narrow kernels
    walk 64- or 128-row slices of the flattened voxels)."""
    B, D, H, W, _ = x.shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if route == "sm90":
        return list(cv.sm90_tile(B, D, H, W, cout, sms))
    if route == "f32_head":
        return dict(window=list(cv.head_tile(cout)),
                    segments=cv.head_plan(D, H, W, cout, sms)[2])
    if route in ("sm90_narrow", "f32_narrow"):
        return None
    return list(cv.pick_tile(D, H, W))


def phase_kernels(gen: torch.Generator, conv_shapes, gn_shapes,
                  conv_parent=None, gn_parent=None) -> dict:
    """Each kernel against its plain version at every distinct shape of the
    main path; the shapes of CONV_TIMED / GN_TIMED are timed too, the f32
    head also beside ``conv_parent`` (a build of the parent's
    csrc/conv3d.cu, whose Cout <= 8 instance carried it) when given, K1
    beside ``gn_parent`` (the parent's csrc/groupnorm.cu) when given. K1
    is also checked bit for bit between two runs and between a volume
    alone and in a batch of 2."""
    from ddpm3d_tpu_torch.ops import conv3d as cv
    from ddpm3d_tpu_torch.ops import groupnorm as gn

    dev = torch.device("cuda")
    for case in CONV_TIMED:
        check(case in conv_shapes, f"timed conv {case} is on the main path")
    for case in GN_TIMED:
        check(case in gn_shapes, f"timed GN {case} is on the main path")
    summary = {}
    checked = {"conv3d": 0, "gn_stats": 0, "gn_apply": 0}
    warm_card()

    for case in CONV_TIMED + [c for c in conv_shapes if c not in CONV_TIMED]:
        D, H, W, cin, cout, dt = case
        B = 1
        x = torch.randn((B, D, H, W, cin), generator=gen, device=dev).to(dt)
        w = (torch.randn((cout, cin, 3, 3, 3), generator=gen, device=dev)
             * (27 * cin) ** -0.5)
        b = torch.randn((cout,), generator=gen, device=dev) * 0.1
        wp = cv.pack_weight_kernel(w, dt)
        wd = w.to(dt)
        out = cv.conv3d_kernel(x, wp, b)
        ref = cv.conv3d_plain(x, wd, b)
        torch.cuda.synchronize()
        err, rel = rel_err(out, ref)
        check(bool(torch.isfinite(out.float()).all()), "conv3d output finite")
        route = cv.conv3d_route(x.shape, dt, cout)
        line = dict(kernel="conv3d", shape=[B, D, H, W, cin], cout=cout,
                    dtype=str(dt).split(".")[-1], route=route,
                    tile=_conv_tile(cv, x, cout, route),
                    max_abs_err=err, rel_err=rel, tol=TOL[dt])
        if case in CONV_TIMED:
            ms = time_ms(lambda: cv.conv3d_kernel(x, wp, b))
            wo = cv.pack_weight(w, dt)
            if route != "ndhwc":  # the same conv on the previous kernel
                line["ndhwc_ms"] = time_ms(lambda: _ndhwc_conv(x, wo, b))
            if route == "f32_head":  # and on the parent's head instance
                line["parent_ms"] = None
                if conv_parent is not None:
                    line["parent_ms"] = time_ms(
                        lambda: _ndhwc_conv(x, wo, b, conv_parent))
                    p_err = rel_err(_ndhwc_conv(x, wo, b, conv_parent), ref)
                    line["parent_rel_err"] = p_err[1]
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
        if case in CONV_TIMED:  # the input and head instances' own lines
            name = {"sm90_narrow": "conv3d_narrow",
                    "f32_head": "conv3d_head"}.get(route)
            if name:
                summary.setdefault(name, dict(line, shapes_checked=1))
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
        # K1's yardstick: the one PyTorch call that yields the same group
        # statistics (mean and variance over the [N, C/32] group view); K2
        # has none (no single call does GN + FiLM + SiLU)
        xg = x.reshape(B, N, gn.NORM_GROUPS, C // gn.NORM_GROUPS)
        cases = (
            ("gn_stats", s_err, s_rel, 1e-5,
             lambda: gn.channel_stats(x), lambda: gn.channel_stats_plain(x),
             lambda: torch.var_mean(xg, dim=(1, 3)),
             B * N * C * isz + B * 2 * C * 4, 3.0 * B * N * C),
            ("gn_apply", a_err, a_rel, TOL[dt],
             lambda: gn.gn_apply(x, g, bb, silu),
             lambda: gn.gn_apply_plain(x, g, bb, silu), None,
             2 * B * N * C * isz + 2 * B * C * 4, 6.0 * B * N * C),
        )
        for name, err, rel, tol, kfn, pfn, lfn, nbytes, flops in cases:
            line = dict(kernel=name, shape=[B, N, C],
                        dtype=str(dt).split(".")[-1], film=film, silu=silu,
                        max_abs_err=err, rel_err=rel, tol=tol)
            if case in GN_TIMED:
                ms = time_ms(kfn)
                bms, by = bound(flops, nbytes, torch.float32)
                line.update(kernel_ms=ms, plain_ms=time_ms(pfn),
                            library_ms=time_ms(lfn) if lfn else None,
                            bound_ms=bms, bound_by=by,
                            gb_per_s=nbytes / ms / 1e6)
                if name == "gn_stats":
                    line["parent_ms"] = None
                    if gn_parent is not None:
                        p_st = _parent_gn_stats(gn_parent, x)
                        line["parent_rel_err"] = rel_err(p_st, st_ref)[1]
                        line["parent_ms"] = time_ms(
                            lambda: _parent_gn_stats(gn_parent, x))
            if name == "gn_stats":
                # one launch, fixed order: equal on a second run and for
                # volume 1 of a batch of 2 (its own data) alone
                x2 = torch.cat([x, (x.float() * 0.5 - 0.25).to(dt)])
                st2 = gn.channel_stats(x2)
                line["deterministic"] = bool(torch.equal(st, gn.channel_stats(x)))
                line["batch_invariant"] = bool(torch.equal(
                    st2[:1], st) and torch.equal(
                        st2[1:], gn.channel_stats(x2[1:].contiguous())))
                del x2
            emit(line)
            check(rel <= tol, f"{name} {line['shape']} rel err {rel}")
            if name == "gn_stats":
                check(line["deterministic"] and line["batch_invariant"],
                      f"gn_stats {line['shape']} is deterministic and "
                      f"batch-invariant")
            checked[name] += 1
            summary.setdefault(name, line)
        check(f_rel <= TOL[dt], f"group_norm end to end rel err {f_rel}")
        del x, y, y_ref, full
    for name, n in checked.items():
        summary[name] = dict(summary[name], shapes_checked=n)
    return summary


def fused_path_shapes(model) -> list:
    """Every distinct fused conv of one bf16 96^3 batch-1 forward of the
    fused model, read by forward pre-hooks: (D, H, W, Cin, Cout, dtype,
    prologue, silu, skip, stats)."""
    from ddpm3d_tpu_torch.models.nn import Conv3x3x3

    convs = set()

    def hook(mod, args, kwargs):
        if not kwargs.get("fused"):
            return
        _, D, H, W, cin = args[0].shape
        convs.add((D, H, W, cin, mod.weight.shape[0], args[0].dtype,
                   kwargs.get("prologue_g") is not None,
                   bool(kwargs.get("prologue_silu", True)),
                   kwargs.get("skip") is not None,
                   bool(kwargs.get("want_stats", False))))

    handles = [m.register_forward_pre_hook(hook, with_kwargs=True)
               for m in model.modules() if isinstance(m, Conv3x3x3)]
    x = torch.randn((1, 96, 96, 96, 1), device="cuda")
    with torch.no_grad():
        model(x, torch.tensor([500], device="cuda"), low_res=x)
    for h in handles:
        h.remove()
    return sorted(convs, key=str)


# fused sites that are timed (the rest are only checked): (D, H, W, Cin,
# Cout, dtype, prologue, silu, skip, stats)
FUSED_TIMED = [
    # level-0 ResBlock out_conv: FiLM'd GN prologue, identity skip, stats
    (96, 96, 96, 128, 128, torch.bfloat16, True, True, True, True),
    # level-0 ResBlock in_conv
    (96, 96, 96, 128, 128, torch.bfloat16, True, True, False, True),
    # level-0 decoder in_conv (the block's out_conv is the 128 -> 128 site
    # above, with the 1x1 conv of this 256-channel input as its skip)
    (96, 96, 96, 256, 128, torch.bfloat16, True, True, False, True),
    (96, 48, 48, 256, 128, torch.bfloat16, True, True, False, True),
    (96, 6, 6, 1024, 512, torch.bfloat16, True, True, False, True),
]


def _parent_fused(lib, x, wp, b, kw):
    """The bf16 fused instance of a previous ``csrc/conv3d.cu`` (its
    ``conv3d_fused_launch``: mma.sync, 128-row tiles of ``pick_tile``, a
    two-level stats finish) on the same inputs: the kernel K4 replaces."""
    from ddpm3d_tpu_torch.ops import _build
    from ddpm3d_tpu_torch.ops import conv3d as cv
    from ddpm3d_tpu_torch.ops import conv3d_fused as fo

    B, D, H, W, cin = x.shape
    cout = wp.shape[1]
    td, th, tw = cv.pick_tile(D, H, W)
    y = torch.empty((B, D, H, W, cout), dtype=x.dtype, device=x.device)
    part = part2 = stats = None
    if kw.get("want_stats"):
        tiles = -(-D // td) * -(-H // th) * -(-W // tw)
        groups = -(-tiles // fo.STATS_GROUP)
        part = torch.empty((B * tiles * 2 * cout,), device=x.device)
        part2 = torch.empty((B * groups * 2 * cout,), device=x.device)
        stats = torch.empty((B, 2, cout), device=x.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = _build.variant_fn(lib, "conv3d_fused_launch")(
        x.data_ptr(), wp.data_ptr(), b.data_ptr(), ptr(kw.get("prologue_g")),
        ptr(kw.get("prologue_b")), int(kw.get("prologue_silu", True)),
        ptr(kw.get("skip")), y.data_ptr(), ptr(part), ptr(part2), ptr(stats),
        B, D, H, W, cin, cout, td, th, tw, 1,
        torch.cuda.current_stream().cuda_stream)
    _build.check(err, "conv3d_fused_launch (parent)")
    return (y, stats) if kw.get("want_stats") else y


def _fused_exact(fo, x, wp, b, kw, gen) -> dict:
    """The sm90 fused conv repeats itself bit for bit, and volume 0 of a
    batch of 2 (the second volume other data) equals it alone: output and
    stats."""
    got = fo.conv3d_fused_kernel(x, wp, b, **kw)
    again = fo.conv3d_fused_kernel(x, wp, b, **kw)
    other = (torch.randn(x.shape, generator=gen, device=x.device)
             .to(x.dtype))
    kw2 = dict(kw)
    for key in ("prologue_g", "prologue_b"):
        if kw.get(key) is not None:
            kw2[key] = torch.cat([kw[key], kw[key].flip(1)])
    if kw.get("skip") is not None:
        kw2["skip"] = torch.cat([kw["skip"], kw["skip"].flip(-1)])
    both = fo.conv3d_fused_kernel(torch.cat([x, other]), wp, b, **kw2)
    torch.cuda.synchronize()
    pairs = [(got, again, both)] if not kw.get("want_stats") else \
        [(got[0], again[0], both[0]), (got[1], again[1], both[1])]
    return dict(deterministic=all(torch.equal(a, c) for a, c, _ in pairs),
                batch_invariant=all(torch.equal(a, z[:1]) for a, _, z in pairs))


def phase_fused_kernels(gen: torch.Generator, shapes, conv_parent=None) -> dict:
    """``conv3d_fused`` against its plain version at every distinct fused
    shape with the flags the model uses there: the output at TOL, the stats
    as the next GroupNorm folds them; at every distinct shape also bit for
    bit between two runs and between a volume alone and in a batch of 2.
    At the FUSED_TIMED sites also the kernel, plain and bound times, the
    unfused sequence the kernel replaces (K2 gn_apply + K3 conv + skip add
    + K1 channel_stats; no single PyTorch call computes this function) and,
    with ``conv_parent`` (a previous csrc/conv3d.cu), the kernel it
    replaces (``previous_ms``)."""
    from ddpm3d_tpu_torch.ops import conv3d as cv
    from ddpm3d_tpu_torch.ops import conv3d_fused as fo
    from ddpm3d_tpu_torch.ops import groupnorm as gn

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for case in FUSED_TIMED:
        check(case in shapes, f"timed fused conv {case} is on the fused path")
    summary, checked, worst = None, 0, collections.defaultdict(float)
    for case in FUSED_TIMED + [c for c in shapes if c not in FUSED_TIMED]:
        D, H, W, cin, cout, dt, pro, silu, use_skip, stats = case
        B, N = 1, D * H * W
        x = (torch.randn((B, D, H, W, cin), generator=gen, device=dev) * 2
             + 0.5).to(dt)
        w = (torch.randn((cout, cin, 3, 3, 3), generator=gen, device=dev)
             * (27 * cin) ** -0.5)
        b = torch.randn((cout,), generator=gen, device=dev) * 0.1
        kw = dict(prologue_silu=silu, want_stats=stats)
        if pro:  # a folded GroupNorm's affine: x is ~N(0.5, 2)
            kw["prologue_g"] = 0.5 * (1 + 0.1 * torch.randn(
                (B, cin), generator=gen, device=dev))
            kw["prologue_b"] = -0.25 + 0.1 * torch.randn(
                (B, cin), generator=gen, device=dev)
        if use_skip:
            kw["skip"] = torch.randn((B, D, H, W, cout), generator=gen,
                                     device=dev).to(dt)
        wp, wd = cv.pack_weight(w, dt), w.to(dt)
        got = fo.conv3d_fused_kernel(x, wp, b, **kw)
        ref = fo.conv3d_fused_plain(x, wd, b, **kw)
        torch.cuda.synchronize()
        out, ref_out = (got[0], ref[0]) if stats else (got, ref)
        check(bool(torch.isfinite(out.float()).all()), "conv3d_fused finite")
        err, rel = rel_err(out, ref_out)
        line = dict(kernel="conv3d_fused", shape=[B, D, H, W, cin], cout=cout,
                    dtype=str(dt).split(".")[-1], prologue=pro, silu=silu,
                    skip=use_skip, stats=stats,
                    route=fo.conv3d_fused_route(x.shape, dt),
                    tile=list(fo.fused_tile(D, H, W, cout, sms)),
                    max_abs_err=err, rel_err=rel, tol=TOL[dt])
        line.update(_fused_exact(fo, x, wp, b, kw, gen))
        if stats:
            ones = torch.ones(cout, device=dev)
            zeros = torch.zeros(cout, device=dev)
            gk, bk = gn.fold_gn_affine(got[1], N, ones, zeros)
            gp, bp = gn.fold_gn_affine(ref[1], N, ones, zeros)
            s2_rel = ((got[1][:, 1] - ref[1][:, 1]).abs()
                      / ref[1][:, 1]).max().item()
            line.update(stats_fold_rel_err=max(rel_err(gk, gp)[1],
                                               rel_err(bk, bp)[1]),
                        stats_fold_tol=STATS_FOLD_TOL, stats_s2_rel_err=s2_rel,
                        stats_s2_tol=STATS_S2_TOL)
        if case in FUSED_TIMED:
            def unfused():
                h = x
                if pro:
                    h = gn.gn_apply(x.reshape(B, N, cin), kw["prologue_g"],
                                    kw["prologue_b"], silu).reshape(x.shape)
                y = cv.conv3d_kernel(h, wp, b)
                if use_skip:
                    y = y + kw["skip"]
                if stats:
                    gn.channel_stats(y.reshape(B, N, cout))
                return y

            ms = time_ms(lambda: fo.conv3d_fused_kernel(x, wp, b, **kw))
            plain_ms = time_ms(lambda: fo.conv3d_fused_plain(x, wd, b, **kw),
                               reps=3, warmup=1)
            seq_ms = time_ms(unfused)
            isz = x.element_size()
            flops = 2.0 * 27 * cin * cout * B * N
            nbytes = (B * N * (cin + cout * (1 + use_skip)) * isz
                      + wp.numel() * isz + (2 * B * cin + cout) * 4
                      + (2 * B * cout * 4 if stats else 0))
            bms, by = bound(flops, nbytes, dt)
            line.update(kernel_ms=ms, plain_ms=plain_ms, bound_ms=bms,
                        bound_by=by, unfused_sequence_ms=seq_ms,
                        library_ms=None, tflops=flops / ms / 1e9,
                        previous_ms=None)
            if conv_parent is not None:
                prev = _parent_fused(conv_parent, x, wp, b, kw)
                prev = prev[0] if stats else prev
                line["previous_rel_err"] = rel_err(prev, ref_out)[1]
                line["previous_ms"] = time_ms(
                    lambda: _parent_fused(conv_parent, x, wp, b, kw))
        emit(line)
        check(rel <= TOL[dt], f"conv3d_fused {line['shape']}->{cout} "
              f"{case[6:]} rel err {rel}")
        check(line["deterministic"] and line["batch_invariant"],
              f"conv3d_fused {line['shape']}->{cout} {case[6:]} repeats "
              f"exactly and alone equals in a batch of 2")
        if stats:
            check(line["stats_fold_rel_err"] <= STATS_FOLD_TOL,
                  f"conv3d_fused stats fold rel err {line['stats_fold_rel_err']}")
            check(s2_rel <= STATS_S2_TOL, f"conv3d_fused s2 rel err {s2_rel}")
            worst["stats_fold"] = max(worst["stats_fold"],
                                      line["stats_fold_rel_err"])
            worst["stats_s2"] = max(worst["stats_s2"], s2_rel)
        worst["out"] = max(worst["out"], rel)
        checked += 1
        if summary is None:
            summary = line
        del x, got, ref, out, ref_out
    emit({"phase": "fused_kernels", "shapes_checked": checked,
          "worst_rel_err": dict(worst), "deterministic": True,
          "batch_invariant": True})
    return dict(summary, shapes_checked=checked)


def _model(use_fp16: bool, seed: int, fused: bool = False, int8=None):
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
    model, sched, cfg = sr_create_model_and_diffusion(**args, fused=fused,
                                                      int8=int8)
    init_params(model, seed=seed, zero_heads=False)
    return model.eval(), sched, cfg


def phase_model(seed: int) -> None:
    from ddpm3d_tpu_torch import ops
    from ddpm3d_tpu_torch.models.factory import create_gaussian_diffusion
    from ddpm3d_tpu_torch.training import train_loop as tl

    model, _, _ = _model(use_fp16=False, seed=seed)
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((1, 8, 32, 32, 1), np.float32))
    low = torch.from_numpy(rng.standard_normal((1, 8, 32, 32, 1), np.float32))
    t = torch.tensor([517])
    with torch.no_grad():
        ref = model(x, t, low_res=low)
        ops.reset_launch_counts()
        out = copy.deepcopy(model).cuda()(
            x.cuda(), t.cuda(), low_res=low.cuda()).cpu()
    routes = {k: v for k, v in ops.route_counts().items() if v}
    err, rel = rel_err(out, ref)
    emit({"phase": "model", "shape": list(x.shape), "channels": 128,
          "dtype": "float32", "max_abs_err": err, "rel_err": rel,
          "tol": MODEL_TOL, "ref_abs_max": ref.abs().max().item(),
          "routes": routes})
    check(ref.abs().max().item() > 1e-3, "model output is non-trivial")
    check(rel <= MODEL_TOL, f"full-width model kernel path rel err {rel}")
    # the f32 model: its Cin = 2 input conv and its head on csrc/
    # conv3d_head.cu, the 70 torso convs on csrc/conv3d.cu
    check(routes == {"conv3d.f32_narrow": 1, "conv3d.f32_head": 1,
                     "conv3d.ndhwc": 70}, f"f32 model conv routes {routes}")

    # the same weights served fused: the card's kernels against the plain
    # fused path on the CPU, and against the unfused card forward
    fused, _, _ = _model(use_fp16=False, seed=seed, fused=True)
    fused.load_state_dict(model.state_dict(), strict=True)
    with torch.no_grad():
        ref_fused = fused(x, t, low_res=low)
        ops.reset_launch_counts()
        out_fused = fused.cuda()(x.cuda(), t.cuda(), low_res=low.cuda()).cpu()
    n_fused = ops.launch_counts()["conv3d_fused"]
    fused_routes = {k: v for k, v in ops.route_counts().items()
                    if k.startswith("conv3d_fused.") and v}
    rel_cpu = rel_err(out_fused, ref_fused)[1]
    rel_unfused = rel_err(out_fused, out)[1]
    emit({"phase": "model_fused", "shape": list(x.shape), "channels": 128,
          "dtype": "float32", "rel_err_vs_cpu": rel_cpu,
          "rel_err_vs_unfused_card": rel_unfused, "tol": MODEL_TOL,
          "conv3d_fused_launches": n_fused, "routes": fused_routes})
    check(n_fused == FORWARD_LAUNCHES["denoise_fused"]["conv3d_fused"],
          f"fused model launched conv3d_fused {n_fused} times")
    # f32 fused convs stay on csrc/conv3d.cu's f32 instance
    check(fused_routes == {"conv3d_fused.ndhwc": n_fused},
          f"f32 fused model routes {fused_routes}")
    check(rel_cpu <= MODEL_TOL, f"fused model card vs CPU rel err {rel_cpu}")
    check(rel_unfused <= MODEL_TOL,
          f"fused vs unfused card forward rel err {rel_unfused}")
    del fused

    # one training loss and every parameter gradient, same t and noise
    sched, cfg = create_gaussian_diffusion(
        steps=1000, learn_sigma=True, noise_schedule="linear")
    x0 = torch.from_numpy(np.clip(x.numpy(), -1, 1))
    noise = torch.from_numpy(rng.standard_normal(x.shape, np.float32))
    grads, losses = [], []
    for dev in ("cpu", "cuda"):
        m = model if dev == "cpu" else copy.deepcopy(model).cuda()
        m.train()
        terms = tl.compute_grads(
            m, sched.to(dev), cfg, x0.to(dev), {"low_res": low.to(dev)},
            t.to(dev), torch.ones(1, device=dev), noise=noise.to(dev))
        losses.append(terms["loss"].cpu())
        grads.append({n: p.grad.cpu() for n, p in m.named_parameters()})
        del m
    loss_rel = rel_err(losses[1], losses[0])[1]
    worst, worst_name = 0.0, None
    for name, g_ref in grads[0].items():
        r = rel_err(grads[1][name], g_ref)[1]
        if r > worst:
            worst, worst_name = r, name
    emit({"phase": "model_grads", "shape": list(x.shape), "dtype": "float32",
          "t": t.tolist(), "loss_cpu": losses[0].tolist(),
          "loss_card": losses[1].tolist(), "loss_rel_err": loss_rel,
          "tensors": len(grads[0]), "worst_grad_rel_err": worst,
          "worst_grad_tensor": worst_name, "tol": GRAD_TOL})
    check(all(bool(torch.isfinite(g).all()) for g in grads[1].values()),
          "card gradients finite")
    check(loss_rel <= GRAD_TOL, f"training loss rel err {loss_rel}")
    check(worst <= GRAD_TOL, f"gradient {worst_name} rel err {worst}")


def phase_denoise(model, sched, cfg, seed: int, phase: str = "denoise"):
    """``denoise_volume`` on the synthetic volume; launches per forward must
    equal FORWARD_LAUNCHES[phase]. Returns (launch counts, volume, the
    chain's first model output)."""
    from ddpm3d_tpu_torch import ops
    from ddpm3d_tpu_torch.inference.pipeline import denoise_volume

    shape = (96, 144, 144)  # (Z, H, W): 2 x 2 patches of 96^3
    vol = np.random.default_rng(seed).gamma(2.0, 0.5, shape).astype(np.float32)
    batch = 2
    with torch.no_grad():  # warm-up: kernel libraries, weight packing
        z = torch.zeros((batch, 96, 96, 96, 1), device="cuda")
        model(z, torch.zeros((batch,), dtype=torch.long, device="cuda"),
              low_res=z)
    first = []
    hook = model.register_forward_hook(
        lambda mod, args, out: first.append(out.float().cpu())
        if not first else None)
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
    routes = ops.route_counts()
    hook.remove()
    steps = sched.num_timesteps
    n_patches = 4
    forwards = steps * -(-n_patches // batch)
    per_forward = {k: v / forwards for k, v in counts.items()}
    routes_per_forward = {k: v / forwards for k, v in routes.items()}
    line = {
        "phase": phase, "volume_zhw": list(shape), "patches": n_patches,
        "patch": 96, "channels": 128, "dtype": "bfloat16", "steps": steps,
        "batch": batch, "wall_s": wall, "sample_wall_s": stats["sample_wall_s"],
        "ms_per_step": stats["sample_wall_s"] * 1e3 / steps,
        "ms_per_forward": stats["sample_wall_s"] * 1e3 / forwards,
        "volume_voxels_per_s": float(np.prod(shape)) / stats["sample_wall_s"],
        "patch_voxel_steps_per_s":
            n_patches * 96 ** 3 * steps / stats["sample_wall_s"],
        "launches": counts,
        "launches_per_forward": per_forward,
        "routes_per_forward": routes_per_forward,
        "finite": bool(np.isfinite(result).all()),
        "result_shape": list(result.shape),
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
    }
    emit(line)
    check(line["finite"], "denoised volume is finite")
    check(tuple(result.shape) == (144, 144, 96), "result is (H, W, Z)")
    check(float(np.abs(result).max()) > 0, "result is non-trivial")
    check(per_forward == FORWARD_LAUNCHES[phase],
          f"{phase} launches per forward {per_forward}")
    check(routes_per_forward == FORWARD_ROUTES[phase],
          f"{phase} conv routes per forward {routes_per_forward}")
    counts["routes"] = routes
    return counts, result, first[0]


def check_volumes(phase, volume, other, eps, other_eps, forward_tol,
                  volume_tol) -> None:
    """Another serving path's chain against the unfused one (same weights,
    volume and noise): the first forward (the same input on both paths)
    within ``forward_tol`` (max-based), the volume within ``volume_tol``
    (mean-based; the max is reported)."""
    d = np.abs(other - volume)
    fwd_rel = rel_err(other_eps, eps)[1]
    mean_rel = float(d.mean() / np.abs(volume).mean())
    emit({"phase": phase,
          "first_forward_rel_diff": fwd_rel, "forward_tol": forward_tol,
          "volume_mean_rel_diff": mean_rel, "volume_tol": volume_tol,
          "volume_max_abs_diff": float(d.max()),
          "volume_max_rel_diff": float(d.max() / np.abs(volume).max()),
          "volume_share_within": {str(a): float((d <= a).mean())
                                  for a in (1e-3, 1e-2, 1e-1)},
          "volume_quantiles": {str(q): float(np.quantile(d, q))
                               for q in (0.5, 0.9, 0.99, 0.999)}})
    check(fwd_rel <= forward_tol, f"{phase}: first forward rel {fwd_rel}")
    check(mean_rel <= volume_tol, f"{phase}: volume mean rel {mean_rel}")


# kernel families of a profile, by substrings of the device kernels' names
FORWARD_FAMILIES = {
    # the fused instances of the sm90 conv (kFused = true; names demangled
    # or mangled) and their stats finish; listed first, so that the conv
    # families below take only the plain conv
    "conv3d_fused": ("conv3d_sm90_kernel<1, true>",
                     "conv3d_sm90_kernel<2, true>",
                     "conv3d_sm90_kernelILi1ELb1E",
                     "conv3d_sm90_kernelILi2ELb1E", "fused_stats_finish"),
    "conv3d_sm90": ("conv3d_sm90_kernel",),
    "conv3d_narrow": ("conv3d_narrow_kernel",),
    "conv3d_bf16": ("conv3d_bf16_kernel",),
    "conv3d_head": ("conv3d_head_kernel",),
    "conv3d_f32_narrow": ("conv3d_f32_narrow_kernel",),
    "conv3d_f32": ("conv3d_f32_kernel",),
    "gn_stats": ("gn_stats_kernel",),
    "gn_apply": ("gn_apply_kernel",),
}
TRAIN_FAMILIES = dict(
    FORWARD_FAMILIES,
    dw_library=("wgrad", "Wgrad", "convolution_backward"),
    optimizer=("multi_tensor_apply", "foreach"),
)


def device_breakdown(prof, families) -> tuple:
    """Device ms of a torch.profiler run by kernel family, and the rest by
    kernel name (cut to 70 characters)."""
    by_family = {k: 0.0 for k in families}
    other = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", 0.0)
        if not us:
            continue
        fam = next((k for k, pats in families.items()
                    if any(p in ev.key for p in pats)), None)
        if fam:
            by_family[fam] += us / 1e3
        else:
            other[ev.key[:70]] = other.get(ev.key[:70], 0.0) + us / 1e3
    return by_family, other


def phase_profile(model, phase: str = "profile",
                  families=FORWARD_FAMILIES) -> None:
    """Device time of one bf16 96^3 forward at batch 1, by kernel family
    (torch.profiler), against the forward's CUDA-event time; and the host's
    time to issue the forward (the call returns before the card is done:
    near the forward's time, the host holds the card back)."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn((1, 96, 96, 96, 1), device="cuda")
    t = torch.tensor([500], device="cuda")
    with torch.no_grad():
        fwd_ms = time_ms(lambda: model(x, t, low_res=x), reps=3, warmup=1)
        host = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model(x, t, low_res=x)
            host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            model(x, t, low_res=x)
            torch.cuda.synchronize()
    by_family, other = device_breakdown(prof, families)
    top = dict(sorted(other.items(), key=lambda kv: -kv[1])[:6])
    device_ms = sum(by_family.values()) + sum(other.values())
    emit({"phase": phase, "forward_ms": fwd_ms, "batch": 1,
          "host_issue_ms": statistics.median(host),
          "device_ms": device_ms, "kernel_ms": by_family,
          "other_ms": sum(other.values()), "top_other_ms": top,
          "idle_share": max(0.0, 1 - device_ms / fwd_ms)})


def training_shapes(model, sched, cfg) -> tuple:
    """Every conv and GroupNorm call of one bf16 96^3 batch-1 training step
    (forward and backward through ``compute_grads``), read by forward
    pre-hooks, with the number of calls of each: conv (D, H, W, Cin, Cout,
    dtype, dx needed) and GN (N, C, dtype, film, silu)."""
    from ddpm3d_tpu_torch.models.nn import Conv3x3x3, GroupNorm32
    from ddpm3d_tpu_torch.training import train_loop as tl

    convs, gns = collections.Counter(), collections.Counter()

    def conv_hook(mod, args):
        x = args[0]
        _, D, H, W, cin = x.shape
        convs[(D, H, W, cin, mod.weight.shape[0], x.dtype,
               bool(x.requires_grad))] += 1

    def gn_hook(mod, args, kwargs):
        x = args[0]
        gns[(int(np.prod(x.shape[1:-1])), x.shape[-1], x.dtype,
             kwargs.get("film_scale") is not None,
             bool(kwargs.get("apply_silu", False)))] += 1

    handles = []
    for m in model.modules():
        if isinstance(m, Conv3x3x3):
            handles.append(m.register_forward_pre_hook(conv_hook))
        elif isinstance(m, GroupNorm32):
            handles.append(m.register_forward_pre_hook(gn_hook,
                                                       with_kwargs=True))
    x = torch.randn((1, 96, 96, 96, 1), device="cuda").clamp(-1, 1)
    tl.compute_grads(model.train(), sched.to("cuda"), cfg, x,
                     {"low_res": x}, torch.tensor([500], device="cuda"),
                     torch.ones(1, device="cuda"))
    torch.cuda.synchronize()
    for h in handles:
        h.remove()
    model.zero_grad(set_to_none=True)
    model.eval()
    return convs, gns


# backward sites that are timed beside their plain and library versions:
# forward conv (D, H, W, Cin, Cout, dtype); the dx conv maps Cout -> Cin
DX_TIMED = [
    (96, 96, 96, 128, 128, torch.bfloat16),   # level-0 ResBlock conv
    (96, 96, 96, 256, 128, torch.bfloat16),   # level-0 decoder in_conv
    (96, 48, 48, 256, 128, torch.bfloat16),   # level-1 decoder in_conv
    (96, 6, 6, 1024, 512, torch.bfloat16),    # level-4 decoder in_conv
    (96, 96, 96, 128, 2, torch.float32),      # head conv: dx is f32 2 -> 128
]


def _library_dx(dy, x, w):
    """cuDNN's data-gradient conv on NCDHW views (the yardstick; TF32 is
    off for the whole script)."""
    return torch.ops.aten.convolution_backward(
        dy.permute(0, 4, 1, 2, 3), x.permute(0, 4, 1, 2, 3), w, None,
        [1, 1, 1], [1, 1, 1], [1, 1, 1], False, [0, 0, 0], 1,
        [True, False, False])[0]


def _gn_plain(x, scale, bias, fs, fh, silu):
    """The plain GroupNorm composition (differentiable torch ops)."""
    from ddpm3d_tpu_torch.ops import groupnorm as gn

    g, b = gn.fold_gn_affine(gn.channel_stats_plain(x), x.shape[1], scale,
                             bias, film_scale=fs, film_shift=fh)
    return gn.gn_apply_plain(x, g, b, silu)


def phase_backward(gen: torch.Generator, conv_shapes, gn_shapes) -> dict:
    """At every distinct backward shape of a training step: the conv dx
    kernel and the library filter gradient against their plain versions,
    and the GroupNorm Function's backward against autograd through the
    plain GroupNorm. Each is timed; per-step sums weight the times by the
    calls per step."""
    from ddpm3d_tpu_torch.ops import conv3d as cv
    from ddpm3d_tpu_torch.ops import groupnorm as gn

    dev = torch.device("cuda")
    dx_keys = {k[:6] for k in conv_shapes if k[6]}
    for case in DX_TIMED:
        check(case in dx_keys, f"timed dx {case} is on the training path")
    per_step = {"conv3d_dx_ms": 0.0, "dw_library_ms": 0.0,
                "gn_backward_ms": 0.0}
    summary, worst = {}, collections.defaultdict(float)
    checked = collections.Counter()
    order = DX_TIMED + sorted((k[:6] for k in conv_shapes
                               if k[:6] not in DX_TIMED), key=str)
    calls = collections.Counter()
    needs_dx = collections.defaultdict(bool)
    for k, n in conv_shapes.items():
        calls[k[:6]] += n
        needs_dx[k[:6]] |= k[6]
    for case in dict.fromkeys(order):
        D, H, W, cin, cout, dt = case
        x = torch.randn((1, D, H, W, cin), generator=gen, device=dev).to(dt)
        dy = torch.randn((1, D, H, W, cout), generator=gen, device=dev).to(dt)
        w = (torch.randn((cout, cin, 3, 3, 3), generator=gen, device=dev)
             * (27 * cin) ** -0.5)
        vox, isz = D * H * W, x.element_size()
        flops = 2.0 * 27 * cin * cout * vox
        base = dict(shape=[1, D, H, W], cin=cin, cout=cout,
                    dtype=str(dt).split(".")[-1], calls_per_step=calls[case])
        lines = []
        if needs_dx[case]:
            wpd = cv.pack_weight_dx(w, dt)
            dx = cv.conv3d_dx_kernel(dy, wpd)
            dx_ref = cv.conv3d_dx_plain(dy, w)
            torch.cuda.synchronize()
            err, rel = rel_err(dx, dx_ref)
            check(bool(torch.isfinite(dx.float()).all()), "conv3d_dx finite")
            route = cv.conv3d_route(dy.shape, dt, cin)
            line = dict(kernel="conv3d_dx", **base, route=route,
                        tile=_conv_tile(cv, dy, cin, route),
                        max_abs_err=err, rel_err=rel, tol=TOL[dt],
                        kernel_ms=time_ms(lambda: cv.conv3d_dx_kernel(dy, wpd)))
            per_step["conv3d_dx_ms"] += line["kernel_ms"] * calls[case]
            if case in DX_TIMED:
                wd = w.to(dt)
                if route != "ndhwc":  # the same dx on the previous kernel
                    wpo = cv.pack_weight(cv.flip_weight(w), dt)
                    line["ndhwc_ms"] = time_ms(
                        lambda: _ndhwc_conv(dy, wpo, None))
                line["plain_ms"] = time_ms(lambda: cv.conv3d_dx_plain(dy, w),
                                           reps=3, warmup=1)
                line["library_ms"] = time_ms(lambda: _library_dx(dy, x, wd))
                if route == "f32_narrow":  # one F.conv3d on the flipped weight
                    wf = cv.flip_weight(wd).contiguous()
                    dyn = dy.permute(0, 4, 1, 2, 3)
                    line["conv_call_ms"] = time_ms(
                        lambda: F.conv3d(dyn, wf, padding=1))
                nbytes = vox * (cin + cout) * isz + 27 * cin * cout * isz
                line["bound_ms"], line["bound_by"] = bound(flops, nbytes, dt)
            lines.append(line)
            if route == "f32_narrow":  # the f32 head's dx
                checked["conv3d_head_dx"] += 1
                if case in DX_TIMED:
                    summary["conv3d_head_dx"] = line
            del dx, dx_ref
        dw = cv.conv3d_dw_library(x, dy)
        dw_ref = cv.conv3d_dw_plain(x, dy)
        torch.cuda.synchronize()
        err, rel = rel_err(dw, dw_ref)
        line = dict(kernel="dw_library", **base, max_abs_err=err, rel_err=rel,
                    tol=TOL[dt],
                    library_ms=time_ms(lambda: cv.conv3d_dw_library(x, dy)))
        per_step["dw_library_ms"] += line["library_ms"] * calls[case]
        if case in DX_TIMED:
            line["plain_ms"] = time_ms(lambda: cv.conv3d_dw_plain(x, dy),
                                       reps=3, warmup=1)
            nbytes = vox * (cin + cout) * isz + 27 * cin * cout * isz
            line["bound_ms"], line["bound_by"] = bound(flops, nbytes, dt)
        lines.append(line)
        for line in lines:
            emit(line)
            name = line["kernel"]
            check(line["rel_err"] <= line["tol"],
                  f"{name} {line['shape']} {cin}->{cout} rel err "
                  f"{line['rel_err']}")
            checked[name] += 1
            worst[name] = max(worst[name], line["rel_err"])
            summary.setdefault(name, line)
        del x, dy, dw, dw_ref

    gn_calls = collections.Counter()
    for k, n in gn_shapes.items():
        gn_calls[k] += n
    for case in sorted(gn_calls, key=lambda k: (-k[0] * k[1], str(k))):
        N, C, dt, film, silu = case
        x = (torch.randn((1, N, C), generator=gen, device=dev) * 2 + 0.5).to(dt)
        do = torch.randn((1, N, C), generator=gen, device=dev).to(dt)
        scale = 1 + 0.1 * torch.randn((C,), generator=gen, device=dev)
        shift = 0.1 * torch.randn((C,), generator=gen, device=dev)
        fs = fh = None
        if film:
            fs = 0.1 * torch.randn((1, C), generator=gen, device=dev)
            fh = 0.1 * torch.randn((1, C), generator=gen, device=dev)
        got, ref = [], []
        for fn, out in ((lambda *a: gn.group_norm(
                            *a[:3], film_scale=a[3], film_shift=a[4],
                            apply_silu=silu), got),
                        (lambda *a: _gn_plain(*a, silu), ref)):
            ins = [None if v is None else v.detach().clone().requires_grad_()
                   for v in (x, scale, shift, fs, fh)]
            fn(*ins).backward(do)
            out.extend(v.grad for v in ins if v is not None)
        torch.cuda.synchronize()
        mean_c, rstd_c = gn.gn_moments(gn.channel_stats(x), N)
        bwd = lambda: gn.group_norm_backward(  # noqa: E731
            do, x, scale, shift, fs, fh, mean_c, rstd_c, gn.NORM_GROUPS, silu)
        names = ["dx", "d_scale", "d_bias", "d_film_scale", "d_film_shift"]
        errs = {}
        for nm, g_, r_ in zip(names, got, ref):
            check(bool(torch.isfinite(g_.float()).all()), f"GN {nm} finite")
            errs[nm] = rel_err(g_, r_)[1]
        tol = {nm: TOL[dt] if nm == "dx" else TOL[torch.float32]
               for nm in errs}
        isz = x.element_size()
        nbytes = 3 * N * C * isz  # x and dy read, dx written
        bms, by = bound(12.0 * N * C, nbytes, torch.float32)
        line = dict(kernel="gn_backward", shape=[1, N, C],
                    dtype=str(dt).split(".")[-1], film=film, silu=silu,
                    calls_per_step=gn_calls[case], rel_err=errs, tol=tol,
                    max_abs_err=rel_err(got[0], ref[0])[0],
                    plain_ms=time_ms(bwd), bound_ms=bms, bound_by=by,
                    library_ms=None)
        per_step["gn_backward_ms"] += line["plain_ms"] * gn_calls[case]
        emit(line)
        for nm, r in errs.items():
            check(r <= tol[nm], f"GN backward {nm} {[1, N, C]} rel err {r}")
        checked["gn_backward"] += 1
        worst["gn_backward"] = max(worst["gn_backward"], max(errs.values()))
        summary.setdefault("gn_backward", line)
        del x, do, got, ref
    emit({"phase": "backward", "shapes_checked": dict(checked),
          "worst_rel_err": dict(worst), "per_step_ms": per_step})
    for name, n in checked.items():
        summary[name] = dict(summary[name], shapes_checked=n)
    return summary


def _read_progress(path: str) -> list:
    with open(path) as f:
        return [{k: float(v) for k, v in row.items() if v not in ("", None)}
                for row in csv.DictReader(f)]


def phase_train(seed: int) -> dict:
    """The training CLI at the production flags on a synthetic volume pair:
    6 steps at batch 1, saved at steps 0 and 5 (``DIFFUSION_TRAINING_TEST``
    stops after the first save past step 0). Steps and saves are timed by
    wrapping ``TrainLoop.run_step`` / ``TrainLoop.save``."""
    from ddpm3d_tpu_torch import ops
    from ddpm3d_tpu_torch.data import tiff_io
    from ddpm3d_tpu_torch.models.factory import sr_create_model_and_diffusion
    from ddpm3d_tpu_torch.models.nn import init_params
    from ddpm3d_tpu_torch.scripts import train as train_cli
    from ddpm3d_tpu_torch.training import TrainLoop
    from ddpm3d_tpu_torch.utils.config import (
        args_to_dict, sr_model_and_diffusion_defaults)
    from ddpm3d_tpu_torch.utils.convert import load_checkpoint

    step_ms, save_s, loops = [], [], []
    run_step, save = TrainLoop.run_step, TrainLoop.save

    def timed_step(self, *a, **k):
        if not loops:
            loops.append(self)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = run_step(self, *a, **k)
        end.record()
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
        return out

    def timed_save(self):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        out = save(self)
        save_s.append(time.monotonic() - t0)
        return out

    with tempfile.TemporaryDirectory() as tmp:
        data_dir, run_dir = os.path.join(tmp, "data"), os.path.join(tmp, "run")
        os.makedirs(data_dir)
        rng = np.random.default_rng(seed)
        high = rng.gamma(2.0, 0.5, (96, 200, 200)).astype(np.float32)
        low = high + rng.normal(0.0, 0.3, high.shape).astype(np.float32)
        tiff_io.imwrite(os.path.join(data_dir, "pair.tif"),
                        np.stack([low, high]))  # (2, 96, 200, 200): 9 patches
        argv = TRAIN_FLAGS + [
            "--data_dir", data_dir, "--result_folder", run_dir,
            "--save_interval", str(TRAIN_STEPS - 1), "--log_interval", "1",
            "--seed", str(seed)]
        TrainLoop.run_step, TrainLoop.save = timed_step, timed_save
        os.environ["DIFFUSION_TRAINING_TEST"] = "1"
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            t0 = time.monotonic()
            train_cli.main(argv)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            counts = ops.launch_counts()
            routes = ops.route_counts()
        finally:
            TrainLoop.run_step, TrainLoop.save = run_step, save
            del os.environ["DIFFUSION_TRAINING_TEST"]
        peak = torch.cuda.max_memory_allocated()
        rows = _read_progress(os.path.join(run_dir, "progress.csv"))
        files = sorted(os.listdir(run_dir))
        last = f"model{TRAIN_STEPS - 1:06d}.pt"
        check(last in files and f"ema_0.9999_{TRAIN_STEPS - 1:06d}.pt" in files
              and f"opt{TRAIN_STEPS - 1:06d}.pt" in files,
              f"checkpoint files at step {TRAIN_STEPS - 1}: {files}")
        sd = load_checkpoint(os.path.join(run_dir, last))

    steps = len(step_ms)
    per_step = {k: v / steps for k, v in counts.items()}
    routes_per_step = {k: v / steps for k, v in routes.items()}
    line = {
        "phase": "train", "flags": " ".join(TRAIN_FLAGS), "batch": 1,
        "steps": steps, "step_ms": step_ms,
        "ms_per_step": statistics.median(step_ms[1:]),
        "max_memory_allocated_gb": peak / 2 ** 30,
        "loss": [r.get("loss") for r in rows],
        "mse": [r.get("mse") for r in rows],
        "vb": [r.get("vb") for r in rows],
        "grad_norm": [r.get("grad_norm") for r in rows],
        "launches": counts, "launches_per_step": per_step,
        "routes_per_step": routes_per_step, "save_s": save_s, "wall_s": wall, "files": files,
    }
    emit(line)
    check(steps == TRAIN_STEPS and len(rows) == TRAIN_STEPS,
          f"{TRAIN_STEPS} steps logged")
    for key in ("loss", "mse", "vb", "grad_norm"):
        check(all(v is not None and np.isfinite(v) for v in line[key]),
              f"{key} finite at every step")
    check(all(v > 0 for v in line["grad_norm"]), "grad_norm > 0")
    for name in TRAIN_KERNELS:
        check(counts[name] > 0, f"kernel {name} launched on the train path")
    check(per_step == {"conv3d": 72, "conv3d_dx": 71, "conv3d_fused": 0,
                       "conv3d_s8": 0, "gn_stats": 71, "gn_apply": 71},
          f"launches per step {per_step}")
    check(routes_per_step == STEP_ROUTES,
          f"conv routes per step {routes_per_step}")
    line["launches"] = dict(counts, routes=routes)

    # the saved weights serve: a serving model loads them strictly, they
    # moved from the initial ones, and a bf16 96^3 forward is finite
    args = sr_model_and_diffusion_defaults()
    args.update(args_to_dict(train_cli.create_argparser().parse_args(
        TRAIN_FLAGS + ["--data_dir", "unused"]), args.keys()))
    serving, _, _ = sr_create_model_and_diffusion(**args)
    init_params(serving, seed=seed)
    initial = {k: v.clone() for k, v in serving.state_dict().items()}
    serving.load_state_dict(sd, strict=True)
    moved = sum(not torch.equal(initial[k], v)
                for k, v in serving.state_dict().items())
    serving.cuda().eval()
    x = torch.randn((1, 96, 96, 96, 1), device="cuda")
    with torch.no_grad():
        y = serving(x, torch.tensor([500], device="cuda"), low_res=x)
    torch.cuda.synchronize()
    emit({"phase": "train_checkpoint", "file": last, "tensors": len(sd),
          "tensors_moved": moved, "forward_finite":
          bool(torch.isfinite(y).all())})
    check(moved > 0, "trained weights differ from the initial ones")
    check(bool(torch.isfinite(y).all()), "served forward is finite")
    del serving, y
    line["loop"] = loops[0]
    return line


# ------------------------------------------------------------------ int8 --

# a quantized conv site: (D, H, W, Cin, N, taps, upsample) of one bf16 96^3
# int8 forward; N = Cout, or 4 * Cout stacked phases on the phase route
def int8_path_shapes(model) -> list:
    """Every distinct quantized conv of one bf16 96^3 batch-1 int8 forward,
    read by forward hooks on the int8 sites."""
    shapes = set()

    def hook(mod, args, kwargs, out):
        _, D, H, W, cin = args[0].shape
        up = bool(kwargs.get("upsample", False))
        n = mod.weight.shape[0] * (4 if up else 1)
        shapes.add((D, H, W, cin, n, mod.weight[0, 0].numel(), up))

    handles = [m.register_forward_hook(hook, with_kwargs=True)
               for m in model.modules()
               if getattr(m, "site", "") and m.int8_active()]
    x = torch.randn((1, 96, 96, 96, 1), device="cuda")
    with torch.no_grad():
        model(x, torch.tensor([500], device="cuda"), low_res=x)
    for h in handles:
        h.remove()
    return sorted(shapes)


# sites timed beside the plain version and K3 (bf16) at the conv int8
# replaces: (D, H, W, Cin, N, taps, upsample); the up site is added from
# the path (its widest)
S8_TIMED = [
    (96, 96, 96, 128, 128, 27, False),   # level-0 ResBlock conv
    (96, 96, 96, 256, 128, 27, False),   # level-0 decoder in_conv
    (96, 96, 96, 256, 128, 1, False),    # its 1x1 skip (beside _int_mm)
    (96, 48, 48, 256, 128, 27, False),   # level-1 decoder in_conv
    (96, 6, 6, 1024, 512, 27, False),    # level-4 decoder in_conv
]


def _s8_inputs(gen, case, B, static):
    """Random int8 operands of one site; on the phase route the weight is
    zero outside each phase's 2x2 window, as ``stacked_phase_weight`` makes
    it (the kernel's phase tiles run only those taps)."""
    from ddpm3d_tpu_torch.ops.phase_up import phase_window_mask

    D, H, W, cin, n, taps, up = case
    dev = torch.device("cuda")
    k = 3 if taps == 27 else 1
    xq = torch.randint(-127, 128, (B, D, H, W, cin), generator=gen,
                       device=dev, dtype=torch.int8)
    wq = torch.randint(-127, 128, (n, cin, k, k, k), generator=gen,
                       device=dev, dtype=torch.int8)
    if up:
        wq = wq * phase_window_mask(n // 4).to(dev, torch.int8)
    s_x = (torch.full((B,), 0.02, device=dev) if static else
           0.01 + 0.02 * torch.rand((B,), generator=gen, device=dev))
    s_w = 1e-4 + 1e-3 * torch.rand((n,), generator=gen, device=dev)
    bias = torch.randn((n // 4 if up else n,), generator=gen, device=dev)
    return xq, wq, s_x, s_w, bias


def phase_s8_kernels(gen: torch.Generator, shapes, libs) -> dict:
    """``conv3d_s8`` against its plain version at every distinct quantized
    shape of the int8 path, three variants each (batch 1 dynamic with bias
    and bf16 out, as the path runs it; batch 2 dynamic with per-sample
    scales, no bias, f32 out; batch 1 static with bias, f32 out): equal
    bit for bit. The S8_TIMED sites and the widest up site are timed, the
    latter also on the 27-tap study build ``libs["s8_all_taps"]``."""
    from ddpm3d_tpu_torch.ops import conv3d_s8 as s8

    for case in S8_TIMED:
        check(case in shapes, f"timed s8 conv {case} is on the int8 path")
    up_sites = [c for c in shapes if c[6]]
    check(len(up_sites) > 0, "the int8 path has phase-route sites")
    timed = S8_TIMED + [max(up_sites, key=lambda c: c[1] * c[2])]
    variants = (  # (B, static, bias, out dtype)
        (1, False, True, torch.bfloat16),
        (2, False, False, torch.float32),
        (1, True, True, torch.float32),
    )
    summary, checked, worst = None, 0, 0.0
    for case in timed + [c for c in shapes if c not in timed]:
        D, H, W, cin, n, taps, up = case
        for vi, (B, static, with_bias, dt) in enumerate(variants):
            xq, wq, s_x, s_w, bias = _s8_inputs(gen, case, B, static)
            bias = bias if with_bias else None
            wp = s8.pack_weight_s8(wq)
            got = s8.conv3d_s8_kernel(xq, wp, s_x, s_w, bias, dt, up)
            ref = s8.conv3d_s8_plain(xq, wq, s_x, s_w, bias, dt, up)
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs().max().item()
            line = dict(kernel="conv3d_s8", shape=[B, D, H, W, cin], n=n,
                        taps=taps, upsample=up, static=static,
                        bias=with_bias, dtype=str(dt).split(".")[-1],
                        tile=list(s8.s8_tile(B, D, H, W, n, taps, dt)),
                        max_abs_err=err, equal=bool(torch.equal(got, ref)))
            check(bool(torch.isfinite(got.float()).all()), "conv3d_s8 finite")
            if vi == 0 and case in timed:
                line.update(_time_s8_site(case, xq, wq, wp, s_x, s_w, bias,
                                          dt, libs, ref))
                if summary is None:
                    summary = line
            emit(line)
            # K5 equals its plain version bit for bit: the same int32 sums
            # (exact in any order) and the same f32 multiply, add and
            # rounding, none contracted into an FMA
            check(line["equal"], f"conv3d_s8 {case} variant {vi} differs "
                  f"from its plain version by {err}")
            worst = max(worst, err)
            checked += 1
            del xq, wq, got, ref
    emit({"phase": "s8_kernels", "shapes": len(shapes),
          "checks": checked, "worst_max_abs_err": worst})
    return dict(summary, shapes_checked=len(shapes))


def _s8_variant(lib, xq, wp, s_x, s_w, bias, dt, up, tile):
    """One launch of a study build of K5 (the package's C entry point) on
    the tile it is given."""
    from ddpm3d_tpu_torch.ops import _build

    B, D, H, W, cin = xq.shape
    n = wp.shape[1]
    cout = n // 4 if up else n
    y = torch.empty((B, D, 2 * H, 2 * W, cout) if up else (B, D, H, W, cout),
                    dtype=dt, device=xq.device)
    if bias is not None and up:  # the phase route adds the rounded bias
        bias = bias.to(dt).float()
    err = _build.variant_fn(lib, "conv3d_s8_launch")(
        xq.data_ptr(), wp.data_ptr(), s_x.data_ptr(), s_w.data_ptr(),
        None if bias is None else bias.data_ptr(), y.data_ptr(), B, D, H, W,
        cin, n, wp.shape[0], int(up), *tile, 1 if dt == torch.bfloat16 else 0,
        torch.cuda.current_stream().cuda_stream)
    _build.check(err, "conv3d_s8_launch (study build)")
    return y


def _time_s8_site(case, xq, wq, wp, s_x, s_w, bias, dt, libs, ref) -> dict:
    """Kernel, plain and K3 (bf16, the conv int8 replaces: on the
    upsampled input for the phase route) times at one site, the quantize
    glue on a bf16 activation of the site's shape, and the bound; the 1x1
    skip also beside ``torch._int_mm`` (its s8 GEMM alone); the previous K5
    on its own 128-row tiles (``parent_ms``) when its build is given; a
    phase site also on the 27-tap build (``all_taps_ms``), both equal."""
    from ddpm3d_tpu_torch.models.nn import upsample_nearest_hw
    from ddpm3d_tpu_torch.ops import conv3d as cv
    from ddpm3d_tpu_torch.ops import conv3d_s8 as s8
    from ddpm3d_tpu_torch.ops import quant

    D, H, W, cin, n, taps, up = case
    cout = n // 4 if up else n
    vox = D * H * W
    ms = time_ms(lambda: s8.conv3d_s8_kernel(xq, wp, s_x, s_w, bias, dt, up))
    plain_ms = time_ms(lambda: s8.conv3d_s8_plain(xq, wq, s_x, s_w, bias,
                                                  dt, up), reps=3, warmup=1)
    xb = (torch.randn(xq.shape, device="cuda") * 2).to(torch.bfloat16)
    quant_ms = time_ms(lambda: quant.quantize_act(xb))
    out = {"kernel_ms": ms, "plain_ms": plain_ms, "quantize_act_ms": quant_ms,
           "library_ms": None}
    for key, name, tile in (
            ("parent", "s8_parent", cv.pick_tile(D, H, W)),
            ("all_taps", "s8_all_taps", s8.s8_tile(1, D, H, W, n, taps,
                                                   dt))):
        if name not in libs or (key == "all_taps" and not up):
            continue
        run = lambda: _s8_variant(libs[name], xq, wp, s_x, s_w,  # noqa: E731
                                  bias, dt, up, tile)
        y = run()
        torch.cuda.synchronize()
        out[key + "_equal"] = bool(torch.equal(y, ref))
        check(out[key + "_equal"], f"{name} at {case} equals the plain K5")
        out[key + "_ms"] = time_ms(run)
    if taps == 27:
        xk = upsample_nearest_hw(xb) if up else xb
        wk = cv.pack_weight(torch.randn((cout, cin, 3, 3, 3), device="cuda")
                            * (27 * cin) ** -0.5, torch.bfloat16)
        out["k3_bf16_ms"] = time_ms(lambda: cv.conv3d_kernel(xk, wk, bias))
    else:
        a = xq.reshape(vox, cin)
        b = wq.reshape(n, cin).t()  # column-major [Cin, N]
        try:
            out["library_ms"] = time_ms(lambda: torch._int_mm(a, b))
            out["library"] = "torch._int_mm (the s8 GEMM alone, int32 out)"
        except RuntimeError as e:  # a yardstick only: report, go on
            out["library_error"] = str(e)[:200]
        wl = torch.randn((cout, cin), device="cuda").to(torch.bfloat16)
        out["bf16_linear_ms"] = time_ms(lambda: F.linear(xb, wl))
    # bound: the phase route counts its 12-tap work, not the 27 it executes
    macs = vox * cin * cout * (48 if up else taps)
    out_vox = vox * (4 if up else 1)
    nbytes = (vox * cin + wq.numel() + out_vox * cout * (2 if dt ==
              torch.bfloat16 else 4) + (n + 1 + cout) * 4)
    t_ops, t_bytes = 2.0 * macs / H100_INT8_OPS * 1e3, nbytes / H100_BYTES * 1e3
    out.update(bound_ms=max(t_ops, t_bytes),
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               tops=2.0 * macs / ms / 1e9)
    return out


# the int8 model on the card against the plain int8 path on the CPU, f32.
# An int8 network is discontinuous in its input: the float layers between
# the quantized convs (the f32 K3 input conv, GroupNorm, FiLM) sum in
# another order on the card (~1e-7 relative), so an activation near a
# rounding boundary quantizes to the neighbouring int8 value, and the
# change spreads through the GroupNorms that follow (this full-width model
# measured 4.6e-2 card against CPU on an H100 80GB HBM3 at 700 W). So
# every quantized site is held exactly (its card output
# equals the plain int8 conv on the CPU on the site's own input), and the
# whole forward only by its mean |diff| / mean |CPU|, with 3x margin:
INT8_MODEL_MEAN_TOL = 0.15


def phase_model_int8(seed: int) -> None:
    """The full-width f32 int8 model at [1, 8, 32, 32, 1]: card against
    CPU, per site and whole; 88 ``conv3d_s8`` launches."""
    from ddpm3d_tpu_torch import ops
    from ddpm3d_tpu_torch.ops import quant

    model, _, _ = _model(use_fp16=False, seed=seed, int8=quant.Int8Config())
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((1, 8, 32, 32, 1), np.float32))
    low = torch.from_numpy(rng.standard_normal((1, 8, 32, 32, 1), np.float32))
    t = torch.tensor([517])
    card = copy.deepcopy(model).cuda()
    io = []
    handles = [m.register_forward_hook(
        lambda mod, args, kwargs, out: io.append(
            (mod, args[0].cpu(), out.cpu(), bool(kwargs.get("upsample")))),
        with_kwargs=True) for m in card.modules()
        if getattr(m, "site", "") and m.int8_active()]
    with torch.no_grad():
        ref = model(x, t, low_res=low)
        ops.reset_launch_counts()
        out = card(x.cuda(), t.cuda(), low_res=low.cuda()).cpu()
        n_s8 = ops.launch_counts()["conv3d_s8"]
        for h in handles:
            h.remove()
        unequal = []
        for mod, xin, yout, up in io:
            cpu_mod = model.get_submodule(
                next(n for n, m in card.named_modules() if m is mod))
            y_cpu = cpu_mod(xin, upsample=up) if up else cpu_mod(xin)
            if not torch.equal(y_cpu, yout):
                unequal.append((mod.site, (y_cpu - yout).abs().max().item()))
    err, rel = rel_err(out, ref)
    mean_rel = ((out - ref).abs().mean() / ref.abs().mean()).item()
    emit({"phase": "model_int8", "shape": list(x.shape), "channels": 128,
          "dtype": "float32", "sites_checked": len(io),
          "sites_unequal": unequal, "max_abs_err": err, "rel_err": rel,
          "mean_rel_err": mean_rel, "mean_tol": INT8_MODEL_MEAN_TOL,
          "conv3d_s8_launches": n_s8})
    check(n_s8 == FORWARD_LAUNCHES["denoise_int8"]["conv3d_s8"],
          f"int8 model launched conv3d_s8 {n_s8} times")
    check(len(io) == n_s8 and not unequal,
          f"int8 sites unequal to the plain int8 conv: {unequal}")
    check(bool(torch.isfinite(out).all()), "int8 model output finite")
    check(mean_rel <= INT8_MODEL_MEAN_TOL,
          f"int8 model card vs CPU mean rel err {mean_rel}")


def phase_denoise_int8_static(model, seed: int):
    """The int8 model on per-time-bin static scales (the committed
    INT8_SCALES_PROD.json, 25 bins over its 25-step respacing) through
    ``denoise_volume``: 25 distinct bins, finite output, exact launches.
    Random weights: no quality figure."""
    from ddpm3d_tpu_torch.models.factory import create_gaussian_diffusion
    from ddpm3d_tpu_torch.ops import quant

    fname = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "INT8_SCALES_PROD.json")
    cfg8 = quant.Int8Config(scales=fname)
    check(cfg8.has_time_bins, "INT8_SCALES_PROD.json has time bins")
    model.set_int8(cfg8)
    sched, cfg = create_gaussian_diffusion(
        steps=1000, learn_sigma=True, noise_schedule="linear",
        timestep_respacing="25")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        counts, volume, _ = phase_denoise(model, sched, cfg, seed,
                                          phase="denoise_int8_static")
    emit({"phase": "denoise_int8_static_bins",
          "bins_used": sorted(cfg8.bins_used),
          "distinct_bins": len(cfg8.bins_used),
          "warnings": sorted({str(w.message)[:80] for w in caught}),
          "volume_abs_mean": float(np.abs(volume).mean())})
    check(len(cfg8.bins_used) == 25, f"bins used {sorted(cfg8.bins_used)}")
    check(not caught, "every site has a scale in the file")
    return counts


# quantize glue kernels (the JAX package's XLA-fused glue): the per-sample
# min/max, the f32 division, round and clamp; the cast to int8 is a plain
# copy kernel and stays in "other"
INT8_FAMILIES = dict(
    FORWARD_FAMILIES,
    conv3d_s8=("conv3d_s8_kernel",),
    quantize=("MinMax", "minmax", "DivFunctor", "div_true", "round_kernel",
              "clamp"),
)


def phase_profile_int8(model) -> None:
    """One bf16 96^3 int8 forward at batch 1 by kernel family
    (torch.profiler), the quantize glue also by CUDA events around each
    ``quantize_act`` call, and the idle share."""
    from ddpm3d_tpu_torch.ops import quant

    phase_profile(model, phase="profile_int8", families=INT8_FAMILIES)
    x = torch.randn((1, 96, 96, 96, 1), device="cuda")
    t = torch.tensor([500], device="cuda")
    evs = []
    orig = quant.quantize_act

    def timed(*a, **k):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = orig(*a, **k)
        e1.record()
        evs.append((e0, e1))
        return out

    with torch.no_grad():
        model(x, t, low_res=x)  # warm
        quant.quantize_act = timed
        try:
            model(x, t, low_res=x)
        finally:
            quant.quantize_act = orig
    torch.cuda.synchronize()
    emit({"phase": "profile_int8_quantize", "calls": len(evs),
          "quantize_act_ms": sum(a.elapsed_time(b) for a, b in evs)})


def phase_train_profile(loop) -> None:
    """One more batch-1 training step of the CLI's loop: its parts by CUDA
    events (loss forward, backward, update), then a torch.profiler
    breakdown of a whole step by kernel family, and the idle share."""
    from torch.profiler import ProfilerActivity, profile

    from ddpm3d_tpu_torch.diffusion.losses import training_losses
    from ddpm3d_tpu_torch.training import train_loop as tl

    batch, cond = next(loop.data)
    x = torch.as_tensor(batch).cuda()
    c = {k: torch.as_tensor(v).cuda() for k, v in cond.items()}
    parts = collections.defaultdict(list)
    for _ in range(3):
        t, w = loop.sample_t(1)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        loop.model.zero_grad(set_to_none=True)
        ev[0].record()
        terms = training_losses(loop.model, loop.sched, loop.cfg, x, t,
                                model_kwargs=c, generator=loop.noise_gen)
        loss = torch.mean(terms["loss"] * w)
        ev[1].record()
        loss.backward()
        ev[2].record()
        tl.apply_update(loop.state, t, {k: v.detach() for k, v in terms.items()},
                        w, loop.lr, loop.lr_anneal_steps, loop.ema_rate)
        ev[3].record()
        ev[3].synchronize()
        for name, a, b in (("forward_loss", 0, 1), ("backward", 1, 2),
                           ("update", 2, 3)):
            parts[name].append(ev[a].elapsed_time(ev[b]))
    step_ms = time_ms(lambda: loop.run_step(batch, cond), reps=3, warmup=1)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        loop.run_step(batch, cond)
        torch.cuda.synchronize()
    by_family, other = device_breakdown(prof, TRAIN_FAMILIES)
    device_ms = sum(by_family.values()) + sum(other.values())
    emit({"phase": "train_profile", "batch": 1, "step_ms": step_ms,
          "parts_ms": {k: statistics.median(v) for k, v in parts.items()},
          "device_ms": device_ms, "kernel_ms": by_family,
          "other_ms": sum(other.values()),
          "top_other_ms": dict(sorted(other.items(), key=lambda kv: -kv[1])[:12]),
          "idle_share": max(0.0, 1 - device_ms / step_ms)})


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--parent-s8", metavar="FILE",
                    help="a previous csrc/conv3d_s8.cu (same C entry point) "
                         "to time beside K5 at the timed int8 sites")
    ap.add_argument("--parent-conv", metavar="FILE",
                    help="a previous csrc/conv3d.cu (same C entry points) "
                         "whose Cout <= 8 instance is timed beside the "
                         "f32 head kernel and whose bf16 fused instance "
                         "beside K4")
    ap.add_argument("--parent-gn", metavar="FILE",
                    help="a previous csrc/groupnorm.cu whose two-launch "
                         "gn_stats_launch (x, part, stats, ...) is timed "
                         "beside K1")
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

    libs = phase_build(args.parent_s8, args.parent_conv, args.parent_gn)
    model, sched, cfg = _model(use_fp16=True, seed=args.seed)
    model.cuda()
    fused = _model(use_fp16=True, seed=args.seed, fused=True)[0]
    fused.load_state_dict(model.state_dict(), strict=True)
    fused.cuda()
    from ddpm3d_tpu_torch.ops import quant
    int8m = _model(use_fp16=True, seed=args.seed,
                   int8=quant.Int8Config())[0]
    int8m.load_state_dict(model.state_dict(), strict=True)
    int8m.cuda()
    summary = phase_kernels(gen, *main_path_shapes(model),
                            conv_parent=libs.get("conv_parent"),
                            gn_parent=libs.get("gn_parent"))
    summary["conv3d_fused"] = phase_fused_kernels(
        gen, fused_path_shapes(fused), conv_parent=libs.get("conv_parent"))
    summary["conv3d_s8"] = phase_s8_kernels(gen, int8_path_shapes(int8m),
                                            libs)
    from ddpm3d_tpu_torch.models.factory import create_gaussian_diffusion
    train_sched, train_cfg = create_gaussian_diffusion(
        steps=1000, learn_sigma=True, noise_schedule="linear")
    bwd = phase_backward(gen, *training_shapes(model, train_sched, train_cfg))
    phase_model(args.seed)
    phase_model_int8(args.seed)
    denoise_counts, volume, eps = phase_denoise(model, sched, cfg, args.seed)
    phase_profile(model)
    fused_counts, fused_volume, fused_eps = phase_denoise(
        fused, sched, cfg, args.seed, phase="denoise_fused")
    check_volumes("denoise_fused_vs_unfused", volume, fused_volume, eps,
                  fused_eps, FUSED_FORWARD_TOL, DENOISE_FUSED_TOL)
    phase_profile(fused, phase="profile_fused")
    int8_counts, int8_volume, int8_eps = phase_denoise(
        int8m, sched, cfg, args.seed, phase="denoise_int8")
    check_volumes("denoise_int8_vs_bf16", volume, int8_volume, eps, int8_eps,
                  INT8_FORWARD_TOL, DENOISE_INT8_TOL)
    phase_profile_int8(int8m)
    static_counts = phase_denoise_int8_static(int8m, args.seed)
    del model, fused, int8m
    torch.cuda.empty_cache()
    train = phase_train(args.seed)
    phase_train_profile(train.pop("loop"))

    summary["conv3d_dx"] = bwd["conv3d_dx"]
    summary["conv3d_head_dx"] = bwd["conv3d_head_dx"]
    kernels = []
    for name, meta in KERNELS.items():
        s = summary[name]
        count = ((lambda c: c[name]) if name not in ROUTE_OF
                 else (lambda c: c["routes"][ROUTE_OF[name]]))
        by_path = {"denoise": count(denoise_counts),
                   "denoise_fused": count(fused_counts),
                   "denoise_int8": count(int8_counts),
                   "denoise_int8_static": count(static_counts),
                   "train": count(train["launches"])}
        main_path = {"conv3d_fused": "denoise_fused",
                     "conv3d_s8": "denoise_int8"}.get(name, "train")
        extra = {}
        if name == "conv3d_fused":  # serving only: no single library call
            extra["unfused_sequence_ms"] = s["unfused_sequence_ms"]
            # the kernel it replaces (the parent's csrc/conv3d.cu, or None)
            extra["previous_ms"] = s["previous_ms"]
            extra["routes_by_path"] = {
                path: {k: v for k, v in c["routes"].items()
                       if k.startswith("conv3d_fused.")}
                for path, c in (("denoise", denoise_counts),
                                ("denoise_fused", fused_counts),
                                ("denoise_int8", int8_counts),
                                ("train", train["launches"]))}
        if name == "gn_stats":  # the parent's two-launch K1 (or None)
            extra["parent_ms"] = s["parent_ms"]
        if name == "conv3d_s8":  # the bf16 conv it replaces at that site
            extra["k3_bf16_ms"] = s["k3_bf16_ms"]
            extra["parent_ms"] = s.get("parent_ms")
        if name in ("conv3d_narrow", "conv3d_head", "conv3d_head_dx"):
            extra["ndhwc_ms"] = s["ndhwc_ms"]  # the previous kernel
        if name == "conv3d_head":  # the parent's head instance (or None)
            extra["parent_ms"] = s["parent_ms"]
        if name == "conv3d_head_dx":  # F.conv3d on the flipped weight
            extra["conv_call_ms"] = s["conv_call_ms"]
        if name in ("conv3d", "conv3d_dx"):
            # the previous kernel (csrc/conv3d.cu) on the same inputs, and
            # each path's launches by route (ops.route_counts)
            extra["ndhwc_ms"] = s["ndhwc_ms"]
            extra["routes_by_path"] = {
                path: {k: v for k, v in c["routes"].items()
                       if k.startswith(name + ".")}
                for path, c in (("denoise", denoise_counts),
                                ("denoise_fused", fused_counts),
                                ("denoise_int8", int8_counts),
                                ("train", train["launches"]))}
        kernels.append(dict(
            name=name, **meta,
            launches=by_path[main_path],
            launches_by_path=by_path,
            max_abs_err=s["max_abs_err"], ms=s["kernel_ms"],
            plain_ms=s["plain_ms"], bound_ms=s["bound_ms"],
            bound_by=s["bound_by"], library_ms=s["library_ms"],
            shapes_checked=s["shapes_checked"], **extra,
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
