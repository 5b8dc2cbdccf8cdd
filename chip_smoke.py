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
               ``csrc/conv3d_head.cu``), each timed beside the general
               kernel of its dtype (in bf16 the gather instance of
               ``csrc/conv3d_narrow.cu``, any Cin, as ``gather_ms``;
               ``csrc/conv3d_f32.cu`` in f32, as ``general_ms``) on the
               same inputs; K1
               (GN stats, one launch) also bit for bit twice and alone
               against in a batch of 2, timed beside ``torch.var_mean``
               and, with ``--parent-gn``, a previous
               ``csrc/groupnorm.cu`` (its sums equal to K1's); K1 with
               its fold: the same sums, (g, b) and the moments within
               2 ulp of the torch fold, timed beside K1 alone;
               ``gn_fold_route`` (after the model phase): one bf16
               forward with the fold in K1 against the torch fold between
               K1 and K2, its device activities, host issue and ms;
  3. backward — at every distinct conv and GroupNorm shape of one bf16 96^3
               training step (read by hooks): the conv dx kernel, the
               library filter gradient and the GroupNorm Function's backward
               against their plain versions; each timed, and summed per step;
               at the main sites also the plain and library (cuDNN) times,
               the head's dx (f32 2 -> 128 on ``csrc/conv3d_head.cu``) also
               beside ``F.conv3d`` and the general f32 kernel;
  4. model   — the full-width model (128 ch, (1,1,2,3,4), 2 res blocks) in
               f32 at a small spatial size, kernel path on the card against
               the plain path on the CPU (its input conv and head on the
               f32 routes of ``csrc/conv3d_head.cu``, its 70 torso convs
               and their dx on ``csrc/conv3d_f32.cu``): the forward, then
               one training loss and every parameter gradient (the launch
               counts of each, by route); ``model_f32_timed``, the same
               model at 96^3: forward and forward + backward ms;
  5. denoise — ``denoise_volume`` at 128 ch / 96^3 patches / bf16 on a
               synthetic volume with a short respaced chain; the launch
               counters are zeroed just before and read just after, and
               the conv launches per forward are checked by route; then a
               torch.profiler breakdown of one forward by kernel family;
               then, on the same weights, volume and seed: ``dpm``,
               DPM-Solver++(2M) over a 5-step respacing (exact launches),
               order 1 against DDIM (eta 0) on the same x_T, and each
               sampler's own device time per step beyond the forward;
               ``distributed``, the phase again through the patch split
               under an in-process NCCL group of one rank, bit-equal to
               the denoise volume, and one all_gather timed;
               ``spatial_one_rank``, the phase again through
               ``make_mesh(n_spatial=1)`` under such a group, bit-equal to
               the denoise volume; ``cli``, the
               serving CLI under ``torchrun --nproc_per_node 1`` at the
               production flags with ``--timesteps_file`` (3 steps) and
               ``--use_dpm_solver``: outputs of (200, 200, 96), finite,
               and the launches per forward that it logs;
  6. fused   — the fused serving path (``fused=True``, the same weights):
               ``conv3d_fused`` (bf16: the fused instance of
               ``csrc/conv3d_sm90.cu``) against its plain version at every
               distinct fused-conv shape of one bf16 96^3 forward (read by
               hooks), with its stats checked as the next GroupNorm folds
               them, output and stats bit for bit twice and alone against
               in a batch of 2, and five sites timed beside the unfused
               sequence they replace;
               the full-width f32 fused model on the card against the CPU
               and the unfused card forward (in the model phase);
               ``denoise_fused``, the denoise phase again on the fused
               model, against the unfused volume and with exact launch
               counts; ``profile_fused``, its one-forward breakdown;
  7. int8    — the int8 (W8A8) serving path (``int8=Int8Config()``, the
               same weights): ``conv3d_s8`` against its plain version at
               every distinct quantized-conv shape of one bf16 96^3 int8
               forward (read by hooks; 3^3 and the stacked phases of the
               up sites on ``csrc/conv3d_s8.cu``, 1^3 on
               ``csrc/conv1x1_s8.cu``), each at batch 1 and 2, dynamic and
               static, with and without bias, bf16 and f32 out, checked
               for equality; eight sites timed beside the plain version
               and K3 (the 1x1 sites at 96^2, 48^2 and 6^2 beside
               ``torch._int_mm``), and beside the previous K5 when
               ``--parent-s8`` names its source (at the 1x1 sites its
               no-halo instance), every 1x1 shape also alone
               (``conv1x1_s8_shapes``); the widest phase site also beside
               a 27-tap build of the same kernel
               (``-DCONV3D_S8_ALL_TAPS``); ``model_int8``, the
               full-width f32 int8 model on the card against the CPU, every
               site's output equal to the plain int8 conv on its own input;
               ``denoise_int8``, the denoise phase on the int8 model with
               dynamic scales, exact launches per forward and the volume
               against the bf16 one; ``denoise_int8_static``, per-time-bin
               scales from ``INT8_SCALES_PROD.json`` over its 25-step
               respacing; ``profile_int8``, one forward by family (the
               1x1 sites as ``conv1x1_s8``); the launches by route pin the
               split 70 ``conv3d_s8.sm90`` + 18 ``conv3d_s8.conv1x1``;
     spatial — (after the int8 phases) one 96^3 patch's H split over two
               shards of the spatial mesh axis at full width, each shard a
               thread of this process with a CUDA stream of its own that
               exchanges halo planes, GroupNorm sums and int8 abs-maxima
               with the other through events (an in-process counterpart of
               ``parallel/spatial.py``'s NCCL transport; the card machine
               has one GPU): the forward unfused, fused, int8 dynamic and
               static, and f32 against the unsharded forward (bf16 <= 1e-2,
               f32 <= 1e-5, int8 <= 0.15; every int8 site's scale the
               group's, bit for bit), each shard's launches by kernel and
               route, each shard alone again from what it received (bit-
               equal, its device ms and host issue ms beside the unsharded
               forward's) and the conv rows the halo adds; then a 3-step
               DDPM chain of one patch against the unsharded chain
               (``spatial``, counters zeroed just before);
     spatial_seg — the Seg models (SegUNetModel add / cat_conv / midcat,
               SegModelv2_6c / SegModelv3_6c with a 3-channel conditioner)
               the same way, bf16, f32 and int8 dynamic: launches and
               routes per shard as unsharded, every int8 site exact, the
               shards of add and SegModelv2_6c timed alone; the kernels
               phases also check every kernel at the Seg shard shapes;
  8. train   — the training CLI (``ddpm3d_tpu_torch.scripts.train``) at the
               production flags on a synthetic (2, 96, 200, 200) low/high
               pair: 6 bf16 steps at batch 1 with the launch counters zeroed
               just before; step time, peak memory, losses, launches per
               step, save time; the saved ``model*.pt`` loaded into a serving
               model with ``strict=True``; then a profile of one step;
  9. train_ddp — ``TrainLoop`` under an in-process NCCL group of one rank
               (DistributedDataParallel) against the plain loop, 3 steps at
               the production flags on the same batches and seed: params
               and EMA bit-equal, launches per step 72/71/71/71, both
               loops' step ms, the all-reduce's device time and host ops;
 10. distill — the distill CLI under ``torchrun --nproc_per_node 1`` at the
               production model flags on the train phase's pair, 8 -> 4 ->
               2 steps, 3 optimizer steps a phase: the ``.pt`` and
               ``_ts.npy`` of each phase (the halving ladder), finite
               losses, moved students, launches per distill step exactly
               216/213/213/71; ``distill_step``, the step in this process
               (ms, by part, peak memory); ``distill_serve``, the 2-step
               ``.pt`` served strict=True along its explicit 2-step DDIM
               chain by ``denoise_volume`` (72/71/71 per forward).
 (between 7 and 8)
     attention — the production model with middle attention (8 heads over
               96 x 6 x 6 = 3456 tokens at 512 channels), bf16: launches of
               one forward 72/72/72 unfused and 18/54/33/18 fused
               (conv3d/conv3d_fused/gn_stats/gn_apply), forward ms and peak
               memory at batch 1 and 2, the middle AttentionBlock alone in
               both qkv orders (ms, bound, card against CPU), the f32 model
               card against CPU, ``profile_attention`` (host issue, device
               busy and idle); ``attention_denoise``, the denoise phase's
               volume on this model (72/72/72 per forward);
     classifier_sample — the guided-sampling CLI at the JAX CLI's default
               model and classifier (full widths), 10 steps, DDPM and DDIM:
               exit 0, finite (4, 64, 64, 3) samples, 4 labels, launches per
               guided step; a step's parts timed and the guidance gradient
               (f32) on the card against the CPU.
     seg     — the three Seg models (add, cat_conv, midcat) at the
               production flags, bf16, 96^3: parameter count, forward ms and
               peak memory at batch 1 and 2, launches per forward by kernel
               and route (101 K3 with the encoder's Cin = 1 input conv on
               csrc/conv3d_narrow.cu's Cin = 1 instance, route sm90_cin1,
               99 K1, 99 K2), the f32 model
               card vs CPU; in int8 (add, cat_conv) the K5 launches (119,
               134), every site equal to the plain int8 conv on its input,
               the forward vs bf16; ``seg_6c``, the two 6-channel aliases
               (SegModelv2_6c add, SegModelv3_6c cat_conv: a 3-channel
               conditioner, so input convs of Cin 4 and 3) at the same
               flags: params, forward ms and peak at batch 1 and 2, 101 /
               99 / 99 a forward with routes 98 sm90 + 2 sm90_smallcin + 1
               f32_head (0 sm90_gather), the f32 model card vs CPU, int8 119 /
               134 K5 with every site equal, ``profile_seg_6c`` (the
               v2_6c forward by family); ``seg_denoise``, the denoise
               phase on the add model; ``seg_train``, two TrainLoop steps of the midcat
               model; ``calibrate``, the port's int8 calibration tool as a
               subprocess on the production SuperResModel (90 sites, every
               meta key), then ``denoise_int8_calibrated`` on its file (88
               K5 a forward); ``eps_calibration``, the lambda table of the
               production model; ``evaluate``, the evaluate CLI on the
               denoise volume against the CPU metrics. The kernels phase
               also checks K1/K2/K3/K5 at every Seg shape. The redesigned
               rows (``phase_conv3d_cu``): ``csrc/conv3d_f32.cu``'s plain,
               fused and dx instances against their plain versions at
               every distinct shape of the f32 model phase (forward, fused,
               gradients) and of the f32 Seg models, the fused ones also
               bit for bit twice and alone against in a batch of 2; the
               Cin = 1 conv at batch 1 and 2 of the Seg input; the narrow
               kernel's small-Cin instances (route sm90_smallcin) at every
               Cin 3 to 7 and its gather instance (route sm90_gather) at
               every Cin 9 to 15 and at 17, 20, 36 and 130 -> 128 at the
               full patch, batch 1 and 2 (batch 2's first volume bit-equal to
               batch 1), at ten ragged shapes and in three dx, timed at
               Cin 3, 4, 9, 12, 15, 20 and 130; each timed at the torso
               shape (the Cin = 1 conv at the Seg input) beside
               ``F.conv3d`` (TF32 off; cuDNN's data gradient for the dx)
               and its bound, the bf16 ones also beside the retired
               ``mma.sync`` conv of a previous ``csrc/conv3d.cu`` on the
               same inputs when ``--parent-conv`` names it.
     quality tools (after evaluate; ``ddpm3d_tpu_torch/tools``) —
               ``e2e_learning``: the end-to-end learning check in this
               process at its defaults (exit 0: the loss fell and a PSNR
               beat the noisy input's; its JSON; launches on sm90, K1, K2
               and the conv dx); ``respacing_full_width``: the respacing
               study at the production model (96^3, 10 training steps,
               ddpm25 / ddim25 / dpm2m10, one volume), then its checkpoint
               in int8 (ddpm25, ddim25): finite rows with the JAX tool's
               keys, the run's own ms per chain step as
               ``flagship_per_step_ms``, 70 sm90 a forward (and 70 dx a
               step) in bf16, 88 K5 + 2 K3 in int8; ``respacing_debug``:
               the study at its default model (50 steps) and the debugger
               on its checkpoint, every section finite;
               ``volume_quality``: a (100, 200, 200) synthetic volume
               through the volume harness (a subprocess running the
               serving CLI as one) on the full-width checkpoint, ddpm25
               in bf16 and int8 over the 18-patch grid: exit 0, finite
               seam and interior rows, outputs of the input's shape, the
               CLI's launches per forward (72/71/71; 88 K5 + 2 K3), each
               config's sampling wall; ``seg_int8_check`` (20 steps, one
               eval volume): every fusion's and the encoder's row finite,
               K5 and sm90_cin1 launched; ``host_tier`` (on the host,
               after volume_quality): the native C++ tier's cold build
               seconds; at the production volume a (2, 130, 200, 200) f32
               TIFF written and read, 18 patches of 96^3 cut and blended,
               each through the native tier and through numpy (equal
               values; ms, best of 3); the serving pipeline's host share,
               ``(wall_s - sample_wall_s) / wall_s``, of each
               volume_quality config (18 patches, from the CLI's
               ``host tier:`` log line); a ``mem://`` checkpoint round
               trip of the production model's state dict, bit-equal.
Then the whole run's seconds, the card's name and power limit, one
``{"kernels": [...]}`` line, and as the last line
``{"ok": true, "device": {...}}``.

Weights are random, made from ``--seed``. Imports no JAX. The build
phase fails on a spill in the Hopper kernels (the wgmma ones, the fused
K4's instances among them, ``csrc/conv3d_head.cu``, ``csrc/conv3d_f32.cu``
and ``csrc/groupnorm.cu``), on a serialized wgmma and on an FFMA in K5's SASS
(its epilogue must not contract the multiply and add).
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import copy
import csv
import functools
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import warnings

import numpy as np
import torch
import torch.nn.functional as F

H100_BF16_FLOPS = 989e12   # dense tensor-core bf16 (NVIDIA data sheet, SXM)
H100_INT8_OPS = 1979e12    # dense tensor-core int8
H100_F32_FLOPS = 67e12     # f32 on CUDA cores
H100_BYTES = 3.35e12       # HBM3 bytes/s
T_START = time.monotonic()

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
    # the fold's own launch (fold_stats), on sums K1 did not make: no TPU
    # kernel there (the JAX package folds in XLA)
    "gn_fold": dict(
        route="cuda", source="ddpm3d_tpu_torch/csrc/groupnorm.cu",
        replaces="ddpm3d_tpu/models/nn.py:98"),
    "conv3d_fused": dict(
        route="cuda", source="ddpm3d_tpu_torch/csrc/conv3d_sm90.cu",
        replaces="ddpm3d_tpu/ops/conv3d_fused.py:230"),
    "conv3d_s8": dict(
        route="cuda", source="ddpm3d_tpu_torch/csrc/conv3d_s8.cu",
        replaces="ddpm3d_tpu/ops/conv3d_s8.py:369"),
    # the int8 1x1x1 sites: no TPU kernel there (conv3d_s8_applicable
    # refuses 1x1x1 kernels and the JAX package leaves them to XLA)
    "conv1x1_s8": dict(
        route="cuda", source="ddpm3d_tpu_torch/csrc/conv1x1_s8.cu",
        replaces="ddpm3d_tpu/ops/conv3d_s8.py:85"),
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
    # the bf16 Cin = 1 input conv of the Seg encoder (conv3d_narrow.cu's
    # Cin = 1 instance), and csrc/conv3d_f32.cu: K3's f32 torso convs, their
    # dx and K4's f32 instance
    "conv3d_cin1": dict(
        route="cuda", source="ddpm3d_tpu_torch/csrc/conv3d_narrow.cu",
        replaces="ddpm3d_tpu/ops/conv3d_mxu.py:203"),
    "conv3d_f32": dict(
        route="cuda", source="ddpm3d_tpu_torch/csrc/conv3d_f32.cu",
        replaces="ddpm3d_tpu/ops/conv3d_mxu.py:203"),
    "conv3d_f32_dx": dict(
        route="cuda", source="ddpm3d_tpu_torch/csrc/conv3d_f32.cu",
        replaces="ddpm3d_tpu/ops/conv3d_mxu.py:267"),
    "conv3d_fused_f32": dict(
        route="cuda", source="ddpm3d_tpu_torch/csrc/conv3d_f32.cu",
        replaces="ddpm3d_tpu/ops/conv3d_fused.py:230"),
    # the bf16 Cin = 3 to 7 input convs of the 6-channel Seg models
    # (conv3d_narrow.cu's small-Cin instances)
    "conv3d_smallcin": dict(
        route="cuda", source="ddpm3d_tpu_torch/csrc/conv3d_narrow.cu",
        replaces="ddpm3d_tpu/ops/conv3d_mxu.py:203"),
}
# the route (ops.route_counts) whose launches are each instance's (the int8
# kernels: launch_counts' "conv3d_s8" counts both, by route here)
ROUTE_OF = {"conv3d_s8": "conv3d_s8.sm90",
            "conv1x1_s8": "conv3d_s8.conv1x1",
            "conv3d_narrow": "conv3d.sm90_narrow",
            "conv3d_head": "conv3d.f32_head",
            "conv3d_head_dx": "conv3d_dx.f32_narrow",
            "conv3d_cin1": "conv3d.sm90_cin1",
            "conv3d_smallcin": "conv3d.sm90_smallcin",
            "conv3d_f32": "conv3d.f32",
            "conv3d_f32_dx": "conv3d_dx.f32",
            "conv3d_fused_f32": "conv3d_fused.f32"}
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
                "conv3d_s8": 0, "gn_stats": 71, "gn_apply": 71,
                "gn_fold": 0},
    # 27 fusable ResBlocks x 2; input conv, head conv, 8 up/down blocks x 2;
    # 16 + the head's GN applied; 17 unfused GNs + 14 fused blocks that
    # enter without stats (5 in the encoder, 9 in the decoder), each K1
    # folding its own sums; the other 40 folds, of K4's stats, launched
    "denoise_fused": {"conv3d": 18, "conv3d_dx": 0, "conv3d_fused": 54,
                      "conv3d_s8": 0, "gn_stats": 31, "gn_apply": 17,
                      "gn_fold": 40},
    # the 90 conv sites of INT8_SCALES_PROD.json less in0_0 and head_conv:
    # 66 3x3x3 + the 4 up blocks' in_conv (one phase-route launch each) +
    # 18 1x1 skips; the two excluded convs stay K3
    "denoise_int8": {"conv3d": 2, "conv3d_dx": 0, "conv3d_fused": 0,
                     "conv3d_s8": 88, "gn_stats": 71, "gn_apply": 71,
                     "gn_fold": 0},
}
FORWARD_LAUNCHES["denoise_int8_static"] = FORWARD_LAUNCHES["denoise_int8"]
# the production model with middle attention: the no-attention counts plus
# the attention's one GroupNorm (its qkv and proj_out are 1x1 matmuls);
# fused, also the stats of the ResBlock after the attention, which drops
# the fused stats (tests/test_torch_port_attention.py counts the same on
# the CPU)
FORWARD_LAUNCHES["attention"] = {"conv3d": 72, "conv3d_dx": 0,
                                 "conv3d_fused": 0, "conv3d_s8": 0,
                                 "gn_stats": 72, "gn_apply": 72,
                                 "gn_fold": 0}
FORWARD_LAUNCHES["attention_fused"] = {"conv3d": 18, "conv3d_dx": 0,
                                       "conv3d_fused": 54, "conv3d_s8": 0,
                                       "gn_stats": 33, "gn_apply": 18,
                                       "gn_fold": 39}
FORWARD_LAUNCHES["attention_denoise"] = FORWARD_LAUNCHES["attention"]
# one guided step of classifier_sample at the CLI defaults: the 2-D UNet's
# 56 GroupNorms a forward (its convs, attention and denses are PyTorch
# calls) and the classifier's 41 under the guidance gradient (its GN
# backward is plain torch); tests/test_torch_port_classifier.py counts the
# same on the CPU
GUIDED_LAUNCHES = {"denoiser_forward": {"gn_stats": 56, "gn_apply": 56},
                   "classifier_forward_backward": {"gn_stats": 41,
                                                   "gn_apply": 41}}
GUIDED_STEP_LAUNCHES = {"gn_stats": 97, "gn_apply": 97}
# the serving phases on the unfused bf16 model: DPM-Solver++ (orders 2 and
# 1), DDIM, the patch split under a process group, the CLI under torchrun
SERVING_PATHS = ("dpm", "dpm_order1", "ddim", "distributed",
                 "spatial_one_rank", "cli")
for _path in SERVING_PATHS:
    FORWARD_LAUNCHES[_path] = FORWARD_LAUNCHES["denoise"]
# the conv3d launches per forward by kernel route (ops.route_counts): the
# bf16 torso convs on csrc/conv3d_sm90.cu, the Cin = 2 input conv on
# csrc/conv3d_narrow.cu, the f32 head conv on csrc/conv3d_head.cu, none on
# the narrow kernel's gather instance or csrc/conv3d_f32.cu; fused: 8
# up/down blocks x 2 on sm90, and every fused conv on the sm90 fused
# instance (conv3d_fused.sm90)
CONV_ROUTES = ("sm90", "sm90_narrow", "sm90_cin1", "sm90_smallcin",
               "sm90_gather", "f32_head", "f32_narrow", "f32")


def _routes(sm90, narrow, head, dx_sm90=0, dx_f32_narrow=0, fused_sm90=0,
            s8_sm90=0, s8_1x1=0):
    counts = {f"{what}.{route}": 0 for what in ("conv3d", "conv3d_dx")
              for route in CONV_ROUTES}
    counts.update({"conv3d_fused.sm90": fused_sm90, "conv3d_fused.f32": 0})
    counts.update({"conv3d_s8.sm90": s8_sm90, "conv3d_s8.conv1x1": s8_1x1})
    counts.update({"conv3d.sm90": sm90, "conv3d.sm90_narrow": narrow,
                   "conv3d.f32_head": head, "conv3d_dx.sm90": dx_sm90,
                   "conv3d_dx.f32_narrow": dx_f32_narrow})
    return counts


FORWARD_ROUTES = {
    "denoise": _routes(70, 1, 1),
    "denoise_fused": _routes(16, 1, 1, fused_sm90=54),
    # the 88 int8 launches by kernel: 66 3x3x3 + 4 phase-route on
    # csrc/conv3d_s8.cu, the 18 1x1 skips on csrc/conv1x1_s8.cu
    "denoise_int8": _routes(0, 1, 1, s8_sm90=70, s8_1x1=18),
}
FORWARD_ROUTES["denoise_int8_static"] = FORWARD_ROUTES["denoise_int8"]
FORWARD_ROUTES["attention"] = FORWARD_ROUTES["denoise"]
FORWARD_ROUTES["attention_denoise"] = FORWARD_ROUTES["denoise"]
for _path in SERVING_PATHS:
    FORWARD_ROUTES[_path] = FORWARD_ROUTES["denoise"]
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
# the native Hann blend against its numpy version (another summation
# order): max |diff| over max |value|
HOST_BLEND_REL = 1e-6


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


def device_ms(fn, n: int = 20, rounds: int = 3) -> float:
    """``fn``'s device ms: ``n`` calls between two events, enqueued while a
    sleep kernel holds the card, so the host's time to issue each call
    (which time_ms measures where it exceeds the kernel's) stays out;
    the median of ``rounds``."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        torch.cuda._sleep(5_000_000)  # ~3 ms: longer than n issues
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
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
WGMMA_SOURCES = ("conv3d_sm90", "conv3d_s8", "conv1x1_s8", "conv3d_narrow")
# the int8 sources, which equal their plain versions only without FFMA
S8_SOURCES = ("conv3d_s8", "conv1x1_s8")
# sources whose kernels must not spill: the wgmma ones, the f32 head's, the
# f32 torso conv's and the GroupNorm kernels
NO_SPILL_SOURCES = WGMMA_SOURCES + ("conv3d_head", "conv3d_f32", "groupnorm")
# study builds compiled beside the package's sources (chip_smoke's own
# names): K5 with every phase tile running all 27 taps, and the previous
# K5 / csrc/conv3d.cu (the retired mma.sync conv) / csrc/groupnorm.cu when
# --parent-s8 / --parent-conv / --parent-gn names its source
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
    # the int8 kernels equal their plain version only if the multiply and
    # the add of the epilogue stay two roundings: no FFMA anywhere in them
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    for lib in S8_SOURCES:
        sass = subprocess.run([cuobjdump, "-sass", paths[lib]],
                              capture_output=True, text=True,
                              check=True).stdout
        # (GMMA: the wgmma opcodes, IGMMA for int8)
        counts = {op: sass.count(op) for op in ("FFMA", "FMUL", "FADD",
                                                  "GMMA")}
        emit({"phase": "build_sass", "lib": lib, "counts": counts})
        check(counts["GMMA"] > 0 and counts["FMUL"] > 0,
              f"{lib} SASS has its wgmma and its epilogue multiply")
        check(counts["FFMA"] == 0, f"{lib} SASS contracts an FMA: {counts}")
    return libs


def _gn_hooks(model, gns: set) -> list:
    """Forward pre-hooks on ``model``'s GroupNorm32s that add each call's
    (N, C, dtype, film, silu) to ``gns``; returns the handles."""
    from ddpm3d_tpu_torch.models.nn import GroupNorm32

    def gn_hook(mod, args, kwargs):
        x = args[0]
        gns.add((int(np.prod(x.shape[1:-1])), x.shape[-1], x.dtype,
                 kwargs.get("film_scale") is not None,
                 bool(kwargs.get("apply_silu", False))))

    return [m.register_forward_pre_hook(gn_hook, with_kwargs=True)
            for m in model.modules() if isinstance(m, GroupNorm32)]


def main_path_shapes(model) -> tuple:
    """Every distinct conv and GroupNorm call of one bf16 96^3 batch-1
    forward, read by forward pre-hooks: conv (D, H, W, Cin, Cout, dtype)
    and GN (N, C, dtype, film, silu)."""
    from ddpm3d_tpu_torch.models.nn import Conv3x3x3

    convs, gns = set(), set()

    def conv_hook(mod, args):
        _, D, H, W, cin = args[0].shape
        convs.add((D, H, W, cin, mod.weight.shape[0], args[0].dtype))

    handles = _gn_hooks(model, gns)
    for m in model.modules():
        if isinstance(m, Conv3x3x3):
            handles.append(m.register_forward_pre_hook(conv_hook))
    x = torch.randn((1, 96, 96, 96, 1), device="cuda")
    with torch.no_grad():
        model(x, torch.tensor([500], device="cuda"), low_res=x)
    for h in handles:
        h.remove()
    return sorted(convs, key=str), sorted(gns, key=str)


def _shape_route(case) -> str:
    """The route of a conv shape (D, H, W, Cin, Cout, dtype)."""
    from ddpm3d_tpu_torch.ops import conv3d as cv

    return cv.conv3d_route((1,) + tuple(case[:4]), case[5], case[4])


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


def _general_key(dtype) -> str:
    """The key of ``_general_conv``'s time: ``gather_ms`` in bf16 (the
    narrow kernel's gather instance; before it, ``general_ms`` timed the
    retired ``mma.sync`` conv, so the two do not compare), ``general_ms``
    in f32."""
    return "gather_ms" if str(dtype).endswith("bfloat16") else "general_ms"


def _general_conv(x, w, bias):
    """The general kernel of x's dtype on the same inputs (``w`` the torch
    layout): bf16 on ``csrc/conv3d_narrow.cu``'s gather instance (any Cin,
    the weight streamed), f32 on ``csrc/conv3d_f32.cu``; timed beside the
    specialised kernels in one run."""
    from ddpm3d_tpu_torch.ops import _build
    from ddpm3d_tpu_torch.ops import conv3d as cv

    B, D, H, W, cin = x.shape
    cout = w.shape[0]
    y = torch.empty((B, D, H, W, cout), dtype=x.dtype, device=x.device)
    b_ptr = None if bias is None else bias.data_ptr()
    stream = torch.cuda.current_stream().cuda_stream
    if x.dtype == torch.float32:
        wp = cv.pack_weight_f32(w)
        err = _build.fn("conv3d_f32_launch")(
            x.data_ptr(), wp.data_ptr(), b_ptr, y.data_ptr(), B, D, H, W,
            cin, cout, *cv.pick_tile_f32(D, H, W), stream)
        _build.check(err, "conv3d_f32_launch")
        return y
    wp = cv.pack_weight_narrow(w, x.dtype)
    err = _build.fn("conv3d_gather_launch")(
        x.data_ptr(), wp.data_ptr(), b_ptr, y.data_ptr(), B, D, H, W, cin,
        cout, stream)
    _build.check(err, "conv3d_gather_launch")
    return y


def _ndhwc_tile(D: int, H: int, W: int) -> tuple:
    """The output tile (TD, TH, TW) that the retired ``mma.sync`` conv
    (``conv3d_ndhwc_launch`` of a previous ``csrc/conv3d.cu``) takes: at
    most 128 voxels and a 640-voxel halo; fewest tiles, then the smallest
    halo, then the widest TW."""
    best = None
    for tw in range(1, min(W, 128) + 1):
        for th in range(1, min(H, 128 // tw) + 1):
            td = min(D, 128 // (tw * th))
            halo = (td + 2) * (th + 2) * (tw + 2)
            if halo > 640:
                continue
            tiles = -(-D // td) * -(-H // th) * -(-W // tw)
            key = (tiles, halo, -tw)
            if best is None or key < best[0]:
                best = (key, (td, th, tw))
    return best[1]


def _parent_ndhwc(lib, x, w, bias):
    """The bf16 ``mma.sync`` conv of a previous ``csrc/conv3d.cu`` (its
    ``conv3d_ndhwc_launch``: [27, Cout, Cin] weight, the tiles of
    ``_ndhwc_tile``) on the same inputs: the kernel that carried every bf16
    Cin above 2 that is not a multiple of 8 before the narrow kernel's
    instances."""
    import ctypes

    from ddpm3d_tpu_torch.ops import _build
    from ddpm3d_tpu_torch.ops import conv3d as cv

    B, D, H, W, cin = x.shape
    cout = w.shape[0]
    wp = cv.pack_weight(w, x.dtype)
    y = torch.empty((B, D, H, W, cout), dtype=x.dtype, device=x.device)
    fn = lib.conv3d_ndhwc_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _build.check(fn(x.data_ptr(), wp.data_ptr(),
                    None if bias is None else bias.data_ptr(), y.data_ptr(),
                    B, D, H, W, cin, cout, *_ndhwc_tile(D, H, W), 1,
                    torch.cuda.current_stream().cuda_stream),
                 "conv3d_ndhwc_launch (parent)")
    return y


def _parent_gn_stats(lib, x):
    """K1 of a previous ``csrc/groupnorm.cu`` without the fold (entry point
    ``gn_stats_launch(x, part, ticket, stats, B, N, C, rows, dtype,
    stream)``, the split plan of ops/groupnorm.py:stats_plan) on the same
    input, with scratch of its own."""
    import ctypes

    from ddpm3d_tpu_torch.ops import _build
    from ddpm3d_tpu_torch.ops import groupnorm as gn

    B, N, C = x.shape
    rows, S, CS = gn.stats_plan(N, C, x.dtype)
    v = 8 if x.dtype == torch.bfloat16 else 4
    key = (B, N, C, x.dtype)
    if _PARENT_GN_SCRATCH.get("key") != key:
        _PARENT_GN_SCRATCH.update(key=key, ticket=torch.zeros(
            (B * CS,), dtype=torch.int32, device=x.device), part=torch.empty(
            (B * CS * S * 2 * gn.STATS_LANES * v,), device=x.device))
    ticket, part = _PARENT_GN_SCRATCH["ticket"], _PARENT_GN_SCRATCH["part"]
    stats = torch.empty((B, 2, C), dtype=torch.float32, device=x.device)
    fn = lib.gn_stats_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _build.check(fn(x.data_ptr(), part.data_ptr(), ticket.data_ptr(),
                    stats.data_ptr(), B, N, C, rows,
                    1 if x.dtype == torch.bfloat16 else 0,
                    torch.cuda.current_stream().cuda_stream),
                 "gn_stats_launch (parent)")
    return stats


_PARENT_GN_SCRATCH: dict = {}


def _ulps(got, ref) -> float:
    """The largest distance of got from ref in f32 units in the last place
    of ref."""
    ref = ref.float()
    a = ref.abs()
    ulp = torch.nextafter(a, torch.full_like(a, float("inf"))) - a
    return ((got.float() - ref).abs() / ulp).max().item()


def _conv_tile(cv, x, cout, route):
    """The output tile the conv's launch uses (sm90: 256 or 128 rows; the
    head: its (H, W) window and D segments per volume; the narrow kernels
    walk 64- or 128-row slices of the flattened voxels; f32: (TD, TH) of a
    TD x TH x 8 tile)."""
    B, D, H, W, _ = x.shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if route == "sm90":
        return list(cv.sm90_tile(B, D, H, W, cout, sms))
    if route == "f32_head":
        return dict(window=list(cv.head_tile(cout)),
                    segments=cv.head_plan(D, H, W, cout, sms)[2])
    if route == "f32":
        return list(cv.pick_tile_f32(D, H, W))
    return None


def _k1_fold_check(gn, x, st, scale, shift, fs, fh) -> dict:
    """K1 with its fold on x [B, N, C] against K1's sums ``st``: its own
    sums bit for bit, and (g, b, mean_c, rstd_c) in ulps of the torch fold
    (fold_gn_affine, gn_moments) on those sums; both tickets back at 0 (a
    second launch gives the same)."""
    B, N, C = x.shape
    got_st = torch.empty_like(st)
    got = gn.stats_and_fold(x, scale, shift, film_scale=fs, film_shift=fh,
                            moments=True, stats=got_st)
    again = gn.stats_and_fold(x, scale, shift, film_scale=fs, film_shift=fh,
                              moments=True)
    ref = gn.fold_gn_affine(st, N, scale, shift, film_scale=fs,
                            film_shift=fh) + gn.gn_moments(st, N)
    ulps = {k: _ulps(a, r) for k, a, r in zip(("g", "b", "mean", "rstd"),
                                                got, ref)}
    return {"fold_sums_equal": bool(torch.equal(got_st, st)),
            "fold_ulps": ulps, "fold_max_ulps": max(ulps.values()),
            "fold_bit_equal": all(bool(torch.equal(a, r))
                                  for a, r in zip(got, ref)),
            "fold_repeats": all(bool(torch.equal(a, r))
                                for a, r in zip(got, again))}


def _k1_fold_times(gn, x, scale, shift, fs, fh, gn_parent) -> dict:
    """K1 with its fold timed (CUDA events, and device ms with the host's
    issue held out) and, with ``gn_parent``, the parent's K1 (device ms);
    beside them K1 followed by the torch fold (CUDA events, the fold's
    host issue included)."""
    def fold():
        return gn.stats_and_fold(x, scale, shift, film_scale=fs,
                                 film_shift=fh)

    def torch_fold():
        st = gn.channel_stats(x)
        return gn.fold_gn_affine(st, x.shape[1], scale, shift,
                                 film_scale=fs, film_shift=fh)

    out = {"fold_ms": time_ms(fold), "fold_device_ms": device_ms(fold),
           "torch_fold_ms": time_ms(torch_fold),
           "parent_device_ms": None}
    if gn_parent is not None:
        out["parent_device_ms"] = device_ms(
            lambda: _parent_gn_stats(gn_parent, x))
    return out


def phase_kernels(gen: torch.Generator, conv_shapes, gn_shapes,
                  gn_parent=None) -> dict:
    """Each kernel against its plain version at every distinct shape of the
    main path (``gn_shapes`` also holds the guided-sampling path's); the
    shapes of CONV_TIMED / GN_TIMED are timed too, each conv beside the
    general kernel of its dtype, K1 beside ``gn_parent`` (the parent's
    csrc/groupnorm.cu) when given. K1
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
            # the same conv on the general kernel of its dtype
            line[_general_key(dt)] = time_ms(lambda: _general_conv(x, w, b))
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
        if film:  # a ResBlock's chunks of its [B, 2C] embedding output
            fs, fh = (0.1 * torch.randn((B, 2 * C), generator=gen,
                                        device=dev)).chunk(2, dim=-1)
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
                        line["parent_equal"] = bool(torch.equal(p_st, st))
                        line["parent_ms"] = time_ms(
                            lambda: _parent_gn_stats(gn_parent, x))
                    line["device_ms"] = device_ms(kfn)
                    line.update(_k1_fold_times(gn, x, scale, shift, fs, fh,
                                               gn_parent))
            if name == "gn_stats":
                line.update(_k1_fold_check(gn, x, st, scale, shift, fs, fh))
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
                check(line["fold_sums_equal"] and line["fold_max_ulps"] <= 2,
                      f"K1 with its fold {line['shape']} film={film}: sums "
                      f"equal {line['fold_sums_equal']}, "
                      f"{line['fold_ulps']} ulps")
                check(line.get("parent_equal", True),
                      f"gn_stats {line['shape']}: sums equal the parent's")
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


def spatial_path_shapes(seed: int, model, fused, int8m, n: int) -> dict:
    """Every distinct kernel call of the spatial phase's forwards (one 96^3
    batch-1 patch, H over ``n`` shards; bf16 unfused, fused and int8, f32
    unfused and fused) at the shapes the kernels get there
    (:func:`_shard_shapes`)."""
    f32 = [_model(use_fp16=False, seed=seed, fused=f)[0].cuda()
           for f in (False, True)]
    out = _shard_shapes([(m, 1) for m in (model, fused, int8m, *f32)], n)
    del f32
    torch.cuda.empty_cache()
    return out


def spatial_seg_path_shapes(seg_models: dict, n: int) -> dict:
    """Every distinct kernel call of the spatial_seg phase's forwards (each
    Seg model of ``seg_models``, on the host, over ``n`` shards: bf16, f32
    and int8 dynamic; :func:`_shard_shapes`)."""
    from ddpm3d_tpu_torch.ops import quant

    out = None
    for name, model in seg_models.items():
        card = model.cuda()
        f32 = _as_f32(card)
        cond = _seg_cond(name)
        out = _shard_shapes([(card, cond), (f32, cond)], n, out)
        card.set_int8(quant.Int8Config())
        out = _shard_shapes([(card, cond)], n, out)
        card.set_int8(None)
        del f32
        _to_host(card)
    torch.cuda.empty_cache()
    return out


def _shard_shapes(models, n: int, out=None) -> dict:
    """Every distinct kernel call of each (model, conditioner channels) of
    ``models`` (on the card) on one 96^3 batch-1 patch with H over ``n``
    shards, at the shapes the kernels get there: haloed rows, an up site's
    haloed low-resolution rows upsampled, a fused site's padded skip, a
    GroupNorm's local rows. Read one shard at a time under a group whose
    transport gives shapes only (zero halo planes, local sums, the shard
    repeated for a gather), through the package's own halo and crop logic,
    by wrapping the ops the model calls and by the GroupNorm hooks, into
    ``out`` (new if None): {"conv": {(D, H, W, Cin, Cout, dtype)},
    "fused": {(... as fused_path_shapes)}, "fused_f32": {(... as
    f32_path_shapes' fused)}, "gn": {(N, C, dtype, film, silu)}, "s8":
    {(... as int8_path_shapes)}}."""
    from ddpm3d_tpu_torch.ops import conv3d as cv
    from ddpm3d_tpu_torch.ops import conv3d_fused as fo
    from ddpm3d_tpu_torch.ops import quant
    from ddpm3d_tpu_torch.parallel import SpatialGroup

    class ShapeGroup(SpatialGroup):
        def _exchange(self, sends):
            return {p: torch.zeros_like(t) for p, t in sends.items()}

        def _reduce(self, t, op):
            return t.clone()

        def _gather(self, t):
            return [t] * self.size

    if out is None:
        out = {k: set() for k in ("conv", "fused", "fused_f32", "gn", "s8")}
    real = (cv.conv3d, fo.conv3d_fused, quant.conv3d_int8)

    def conv(x, weight, *args, **kw):
        _, D, H, W, cin = x.shape
        out["conv"].add((D, H, W, cin, weight.shape[0], x.dtype))
        return real[0](x, weight, *args, **kw)

    def conv_fused(x, weight, *args, **kw):
        _, D, H, W, cin = x.shape
        flags = (kw.get("prologue_g") is not None,
                 bool(kw.get("prologue_silu", True)),
                 kw.get("skip") is not None, bool(kw.get("want_stats", False)))
        if x.dtype == torch.float32:
            out["fused_f32"].add((D, H, W, cin, weight.shape[0]) + flags)
        else:
            out["fused"].add((D, H, W, cin, weight.shape[0], x.dtype) + flags)
        return real[1](x, weight, *args, **kw)

    def conv_int8(x, wq, *args, upsample=False, **kw):
        _, D, H, W, cin = x.shape
        out["s8"].add((D, H, W, cin, wq.shape[0], wq[0, 0].numel(),
                       bool(upsample)))
        return real[2](x, wq, *args, upsample=upsample, **kw)

    h = 96 // n
    x = torch.randn((1, 96, h, 96, 1), device="cuda")
    t = torch.tensor([500], device="cuda")
    cv.conv3d, fo.conv3d_fused, quant.conv3d_int8 = conv, conv_fused, conv_int8
    try:
        for m, cond in models:
            low = x if cond == 1 else torch.randn((1, 96, h, 96, cond),
                                                  device="cuda")
            handles = _gn_hooks(m, out["gn"])
            try:
                for i in range(n):
                    m.set_spatial(ShapeGroup(range(n), i))
                    with torch.inference_mode():
                        m(x, t, low_res=low)
            finally:
                m.set_spatial(None)
                for hd in handles:
                    hd.remove()
    finally:
        cv.conv3d, fo.conv3d_fused, quant.conv3d_int8 = real
    return out


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


def phase_fused_kernels(gen: torch.Generator, shapes) -> dict:
    """``conv3d_fused`` against its plain version at every distinct fused
    shape with the flags the model uses there: the output at TOL, the stats
    as the next GroupNorm folds them; at every distinct shape also bit for
    bit between two runs and between a volume alone and in a batch of 2.
    At the FUSED_TIMED sites also the kernel, plain and bound times, the
    unfused sequence the kernel replaces (K2 gn_apply + K3 conv + skip add
    + K1 channel_stats; no single PyTorch call computes this function)."""
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
                        library_ms=None, tflops=flops / ms / 1e9)
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


def phase_fold_launch(gen: torch.Generator, fused) -> dict:
    """The fold's own launch (``fold_stats``: gn_fold_kernel) against the
    torch fold (``fold_gn_affine``, ``gn_moments``) on the same sums, in
    ulps (at most 2): at every (C, FiLM) it folds in one bf16 96^3 batch-1
    forward of ``fused``, on K4's stats and the FiLM rows as the forward
    hands them in, and on the sums of two halves of a batch of 2 added, as
    a spatial group's all-reduce gives them, with FiLM rows a chunk of a
    [2, 2C] embedding output (the row stride). Timed on the forward's
    widest sums with FiLM: the launch (CUDA events, and device ms), the
    torch fold, and the bound of the launch's bytes."""
    import inspect

    from ddpm3d_tpu_torch.ops import groupnorm as gn

    dev = torch.device("cuda")
    real, calls = gn.fold_stats, {}
    sig = inspect.signature(real)

    def capture(*args, **kw):
        a = sig.bind(*args, **kw)
        a.apply_defaults()
        a = dict(a.arguments)
        calls.setdefault((a["stats"].shape[-1],
                          a["film_scale"] is not None), a)
        return real(*args, **kw)

    x = torch.randn((1, 96, 96, 96, 1), device=dev)
    gn.fold_stats = capture
    try:
        with torch.inference_mode():
            fused(x, torch.tensor([500], device=dev), low_res=x)
    finally:
        gn.fold_stats = real
    check(len(calls) > 0, "the fused forward launches the fold")
    worst, worst_err, checked = 0.0, 0.0, 0
    with torch.inference_mode():
        for (C, film), a in sorted(calls.items()):
            h = (torch.randn((2, 2 * 4096, C), generator=gen, device=dev) * 2
                 + 0.5).to(torch.bfloat16)
            emb = 0.1 * torch.randn((2, 2 * C), generator=gen, device=dev)
            fs, fh = emb.chunk(2, dim=-1) if film else (None, None)
            cases = (
                ("k4", a["stats"], a["n_spatial"], a["film_scale"],
                 a["film_shift"]),
                ("all_reduced",
                 gn.channel_stats(h[:, :4096].contiguous())
                 + gn.channel_stats(h[:, 4096:].contiguous()),
                 2 * 4096, fs, fh))
            for src, st, n, s, sh in cases:
                kw = dict(num_groups=a["num_groups"], eps=a["eps"],
                          film_scale=s, film_shift=sh)
                got = gn.fold_stats(st, n, a["scale"], a["bias"],
                                    moments=True, **kw)
                ref = (gn.fold_gn_affine(st, n, a["scale"], a["bias"], **kw)
                       + gn.gn_moments(st, n, a["num_groups"], a["eps"]))
                ulps = {k: _ulps(v, r) for k, v, r in zip(
                    ("g", "b", "mean", "rstd"), got, ref)}
                err = max(rel_err(v, r)[0] for v, r in zip(got, ref))
                emit(dict(kernel="gn_fold", sums=src, shape=list(st.shape),
                          n=n, film=film, ulps=ulps, max_abs_err=err))
                check(max(ulps.values()) <= 2,
                      f"gn_fold {src} C={C} film={film}: {ulps} ulps")
                worst = max(worst, max(ulps.values()))
                worst_err = max(worst_err, err)
                checked += 1
        C, film = max(k for k in calls if k[1])
        a = calls[(C, film)]
        args = (a["stats"], a["n_spatial"], a["scale"], a["bias"],
                a["num_groups"], a["eps"], a["film_scale"], a["film_shift"])
        B = a["stats"].shape[0]
        # reads: the sums, gamma and beta, the FiLM rows; writes: g and b
        nbytes = (2 * B * C + 2 * C + 2 * B * C + 2 * B * C) * 4
        bms, by = bound(10.0 * B * C, nbytes, torch.float32)
        line = dict(kernel="gn_fold", shape=list(a["stats"].shape),
                    film=film, kernel_ms=time_ms(lambda: gn.fold_stats(*args)),
                    device_ms=device_ms(lambda: gn.fold_stats(*args)),
                    plain_ms=time_ms(lambda: gn.fold_gn_affine(*args)),
                    library_ms=None, bound_ms=bms, bound_by=by,
                    max_abs_err=worst_err, fold_max_ulps=worst,
                    shapes_checked=checked)
    emit(dict(line, phase="fold_launch"))
    return line


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


def phase_model(seed: int) -> dict:
    """The full-width f32 model on the card against the CPU: the forward,
    the fused forward, one loss and its gradients. Returns the counts of
    the forward ("model"), of the fused forward ("model_fused") and of the
    loss and its gradients ("model_grads")."""
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
    paths = {"model": dict(ops.launch_counts(), routes=ops.route_counts())}
    routes = {k: v for k, v in ops.route_counts().items() if v}
    err, rel = rel_err(out, ref)
    emit({"phase": "model", "shape": list(x.shape), "channels": 128,
          "dtype": "float32", "max_abs_err": err, "rel_err": rel,
          "tol": MODEL_TOL, "ref_abs_max": ref.abs().max().item(),
          "routes": routes})
    check(ref.abs().max().item() > 1e-3, "model output is non-trivial")
    check(rel <= MODEL_TOL, f"full-width model kernel path rel err {rel}")
    # the f32 model: its Cin = 2 input conv and its head on csrc/
    # conv3d_head.cu, the 70 torso convs on csrc/conv3d_f32.cu
    check(routes == {"conv3d.f32_narrow": 1, "conv3d.f32_head": 1,
                     "conv3d.f32": 70}, f"f32 model conv routes {routes}")

    # the same weights served fused: the card's kernels against the plain
    # fused path on the CPU, and against the unfused card forward
    fused, _, _ = _model(use_fp16=False, seed=seed, fused=True)
    fused.load_state_dict(model.state_dict(), strict=True)
    with torch.no_grad():
        ref_fused = fused(x, t, low_res=low)
        ops.reset_launch_counts()
        out_fused = fused.cuda()(x.cuda(), t.cuda(), low_res=low.cuda()).cpu()
    paths["model_fused"] = dict(ops.launch_counts(),
                                routes=ops.route_counts())
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
    # f32 fused convs run csrc/conv3d_f32.cu's fused instance
    check(fused_routes == {"conv3d_fused.f32": n_fused},
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
        ops.reset_launch_counts()
        terms = tl.compute_grads(
            m, sched.to(dev), cfg, x0.to(dev), {"low_res": low.to(dev)},
            t.to(dev), torch.ones(1, device=dev), noise=noise.to(dev))
        losses.append(terms["loss"].cpu())
        grads.append({n: p.grad.cpu() for n, p in m.named_parameters()})
        del m
    paths["model_grads"] = dict(ops.launch_counts(),
                                routes=ops.route_counts())
    grad_routes = {k: v for k, v in ops.route_counts().items() if v}
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
          "worst_grad_tensor": worst_name, "tol": GRAD_TOL,
          "routes": grad_routes})
    # the forward's routes, and the dx of the 70 torso convs on
    # csrc/conv3d_f32.cu, the head's on csrc/conv3d_head.cu (the input conv
    # has no dx)
    check(grad_routes == {"conv3d.f32_narrow": 1, "conv3d.f32_head": 1,
                          "conv3d.f32": 70, "conv3d_dx.f32": 70,
                          "conv3d_dx.f32_narrow": 1},
          f"f32 model gradient routes {grad_routes}")
    check(all(bool(torch.isfinite(g).all()) for g in grads[1].values()),
          "card gradients finite")
    check(loss_rel <= GRAD_TOL, f"training loss rel err {loss_rel}")
    check(worst <= GRAD_TOL, f"gradient {worst_name} rel err {worst}")
    return paths


def phase_gn_fold_route(model) -> dict:
    """One bf16 96^3 forward at batch 1 (``model``, unfused) with every
    GroupNorm's fold in K1, the program's route (``k1``, measured first and
    again last, ``k1_again``: the host's issue drifts once the profiler has
    run), against the fold in torch ops between K1 and K2 (``torch``, the
    route before the fold moved into K1, rebuilt here from K1 alone,
    ``gn_moments`` and ``gn_affine``). Per route: the device activities a
    forward launches (torch.profiler: kernels, copies and fills), the
    hand-written ones among them, the host's issue ms, the forward's ms
    and device ms, the folds by route; and the torch route's output
    difference to ``k1`` (the fold is bit-equal to the torch fold, so 0)."""
    from torch.profiler import ProfilerActivity, profile

    from ddpm3d_tpu_torch import ops
    from ddpm3d_tpu_torch.ops import groupnorm as gn

    def torch_fold(x, scale, bias, num_groups, eps, film_scale, film_shift,
                   moments=False):
        st = gn.channel_stats(x)
        mean_c, rstd_c = gn.gn_moments(st, x.shape[1], num_groups, eps)
        return gn.gn_affine(mean_c, rstd_c, scale, bias, film_scale,
                            film_shift) + (mean_c, rstd_c)

    x = torch.randn((1, 96, 96, 96, 1), device="cuda")
    t = torch.tensor([500], device="cuda")
    hand = tuple(p for pats in FORWARD_FAMILIES.values() for p in pats)
    real = gn.stats_and_fold
    line, outs = {"phase": "gn_fold_route", "batch": 1}, {}
    for route in ("k1", "torch", "k1_again"):
        if route == "torch":
            gn.stats_and_fold = torch_fold
        try:
            with torch.inference_mode():
                outs[route] = model(x, t, low_res=x).float()
                prof = time_and_profile(lambda: model(x, t, low_res=x),
                                        FORWARD_FAMILIES, reps=5, warmup=2,
                                        host_reps=7, top=4)
                torch.cuda.synchronize()
                ops.reset_launch_counts()
                with profile(activities=[ProfilerActivity.CUDA]) as p:
                    model(x, t, low_res=x)
                    torch.cuda.synchronize()
                folds = ops.fold_counts()
        finally:
            gn.stats_and_fold = real
        acts = [(ev.key, ev.count) for ev in p.key_averages()
                if getattr(ev, "device_time_total", 0)]
        line[route] = dict(
            prof, activities=sum(n for _, n in acts),
            hand_written=sum(n for k, n in acts if any(h in k for h in hand)),
            folds=folds)
    line["max_abs_diff"], line["rel_err"] = rel_err(outs["torch"],
                                                    outs["k1"])
    line["bit_equal"] = bool(torch.equal(outs["torch"], outs["k1"]))
    emit(line)
    for route in ("k1", "k1_again"):
        check(line[route]["folds"] == {"k1": 71, "launch": 0, "torch": 0},
              f"gn_fold_route: folds of a forward {line[route]['folds']}")
    check(line["rel_err"] <= TOL[torch.bfloat16],
          f"gn_fold_route: K1's fold against the torch fold "
          f"{line['rel_err']}")
    return line


def phase_model_f32_timed(seed: int) -> dict:
    """The full-width f32 model (phase_model's) at 96^3, batch 1, on the
    card: one forward (no grad) and one training loss with every parameter
    gradient (forward + backward, ``compute_grads``), ms by CUDA events
    (median of 2 after 1 warm-up), launches by route. Returns the launch
    counts of one forward + backward."""
    from ddpm3d_tpu_torch import ops
    from ddpm3d_tpu_torch.models.factory import create_gaussian_diffusion
    from ddpm3d_tpu_torch.training import train_loop as tl

    model = _model(use_fp16=False, seed=seed)[0].cuda()
    sched, cfg = create_gaussian_diffusion(
        steps=1000, learn_sigma=True, noise_schedule="linear")
    sched = sched.to("cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((1, 96, 96, 96, 1), generator=gen, device="cuda")
    low = torch.randn((1, 96, 96, 96, 1), generator=gen, device="cuda")
    noise = torch.randn(x.shape, generator=gen, device="cuda")
    t = torch.tensor([517], device="cuda")
    x0 = x.clamp(-1, 1)

    def forward():
        with torch.no_grad():
            model.eval()
            model(x, t, low_res=low)

    def grads():
        model.train()
        model.zero_grad(set_to_none=True)
        tl.compute_grads(model, sched, cfg, x0, {"low_res": low}, t,
                         torch.ones(1, device="cuda"), noise=noise)

    def timed(fn):
        return time_ms(fn, reps=2, warmup=1)

    ops.reset_launch_counts()
    grads()
    torch.cuda.synchronize()
    counts = dict(ops.launch_counts(), routes=ops.route_counts())
    torch.cuda.reset_peak_memory_stats()
    forward_ms, grads_ms = timed(forward), timed(grads)
    line = {"phase": "model_f32_timed", "shape": [1, 96, 96, 96, 1],
            "channels": 128, "dtype": "float32",
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "routes": {k: v for k, v in counts["routes"].items() if v},
            "forward_ms": forward_ms, "grads_ms": grads_ms}
    emit(line)
    check(line["routes"].get("conv3d.f32") == 70
          and line["routes"].get("conv3d_dx.f32") == 70,
          f"f32 model at 96^3 routes {line['routes']}")
    model.zero_grad(set_to_none=True)
    del model
    torch.cuda.empty_cache()
    return counts


def phase_denoise(model, sched, cfg, seed: int, phase: str = "denoise",
                  mesh=None, **sampler):
    """``denoise_volume`` on the synthetic volume, with ``sampler``'s options
    (``use_ddim``, ``use_dpm_solver``, ``dpm_order``) and ``mesh``; launches
    per forward must equal FORWARD_LAUNCHES[phase]. Returns (launch counts,
    volume, the chain's first model output)."""
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
        batch_size=batch, mesh=mesh, **sampler,
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
    folds_per_forward = {k: v / forwards
                         for k, v in ops.fold_counts().items()}
    line = {
        "phase": phase, "volume_zhw": list(shape), "patches": n_patches,
        "patch": 96, "channels": 128, "dtype": "bfloat16", "steps": steps,
        "sampler": sampler,
        "batch": batch, "wall_s": wall, "sample_wall_s": stats["sample_wall_s"],
        "ms_per_step": stats["sample_wall_s"] * 1e3 / steps,
        "ms_per_forward": stats["sample_wall_s"] * 1e3 / forwards,
        "volume_voxels_per_s": float(np.prod(shape)) / stats["sample_wall_s"],
        "patch_voxel_steps_per_s":
            n_patches * 96 ** 3 * steps / stats["sample_wall_s"],
        "launches": counts,
        "launches_per_forward": per_forward,
        "routes_per_forward": routes_per_forward,
        "folds_per_forward": folds_per_forward,
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
    want = FORWARD_LAUNCHES[phase]
    check(folds_per_forward == {"k1": want["gn_stats"],
                                "launch": want["gn_fold"], "torch": 0},
          f"{phase} GroupNorm folds per forward {folds_per_forward}")
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


# ------------------------------------------------------------- serving --

# DPM-Solver++ order 1 against DDIM (eta 0) from the same x_T on the card,
# mean |dpm1 - ddim| / mean |ddim| over the volume: the two are the same
# update (x0 form and eps form), so they differ only by f32 rounding in the
# update, which flips a few bf16 roundings of the next step's input; the
# x0 recovery at early steps multiplies the model's difference by up to
# sqrt(1/acp - 1) ~ 158 before clipping. A wrong coefficient or a step off
# by one moves the volume as a different sampler does: order 2 against
# order 1 is reported beside it as that scale. Measured on an H100 80GB
# HBM3 at 700 W: 1.05e-3, and 3.0e-2 for order 2 against order 1. The first
# forward sees the same input on both chains and must agree bit for bit.
DPM_DDIM_TOL = 1e-2
DPM_RESPACING = "ddim5"
# the CLI phase: the production launch (test_DDPM_3d_tpu.sh) on a (96,
# 200, 200) volume, 9 patches of 96^3, 6 draws each, with an explicit
# 3-step chain (the odd positions of a 6-step one, as a distilled student's)
CLI_FLAGS = [
    "--large_size", "96", "--num_channels", "128", "--learn_sigma", "True",
    "--use_fp16", "True", "--use_scale_shift_norm", "True",
    "--resblock_updown", "True", "--attention_resolutions", "1000",
    "--num_head_channels", "64", "--diffusion_steps", "1000",
    "--noise_schedule", "linear", "--num_samples", "6", "--batch_size", "1",
    "--timestep_respacing", "", "--use_dpm_solver", "True",
]
CLI_CHAIN = [167, 501, 835]
CLI_TIMEOUT_S = 600


def phase_dpm(model, seed: int) -> dict:
    """The denoise phase's volume and weights through DPM-Solver++(2M) over
    a 5-step respacing, with exact launches per forward; order 1 and DDIM
    (eta 0) on the same x_T against each other; and the samplers' own
    device time per step beyond the forward (a stub model that returns a
    fixed output). Returns {path: launch counts}."""
    from ddpm3d_tpu_torch.models.factory import create_gaussian_diffusion

    sched, cfg = create_gaussian_diffusion(
        steps=1000, learn_sigma=True, noise_schedule="linear",
        timestep_respacing=DPM_RESPACING)
    counts, runs = {}, {}
    for path, sampler in (("dpm", dict(use_dpm_solver=True)),
                          ("dpm_order1", dict(use_dpm_solver=True,
                                              dpm_order=1)),
                          ("ddim", dict(use_ddim=True))):
        counts[path], vol, eps = phase_denoise(model, sched, cfg, seed,
                                               phase=path, **sampler)
        runs[path] = (vol, eps)
    d21 = np.abs(runs["dpm"][0] - runs["dpm_order1"][0])
    emit({"phase": "dpm_order2_vs_order1",
          "volume_mean_rel_diff":
              float(d21.mean() / np.abs(runs["dpm_order1"][0]).mean())})
    check_volumes("dpm_order1_vs_ddim", runs["ddim"][0],
                  runs["dpm_order1"][0], runs["ddim"][1],
                  runs["dpm_order1"][1], 0.0, DPM_DDIM_TOL)
    phase_sampler_overhead(sched, cfg)
    return counts


def phase_sampler_overhead(sched, cfg) -> None:
    """Device ms per step of each sampler's own work at batch 2 of 96^3 (the
    model a stub returning a fixed learned-sigma output): p_mean_variance,
    the update and, for DDPM/DDIM, the step noise; torch.profiler's device
    time and CUDA events over the whole chain."""
    from torch.profiler import ProfilerActivity, profile

    from ddpm3d_tpu_torch.diffusion import (
        dpm_solver_pp_sample_loop, p_sample_loop)

    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((2, 96, 96, 96, 1), device="cuda", generator=gen)
    out = torch.randn((2, 96, 96, 96, 2), device="cuda", generator=gen)

    def stub(x, t, **kw):
        return out

    chains = {
        "dpm_solver_2m": lambda: dpm_solver_pp_sample_loop(
            stub, sched, cfg, x, device="cuda"),
        "ddim": lambda: p_sample_loop(stub, sched, cfg, noise=x,
                                      use_ddim=True, device="cuda"),
        "ddpm": lambda: p_sample_loop(stub, sched, cfg, noise=x,
                                      device="cuda"),
    }
    steps = sched.num_timesteps
    line = {"phase": "sampler_overhead", "batch": 2, "patch": 96,
            "steps": steps, "device_ms_per_step": {}, "ms_per_step": {}}
    for name, run in chains.items():
        line["ms_per_step"][name] = time_ms(run, reps=5, warmup=2) / steps
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        _, other = device_breakdown(prof, {})
        line["device_ms_per_step"][name] = sum(other.values()) / steps
    emit(line)
    check(all(v > 0 for v in line["device_ms_per_step"].values()),
          "the profiler saw the samplers' device time")


def phase_distributed(model, sched, cfg, seed: int, volume) -> dict:
    """The denoise phase again through the patch split: an NCCL process
    group of one rank (in this process, through a FileStore), so the rank's
    slice goes through the all_gather; its volume must equal the denoise
    phase's bit for bit. Then one all_gather of the phase's four 96^3 f32
    patches, timed. Returns the launch counts."""
    import torch.distributed as dist

    from ddpm3d_tpu_torch.parallel import all_gather_rows, world

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
            rank=0, world_size=1)
        try:
            check(world() == (0, 1), "the process group is up")
            # NCCL makes its communicator at the first collective: timed
            # here, so that the phase's sampling time is the split path's
            rows = torch.randn((4, 96, 96, 96), device="cuda")
            torch.cuda.synchronize()
            t0 = time.monotonic()
            all_gather_rows(rows[:1])
            torch.cuda.synchronize()
            first_s = time.monotonic() - t0
            counts, split_volume, _ = phase_denoise(
                model, sched, cfg, seed, phase="distributed")
            gathered = all_gather_rows(rows)
            check(torch.equal(gathered, rows), "all_gather of one rank")
            ms = time_ms(lambda: all_gather_rows(rows), reps=10, warmup=3)
            backend = dist.get_backend()
        finally:
            dist.destroy_process_group()
    equal = bool(np.array_equal(split_volume, volume))
    emit({"phase": "distributed_gather", "backend": backend, "world_size": 1,
          "volume_bit_equal_to_denoise": equal,
          "volume_max_abs_diff": float(np.abs(split_volume - volume).max()),
          "first_collective_s": first_s,
          "all_gather_ms": ms, "all_gather_bytes": rows.numel() * 4,
          "all_gather_gb_per_s": rows.numel() * 4 / ms / 1e6})
    check(equal, "the split path's volume equals the denoise phase's")
    return counts


def phase_spatial_one_rank(model, sched, cfg, seed: int, volume) -> dict:
    """The denoise phase through ``make_mesh(n_spatial=1)`` under an NCCL
    process group of one rank (in this process, through a FileStore): the
    spatial axis of one changes nothing, so the volume must equal the
    denoise phase's bit for bit. Returns the launch counts."""
    import torch.distributed as dist

    from ddpm3d_tpu_torch.parallel import make_mesh

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
            rank=0, world_size=1)
        try:
            mesh = make_mesh(n_spatial=1)
            check(mesh.shape == {"data": 1, "spatial": 1}, "a (1, 1) mesh")
            counts, got, _ = phase_denoise(model, sched, cfg, seed,
                                           phase="spatial_one_rank",
                                           mesh=mesh)
        finally:
            dist.destroy_process_group()
    equal = bool(np.array_equal(got, volume))
    emit({"phase": "spatial_one_rank_volume", "backend": "nccl",
          "mesh": [1, 1], "volume_bit_equal_to_denoise": equal,
          "volume_max_abs_diff": float(np.abs(got - volume).max())})
    check(equal, "the (1, 1) mesh's volume equals the denoise phase's")
    return counts


# ------------------------------------------------------------- spatial --

# the spatial phase splits one 96^3 patch's H over this many shards, each
# on its own CUDA stream in a thread of this process (the machine has one
# card, and NCCL takes one rank per card)
SPATIAL_SHARDS = 2
# launches per shard of one forward under a spatial group: every conv and
# GroupNorm launches once, as unsharded (on its haloed rows); fused, every
# GroupNorm takes K1's local sums (the fused conv's stats would count the
# halo rows), 17 unfused + 54 folds
# (every GroupNorm folds the group's all-reduced sums in the fold's own
# launch)
SPATIAL_LAUNCHES = {
    "unfused": dict(FORWARD_LAUNCHES["denoise"], gn_fold=71),
    "fused": dict(FORWARD_LAUNCHES["denoise_fused"], gn_stats=71,
                  gn_fold=71),
    "int8_dynamic": dict(FORWARD_LAUNCHES["denoise_int8"], gn_fold=71),
    "int8_static": dict(FORWARD_LAUNCHES["denoise_int8"], gn_fold=71),
    "f32": dict(FORWARD_LAUNCHES["denoise"], gn_fold=71),
    "fused_f32": dict(FORWARD_LAUNCHES["denoise_fused"], gn_stats=71,
                      gn_fold=71),
}
SPATIAL_ROUTES = {
    "unfused": FORWARD_ROUTES["denoise"],
    "fused": FORWARD_ROUTES["denoise_fused"],
    "int8_dynamic": FORWARD_ROUTES["denoise_int8"],
    "int8_static": FORWARD_ROUTES["denoise_int8"],
    "f32": dict(_routes(0, 0, 0), **{"conv3d.f32_narrow": 1,
                                    "conv3d.f32_head": 1, "conv3d.f32": 70}),
    "fused_f32": dict(_routes(0, 0, 0), **{
        "conv3d.f32_narrow": 1, "conv3d.f32_head": 1, "conv3d.f32": 16,
        "conv3d_fused.f32": 54}),
}
# the 2-shard forward against the unsharded one, max |diff| / max |ref|:
# the GroupNorm sums add in another order (per shard, then over the
# group). In f32 that is summation order alone; bf16 and int8 carry the
# roundings it flips through ~70 layers (a bf16 line reports the
# forward's own noise, ``noise_rel_err``: every GroupNorm's sums one f32
# ulp larger), so int8 is held to INT8_FORWARD_TOL and, exactly, every
# int8 site on its own input
SPATIAL_TOL = {"unfused": TOL[torch.bfloat16], "fused": TOL[torch.bfloat16],
               "int8_dynamic": INT8_FORWARD_TOL,
               "int8_static": INT8_FORWARD_TOL, "f32": TOL[torch.float32],
               "fused_f32": TOL[torch.float32]}
# int8 static runs on INT8_SCALES_PROD.json, the served scales: calibrated
# on trained weights, they saturate many sites of these random ones, so a
# flipped rounding ahead of a saturated site moves the forward by far more
# than INT8_FORWARD_TOL. Its bound is then also this factor times the
# forward's own noise read in the same run (``noise_rel_err``, every
# GroupNorm's sums one f32 ulp larger; the shards' sums differ from the
# unsharded ones by their order, a few ulps either way); every site on its
# own input stays exact
SPATIAL_NOISE_TOL = {"int8_static": 2.0}
# the 3-step DDPM chain of one patch, mean |diff| / mean |unsharded| (the
# x0 recovery at t = 999 multiplies differences by ~158 before clipping, as
# DENOISE_FUSED_TOL says)
SPATIAL_CHAIN_TOL = TOL[torch.bfloat16]
SPATIAL_TIMEOUT_S = 300.0


def _all_counts() -> collections.Counter:
    from ddpm3d_tpu_torch import ops

    return collections.Counter(dict(ops.launch_counts(),
                                    **ops.route_counts()))


class _ShardBoard:
    """Where the shard threads meet: each collective waits until every
    shard has put its part, then hands every shard the list of parts. One
    thread issues work at a time (the turn: a shard gives it up only while
    it waits at a collective), so the launch counters stay exact and each
    shard's launches are told apart. Every part stays referenced until
    :meth:`clear`, after the caller synchronized: no shard's memory is
    reused while another shard's stream may still read it."""

    def __init__(self, n: int):
        self.n = n
        self.cond = threading.Condition()
        self.turn = threading.Lock()
        self.slots, self.result, self.gen, self.failed = {}, None, 0, False
        self.kept = []
        self.launches = [collections.Counter() for _ in range(n)]
        self._mark = None

    def _take(self) -> None:
        self.turn.acquire()
        self._mark = _all_counts()

    def _give(self, index: int) -> None:
        self.launches[index] += _all_counts() - self._mark
        self.turn.release()

    def meet(self, index: int, part):
        self._give(index)
        try:
            with self.cond:
                gen = self.gen
                self.slots[index] = part
                if len(self.slots) == self.n:
                    self.result = [self.slots[i] for i in range(self.n)]
                    self.kept.append(self.result)
                    self.slots, self.gen = {}, gen + 1
                    self.cond.notify_all()
                elif not self.cond.wait_for(
                        lambda: self.gen != gen or self.failed,
                        SPATIAL_TIMEOUT_S):
                    raise RuntimeError("a shard never reached a collective")
                if self.failed:
                    raise RuntimeError("another shard failed")
                return self.result
        finally:
            self._take()

    def run(self, fns, streams):
        """``fns[i]()`` in thread i on ``streams[i]``, in inference mode
        (each stream first waits for the current one); their results, once
        every stream is done."""
        outs, errs = [None] * self.n, []
        for s in streams:
            s.wait_stream(torch.cuda.current_stream())

        def body(i):
            self._take()
            try:  # grad mode and the current stream are per thread
                with torch.inference_mode(), torch.cuda.stream(streams[i]):
                    outs[i] = fns[i]()
            except BaseException as e:  # handed to the caller below
                errs.append(e)
                with self.cond:
                    self.failed = True
                    self.cond.notify_all()
            finally:
                self._give(i)

        threads = [threading.Thread(target=body, args=(i,))
                   for i in range(self.n)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(SPATIAL_TIMEOUT_S * 4)
        check(not any(th.is_alive() for th in threads),
              "the shard threads finished")
        if errs:
            raise errs[0]
        torch.cuda.synchronize()
        return outs

    def clear(self) -> None:
        self.kept = []


def _spatial_group_types():
    """The in-process counterparts of ``parallel/spatial.py``'s transport
    (the group's halo, crop and concatenation logic is the package's):
    ``ThreadGroup``, shared by the shard threads, whose index is the
    calling thread's shard and whose parts cross streams by events; and
    ``ReplayGroup``, one shard alone on the current stream, handed what
    that shard received in a ThreadGroup run, in order (its device time is
    then the shard's own)."""
    from ddpm3d_tpu_torch.parallel import SpatialGroup

    class ThreadGroup(SpatialGroup):
        def __init__(self, board: _ShardBoard):
            self.local = threading.local()
            super().__init__(range(board.n), 0)
            self.board = board
            self.received = [[] for _ in range(board.n)]

        @property
        def index(self):
            return getattr(self.local, "index", 0)

        @index.setter
        def index(self, value):
            self.local.index = value

        def _meet(self, part):
            ev = torch.cuda.Event()
            ev.record()
            got = self.board.meet(self.index, (part, ev))
            for i, (_, e) in enumerate(got):
                if i != self.index:
                    torch.cuda.current_stream().wait_event(e)
            return [p for p, _ in got]

        def _keep(self, value):
            self.received[self.index].append(value)
            return value

        def _exchange(self, sends):
            got = self._meet(sends)
            return self._keep({p: got[p][self.index] for p in sends})

        def _reduce(self, t, op):
            parts = self._meet(t)
            out = parts[0].clone()
            for p in parts[1:]:
                out = out + p if op == "sum" else torch.maximum(out, p)
            return self._keep(out)

        def _gather(self, t):
            return self._keep(self._meet(t))

    class ReplayGroup(SpatialGroup):
        def __init__(self, n: int, index: int, received: list):
            super().__init__(range(n), index)
            self.received, self.cursor = received, 0

        def rewind(self):
            self.cursor = 0

        def _next(self):
            self.cursor += 1
            return self.received[self.cursor - 1]

        def _exchange(self, sends):
            return self._next()

        def _reduce(self, t, op):
            return self._next()

        def _gather(self, t):
            return self._next()

    return ThreadGroup, ReplayGroup


def _shards(t: torch.Tensor, n: int) -> list:
    h = t.shape[2] // n
    return [t[:, :, i * h:(i + 1) * h].contiguous() for i in range(n)]


def _sharded_run(model, fns_of_shard, n: int):
    """``fns_of_shard(i)`` for every shard at once under one ThreadGroup
    attached to ``model``: (outputs, the group, its operations run
    {op: n}, each shard's launches)."""
    from ddpm3d_tpu_torch.utils import tracing

    ThreadGroup, _ = _spatial_group_types()
    before = tracing.counters("spatial.")
    board = _ShardBoard(n)
    group = ThreadGroup(board)
    streams = [torch.cuda.Stream() for _ in range(n)]

    def shard(i):
        group.index = i
        return fns_of_shard(i)

    model.set_spatial(group)
    try:
        outs = board.run([functools.partial(shard, i) for i in range(n)],
                         streams)
    finally:
        model.set_spatial(None)
    board.clear()
    calls = {k.split(".", 1)[1]: v - before.get(k, 0)
             for k, v in tracing.counters("spatial.").items()}
    return outs, group, {k: v for k, v in calls.items() if v}, board.launches


def _conv_row_overhead(model, x, t, low, n: int) -> float:
    """The share of extra conv work the halo rows cost on a shard: sum over
    the 3x3x3 convs of D x (h + halo) x W x Cin x Cout over the same with h
    alone (one neighbour for an edge shard of 2; the input rows of an up
    site double, and so do its halo rows)."""
    from ddpm3d_tpu_torch.models.nn import Conv3x3x3

    work = []

    def hook(mod, args, kwargs):
        b, d, h, w, cin = args[0].shape
        f = 2 if kwargs.get("upsample") else 1
        work.append((d * h * f * w * f * cin * mod.weight.shape[0],
                     d * (h + 1) * f * w * f * cin * mod.weight.shape[0]))

    hooks = [m.register_forward_pre_hook(hook, with_kwargs=True)
             for m in model.modules() if isinstance(m, Conv3x3x3)]
    try:
        with torch.inference_mode():
            model(_shards(x, n)[0], t, low_res=_shards(low, n)[0])
    finally:
        for h in hooks:
            h.remove()
    return sum(b for _, b in work) / sum(a for a, _ in work) - 1.0


@contextlib.contextmanager
def _gn_sums_one_ulp_larger(gn_ops):
    """Every GroupNorm's own sums one f32 ulp larger: K1's sums scaled,
    then folded by the fold's own launch, where K1 would fold them
    (``group_norm`` reaches K1 through ``stats_and_fold``)."""
    real = gn_ops.channel_stats, gn_ops.stats_and_fold

    def stats(v):
        return real[0](v) * (1 + 2.0 ** -23)

    def stats_and_fold(x, scale, bias, num_groups=gn_ops.NORM_GROUPS,
                       eps=1e-5, film_scale=None, film_shift=None,
                       moments=False):
        return gn_ops.fold_stats(stats(x), x.shape[1], scale, bias,
                                 num_groups, eps, film_scale, film_shift,
                                 moments)

    gn_ops.channel_stats, gn_ops.stats_and_fold = stats, stats_and_fold
    try:
        yield
    finally:
        gn_ops.channel_stats, gn_ops.stats_and_fold = real


def _spatial_forward(model, name: str, x, low, t, n: int,
                     spec=None) -> dict:
    """One variant: the unsharded forward, the n-shard forward in threads
    (against it, with each shard's launches; in int8 every site's scale,
    and every site on the shards' gathered input, unsharded, against the
    shards' outputs bit for bit), each shard alone again from what it
    received (bit-equal to its threaded output, timed and profiled beside
    the unsharded forward). A bf16 model (int8 too) also reports the
    forward's own noise: the unsharded forward with every GroupNorm's sums
    one f32 ulp larger, from which a variant with a noise factor takes its
    bound. ``spec`` holds the line's ``phase`` and ``label`` keys, the
    ``launches`` and ``routes`` wanted per shard, ``tol``,
    ``noise_factor`` (or None) and whether the shards are ``timed``;
    default: the spatial phase's tables for ``name``."""
    if spec is None:
        spec = dict(phase="spatial_forward", label={},
                    launches=SPATIAL_LAUNCHES[name],
                    routes=SPATIAL_ROUTES[name], tol=SPATIAL_TOL[name],
                    noise_factor=SPATIAL_NOISE_TOL.get(name),
                    timed=model.dtype == torch.bfloat16)
    from ddpm3d_tpu_torch.models.nn import Conv1x1x1, Conv3x3x3
    from ddpm3d_tpu_torch.ops import groupnorm as gn_ops
    from ddpm3d_tpu_torch.ops import quant

    _, ReplayGroup = _spatial_group_types()
    real = quant.quantize_act
    scales = collections.defaultdict(list)  # thread -> [(amax, scale)]
    sites = collections.defaultdict(list)   # thread -> [(site, x, up, y)]

    def recording(x, static_scale=None, spatial=None):
        q, s = real(x, static_scale, spatial)
        amax = torch.linalg.vector_norm(x.reshape(x.shape[0], -1),
                                        float("inf"), dim=1,
                                        dtype=torch.float32)
        scales[threading.get_ident()].append((amax, s))
        return q, s

    def site_hook(mod, args, kwargs, out):
        if mod.int8_active():
            sites[threading.get_ident()].append(
                (mod, args[0], bool(kwargs.get("upsample")), out))

    xs, lows = _shards(x, n), _shards(low, n)
    idents = [None] * n

    def fwd(i):
        idents[i] = threading.get_ident()
        return model(xs[i], t, low_res=lows[i])

    int8 = model.int8 is not None
    hooks = [m.register_forward_hook(site_hook, with_kwargs=True)
             for m in model.modules()
             if int8 and isinstance(m, (Conv3x3x3, Conv1x1x1))]
    with torch.inference_mode():
        model(x, t, low_res=low)  # warm: weight packing
        quant.quantize_act = recording
        try:
            ref = model(x, t, low_res=low)
            ref_scales = scales.pop(threading.get_ident(), [])
            sites.clear()
            outs, group, calls, launches = _sharded_run(model, fwd, n)
        finally:
            quant.quantize_act = real
            for h in hooks:
                h.remove()
    got = torch.cat(outs, dim=2)
    err, rel = rel_err(got, ref)
    want_launches, want_routes = spec["launches"], spec["routes"]
    line = {"phase": spec["phase"], **spec["label"], "variant": name,
            "shards": n, "shape": list(x.shape),
            "cond_shape": list(low.shape), "max_abs_err": err,
            "rel_err": rel, "tol": spec["tol"],
            "calls_per_forward": {k: v // n for k, v in calls.items()},
            "launches_per_shard": [{k: c.get(k, 0) for k in want_launches}
                                   for c in launches]}
    if model.dtype == torch.bfloat16:
        with torch.inference_mode(), _gn_sums_one_ulp_larger(gn_ops):
            line["noise_rel_err"] = rel_err(model(x, t, low_res=low),
                                            ref)[1]
        if spec["noise_factor"]:
            line["tol"] = max(line["tol"], spec["noise_factor"]
                              * line["noise_rel_err"])
    what = " ".join([spec["phase"], *map(str, spec["label"].values()), name])
    check(bool(torch.isfinite(got).all()), f"{what}: finite")
    check(rel <= line["tol"], f"{what}: rel err {rel} > {line['tol']}")
    for i, c in enumerate(launches):
        check({k: c.get(k, 0) for k in want_launches} == want_launches,
              f"{what}: shard {i} launches {dict(c)}")
        check({k: c.get(k, 0) for k in want_routes} == want_routes,
              f"{what}: shard {i} routes {dict(c)}")
    if int8:
        per = [scales[idents[i]] for i in range(n)]
        amax = torch.stack([torch.stack([a for a, _ in p]) for p in per])
        used = torch.stack([torch.stack([s for _, s in p]) for p in per])
        ref_used = torch.stack([s for _, s in ref_scales])
        want = (quant._abs_max_scale(amax.amax(0))
                if model.int8.scales == "" else ref_used)
        scales_equal = all(torch.equal(used[i], want) for i in range(n))
        # every site on the gathered input, unsharded (the dynamic scale
        # is then the whole input's: the max over the shards')
        caught = [sites[idents[i]] for i in range(n)]
        n_sites = len(caught[0])
        unequal = []
        with torch.inference_mode():
            for k in range(len(caught[0])):
                mod, _, up, _ = caught[0][k]
                xw = torch.cat([c[k][1] for c in caught], dim=2)
                yw = mod(xw, upsample=up) if up else mod(xw)
                if not torch.equal(yw, torch.cat([c[k][3] for c in caught],
                                                 dim=2)):
                    unequal.append(mod.site)
        del caught
        sites.clear()
        line.update(sites=int(used.shape[1]),
                    site_scales_bit_equal=scales_equal,
                    sites_scale_as_unsharded=int(
                        (used[0] == ref_used).all(-1).sum()),
                    sites_checked=n_sites, sites_unequal=unequal)
        check(used.shape[1] == len(ref_scales) == n_sites
              == want_launches["conv3d_s8"],
              f"{what}: {used.shape[1]} int8 sites a shard")
        check(scales_equal, f"{what}: every site's scale is the group's")
        check(not unequal, f"{what}: sites unequal to the unsharded site on "
                           f"the gathered input: {unequal}")
    if spec["timed"]:
        line["overhead_conv_rows"] = _conv_row_overhead(model, x, t, low, n)
        line["unsharded"] = _profile_forward(
            lambda: model(x, t, low_res=low), int8)
        line["per_shard"] = []
        for i in range(n):
            replay = ReplayGroup(n, i, group.received[i])

            def alone(i=i, replay=replay):
                replay.rewind()
                return model(xs[i], t, low_res=lows[i])

            model.set_spatial(replay)
            try:
                with torch.inference_mode():
                    same = torch.equal(alone(), outs[i])
                    timed = _profile_forward(alone, int8)
            finally:
                model.set_spatial(None)
            check(same, f"{what}: shard {i} alone equals its run")
            line["per_shard"].append(dict(timed, replay_bit_equal=same))
        line["shard_device_share"] = [
            s["device_ms"] / line["unsharded"]["device_ms"]
            for s in line["per_shard"]]
    emit(line)
    return {"launches": sum(launches, collections.Counter())}


def _profile_forward(fn, int8: bool) -> dict:
    """``fn``'s forward ms, host issue ms, device ms and idle share, and its
    device ms by family: the kernels', the int8 glue's and the copies the
    halo adds (the concatenation and the crop's copy; the unsharded forward
    has some of both in its glue)."""
    families = dict(INT8_FAMILIES if int8 else FORWARD_FAMILIES,
                    concat=("CatArrayBatchedCopy",),
                    copy=("direct_copy_kernel", "copy_kernel"))
    with torch.inference_mode():
        prof = time_and_profile(fn, families, reps=3, warmup=1,
                                host_reps=3, top=3)
    return {"forward_ms": prof["ms"], "host_issue_ms": prof["host_issue_ms"],
            "device_ms": prof["device_ms"], "idle_share": prof["idle_share"],
            "kernel_ms": {k: v for k, v in prof["kernel_ms"].items() if v},
            "other_ms": prof["other_ms"]}


def phase_spatial(seed: int, model, fused, int8m, sched, cfg) -> dict:
    """The production model at full width with one 96^3 patch's H split
    over SPATIAL_SHARDS shards (threads of this process, a CUDA stream
    each, exchanging through ``_ShardBoard``): the forward unfused, fused,
    int8 with dynamic and with static scales (INT8_SCALES_PROD.json, the
    served file), and f32, each against the unsharded forward (SPATIAL_TOL,
    SPATIAL_NOISE_TOL; every int8 site's scale bit-equal to the group's),
    each shard's launches by kernel and route
    (SPATIAL_LAUNCHES, SPATIAL_ROUTES), and each shard's own device time
    beside the unsharded forward's; then a 3-step DDPM chain of one patch
    (each shard draws the whole patch's noise and keeps its rows) against
    the unsharded chain. Returns {path: launch counts}: ``spatial`` the
    chain's (both shards, counters zeroed just before), the forwards'
    under ``spatial_<variant>``."""
    from ddpm3d_tpu_torch import ops
    from ddpm3d_tpu_torch.diffusion import p_sample_loop
    from ddpm3d_tpu_torch.ops import quant

    n = SPATIAL_SHARDS
    t0 = time.monotonic()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((1, 96, 96, 96, 1), device="cuda", generator=gen)
    low = torch.randn((1, 96, 96, 96, 1), device="cuda", generator=gen)
    t = torch.tensor([500], device="cuda")
    counts = {}
    served = int8m.int8
    for name, m in (("unfused", model), ("fused", fused),
                    ("int8_dynamic", int8m), ("int8_static", int8m)):
        if name == "int8_dynamic":
            m.set_int8(quant.Int8Config())
        elif name == "int8_static":  # the served scales, whole chain
            m.set_int8(quant.Int8Config(scales=os.path.join(
                os.path.dirname(os.path.abspath(__file__)),
                "INT8_SCALES_PROD.json")))
        counts[f"spatial_{name}"] = _spatial_forward(m, name, x, low, t, n)[
            "launches"]
    int8m.set_int8(served)
    for name, is_fused in (("f32", False), ("fused_f32", True)):
        f32 = _model(use_fp16=False, seed=seed, fused=is_fused)[0]
        f32.load_state_dict(model.state_dict(), strict=True)
        f32.cuda()
        counts[f"spatial_{name}"] = _spatial_forward(f32, name, x, low, t,
                                                     n)["launches"]
        del f32
        torch.cuda.empty_cache()

    # the chain: DDPM, 3 steps, drawn noise, one patch
    def chain(x_shape, window, low_part):
        return p_sample_loop(
            lambda xx, tt, low_res: model(xx, tt, low_res=low_res).float(),
            sched, cfg, shape=x_shape, seed=seed, sample_ids=[0],
            model_kwargs={"low_res": low_part}, device="cuda",
            noise_window=window)

    with torch.inference_mode():
        ref = chain(tuple(x.shape), None, low)
        lows = _shards(low, n)
        h = 96 // n
        ops.reset_launch_counts()
        outs, _, _, launches = _sharded_run(
            model, lambda i: chain((1, 96, h, 96, 1),
                                   ((96, 96, 96, 1), i * h, (i + 1) * h),
                                   lows[i]), n)
        counts["spatial"] = dict(ops.launch_counts(),
                                 routes=ops.route_counts())
    got = torch.cat(outs, dim=2)
    d = (got - ref).abs()
    mean_rel = (d.mean() / ref.abs().mean()).item()
    steps = sched.num_timesteps
    emit({"phase": "spatial_chain", "shards": n, "steps": steps,
          "sampler": "ddpm", "volume_mean_rel_diff": mean_rel,
          "volume_max_abs_diff": d.max().item(), "tol": SPATIAL_CHAIN_TOL,
          "launches_per_shard": [{k: c.get(k, 0) for k in
                                  SPATIAL_LAUNCHES["unfused"]}
                                 for c in launches]})
    check(bool(torch.isfinite(got).all()), "spatial chain finite")
    check(mean_rel <= SPATIAL_CHAIN_TOL, f"spatial chain mean rel {mean_rel}")
    for i, c in enumerate(launches):
        check({k: c.get(k, 0) for k in SPATIAL_LAUNCHES["unfused"]}
              == {k: v * steps for k, v in SPATIAL_LAUNCHES["unfused"].items()},
              f"spatial chain: shard {i} launches {dict(c)}")
    total = {k: counts["spatial"][k] for k in SPATIAL_LAUNCHES["unfused"]}
    check(total == {k: v * steps * n for k, v
                    in SPATIAL_LAUNCHES["unfused"].items()},
          f"spatial chain launches {total}")
    emit({"phase": "spatial", "seconds": time.monotonic() - t0})
    for path in list(counts):
        if "routes" not in counts[path]:
            c = counts[path]
            counts[path] = dict({k: c.get(k, 0) for k in
                                 FORWARD_LAUNCHES["denoise"]},
                                routes={k: c.get(k, 0) for k in
                                        _routes(0, 0, 0)})
    return counts


def _seg_cond(name: str) -> int:
    """The conditioner's channels of a Seg model of SPATIAL_SEG_MODELS."""
    return SEG_6C_COND if name in SEG_6C_MODELS else 1


def _seg_fusion(name: str) -> str:
    return {"SegModelv2_6c": "add", "SegModelv3_6c": "cat_conv"}.get(name,
                                                                     name)


def _seg_spatial_spec(name: str, variant: str) -> dict:
    """_spatial_forward's spec of one Seg model and variant."""
    six = name in SEG_6C_MODELS
    sharded = dict(SEG_LAUNCHES, gn_fold=99)  # the group's sums: launched
    if variant == "int8_dynamic":
        launches = dict(sharded, conv3d=3,
                        conv3d_s8=SEG_INT8_S8[_seg_fusion(name)])
        routes = (SEG_6C_INT8_ROUTES if six
                  else SEG_INT8_ROUTES)[_seg_fusion(name)]
    elif variant == "f32":
        launches = sharded
        routes = dict(_routes(0, 0, 0), **{
            "conv3d.f32": 100 if six else 99,
            "conv3d.f32_narrow": 0 if six else 1, "conv3d.f32_head": 1})
    else:
        launches, routes = sharded, SEG_6C_ROUTES if six else SEG_ROUTES
    return dict(phase="spatial_seg_forward", label={"model": name},
                launches=launches, routes=routes,
                tol=INT8_FORWARD_TOL if variant == "int8_dynamic"
                else TOL[torch.float32 if variant == "f32"
                         else torch.bfloat16],
                noise_factor=SPATIAL_SEG_NOISE_TOL if variant == "bf16"
                else None,
                timed=variant == "bf16" and name in SPATIAL_SEG_TIMED)


def _as_f32(model):
    """An f32 copy of a bf16 Seg model: the same parameters (f32 in every
    dtype), its main branch and encoder computing in f32, as a model built
    with ``dtype=torch.float32`` (the constructor's ``dtype`` sets those
    two attributes alone)."""
    f32 = copy.deepcopy(model)
    f32.dtype = f32.encoder.dtype = torch.float32
    return f32


def _to_host(model):
    """``model`` moved to the host, with the weights its conv modules keep
    packed or quantized on the card dropped: it then holds no card
    memory."""
    for m in model.modules():
        if hasattr(m, "_packed"):
            m._packed = m._packed_key = None
        if hasattr(m, "_q"):
            m._q = m._q_key = None
    return model.cpu()


def phase_spatial_seg(seed: int, seg_models: dict) -> dict:
    """Each Seg model of ``seg_models`` (bf16, on the host; SegUNetModel
    add / cat_conv / midcat, SegModelv2_6c / SegModelv3_6c with a
    3-channel conditioner) with one 96^3 patch's H split over
    SPATIAL_SHARDS shard threads (as phase_spatial), bf16, f32 and int8
    dynamic, each against the unsharded forward with its launches and
    routes per shard (_seg_spatial_spec), every int8 site exact on its
    gathered input; the shards of SPATIAL_SEG_TIMED replayed alone and
    profiled. Returns {path: launch counts of the forwards, both shards}:
    ``spatial_seg`` (bf16), ``spatial_seg_f32``, ``spatial_seg_int8``."""
    from ddpm3d_tpu_torch.ops import quant

    n = SPATIAL_SHARDS
    t0 = time.monotonic()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((1, 96, 96, 96, 1), device="cuda", generator=gen)
    lows = {c: torch.randn((1, 96, 96, 96, c), device="cuda", generator=gen)
            for c in (1, SEG_6C_COND)}
    t = torch.tensor([500], device="cuda")
    paths = {"bf16": "spatial_seg", "f32": "spatial_seg_f32",
             "int8_dynamic": "spatial_seg_int8"}
    counts = {p: collections.Counter() for p in paths.values()}
    for name, model in seg_models.items():
        card = model.cuda()
        low = lows[_seg_cond(name)]
        for variant in SPATIAL_SEG_VARIANTS:
            m = _as_f32(card) if variant == "f32" else card
            if variant == "int8_dynamic":
                m.set_int8(quant.Int8Config())
            try:
                counts[paths[variant]] += _spatial_forward(
                    m, variant, x, low, t, n,
                    _seg_spatial_spec(name, variant))["launches"]
            finally:
                m.set_int8(None)
            del m
        _to_host(card)
        torch.cuda.empty_cache()
    emit({"phase": "spatial_seg", "seconds": time.monotonic() - t0})
    return {path: dict({k: c.get(k, 0) for k in FORWARD_LAUNCHES["denoise"]},
                       routes={k: c.get(k, 0) for k in _routes(0, 0, 0)})
            for path, c in counts.items()}


def phase_cli(model, seed: int) -> dict:
    """The serving CLI under ``torchrun --standalone --nproc_per_node 1`` at
    the production flags, with ``--timesteps_file`` (a 3-step chain) and
    ``--use_dpm_solver``, on a synthetic (96, 200, 200) TIFF and a ``.pt``
    of the phase's weights: exit 0, finite (200, 200, 96) outputs, the
    uncertainty map of the 6 draws, and the kernel launches per forward
    that the CLI logs. Returns those launch counts."""
    from ddpm3d_tpu_torch.data import tiff_io

    repo = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        vol_path = os.path.join(tmp, "vol.tif")
        tiff_io.imwrite(vol_path, np.random.default_rng(seed).gamma(
            2.0, 0.5, (96, 200, 200)).astype(np.float32))
        ckpt = os.path.join(tmp, "model000000.pt")
        torch.save(model.state_dict(), ckpt)
        ts_path = os.path.join(tmp, "distilled_3steps_ts.npy")
        np.save(ts_path, np.asarray(CLI_CHAIN))
        out = os.path.join(tmp, "out")
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", "1", "-m", "ddpm3d_tpu_torch.scripts.test",
               *CLI_FLAGS, "--base_samples", vol_path, "--model_path", ckpt,
               "--timesteps_file", ts_path, "--save_dir", out,
               "--seed", str(seed)]
        t0 = time.monotonic()
        proc = subprocess.run(cmd, cwd=repo, capture_output=True, text=True,
                              timeout=CLI_TIMEOUT_S)
        wall = time.monotonic() - t0
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
        check(proc.returncode == 0, f"the torchrun CLI exited {proc.returncode}")
        result = np.load(os.path.join(out, "denoised_vol.npz"))["arr_0"]
        tif = tiff_io.imread(os.path.join(out, "denoised_vol.tif"))
        unc = tiff_io.imread(os.path.join(out, "uncertainty_vol.tif"))
        log = open(os.path.join(out, "log.txt")).read().splitlines()
        files = sorted(os.listdir(out))
    launched = json.loads(next(
        l for l in log if l.startswith("kernel launches on rank 0: "))
        .split(": ", 1)[1])
    sampling_s = float(next(l for l in log if l.startswith(
        "Full image denoising:")).rsplit("(sampling ", 1)[1].split("s wall")[0])
    forwards = 9 * 6 * len(CLI_CHAIN)  # patches x draws x steps, batch 1
    counts = dict(launched["launches"], routes=launched["routes"])
    per_forward = {k: v / forwards for k, v in launched["launches"].items()}
    routes_per_forward = {k: v / forwards
                          for k, v in launched["routes"].items()}
    emit({"phase": "cli", "launcher": "torchrun --standalone "
          "--nproc_per_node 1", "flags": " ".join(CLI_FLAGS),
          "timesteps": CLI_CHAIN, "patches": 9, "draws": 6,
          "result_shape": list(result.shape), "tif_shape": list(tif.shape),
          "uncertainty_shape": list(unc.shape), "files": files,
          "finite": bool(np.isfinite(result).all()),
          "wall_s": wall, "sampling_s": sampling_s,
          "ms_per_forward": sampling_s * 1e3 / forwards,
          "launches_per_forward": per_forward,
          "routes_per_forward": routes_per_forward,
          "log_tail": log[-4:]})
    check(result.shape == (200, 200, 96), f"CLI result shape {result.shape}")
    check(tif.shape == (96, 200, 200), f"CLI TIFF shape {tif.shape}")
    check(unc.shape == (96, 200, 200), f"uncertainty map shape {unc.shape}")
    check(bool(np.isfinite(result).all()) and bool(np.isfinite(tif).all()),
          "CLI outputs are finite")
    check(float(np.abs(result).max()) > 0, "CLI result is non-trivial")
    check(any("sampler: DPM-Solver++(2M), 3-step explicit chain" in l
              for l in log), "the CLI ran DPM-Solver on the explicit chain")
    check(per_forward == FORWARD_LAUNCHES["cli"],
          f"cli launches per forward {per_forward}")
    check(routes_per_forward == FORWARD_ROUTES["cli"],
          f"cli conv routes per forward {routes_per_forward}")
    return counts


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
    # the Cin = 1 and Cin = 3 to 7 instances first, so that the Cin = 2
    # one is conv3d_narrow
    "conv3d_cin1": ("conv3d_narrow_kernel<1>", "conv3d_narrow_kernelILi1E"),
    "conv3d_smallcin": tuple(f"conv3d_narrow_kernel<{c}>" for c in range(3, 8))
    + tuple(f"conv3d_narrow_kernelILi{c}E" for c in range(3, 8)),
    "conv3d_narrow": ("conv3d_narrow_kernel",),
    "conv3d_gather": ("conv3d_gather_kernel",),
    "conv3d_head": ("conv3d_head_kernel",),
    "conv3d_f32_narrow": ("conv3d_f32_narrow_kernel",),
    "conv3d_f32": ("conv3d_f32_kernel",),
    "gn_stats": ("gn_stats_kernel",),
    "gn_apply": ("gn_apply_kernel",),
    "gn_fold": ("gn_fold_kernel",),
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
                  families=FORWARD_FAMILIES, cond_channels: int = 1) -> None:
    """Device time of one bf16 96^3 forward at batch 1, by kernel family
    (torch.profiler), against the forward's CUDA-event time; and the host's
    time to issue the forward (the call returns before the card is done:
    near the forward's time, the host holds the card back). The
    conditioner is x itself, or ``cond_channels`` channels of its own."""
    x = torch.randn((1, 96, 96, 96, 1), device="cuda")
    low = x if cond_channels == 1 else torch.randn(
        (1, 96, 96, 96, cond_channels), device="cuda")
    t = torch.tensor([500], device="cuda")
    with torch.no_grad():
        prof = time_and_profile(lambda: model(x, t, low_res=low), families,
                                reps=3, warmup=1, host_reps=3, top=6)
    emit({"phase": phase, "forward_ms": prof.pop("ms"), "batch": 1, **prof})


def time_and_profile(fn, families, reps: int, warmup: int, host_reps: int,
                     top: int) -> dict:
    """``fn``'s CUDA-event ms (median of ``reps``), the host's time to
    issue it (median of ``host_reps``; the call returns before the card is
    done: near the event ms, the host holds the card back) and its device
    ms (torch.profiler) by kernel family, the ``top`` other kernels beside."""
    from torch.profiler import ProfilerActivity, profile

    ms = time_ms(fn, reps=reps, warmup=warmup)
    host = []
    for _ in range(host_reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_family, other = device_breakdown(prof, families)
    device_ms = sum(by_family.values()) + sum(other.values())
    return {"ms": ms, "host_issue_ms": statistics.median(host),
            "device_ms": device_ms, "kernel_ms": by_family,
            "other_ms": sum(other.values()),
            "top_other_ms": dict(sorted(other.items(),
                                        key=lambda kv: -kv[1])[:top]),
            "idle_share": max(0.0, 1 - device_ms / ms)}


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
                # the same dx on the general kernel of its dtype
                wf = cv.flip_weight(w)
                line[_general_key(dt)] = time_ms(
                    lambda: _general_conv(dy, wf, None))
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


def _write_pair(tmp: str, seed: int) -> str:
    """A synthetic (2, 96, 200, 200) low/high pair (9 training patches of
    96^3) in ``tmp/data``; returns that directory."""
    from ddpm3d_tpu_torch.data import tiff_io

    data_dir = os.path.join(tmp, "data")
    os.makedirs(data_dir)
    rng = np.random.default_rng(seed)
    high = rng.gamma(2.0, 0.5, (96, 200, 200)).astype(np.float32)
    low = high + rng.normal(0.0, 0.3, high.shape).astype(np.float32)
    tiff_io.imwrite(os.path.join(data_dir, "pair.tif"), np.stack([low, high]))
    return data_dir


def phase_train(seed: int) -> dict:
    """The training CLI at the production flags on a synthetic volume pair:
    6 steps at batch 1, saved at steps 0 and 5 (``DIFFUSION_TRAINING_TEST``
    stops after the first save past step 0). Steps and saves are timed by
    wrapping ``TrainLoop.run_step`` / ``TrainLoop.save``."""
    from ddpm3d_tpu_torch import ops
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
        data_dir, run_dir = _write_pair(tmp, seed), os.path.join(tmp, "run")
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
                       "conv3d_s8": 0, "gn_stats": 71, "gn_apply": 71,
                       "gn_fold": 0},
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
# replaces, the 1x1x1 ones beside torch._int_mm: (D, H, W, Cin, N, taps,
# upsample); the up site is added from the path (its widest)
S8_TIMED = [
    (96, 96, 96, 128, 128, 27, False),   # level-0 ResBlock conv
    (96, 96, 96, 256, 128, 27, False),   # level-0 decoder in_conv
    (96, 96, 96, 256, 128, 1, False),    # its 1x1 skip (beside _int_mm)
    (96, 48, 48, 256, 128, 27, False),   # level-1 decoder in_conv
    (96, 48, 48, 256, 128, 1, False),    # its 1x1 skip
    (96, 6, 6, 1024, 512, 27, False),    # level-4 decoder in_conv
    (96, 6, 6, 1024, 512, 1, False),     # its 1x1 skip (weights streamed)
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


def _c1_plan(case, B: int, dt) -> dict:
    """csrc/conv1x1_s8.cu's plan of a 1x1 site (ops/conv3d_s8.py:
    conv1x1_plan), the fields a line reports."""
    from ddpm3d_tpu_torch.ops import conv3d_s8 as s8

    D, H, W, cin, n = case[:5]
    p = s8.conv1x1_plan(B, D * H * W, cin, n, dt,
                        torch.cuda.get_device_properties(0)
                        .multi_processor_count)
    return {"grid": p.grid, "row_tiles": p.row_tiles,
            "col_tiles": p.col_tiles, "resident": p.resident,
            "stages": p.stages, "smem_bytes": p.smem_bytes}


def phase_s8_kernels(gen: torch.Generator, shapes, libs) -> dict:
    """The int8 conv against its plain version at every distinct quantized
    shape of the int8 path, three variants each (batch 1 dynamic with bias
    and bf16 out, as the path runs it; batch 2 dynamic with per-sample
    scales, no bias, f32 out; batch 1 static with bias, f32 out): equal
    bit for bit, the 3x3x3 and phase shapes on ``csrc/conv3d_s8.cu``, the
    1x1x1 ones on ``csrc/conv1x1_s8.cu`` (each call's route counted). The
    S8_TIMED sites and the widest up site are timed, the latter also on the
    27-tap study build ``libs["s8_all_taps"]``; every 1x1 shape's first
    variant also by device time (``conv1x1_s8_shapes``: ms, bound,
    torch._int_mm and, with ``--parent-s8``, the previous instance; the
    host's issue time exceeds the small sites' kernels). Returns the
    summaries of the two kernels, {"conv3d_s8": ..., "conv1x1_s8": ...}."""
    from ddpm3d_tpu_torch import ops
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
    summary = {"conv3d_s8": None, "conv1x1_s8": None}
    checked = {k: 0 for k in summary}
    worst = {k: 0.0 for k in summary}
    n_shapes = {k: 0 for k in summary}
    timed_1x1, shapes_1x1 = [], []
    for case in timed + [c for c in shapes if c not in timed]:
        D, H, W, cin, n, taps, up = case
        kernel = "conv1x1_s8" if taps == 1 else "conv3d_s8"
        route = "conv3d_s8." + ("conv1x1" if taps == 1 else "sm90")
        n_shapes[kernel] += 1
        for vi, (B, static, with_bias, dt) in enumerate(variants):
            xq, wq, s_x, s_w, bias = _s8_inputs(gen, case, B, static)
            bias = bias if with_bias else None
            wp = s8.pack_weight_s8(wq)
            routed = ops.route_counts()[route]
            got = s8.conv3d_s8_kernel(xq, wp, s_x, s_w, bias, dt, up)
            check(ops.route_counts()[route] == routed + 1,
                  f"the int8 conv {case} launched {route}")
            ref = s8.conv3d_s8_plain(xq, wq, s_x, s_w, bias, dt, up)
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs().max().item()
            line = dict(kernel=kernel, shape=[B, D, H, W, cin], n=n,
                        taps=taps, upsample=up, static=static,
                        bias=with_bias, dtype=str(dt).split(".")[-1],
                        max_abs_err=err, equal=bool(torch.equal(got, ref)))
            if taps == 1:
                line["plan"] = _c1_plan(case, B, dt)
            else:
                line["tile"] = list(s8.s8_tile(B, D, H, W, n, dt))
            check(bool(torch.isfinite(got.float()).all()),
                  f"{kernel} finite")
            if vi == 0 and case in timed:
                line.update(_time_s8_site(case, xq, wq, wp, s_x, s_w, bias,
                                          dt, libs, ref))
                if summary[kernel] is None:
                    summary[kernel] = line
                if taps == 1:
                    timed_1x1.append({k: line[k] for k in (
                        "shape", "n", "kernel_ms", "plain_ms", "bound_ms",
                        "library_ms", "parent_ms", "plan")})
            if vi == 0 and taps == 1:
                line.update(_time_1x1_alone(case, xq, wq, wp, s_x, s_w,
                                            bias, dt, libs))
                shapes_1x1.append({k: line.get(k) for k in (
                    "shape", "n", "device_ms", "bound_ms",
                    "library_device_ms", "parent_device_ms")})
            emit(line)
            # the int8 kernels equal their plain version bit for bit: the
            # same int32 sums (exact in any order) and the same f32
            # multiply, add and rounding, none contracted into an FMA
            check(line["equal"], f"{kernel} {case} variant {vi} differs "
                  f"from its plain version by {err}")
            worst[kernel] = max(worst[kernel], err)
            checked[kernel] += 1
            del xq, wq, got, ref
    emit({"phase": "s8_kernels", "shapes": len(shapes),
          "checks": sum(checked.values()),
          "checks_by_kernel": checked,
          "worst_max_abs_err": max(worst.values())})
    emit({"phase": "conv1x1_s8_shapes", "shapes": shapes_1x1,
          "no_slower_than_parent": None if "s8_parent" not in libs
          else all(r["device_ms"] <= r["parent_device_ms"]
                   for r in shapes_1x1)})
    for k in summary:
        check(summary[k] is not None, f"{k} timed at a site")
        summary[k] = dict(summary[k], shapes_checked=n_shapes[k],
                          max_abs_err=worst[k])
    summary["conv1x1_s8"]["timed_sites"] = timed_1x1
    summary["conv1x1_s8"]["shapes_ms"] = shapes_1x1
    return summary


def _parent_1x1_tile(B: int, D: int, H: int, W: int, n: int, dt) -> tuple:
    """The tile on which the previous K5 ran a 1x1x1 site (its no-halo
    instance, before csrc/conv1x1_s8.cu): the sm90 tile rules with no
    halo, 128-row tiles for f32 output."""
    from ddpm3d_tpu_torch.ops import conv3d as cv

    if dt == torch.float32:
        return cv.pick_tile_sm90(D, H, W, cv.SM90_MAX_ROWS // 2, 0)
    return cv.sm90_tile(B, D, H, W, n,
                        torch.cuda.get_device_properties(0)
                        .multi_processor_count, 0)


def _1x1_bound(case, dt) -> tuple:
    """(bound ms, "bytes" or "operations") of one batch-1 1x1 site: x,
    the weight, y, the scales and the bias moved once; 2 Cin N int8
    operations a row."""
    D, H, W, cin, n = case[:5]
    vox = D * H * W
    nbytes = (vox * cin + n * cin + vox * n * (2 if dt == torch.bfloat16
                                               else 4) + (2 * n + 1) * 4)
    t_ops = 2.0 * vox * cin * n / H100_INT8_OPS * 1e3
    t_bytes = nbytes / H100_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def _time_1x1_alone(case, xq, wq, wp, s_x, s_w, bias, dt, libs) -> dict:
    """A 1x1 site's device ms (``device_ms``: at the small sites the host's
    issue time exceeds the kernel's) beside its bound, ``torch._int_mm``
    and, when its build is given, the previous K5's no-halo instance
    (bit-equal)."""
    from ddpm3d_tpu_torch.ops import conv3d_s8 as s8

    D, H, W, cin, n = case[:5]
    out = {"device_ms": device_ms(lambda: s8.conv3d_s8_kernel(
        xq, wp, s_x, s_w, bias, dt, False)), "parent_device_ms": None}
    out["bound_ms"], out["bound_by"] = _1x1_bound(case, dt)
    a, b = xq.reshape(-1, cin), wq.reshape(n, cin).t()
    try:
        out["library_device_ms"] = device_ms(lambda: torch._int_mm(a, b))
    except RuntimeError as e:  # a yardstick only: report, go on
        out["library_device_ms"] = None
        out["library_error"] = str(e)[:200]
    if "s8_parent" in libs:
        tile = _parent_1x1_tile(*xq.shape[:4], n, dt)
        run = lambda: _s8_variant(libs["s8_parent"], xq, wp, s_x,  # noqa
                                  s_w, bias, dt, False, tile)
        y = run()
        ref = s8.conv3d_s8_kernel(xq, wp, s_x, s_w, bias, dt, False)
        torch.cuda.synchronize()
        check(torch.equal(y, ref), f"the previous K5 at {case} equals "
              "csrc/conv1x1_s8.cu")
        out["parent_device_ms"] = device_ms(run)
    return out


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
    glue on a bf16 activation of the site's shape, and the bound; a 1x1
    site beside ``torch._int_mm`` (its s8 GEMM alone, int32 out) instead of
    K3; the previous K5 on the same tiles (``parent_ms``; at a 1x1 site its
    no-halo instance on the tile it ran) when its build is given; a phase
    site also on the 27-tap build (``all_taps_ms``), both equal. A 3x3x3
    site's kernel and previous K5 also by device time (``device_ms``,
    ``parent_device_ms``; a 1x1 site's come from _time_1x1_alone)."""
    from ddpm3d_tpu_torch.models.nn import upsample_nearest
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
           "library_ms": None, "parent_ms": None}
    for key, name, tile in (
            ("parent", "s8_parent", s8.s8_tile(1, D, H, W, n, dt)
             if taps == 27 else _parent_1x1_tile(1, D, H, W, n, dt)),
            ("all_taps", "s8_all_taps", s8.s8_tile(1, D, H, W, n, dt))):
        if name not in libs or (key == "all_taps" and not up):
            continue
        run = lambda: _s8_variant(libs[name], xq, wp, s_x, s_w,  # noqa: E731
                                  bias, dt, up, tile)
        y = run()
        torch.cuda.synchronize()
        out[key + "_equal"] = bool(torch.equal(y, ref))
        check(out[key + "_equal"], f"{name} at {case} equals the plain K5")
        out[key + "_ms"] = time_ms(run)
        if key == "parent" and taps == 27:
            out["parent_device_ms"] = device_ms(run)
    if taps == 27:
        out["device_ms"] = device_ms(lambda: s8.conv3d_s8_kernel(
            xq, wp, s_x, s_w, bias, dt, up))
        xk = upsample_nearest(xb) if up else xb
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
    with torch.no_grad():
        ref = model(x, t, low_res=low)
    ops.reset_launch_counts()
    out, n_sites, unequal = _int8_sites_equal(card, model, x, low, t)
    n_s8 = ops.launch_counts()["conv3d_s8"]
    err, rel = rel_err(out, ref)
    mean_rel = ((out - ref).abs().mean() / ref.abs().mean()).item()
    emit({"phase": "model_int8", "shape": list(x.shape), "channels": 128,
          "dtype": "float32", "sites_checked": n_sites,
          "sites_unequal": unequal, "max_abs_err": err, "rel_err": rel,
          "mean_rel_err": mean_rel, "mean_tol": INT8_MODEL_MEAN_TOL,
          "conv3d_s8_launches": n_s8})
    check(n_s8 == FORWARD_LAUNCHES["denoise_int8"]["conv3d_s8"],
          f"int8 model launched conv3d_s8 {n_s8} times")
    check(n_sites == n_s8 and not unequal,
          f"int8 sites unequal to the plain int8 conv: {unequal}")
    check(bool(torch.isfinite(out).all()), "int8 model output finite")
    check(mean_rel <= INT8_MODEL_MEAN_TOL,
          f"int8 model card vs CPU mean rel err {mean_rel}")


def phase_denoise_int8_static(model, seed: int, fname: str = "",
                              schedule=None, n_bins: int = 25,
                              phase: str = "denoise_int8_static"):
    """The int8 model on per-time-bin static scales (``fname``, by default
    the committed INT8_SCALES_PROD.json, 25 bins over its 25-step
    respacing; ``schedule`` the (sched, cfg) of the file's chain) through
    ``denoise_volume``: ``n_bins`` distinct bins, finite output, exact
    launches. Random weights: no quality figure."""
    from ddpm3d_tpu_torch.models.factory import create_gaussian_diffusion
    from ddpm3d_tpu_torch.ops import quant

    fname = fname or os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                  "INT8_SCALES_PROD.json")
    cfg8 = quant.Int8Config(scales=fname)
    check(cfg8.has_time_bins, f"{os.path.basename(fname)} has time bins")
    model.set_int8(cfg8)
    sched, cfg = schedule or create_gaussian_diffusion(
        steps=1000, learn_sigma=True, noise_schedule="linear",
        timestep_respacing="25")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        counts, volume, _ = phase_denoise(model, sched, cfg, seed,
                                          phase=phase)
    emit({"phase": phase + "_bins",
          "bins_used": sorted(cfg8.bins_used),
          "distinct_bins": len(cfg8.bins_used),
          "warnings": sorted({str(w.message)[:80] for w in caught}),
          "volume_abs_mean": float(np.abs(volume).mean())})
    check(len(cfg8.bins_used) == n_bins, f"bins used {sorted(cfg8.bins_used)}")
    check(not caught, "every site has a scale in the file")
    return counts


# quantize glue kernels (the JAX package's XLA-fused glue): the per-sample
# min/max, the f32 division, round and clamp; the cast to int8 is a plain
# copy kernel and stays in "other"
INT8_FAMILIES = dict(
    FORWARD_FAMILIES,
    conv3d_s8=("conv3d_s8_kernel",),
    conv1x1_s8=("conv1x1_s8_kernel",),
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


TRAIN_DDP_STEPS = 3
# the distill phase: 8 -> 4 -> 2 steps, 3 optimizer steps a phase
DISTILL_START, DISTILL_TARGET, DISTILL_STEPS = 8, 2, 3
# a distill step: two teacher forwards and the student's forward (each the
# train phase's 72/71/71) and the student's backward (71 dx)
DISTILL_STEP_LAUNCHES = {"conv3d": 216, "conv3d_dx": 71, "conv3d_fused": 0,
                         "conv3d_s8": 0, "gn_stats": 213, "gn_apply": 213,
                         "gn_fold": 0}
DISTILL_STEP_ROUTES = _routes(210, 3, 3, dx_sm90=70, dx_f32_narrow=1)
DISTILL_TIMEOUT_S = 600
FORWARD_LAUNCHES["distill_serve"] = FORWARD_LAUNCHES["denoise"]
FORWARD_ROUTES["distill_serve"] = FORWARD_ROUTES["denoise"]


def _train_loop(seed: int):
    """A TrainLoop at the production flags and the training CLI's
    defaults, its model initialised from ``seed``, on the card."""
    from ddpm3d_tpu_torch.models.factory import sr_create_model_and_diffusion
    from ddpm3d_tpu_torch.models.nn import init_params
    from ddpm3d_tpu_torch.scripts import train as train_cli
    from ddpm3d_tpu_torch.training import TrainLoop
    from ddpm3d_tpu_torch.utils.config import (
        args_to_dict, sr_model_and_diffusion_defaults)

    args = train_cli.create_argparser().parse_args(
        TRAIN_FLAGS + ["--data_dir", "unused"])
    model, sched, cfg = sr_create_model_and_diffusion(
        **args_to_dict(args, sr_model_and_diffusion_defaults().keys()))
    init_params(model, seed=seed)
    return TrainLoop(
        model=model, sched=sched, cfg=cfg, data=iter(()),
        batch_size=args.batch_size, microbatch=args.microbatch, lr=args.lr,
        ema_rate=args.ema_rate, log_interval=args.log_interval,
        save_interval=args.save_interval, weight_decay=args.weight_decay,
        lr_anneal_steps=args.lr_anneal_steps, seed=seed, device="cuda")


def _timed_steps(loop, batches) -> list:
    ms = []
    for x, low in batches:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loop.run_step(x, {"low_res": low})
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
    return ms


def phase_train_ddp(seed: int) -> dict:
    """``TrainLoop`` under an in-process NCCL group of one rank (through a
    FileStore), so DistributedDataParallel wraps the model, against the
    plain ``TrainLoop``: 3 steps at the production flags (batch 1, bf16,
    96^3) on the same batches and seed; params and EMA must be bit-equal
    (DDP at world size 1 divides by 1), launches per step exactly the train
    phase's, by route too. Then one more DDP step under torch.profiler for
    the gradient all-reduce's device time (NCCL kernels) and its host ops.
    Returns the DDP loop's launch counts (with routes)."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from ddpm3d_tpu_torch import ops
    from ddpm3d_tpu_torch.utils import logger

    rng = np.random.default_rng(seed)
    batches = [(np.clip(rng.normal(0.0, 0.5, (1, 96, 96, 96, 1)), -1, 1)
                .astype(np.float32),
                rng.normal(0.0, 0.5, (1, 96, 96, 96, 1)).astype(np.float32))
               for _ in range(TRAIN_DDP_STEPS)]
    with tempfile.TemporaryDirectory() as tmp:
        logger.configure(os.path.join(tmp, "log"), format_strs=[])
        loop = _train_loop(seed)
        plain_ms = _timed_steps(loop, batches)
        plain = [p.detach().cpu() for p in loop.model.parameters()]
        plain_ema = [e.cpu() for e in loop.state.ema_params[0]]
        del loop
        torch.cuda.empty_cache()
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
            rank=0, world_size=1)
        try:
            loop = _train_loop(seed)
            wrapper = type(loop.state.model).__name__
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            ddp_ms = _timed_steps(loop, batches)
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            counts["routes"] = ops.route_counts()
            params = [p.detach().cpu() for p in loop.model.parameters()]
            ema = [e.cpu() for e in loop.state.ema_params[0]]
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                loop.run_step(batches[0][0], {"low_res": batches[0][1]})
                torch.cuda.synchronize()
            by_family, other = device_breakdown(
                prof, {"all_reduce": ("nccl", "Nccl", "NCCL")})
            # the host side of DDP's bucket all-reduces (c10d's ops), from
            # one more step
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                loop.run_step(batches[0][0], {"low_res": batches[0][1]})
                torch.cuda.synchronize()
            host_ar = [(ev.key, ev.count, ev.cpu_time_total / 1e3)
                       for ev in prof.key_averages()
                       if "allreduce" in ev.key.replace("_", "").lower()]
            backend = dist.get_backend()
            del loop  # the DDP wrapper before its process group
        finally:
            dist.destroy_process_group()
        torch.cuda.empty_cache()
    params_equal = all(torch.equal(a, b) for a, b in zip(params, plain))
    ema_equal = all(torch.equal(a, b) for a, b in zip(ema, plain_ema))
    steps = len(ddp_ms)
    per_step = {k: v / steps for k, v in counts.items() if k != "routes"}
    routes_per_step = {k: v / steps for k, v in counts["routes"].items()}
    emit({"phase": "train_ddp", "backend": backend, "world_size": 1,
          "wrapper": wrapper, "flags": " ".join(TRAIN_FLAGS), "batch": 1,
          "steps": steps, "plain_step_ms": plain_ms, "ddp_step_ms": ddp_ms,
          "plain_ms_per_step": statistics.median(plain_ms[1:]),
          "ddp_ms_per_step": statistics.median(ddp_ms[1:]),
          "params_bit_equal": params_equal, "ema_bit_equal": ema_equal,
          "all_reduce_device_ms": by_family["all_reduce"],
          "all_reduce_host_ops": host_ar,
          "profiled_step_device_ms": sum(by_family.values())
          + sum(other.values()),
          "grad_bytes": sum(p.numel() for p in params) * 4,
          "launches_per_step": per_step, "routes_per_step": routes_per_step})
    check(wrapper == "DistributedDataParallel", f"the loop runs {wrapper}")
    check(params_equal and ema_equal,
          "DDP at world size 1: params and EMA bit-equal to the plain loop")
    check(per_step == {"conv3d": 72, "conv3d_dx": 71, "conv3d_fused": 0,
                       "conv3d_s8": 0, "gn_stats": 71, "gn_apply": 71,
                       "gn_fold": 0},
          f"train_ddp launches per step {per_step}")
    check(routes_per_step == STEP_ROUTES,
          f"train_ddp conv routes per step {routes_per_step}")
    return counts


def _chain(n: int) -> list:
    """``n`` evenly spaced steps of the 1000-step chain (``--start_respacing
    n``: one section, first and last step kept)."""
    return sorted({round(i * 999 / (n - 1)) for i in range(n)})


def _ladder(start: int, target: int) -> list:
    """The kept timesteps of each halving from ``_chain(start)`` down to at
    most ``target`` steps: the odd positions of the previous chain."""
    ts = _chain(start)
    out = []
    while len(ts) > target:
        ts = ts[1::2]
        out.append(ts)
    return out


def phase_distill(seed: int) -> dict:
    """The distill CLI under ``torchrun --standalone --nproc_per_node 1`` at
    the production model flags, on the train phase's synthetic pair and a
    ``.pt`` of this run's weights, 8 -> 4 -> 2 with 3 optimizer steps a
    phase: exit 0, a ``.pt`` and a ``_ts.npy`` per phase (the halving
    ladder, computed here), finite losses, grad_norm > 0, students that
    moved, and exactly DISTILL_STEP_LAUNCHES per step (the counts the CLI
    logs over its 6 steps). Then, in this process: 4 distill steps on the
    same model, timed (the median after the first) by part, with the peak
    memory; and the 2-step ``.pt`` loaded strict=True into a serving model
    and run by ``denoise_volume`` along its explicit 2-step DDIM chain on the
    denoise phase's volume (``phase_denoise``: finite, 72/71/71 per
    forward). Returns the CLI's launch counts (with routes)."""
    import copy

    from ddpm3d_tpu_torch.diffusion import (
        get_named_beta_schedule, make_spaced_schedule, process)
    from ddpm3d_tpu_torch.training import distill as td
    from ddpm3d_tpu_torch.training import train_loop as tl

    ladder = _ladder(DISTILL_START, DISTILL_TARGET)
    repo = os.path.dirname(os.path.abspath(__file__))
    teacher, sched, cfg = _model(use_fp16=True, seed=seed)
    with tempfile.TemporaryDirectory() as tmp:
        data_dir = _write_pair(tmp, seed)
        ckpt = os.path.join(tmp, "model000000.pt")
        torch.save(teacher.state_dict(), ckpt)
        out = os.path.join(tmp, "distill")
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", "1", "-m", "ddpm3d_tpu_torch.scripts.distill",
               *TRAIN_FLAGS, "--data_dir", data_dir, "--model_path", ckpt,
               "--result_folder", out, "--start_respacing",
               str(DISTILL_START), "--target_steps", str(DISTILL_TARGET),
               "--steps_per_phase", str(DISTILL_STEPS), "--seed", str(seed)]
        t0 = time.monotonic()
        proc = subprocess.run(cmd, cwd=repo, capture_output=True, text=True,
                              timeout=DISTILL_TIMEOUT_S)
        wall = time.monotonic() - t0
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
        check(proc.returncode == 0,
              f"the torchrun distill CLI exited {proc.returncode}")
        files = sorted(os.listdir(out))
        log = open(os.path.join(out, "log.txt")).read().splitlines()
        rows = _read_progress(os.path.join(out, "progress.csv"))
        kept = {len(ts): np.load(os.path.join(out, f"distilled_{len(ts)}"
                                              "steps_ts.npy")).tolist()
                for ts in ladder}
        students = {n: torch.load(os.path.join(out, f"distilled_{n}steps.pt"),
                                  weights_only=True) for n in kept}
    launched = json.loads(next(
        l for l in log if l.startswith("kernel launches on rank 0: "))
        .split(": ", 1)[1])
    steps = DISTILL_STEPS * len(ladder)
    per_step = {k: v / steps for k, v in launched["launches"].items()}
    routes_per_step = {k: v / steps for k, v in launched["routes"].items()}
    initial = teacher.state_dict()
    moved = {n: sum(not torch.equal(v, initial[k]) for k, v in sd.items())
             for n, sd in students.items()}
    line = {"phase": "distill", "launcher": "torchrun --standalone "
            "--nproc_per_node 1", "flags": " ".join(TRAIN_FLAGS),
            "chain": [DISTILL_START] + [len(ts) for ts in ladder],
            "steps_per_phase": DISTILL_STEPS, "files": files,
            "kept_timesteps": kept, "wall_s": wall,
            "loss": [r.get("distill/loss") for r in rows],
            "mse": [r.get("distill/mse") for r in rows],
            "grad_norm": [r.get("distill/grad_norm") for r in rows],
            "skipped": [r.get("distill/skipped_nonfinite") for r in rows],
            "tensors_moved": moved, "launches_per_step": per_step,
            "routes_per_step": routes_per_step, "log_tail": log[-3:]}
    emit(line)
    check(kept == {len(ts): ts for ts in ladder},
          f"the kept timesteps are the halving ladder {ladder}")
    check(len(rows) == 2 * len(ladder), f"{len(rows)} logged distill rows")
    for key in ("loss", "mse", "grad_norm"):
        check(all(v is not None and np.isfinite(v) for v in line[key]),
              f"distill {key} finite")
    check(all(v > 0 for v in line["grad_norm"]), "distill grad_norm > 0")
    check(all(v == 0 for v in line["skipped"]), "no distill step skipped")
    check(all(m > 0 for m in moved.values()), "the students moved")
    check(per_step == DISTILL_STEP_LAUNCHES,
          f"distill launches per step {per_step}")
    check(routes_per_step == DISTILL_STEP_ROUTES,
          f"distill conv routes per step {routes_per_step}")
    counts = dict(launched["launches"], routes=launched["routes"])

    # the step in this process: distill_step timed whole (the median after
    # the first), then by part: the teacher's two DDIM steps, the
    # student's forward and loss, its backward, the update
    betas = get_named_beta_schedule("linear", 1000)
    t_sched, s_sched, _ = td.distill_schedules(betas, _chain(DISTILL_START))
    t_sched, s_sched = t_sched.to("cuda"), s_sched.to("cuda")
    teacher.cuda().eval().requires_grad_(False)
    student = copy.deepcopy(teacher).requires_grad_(True)
    params = list(student.parameters())
    state = tl.TrainState(step=0, model=student,
                          optimizer=tl.make_optimizer(params, 1e-4, 0.0),
                          ema_params=[])
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((1, 96, 96, 96, 1), device="cuda",
                    generator=gen).clamp(-1, 1)
    c = {"low_res": torch.randn(x.shape, device="cuda", generator=gen)}
    draw = lambda k: (torch.tensor([k % s_sched.num_timesteps], device="cuda"),
                      torch.randn(x.shape, device="cuda", generator=gen))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    for k in range(4):
        i, noise = draw(k)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        metrics = td.distill_step(state, teacher, t_sched, s_sched, cfg, x,
                                  c, i, noise, lr=1e-4)
        ev[1].record()
        ev[1].synchronize()
        step_ms.append(ev[0].elapsed_time(ev[1]))
    peak = torch.cuda.max_memory_allocated()
    parts = collections.defaultdict(list)
    for k in range(3):
        i, noise = draw(k)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        student.zero_grad(set_to_none=True)
        ev[0].record()
        x_t = process.q_sample(s_sched, x, i, noise)
        x0 = td.distill_targets(teacher, t_sched, s_sched, cfg, x_t, i,
                                model_kwargs=c)
        target = td.target_to_model_space(s_sched, cfg.mean_type, x_t, i, x0)
        ev[1].record()
        out = student(x_t, process.model_timesteps(s_sched, cfg, i), **c)
        loss = torch.mean((target.float() - out[..., :1].float()) ** 2)
        ev[2].record()
        loss.backward()
        ev[3].record()
        tl.apply_update(state, i, {"loss": loss.detach()[None]},
                        torch.ones(1, device="cuda"), 1e-4, 0, ())
        ev[4].record()
        ev[4].synchronize()
        for name, a, b in (("teacher_targets", 0, 1),
                           ("student_forward_loss", 1, 2),
                           ("backward", 2, 3), ("update", 3, 4)):
            parts[name].append(ev[a].elapsed_time(ev[b]))
    emit({"phase": "distill_step", "batch": 1, "step_ms": step_ms,
          "ms_per_step": statistics.median(step_ms[1:]),
          "parts_ms": {k: statistics.median(v) for k, v in parts.items()},
          "loss": float(metrics["loss"]),
          "max_memory_allocated_gb": peak / 2 ** 30})
    check(bool(np.isfinite(float(metrics["loss"]))), "distill_step loss finite")
    del state, student, params, out, loss
    torch.cuda.empty_cache()

    # the distilled 2-step student serves its explicit chain
    teacher.load_state_dict(students[DISTILL_TARGET], strict=True)
    chain = make_spaced_schedule(betas, kept[DISTILL_TARGET])
    phase_denoise(teacher, chain, cfg, seed, phase="distill_serve",
                  use_ddim=True)
    del teacher
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------- attention
# the middle attention block on the card against the CPU, bf16: the logits
# and softmax are f32 on both; each bf16 rounding of the products may
# differ by one ulp (2^-8), as TOL[bf16] allows the kernels
ATTENTION_FAMILIES = dict(
    FORWARD_FAMILIES,
    softmax=("softmax", "SoftMax"),
    matmul=("gemm", "Gemm", "xmma", "nvjet", "cutlass"),
)


def _attention_model(use_fp16: bool, seed: int, fused: bool = False):
    """test_DDPM_3d_tpu.sh's model with ``middle_attention=True``, the
    reference's SuperResModel with attention: 128 channels, (1,1,2,3,4), 2
    res blocks, 64-channel heads (8 over 512 channels in the middle),
    learned sigma, scale-shift norm, resblock up/down. Random weights from
    ``seed``, heads included."""
    from ddpm3d_tpu_torch.models import SuperResModel
    from ddpm3d_tpu_torch.models.nn import init_params

    model = SuperResModel(
        in_channels=1, model_channels=128, out_channels=2, num_res_blocks=2,
        channel_mult=(1, 1, 2, 3, 4), num_head_channels=64,
        use_scale_shift_norm=True, resblock_updown=True,
        middle_attention=True,
        dtype=torch.bfloat16 if use_fp16 else torch.float32, fused=fused)
    init_params(model, seed=seed, zero_heads=False)
    return model.eval()


def _one_forward_counts(model, x, t, low=None) -> dict:
    """The launch counts (and routes) of one forward after a warm-up (the
    conditioner ``low``, default x)."""
    from ddpm3d_tpu_torch import ops

    low = x if low is None else low
    with torch.no_grad():
        model(x, t, low_res=low)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        model(x, t, low_res=low)
        torch.cuda.synchronize()
    return dict(ops.launch_counts(), routes=ops.route_counts())


def phase_attention(seed: int):
    """The attention model at 96^3, bf16: launches of one unfused forward
    (72/72/72) and one fused forward (18/54/33/18); forward ms and peak
    memory at batch 1 and 2; the middle AttentionBlock alone (both qkv
    orders; T = 96 x 6 x 6 = 3456 tokens, C = 512, 8 heads) timed, beside
    its bound and ``F.scaled_dot_product_attention`` on the same q, k, v
    (timed only: it cannot keep f32 logits), and held against the CPU on
    the same weights and input; the full-width f32 model on the card
    against the CPU; a profile of one batch-1 forward. Returns (the
    model, one unfused forward's counts)."""
    from ddpm3d_tpu_torch.models.unet import qkv_attention

    model = _attention_model(True, seed).cuda()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x1 = torch.randn((1, 96, 96, 96, 1), device="cuda", generator=gen)
    t1 = torch.tensor([500], device="cuda")
    counts = _one_forward_counts(model, x1, t1)
    routes = counts["routes"]
    launched = {k: v for k, v in counts.items() if k != "routes"}
    check(launched == FORWARD_LAUNCHES["attention"],
          f"attention launches per forward {launched}")
    check(routes == FORWARD_ROUTES["attention"],
          f"attention conv routes per forward {routes}")

    by_batch = {}
    with torch.no_grad():
        for B in (1, 2):
            x = torch.randn((B, 96, 96, 96, 1), device="cuda", generator=gen)
            t = torch.full((B,), 500, device="cuda")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ms = time_ms(lambda: model(x, t, low_res=x), reps=3, warmup=1)
            by_batch[B] = {"forward_ms": ms, "max_memory_allocated_gb":
                           torch.cuda.max_memory_allocated() / 2 ** 30}

    fused = _attention_model(True, seed, fused=True)
    fused.load_state_dict(model.state_dict(), strict=True)
    fused.cuda()
    fused_counts = _one_forward_counts(fused, x1, t1)
    fused_launched = {k: v for k, v in fused_counts.items() if k != "routes"}
    with torch.no_grad():
        fused_ms = time_ms(lambda: fused(x1, t1, low_res=x1), reps=3,
                           warmup=1)
        out_f = fused(x1, t1, low_res=x1).float()
        out_u = model(x1, t1, low_res=x1).float()
    fused_rel = rel_err(out_f, out_u)[1]
    del fused
    check(fused_launched == FORWARD_LAUNCHES["attention_fused"],
          f"fused attention launches per forward {fused_launched}")
    check(fused_rel <= FUSED_FORWARD_TOL,
          f"fused attention forward vs unfused rel {fused_rel}")

    # the middle block's input, read by a hook from a batch-1 forward
    captured = []
    block = model.middle_block[1]
    hook = block.register_forward_pre_hook(
        lambda mod, args: captured.append(args[0].detach().clone()))
    with torch.no_grad():
        model(x1, t1, low_res=x1)
    hook.remove()
    xm = captured[0]
    B, T, C = xm.shape[0], int(np.prod(xm.shape[1:-1])), xm.shape[-1]
    heads, ch = block.num_heads, C // block.num_heads
    flops = B * (2 * T * C * 3 * C + 4 * T * T * C + 2 * T * C * C)
    nbytes = (2 * xm.numel() * xm.element_size()       # x in, out
              + 4 * (4 * C * C + 4 * C) + 4 * 2 * C)   # f32 params, GN
    bound_ms, bound_by = bound(flops, nbytes, torch.bfloat16)
    # the materialized f32 logits, written once and read back once
    logits_bound_ms = 2 * B * heads * T * T * 4 / H100_BYTES * 1e3
    blocks = []
    for new_order in (False, True):
        blk = copy.deepcopy(block)
        blk.use_new_attention_order = new_order
        with torch.no_grad():
            ms = time_ms(lambda: blk(xm), reps=10, warmup=2)
            out = blk(xm).float().cpu()
            ref = copy.deepcopy(blk).cpu()(xm.cpu()).float()
            qkv = blk.qkv(blk.norm(xm.reshape(B, T, C)))
            core_ms = time_ms(lambda: qkv_attention(qkv, heads, new_order),
                              reps=10, warmup=2)
            q, k, v = (a.reshape(B, T, heads, ch).transpose(1, 2)
                       for a in qkv.chunk(3, dim=-1))
            sdpa_ms = time_ms(
                lambda: F.scaled_dot_product_attention(q, k, v), reps=10,
                warmup=2)
        err, rel = rel_err(out, ref)
        blocks.append({"new_order": new_order, "ms": ms, "core_ms": core_ms,
                       "sdpa_core_ms": sdpa_ms, "max_abs_err_vs_cpu": err,
                       "rel_err_vs_cpu": rel, "tol": TOL[torch.bfloat16]})
        check(bool(torch.isfinite(out).all()), "attention block finite")
        check(rel <= TOL[torch.bfloat16],
              f"attention block (new_order={new_order}) card vs CPU {rel}")
        del blk, qkv, q, k, v

    # the full-width f32 model, card against CPU (TF32 off), as phase_model
    m32 = _attention_model(False, seed)
    m32.load_state_dict(model.state_dict(), strict=True)
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((1, 8, 32, 32, 1), np.float32))
    low = torch.from_numpy(rng.standard_normal((1, 8, 32, 32, 1), np.float32))
    t = torch.tensor([517])
    with torch.no_grad():
        ref = m32(x, t, low_res=low)
        out = copy.deepcopy(m32).cuda()(x.cuda(), t.cuda(),
                                        low_res=low.cuda()).cpu()
    del m32
    f32_rel = rel_err(out, ref)[1]
    emit({"phase": "attention", "model": "SuperResModel, middle attention, "
          "128 ch, (1,1,2,3,4), 64-channel heads", "patch": 96,
          "dtype": "bfloat16", "launches_per_forward": launched,
          "routes_per_forward": {k: v for k, v in routes.items() if v},
          "fused_launches_per_forward": fused_launched,
          "fused_forward_ms_batch1": fused_ms,
          "fused_vs_unfused_rel": fused_rel, "by_batch": by_batch,
          "middle_block": {"tokens": T, "channels": C, "heads": heads,
                           "batch": B, "flops": flops, "bytes": nbytes,
                           "bound_ms": bound_ms, "bound_by": bound_by,
                           "logits_bound_ms": logits_bound_ms,
                           "orders": blocks},
          "f32_model": {"shape": list(x.shape), "rel_err_vs_cpu": f32_rel,
                        "tol": MODEL_TOL, "ref_abs_max":
                        ref.abs().max().item()}})
    check(ref.abs().max().item() > 1e-3, "f32 attention model non-trivial")
    check(f32_rel <= MODEL_TOL, f"f32 attention model card vs CPU {f32_rel}")
    phase_profile(model, phase="profile_attention",
                  families=ATTENTION_FAMILIES)
    return model, counts


# ---------------------------------------------------------------- guidance
# the classifier_sample CLI at the JAX CLI's default model and classifier
# (full widths) with a short chain
CLASSIFIER_FLAGS = ["--timestep_respacing", "10", "--num_samples", "4",
                    "--batch_size", "2"]
CLASSIFIER_STEPS, CLASSIFIER_BATCHES = 10, 2
CLASSIFIER_TIMEOUT_S = 300


def _guided_models(seed: int):
    """The classifier_sample CLI's default model and classifier, random
    weights from ``seed`` (heads included), on the CPU."""
    from ddpm3d_tpu_torch.models.factory import (
        create_classifier, create_model_and_diffusion)
    from ddpm3d_tpu_torch.models.nn import init_params
    from ddpm3d_tpu_torch.utils.config import (
        classifier_defaults, model_and_diffusion_defaults)

    model = create_model_and_diffusion(**model_and_diffusion_defaults())[0]
    classifier = create_classifier(**classifier_defaults())
    init_params(model, seed=seed, zero_heads=False)
    init_params(classifier, seed=seed + 1, zero_heads=False)
    return model.eval(), classifier.eval().requires_grad_(False)


def guided_path_gn_shapes(model, classifier) -> set:
    """Every distinct GroupNorm call (N, C, dtype, film, silu) of one guided
    step of classifier_sample at the CLI defaults (batch 2, 64x64, f32):
    the denoiser's forward and the classifier's forward under the guidance
    gradient, read by forward pre-hooks on card copies of the models."""
    from ddpm3d_tpu_torch.scripts.classifier_sample import guidance

    gns = set()
    model_c = copy.deepcopy(model).cuda()
    clf_c = copy.deepcopy(classifier).cuda()
    handles = _gn_hooks(model_c, gns) + _gn_hooks(clf_c, gns)
    x = torch.randn((2, 64, 64, 3), device="cuda")
    t = torch.tensor([400, 800], device="cuda")
    with torch.no_grad():
        model_c(x, t)
        guidance(clf_c, torch.tensor([1, 2], device="cuda"), 1.0)(x, t)
    for h in handles:
        h.remove()
    del model_c, clf_c
    return gns


# a guided step's kernel families: the 2-D convs are cuDNN's (with its
# layout transposes), the rest PyTorch's elementwise and GEMM kernels
GUIDED_FAMILIES = dict(
    gn_stats=FORWARD_FAMILIES["gn_stats"],
    gn_apply=FORWARD_FAMILIES["gn_apply"],
    cudnn_conv=("fprop", "dgrad", "nhwcToNchw", "nchwToNhwc"),
)


def phase_classifier_sample(seed: int, model, classifier) -> dict:
    """``python -m ddpm3d_tpu_torch.scripts.classifier_sample`` at the JAX
    CLI's default model and classifier flags, on ``.pt`` state dicts of
    random weights, 10 respaced steps, 4 samples in batches of 2: once DDPM,
    once ``--use_ddim True``. Each: exit 0, a finite (4, 64, 64, 3) npz with
    4 labels, the launches it logs per guided step (97/97). Then in this
    process on ``model`` and ``classifier`` (the CLI's weights, on the
    CPU): one guided step's parts (denoiser forward, classifier forward +
    backward) timed, with their host issue and device time, and their
    launches (56/56, 41/41), and the denoiser's
    forward and the guidance gradient (f32, TF32 off) on the card against
    the CPU. Returns the two runs' launch counts."""
    from ddpm3d_tpu_torch import ops
    from ddpm3d_tpu_torch.scripts.classifier_sample import guidance

    repo = os.path.dirname(os.path.abspath(__file__))
    total = collections.Counter()
    routes = collections.Counter()
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        mpath = os.path.join(tmp, "model.pt")
        cpath = os.path.join(tmp, "classifier.pt")
        torch.save(model.state_dict(), mpath)
        torch.save(classifier.state_dict(), cpath)
        for sampler, extra in (("ddpm", []), ("ddim", ["--use_ddim", "True"])):
            out = os.path.join(tmp, sampler)
            cmd = [sys.executable, "-m",
                   "ddpm3d_tpu_torch.scripts.classifier_sample",
                   *CLASSIFIER_FLAGS, *extra, "--model_path", mpath,
                   "--classifier_path", cpath, "--seed", str(seed),
                   "--save_dir", out]
            t0 = time.monotonic()
            proc = subprocess.run(cmd, cwd=repo, capture_output=True,
                                  text=True, timeout=CLASSIFIER_TIMEOUT_S)
            wall = time.monotonic() - t0
            if proc.returncode != 0:
                print(proc.stdout[-4000:], proc.stderr[-4000:],
                      file=sys.stderr)
            check(proc.returncode == 0,
                  f"classifier_sample ({sampler}) exited {proc.returncode}")
            data = np.load(os.path.join(out, "samples_4x64x64x3.npz"))
            arr, labels = data["arr_0"], data["arr_1"]
            log = open(os.path.join(out, "log.txt")).read().splitlines()
            launched = json.loads(next(
                l for l in log if l.startswith("kernel launches: "))
                .split(": ", 1)[1])
            sampling_s = float(next(
                l for l in log if l.startswith("sampling: "))
                .split(": ", 1)[1].split(" s wall")[0])
            # each batch's seconds; the first also pays the process's
            # first calls (library loads, cuDNN's algorithm choice)
            batch_s = [float(l.rsplit("(", 1)[1].split(" s)")[0])
                       for l in log if l.startswith("created ")]
            steps = CLASSIFIER_STEPS * CLASSIFIER_BATCHES
            total.update(launched["launches"])
            routes.update(launched["routes"])
            run = {"sampler": sampler, "exit": proc.returncode,
                   "wall_s": wall, "sampling_s": sampling_s,
                   "ms_per_guided_step": sampling_s * 1e3 / steps,
                   "batch_s": batch_s,
                   "ms_per_guided_step_last_batch":
                       batch_s[-1] * 1e3 / CLASSIFIER_STEPS,
                   "samples_shape": list(arr.shape),
                   "labels": labels.tolist(),
                   "finite": bool(np.isfinite(arr).all()),
                   "abs_max": float(np.abs(arr).max()),
                   "launches_per_step": {k: v / steps for k, v in
                                         launched["launches"].items() if v}}
            runs.append(run)
            check(arr.shape == (4, 64, 64, 3), f"samples shape {arr.shape}")
            check(labels.shape == (4,), f"labels shape {labels.shape}")
            check(run["finite"], f"{sampler} samples finite")
            check(run["launches_per_step"] == GUIDED_STEP_LAUNCHES,
                  f"{sampler} launches per guided step "
                  f"{run['launches_per_step']}")

    # one guided step's parts at batch 2, same weights
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((2, 64, 64, 3), generator=gen)
    t = torch.tensor([400, 800])
    y = torch.randint(0, 1000, (2,), generator=gen)
    model_c = copy.deepcopy(model).cuda()
    clf_c = copy.deepcopy(classifier).cuda()
    xc, tc, yc = x.cuda(), t.cuda(), y.cuda()
    cond_c = guidance(clf_c, yc, 1.0)
    with torch.no_grad():
        parts = {"batch": 2, **{
            name: time_and_profile(fn, GUIDED_FAMILIES, reps=20, warmup=3,
                                   host_reps=5, top=4)
            for name, fn in (("denoiser_forward", lambda: model_c(xc, tc)),
                             ("classifier_forward_backward",
                              lambda: cond_c(xc, tc)))}}
        ops.reset_launch_counts()
        out_c = model_c(xc, tc).cpu()
        fwd_counts = {k: v for k, v in ops.launch_counts().items() if v}
        ops.reset_launch_counts()
        grad_c = cond_c(xc, tc).cpu()
        cond_counts = {k: v for k, v in ops.launch_counts().items() if v}
        out_cpu = model(x, t)
        grad_cpu = guidance(classifier, y, 1.0)(x, t)
    del model_c, clf_c
    f_err, f_rel = rel_err(out_c, out_cpu)
    err, rel = rel_err(grad_c, grad_cpu)
    emit({"phase": "classifier_sample", "flags": " ".join(CLASSIFIER_FLAGS),
          "model": "UNet 64x64 2-D, 128 ch, (1,2,3,4), 4 heads, attention "
          "at 16 and 8", "classifier": "encoder, width 128, attention at "
          "32, 16 and 8, attention pool", "runs": runs,
          "step_parts": parts,
          "launches_denoiser_forward": fwd_counts,
          "launches_classifier_forward_backward": cond_counts,
          "denoiser_forward": {"dtype": "float32", "shape": list(x.shape),
                               "max_abs_err": f_err, "rel_err_vs_cpu": f_rel,
                               "tol": MODEL_TOL,
                               "abs_max": out_cpu.abs().max().item()},
          "guidance_grad": {"dtype": "float32", "max_abs_err": err,
                            "rel_err_vs_cpu": rel, "tol": GRAD_TOL,
                            "abs_max": grad_cpu.abs().max().item()}})
    check(fwd_counts == GUIDED_LAUNCHES["denoiser_forward"],
          f"denoiser forward launches {fwd_counts}")
    check(cond_counts == GUIDED_LAUNCHES["classifier_forward_backward"],
          f"classifier forward + backward launches {cond_counts}")
    check(out_cpu.abs().max().item() > 1e-3, "denoiser forward non-trivial")
    check(f_rel <= MODEL_TOL, f"denoiser forward card vs CPU rel {f_rel}")
    check(grad_cpu.abs().max().item() > 0, "guidance gradient non-trivial")
    check(rel <= GRAD_TOL, f"guidance gradient card vs CPU rel {rel}")
    return dict(total, routes=dict(routes))


# ------------------------------------------------------------------ Seg --
# the Seg* family at the production flags: launches per forward, derived
# on the CPU (tests/test_torch_port_seg_train.py:SEG_LAUNCHES): the main
# branch's 72 convs / 71 GroupNorms plus the encoder's 29 / 28; the 1x1
# convs are matmuls. In int8, the K5 sites: the main branch's 88, the
# encoder's 31 (its Cin = 1 input conv excluded by "in0_0"), the fusion's
# 1x1 sites (15 fuse{i} for cat_conv, the middle skip for midcat); the
# input convs and the head stay K3
SEG_FUSIONS = ("add", "cat_conv", "midcat")
SEG_LAUNCHES = {"conv3d": 101, "conv3d_dx": 0, "conv3d_fused": 0,
                "conv3d_s8": 0, "gn_stats": 99, "gn_apply": 99, "gn_fold": 0}
SEG_ROUTES = dict(_routes(98, 1, 1), **{"conv3d.sm90_cin1": 1})
SEG_INT8_S8 = {"add": 119, "cat_conv": 134, "midcat": 120}
# by kernel: 98 on csrc/conv3d_s8.cu (the main branch's 70, the encoder's
# 28 3x3x3) and the 1x1x1 sites on csrc/conv1x1_s8.cu (18 + the encoder's 3
# skips, + 15 fuse{i} for cat_conv, + the middle skip for midcat)
SEG_INT8_1X1 = {"add": 21, "cat_conv": 36, "midcat": 22}
SEG_INT8_ROUTES = {f: dict(_routes(0, 1, 1, s8_sm90=SEG_INT8_S8[f]
                                   - SEG_INT8_1X1[f], s8_1x1=SEG_INT8_1X1[f]),
                           **{"conv3d.sm90_cin1": 1}) for f in SEG_INT8_S8}
# the 6-channel aliases (a 3-channel conditioner): the same launches, both
# input convs (the main branch's Cin = 4, the encoder's Cin = 3) on the
# small-Cin instances, none on sm90_gather; in int8 both stay K3 (in0_0), K5 as
# the 1-channel model of their fusion
SEG_6C_MODELS = ("SegModelv2_6c", "SegModelv3_6c")  # add, cat_conv
SEG_6C_COND = 3
SEG_6C_ROUTES = dict(_routes(98, 0, 1), **{"conv3d.sm90_smallcin": 2})
SEG_6C_INT8_ROUTES = {f: dict(_routes(0, 0, 1), **{
    "conv3d.sm90_smallcin": 2, "conv3d_s8.sm90": SEG_INT8_S8[f]
    - SEG_INT8_1X1[f], "conv3d_s8.conv1x1": SEG_INT8_1X1[f]})
    for f in ("add", "cat_conv")}  # SegModelv2_6c, SegModelv3_6c
# the spatial_seg phase: every Seg model of the seg and seg_6c phases
# (phase_seg's weights, made once: _seg_models) on one 96^3 patch at batch
# 1 over SPATIAL_SHARDS shards, bf16, f32 and int8 with dynamic scales (the
# Int8Config() phase_seg serves). Per shard, the launches of the unsharded
# forward: SEG_LAUNCHES (in int8 the input convs and the head on K3, the
# fusion's SEG_INT8_S8 sites on K5), on the routes of phase_seg (f32:
# csrc/conv3d_f32.cu for every conv but the Cin = 2 input conv's and the
# head's; the 6-channel models' Cin 4 and 3 input convs too). Tolerances:
# bf16 within SPATIAL_TOL's, or twice the forward's own one-ulp GroupNorm
# noise where that is larger (the Seg forwards run deeper, through two
# branches); f32 SPATIAL_TOL's; int8 INT8_FORWARD_TOL and every site exact
# on its gathered input. The shards are replayed alone and timed for
# SPATIAL_SEG_TIMED (one model of each conditioner width) in bf16
SPATIAL_SEG_MODELS = SEG_FUSIONS + SEG_6C_MODELS
SPATIAL_SEG_VARIANTS = ("bf16", "f32", "int8_dynamic")
SPATIAL_SEG_TIMED = ("add", "SegModelv2_6c")
SPATIAL_SEG_NOISE_TOL = 2.0
FORWARD_LAUNCHES["seg_denoise"] = SEG_LAUNCHES
FORWARD_ROUTES["seg_denoise"] = SEG_ROUTES
# a training step of the midcat model: its forward, and the dx of every
# 3x3 conv but the two input convs (98 torso dx on sm90, the head's on
# f32_narrow)
SEG_STEP_LAUNCHES = dict(SEG_LAUNCHES, conv3d_dx=99)
SEG_STEP_ROUTES = dict(SEG_ROUTES, **{"conv3d_dx.sm90": 98,
                                      "conv3d_dx.f32_narrow": 1})
SEG_TRAIN_STEPS = 2
# the port's calibration tool on the production SuperResModel: every conv
# site recorded (the excluded ones too), every meta key of the JAX tool
CALIB_SITES = 90
CALIB_META_KEYS = (
    "sampler", "respacing", "margin", "n_volumes", "size", "model_channels",
    "channel_mult", "num_res_blocks", "factory", "ckpt", "time_bins",
    "chain_steps", "max_step_spread", "worst_spread_sites",
    "per_site_step_spread")
CALIB_FLAGS = ["--allow_random", "--factory", "--size", "96",
               "--model_channels", "128", "--num_res_blocks", "2",
               "--respacing", "3", "--time_bins", "3", "--n_volumes", "1"]
CALIB_TIMEOUT_S = 300
FORWARD_LAUNCHES["denoise_int8_calibrated"] = FORWARD_LAUNCHES["denoise_int8"]
FORWARD_ROUTES["denoise_int8_calibrated"] = FORWARD_ROUTES["denoise_int8"]
# the evaluate CLI's JSON against the same metrics on the CPU (float64 on
# both; only the summation order differs)
EVAL_TOL = 1e-9


def _seg_model(fusion: str, use_fp16: bool, seed: int, int8=None):
    """A Seg model at test_DDPM_3d_tpu.sh's flags (128 channels,
    (1,1,2,3,4), 2 res blocks, learned sigma, scale-shift norm, resblock
    up/down, no attention, Cin 1 + conditioner 1), random weights from
    ``seed`` (heads included), on the CPU."""
    from ddpm3d_tpu_torch.models import SegUNetModel
    from ddpm3d_tpu_torch.models.nn import init_params

    model = SegUNetModel(
        in_channels=1, cond_channels=1, model_channels=128, out_channels=2,
        num_res_blocks=2, channel_mult=(1, 1, 2, 3, 4),
        use_scale_shift_norm=True, resblock_updown=True, fusion=fusion,
        dtype=torch.bfloat16 if use_fp16 else torch.float32, int8=int8)
    init_params(model, seed=seed, zero_heads=False)
    return model.eval()


def _seg_6c_model(name: str, use_fp16: bool, seed: int):
    """A 6-channel Seg alias (``SegModelv2_6c``, ``SegModelv3_6c``: its
    default 3-channel conditioner) at _seg_model's flags, random weights
    from ``seed``, on the CPU."""
    from ddpm3d_tpu_torch import models
    from ddpm3d_tpu_torch.models.nn import init_params

    model = getattr(models, name)(
        in_channels=1, model_channels=128, out_channels=2,
        num_res_blocks=2, channel_mult=(1, 1, 2, 3, 4),
        use_scale_shift_norm=True, resblock_updown=True,
        dtype=torch.bfloat16 if use_fp16 else torch.float32)
    init_params(model, seed=seed, zero_heads=False)
    return model.eval()


def _seg_models(seed: int) -> dict:
    """Every Seg model of SPATIAL_SEG_MODELS in bf16, random weights from
    ``seed`` (_seg_model, _seg_6c_model), on the host: built once (a
    build takes seconds of host time), each moved to the card where a
    phase uses it and back after (_to_host)."""
    return {name: (_seg_6c_model if name in SEG_6C_MODELS else _seg_model)(
        name, True, seed) for name in SPATIAL_SEG_MODELS}


def seg_path_shapes(seg_models: dict) -> tuple:
    """Every distinct conv and GroupNorm shape of one bf16 96^3 forward of
    each Seg model of SEG_FUSIONS in ``seg_models`` (on the host), and
    every distinct int8 site of the add and cat_conv int8 forwards
    (main_path_shapes / int8_path_shapes on each)."""
    from ddpm3d_tpu_torch.ops import quant

    convs, gns, s8 = set(), set(), set()
    for fusion in SEG_FUSIONS:
        model = seg_models[fusion].cuda()
        c, g = main_path_shapes(model)
        convs |= set(c)
        gns |= set(g)
        if fusion != "midcat":
            model.set_int8(quant.Int8Config())
            s8 |= set(int8_path_shapes(model))
            model.set_int8(None)
        _to_host(model)
    torch.cuda.empty_cache()
    return convs, gns, s8


# the redesigned rows: csrc/conv3d_f32.cu's plain, fused and dx instances
# at the torso shape ([1,96^3,128] -> 128: the f32 model's level-0 ResBlock
# conv), the Cin = 1 conv at the Seg encoder's input; (D, H, W, Cin, Cout)
F32_TIMED = (96, 96, 96, 128, 128)
CIN1_TIMED = (96, 96, 96, 1, 128)
# the narrow kernel from Cin = 3: every Cin 3 to 7 (route sm90_smallcin;
# the 6-channel Seg models' input convs are Cin 4 and 3) and
# SMALLCIN_GATHER (route sm90_gather) -> 128 at the full patch, batch 1 and
# 2; SMALLCIN_TIMED timed; ragged volumes, Cout < 128 and past one column
# tile ((B, D, H, W, Cin), Cout), five for Cin <= 7 and five above; dx
# through the route (dy [B, D, H, W, Cin] of a conv Cout -> Cin, Cout)
SMALLCIN_VOLUME = (96, 96, 96, 128)
SMALLCIN_GATHER = (9, 10, 11, 12, 13, 14, 15, 17, 20, 36, 130)
SMALLCIN_TIMED = (3, 4, 9, 12, 15, 20, 130)
SMALLCIN_RAGGED = (((2, 5, 7, 9, 3), 40), ((1, 4, 8, 8, 5), 130),
                   ((1, 1, 1, 3, 7), 16), ((2, 3, 5, 6, 6), 128),
                   ((1, 6, 12, 12, 4), 3),
                   ((2, 5, 7, 9, 9), 40), ((1, 4, 8, 8, 13), 130),
                   ((1, 1, 1, 3, 15), 16), ((2, 3, 5, 6, 17), 128),
                   ((1, 6, 12, 12, 130), 3))
SMALLCIN_DX = (((1, 96, 48, 48, 4), 128), ((1, 96, 96, 96, 12), 128),
               ((1, 48, 48, 48, 20), 128))


def f32_path_shapes(seed: int, seg_models: dict) -> dict:
    """Every distinct conv of ``csrc/conv3d_f32.cu`` on the f32 paths:
    phase_model's forward, fused forward and gradients (the full-width f32
    model at [1, 8, 32, 32, 1]) and phase_seg's f32 Seg forwards (the same
    input). Read by hooks from card forwards with random weights:
    {"conv": {(D, H, W, Cin, Cout)}, "dx": {(D, H, W, Cout, Cin)} (the dx
    maps Cout -> Cin), "fused": {(D, H, W, Cin, Cout, prologue, silu, skip,
    stats)}}."""
    from ddpm3d_tpu_torch.models.nn import Conv3x3x3
    from ddpm3d_tpu_torch.ops import conv3d as cv

    out = {"conv": set(), "dx": set(), "fused": set()}
    grads = [True]  # whether the model being read also runs a backward

    def hook(mod, args, kwargs):
        _, D, H, W, cin = args[0].shape
        cout = mod.weight.shape[0]
        if kwargs.get("fused"):
            out["fused"].add((D, H, W, cin, cout,
                              kwargs.get("prologue_g") is not None,
                              bool(kwargs.get("prologue_silu", True)),
                              kwargs.get("skip") is not None,
                              bool(kwargs.get("want_stats", False))))
            return
        if cv.conv3d_route(args[0].shape, torch.float32, cout) == "f32":
            out["conv"].add((D, H, W, cin, cout))
        if grads[0] and cin != 2 and cv.conv3d_route(
                (1, D, H, W, cout), torch.float32, cin) == "f32":
            out["dx"].add((D, H, W, cout, cin))

    x = torch.randn((1, 8, 32, 32, 1), device="cuda")
    t = torch.tensor([517], device="cuda")

    def read(model, with_grads: bool) -> None:
        grads[0] = with_grads
        handles = [m.register_forward_pre_hook(hook, with_kwargs=True)
                   for m in model.modules() if isinstance(m, Conv3x3x3)]
        with torch.no_grad():
            model(x, t, low_res=x)
        for h in handles:
            h.remove()

    # phase_model's gradients; the rest forwards
    read(_model(use_fp16=False, seed=seed)[0].cuda(), True)
    read(_model(use_fp16=False, seed=seed, fused=True)[0].cuda(), False)
    for fusion in SEG_FUSIONS:
        card = seg_models[fusion].cuda()
        read(_as_f32(card), False)
        _to_host(card)
    torch.cuda.empty_cache()
    return {k: sorted(v) for k, v in out.items()}


def _fused_kw(gen, B, D, H, W, cin, cout, pro, silu, skip, stats):
    """The fused conv's arguments for a site: a folded GroupNorm's affine
    (x is ~N(0.5, 2)), the skip in f32."""
    dev = torch.device("cuda")
    kw = dict(prologue_silu=silu, want_stats=stats)
    if pro:
        kw["prologue_g"] = 0.5 * (1 + 0.1 * torch.randn(
            (B, cin), generator=gen, device=dev))
        kw["prologue_b"] = -0.25 + 0.1 * torch.randn(
            (B, cin), generator=gen, device=dev)
    if skip:
        kw["skip"] = torch.randn((B, D, H, W, cout), generator=gen,
                                 device=dev)
    return kw


def _stats_errs(gn, got, ref, N, cout) -> dict:
    """The fused conv's stats as the next GroupNorm folds them (g, b
    against the plain sums' fold, relative to the largest entry) and the
    sum of squares per entry."""
    ones = torch.ones(cout, device="cuda")
    zeros = torch.zeros(cout, device="cuda")
    gk, bk = gn.fold_gn_affine(got, N, ones, zeros)
    gp, bp = gn.fold_gn_affine(ref, N, ones, zeros)
    return dict(stats_fold_rel_err=max(rel_err(gk, gp)[1], rel_err(bk, bp)[1]),
                stats_s2_rel_err=((got[:, 1] - ref[:, 1]).abs()
                                  / ref[:, 1]).max().item(),
                stats_fold_tol=STATS_FOLD_TOL, stats_s2_tol=STATS_S2_TOL)


def phase_conv3d_cu(gen: torch.Generator, shapes: dict,
                    conv_parent=None) -> dict:
    """The redesigned kernels against their plain versions: the f32 conv
    (``csrc/conv3d_f32.cu``) at every distinct shape of ``shapes``
    (f32_path_shapes: plain, dx, fused with the site's flags; fused also
    bit for bit twice and alone against in a batch of 2, its stats as the
    next GroupNorm folds them) and the bf16 Cin = 1 conv
    (``csrc/conv3d_narrow.cu``'s Cin = 1 instance) at the Seg input at
    batch 1 and 2, each on its route. At F32_TIMED / CIN1_TIMED each is
    timed beside its plain version, one library call (``F.conv3d``, TF32
    off; cuDNN's data gradient for the dx) and its bound; the Cin = 1 conv
    also beside ``conv_parent``'s ``mma.sync`` conv (a previous
    ``csrc/conv3d.cu``, the kernel that carried it before) when given.
    Then the narrow kernel's Cin 3 to 7 and gather instances
    (``_smallcin_rows``). Returns the kernels line's entries
    ``conv3d_f32``, ``conv3d_f32_dx``, ``conv3d_fused_f32``,
    ``conv3d_cin1`` and ``conv3d_smallcin``."""
    from ddpm3d_tpu_torch.ops import conv3d as cv
    from ddpm3d_tpu_torch.ops import conv3d_fused as fo
    from ddpm3d_tpu_torch.ops import groupnorm as gn

    dev = torch.device("cuda")
    f32 = torch.float32
    check(any(c[3:] == F32_TIMED[3:] for c in shapes["conv"]),
          "the timed f32 widths are on the f32 model's path")
    out_lines, checked = {}, collections.Counter()
    cases = ([("conv3d_f32", c, None) for c in shapes["conv"]]
             + [("conv3d_f32_dx", c, None) for c in shapes["dx"]]
             + [("conv3d_fused_f32", c[:5], c[5:]) for c in shapes["fused"]]
             + [("conv3d_f32", F32_TIMED, None),
                ("conv3d_f32_dx", F32_TIMED, None),
                ("conv3d_fused_f32", F32_TIMED, (True, True, True, True))])
    warm_card()
    for name, (D, H, W, cin, cout), flags in cases:
        timed = (D, H, W, cin, cout) == F32_TIMED
        B, N = 1, D * H * W
        x = torch.randn((B, D, H, W, cin), generator=gen, device=dev)
        w = (torch.randn((cout, cin, 3, 3, 3), generator=gen, device=dev)
             * (27 * cin) ** -0.5)
        b = torch.randn((cout,), generator=gen, device=dev) * 0.1
        line = dict(kernel=name, shape=[B, D, H, W, cin], cout=cout,
                    dtype="float32", tile=list(cv.pick_tile_f32(D, H, W)))
        flops = 2.0 * 27 * cin * cout * B * N
        nbytes = 4.0 * (B * N * (cin + cout) + 27 * cin * cout + cout)
        if name == "conv3d_f32":
            check(cv.conv3d_route(x.shape, f32, cout) == "f32",
                  f"f32 {line['shape']}->{cout} runs csrc/conv3d_f32.cu")
            wp = cv.pack_weight_kernel(w, f32)
            kfn = lambda: cv.conv3d_kernel(x, wp, b)  # noqa: E731
            pfn = lambda: cv.conv3d_plain(x, w, b)  # noqa: E731
            out, ref = kfn(), pfn()
            xn = x.permute(0, 4, 1, 2, 3)
            lfn = lambda: F.conv3d(xn, w, b, padding=1)  # noqa: E731
        elif name == "conv3d_f32_dx":
            # the dx conv maps Cout -> Cin: x here is dy, w the forward's
            # weight with Cin = cout of the dx
            dy, wf = x, w.transpose(0, 1).contiguous()  # (cin_fwd, cout_fwd)
            route = cv.conv3d_route(dy.shape, f32, cout)
            check(route == "f32", f"f32 dx {line['shape']}->{cout} runs "
                  f"csrc/conv3d_f32.cu, not {route}")
            wpd = cv.pack_weight_dx(wf, f32)
            kfn = lambda: cv.conv3d_dx_kernel(dy, wpd)  # noqa: E731
            pfn = lambda: cv.conv3d_dx_plain(dy, wf)  # noqa: E731
            out, ref = kfn(), pfn()
            xs = torch.empty((B, D, H, W, cout), device=dev)
            lfn = lambda: _library_dx(dy, xs, wf)  # noqa: E731
            nbytes -= 4.0 * cout  # no bias
        else:
            pro, silu, use_skip, stats = flags
            check(fo.conv3d_fused_route(x.shape, f32) == "f32",
                  "the f32 fused conv runs csrc/conv3d_f32.cu")
            x = x * 2 + 0.5
            kw = _fused_kw(gen, B, D, H, W, cin, cout, pro, silu, use_skip,
                           stats)
            wp = fo.pack_weight_fused(w, f32)
            kfn = lambda: fo.conv3d_fused_kernel(x, wp, b, **kw)  # noqa: E731
            pfn = lambda: fo.conv3d_fused_plain(x, w, b, **kw)  # noqa: E731
            got, want = kfn(), pfn()
            out, ref = (got[0], want[0]) if stats else (got, want)
            line.update(prologue=pro, silu=silu, skip=use_skip, stats=stats)
            line.update(_fused_exact(fo, x, wp, b, kw, gen))
            if stats:
                line.update(_stats_errs(gn, got[1], want[1], N, cout))
            xn = x.permute(0, 4, 1, 2, 3)
            lfn = lambda: F.conv3d(xn, w, b, padding=1)  # noqa: E731
            nbytes += 4.0 * (B * N * cout * use_skip + 2 * B * cin
                             + 2 * B * cout * stats)
        torch.cuda.synchronize()
        err, rel = rel_err(out, ref)
        line.update(max_abs_err=err, rel_err=rel, tol=TOL[f32])
        if timed:
            bms, by = bound(flops, nbytes, f32)
            line.update(kernel_ms=time_ms(kfn),
                        plain_ms=time_ms(pfn, reps=3, warmup=1),
                        library_ms=time_ms(lfn), bound_ms=bms, bound_by=by,
                        bytes=nbytes, flops=flops)
            line["tflops"] = flops / line["kernel_ms"] / 1e9
        emit(line)
        check(bool(torch.isfinite(out).all()), f"{name} finite")
        check(rel <= TOL[f32], f"{name} {line['shape']}->{cout} rel err {rel}")
        if flags is not None:
            check(line["deterministic"] and line["batch_invariant"],
                  f"{name} {line['shape']}->{cout} {flags} repeats exactly "
                  f"and alone equals in a batch of 2")
            if flags[3]:
                check(line["stats_fold_rel_err"] <= STATS_FOLD_TOL
                      and line["stats_s2_rel_err"] <= STATS_S2_TOL,
                      f"{name} stats {line}")
        checked[name] += 1
        if timed:
            out_lines[name] = line
        del x, out, ref

    # the Seg encoder's input conv, bf16 Cin = 1, at batch 1 (timed) and 2
    D, H, W, cin, cout = CIN1_TIMED
    for B in (1, 2):
        dt = torch.bfloat16
        x = torch.randn((B, D, H, W, cin), generator=gen, device=dev).to(dt)
        w = (torch.randn((cout, cin, 3, 3, 3), generator=gen, device=dev)
             * (27 * cin) ** -0.5)
        b = torch.randn((cout,), generator=gen, device=dev) * 0.1
        check(cv.conv3d_route(x.shape, dt, cout) == "sm90_cin1",
              "the bf16 Cin = 1 conv runs the narrow kernel's Cin = 1 instance")
        wp, wd = cv.pack_weight_kernel(w, dt), w.to(dt)
        kfn = lambda: cv.conv3d_kernel(x, wp, b)  # noqa: E731
        out, ref = kfn(), cv.conv3d_plain(x, wd, b)
        torch.cuda.synchronize()
        err, rel = rel_err(out, ref)
        line = dict(kernel="conv3d_cin1", route="conv3d.sm90_cin1",
                    shape=[B, D, H, W, cin], cout=cout, dtype="bfloat16",
                    max_abs_err=err, rel_err=rel, tol=TOL[dt])
        if B == 1:
            vox = B * D * H * W
            flops = 2.0 * 27 * cin * cout * vox
            nbytes = 2.0 * (vox * (cin + cout) + 27 * cin * cout) + 4 * cout
            bms, by = bound(flops, nbytes, dt)
            xn = x.permute(0, 4, 1, 2, 3)
            line.update(
                kernel_ms=time_ms(kfn),
                plain_ms=time_ms(lambda: cv.conv3d_plain(x, wd, b), reps=3,
                                 warmup=1),
                library_ms=time_ms(
                    lambda: F.conv3d(xn, wd, b.to(dt), padding=1)),
                bound_ms=bms, bound_by=by, bytes=nbytes, flops=flops,
                **_parent_times(conv_parent, x, w, b, ref))
            out_lines["conv3d_cin1"] = line
        emit(line)
        check(bool(torch.isfinite(out.float()).all()), "conv3d_cin1 finite")
        check(rel <= TOL[dt], f"conv3d_cin1 {line['shape']} rel err {rel}")
        checked["conv3d_cin1"] += 1
        del x, out, ref
    out_lines["conv3d_smallcin"] = _smallcin_rows(gen, checked, conv_parent)
    for name in out_lines:
        out_lines[name]["shapes_checked"] = checked[name]
    emit({"phase": "conv3d_cu", "shapes_checked": dict(checked)})
    return out_lines


def _bf16_conv_times(x, w, b, cout) -> dict:
    """A bf16 conv's kernel (its route), plain and ``F.conv3d`` ms on the
    same inputs, its bytes, FLOP and bound."""
    from ddpm3d_tpu_torch.ops import conv3d as cv

    dt = torch.bfloat16
    B, D, H, W, cin = x.shape
    wp, wd, xn = cv.pack_weight_kernel(w, dt), w.to(dt), x.permute(0, 4, 1, 2, 3)
    vox = B * D * H * W
    flops = 2.0 * 27 * cin * cout * vox
    nbytes = 2.0 * (vox * (cin + cout) + 27 * cin * cout) + 4 * cout
    bms, by = bound(flops, nbytes, dt)
    return dict(
        kernel_ms=time_ms(lambda: cv.conv3d_kernel(x, wp, b)),
        plain_ms=time_ms(lambda: cv.conv3d_plain(x, wd, b), reps=3,
                         warmup=1),
        library_ms=time_ms(lambda: F.conv3d(xn, wd, b.to(dt), padding=1)),
        bound_ms=bms, bound_by=by, bytes=nbytes, flops=flops)


def _parent_times(lib, x, w, b, ref) -> dict:
    """``parent_ms`` (and its rel err against ``ref``) of the retired
    ``mma.sync`` conv of ``lib`` (``--parent-conv``) on the same inputs, or
    None without it."""
    if lib is None:
        return {"parent_ms": None}
    err = rel_err(_parent_ndhwc(lib, x, w, b), ref)[1]
    return {"parent_ms": time_ms(lambda: _parent_ndhwc(lib, x, w, b)),
            "parent_rel_err": err}


def _smallcin_rows(gen: torch.Generator, checked, conv_parent=None) -> dict:
    """The narrow kernel's instances from Cin = 3 (``csrc/conv3d_narrow.cu``,
    routes sm90_smallcin and sm90_gather) against ``conv3d_plain``: every
    Cin 3 to 7 and of SMALLCIN_GATHER -> 128 at the full patch at
    batch 1 and 2 (batch 2's first volume is batch 1's: the same bits), the
    ragged SMALLCIN_RAGGED and the dx of SMALLCIN_DX; at SMALLCIN_TIMED each
    timed beside its plain version, ``F.conv3d``, its bound and, with
    ``conv_parent`` (``--parent-conv``), the retired ``mma.sync`` conv on
    the same inputs (the kernel that carried every one of these Cin before,
    ``parent_ms``). Returns the kernels line's entry: the Cin = 4 row, the
    other timed rows under ``cin_rows``."""
    from ddpm3d_tpu_torch import ops
    from ddpm3d_tpu_torch.ops import conv3d as cv

    dev, dt = torch.device("cuda"), torch.bfloat16
    D, H, W, cout = SMALLCIN_VOLUME

    def inputs(shape, cout):
        cin = shape[-1]
        x = torch.randn(shape, generator=gen, device=dev).to(dt)
        w = (torch.randn((cout, cin, 3, 3, 3), generator=gen, device=dev)
             * (27 * cin) ** -0.5)
        b = torch.randn((cout,), generator=gen, device=dev) * 0.1
        return x, w, b

    timed = {}
    for cin in [c for c in range(3, cv.NARROW_MAX_CIN + 1) if c % 8] + list(
            SMALLCIN_GATHER):
        x, w, b = inputs((1, D, H, W, cin), cout)
        route = "sm90_smallcin" if cin <= cv.NARROW_MAX_CIN else "sm90_gather"
        check(cv.conv3d_route(x.shape, dt, cout) == route,
              f"bf16 Cin = {cin} runs the narrow kernel's {route} instance")
        wp, wd = cv.pack_weight_kernel(w, dt), w.to(dt)
        x2 = torch.cat([x, torch.randn(x.shape, generator=gen,
                                       device=dev).to(dt)])
        ops.reset_launch_counts()
        out, out2 = cv.conv3d_kernel(x, wp, b), cv.conv3d_kernel(x2, wp, b)
        routes = {k: v for k, v in ops.route_counts().items() if v}
        ref, ref2 = cv.conv3d_plain(x, wd, b), cv.conv3d_plain(x2, wd, b)
        torch.cuda.synchronize()
        err, rel = rel_err(out, ref)
        err2, rel2 = rel_err(out2, ref2)
        line = dict(kernel="conv3d_smallcin", route=f"conv3d.{route}",
                    shape=[1, D, H, W, cin], cout=cout, dtype="bfloat16",
                    max_abs_err=max(err, err2), rel_err=rel,
                    rel_err_batch2=rel2, tol=TOL[dt],
                    batch2_equal=bool(torch.equal(out2[:1], out)),
                    routes=routes)
        del x2, out2, ref2
        if cin in SMALLCIN_TIMED:
            line.update(_bf16_conv_times(x, w, b, cout))
            line.update(_parent_times(conv_parent, x, wd, b, ref))
            timed[cin] = line
        emit(line)
        check(routes == {f"conv3d.{route}": 2},
              f"Cin = {cin} routes {routes}")
        check(bool(torch.isfinite(out.float()).all()),
              f"conv3d_smallcin Cin = {cin} finite")
        check(max(rel, rel2) <= TOL[dt],
              f"conv3d_smallcin Cin = {cin} rel err {rel}, batch 2 {rel2}")
        check(line["batch2_equal"],
              f"conv3d_smallcin Cin = {cin}: batch 2 equals batch 1")
        checked["conv3d_smallcin"] += 2
        del x, out, ref

    for shape, n in SMALLCIN_RAGGED:
        x, w, b = inputs(shape, n)
        wp = cv.pack_weight_kernel(w, dt)
        out = cv.conv3d_kernel(x, wp, b)
        err, rel = rel_err(out, cv.conv3d_plain(x, w.to(dt), b))
        repeat = bool(torch.equal(out, cv.conv3d_kernel(x, wp, b)))
        emit(dict(kernel="conv3d_smallcin", shape=list(shape), cout=n,
                  route=cv.conv3d_route(shape, dt, n), dtype="bfloat16",
                  max_abs_err=err, rel_err=rel, tol=TOL[dt],
                  repeat_equal=repeat))
        check(rel <= TOL[dt] and repeat,
              f"conv3d_smallcin {list(shape)}->{n} rel err {rel}, "
              f"repeat equal {repeat}")
        checked["conv3d_smallcin"] += 1

    for shape, n in SMALLCIN_DX:  # dy of a conv n -> Cin, Cin on the route
        dy, w, _ = inputs(shape, n)  # w: (n, Cin, ...), the dx's (out, in)
        wf = w.transpose(0, 1).contiguous()  # the forward's (Cin, n) weight
        route = cv.conv3d_route(dy.shape, dt, n)
        check(route in ("sm90_smallcin", "sm90_gather"),
              f"the dx of a conv to Cin = {shape[-1]} runs the narrow "
              f"kernel, not {route}")
        ops.reset_launch_counts()
        dx = cv.conv3d_dx_kernel(dy, cv.pack_weight_dx(wf, dt))
        dx_routes = {k: v for k, v in ops.route_counts().items() if v}
        err, rel = rel_err(dx, cv.conv3d_dx_plain(dy, wf))
        emit(dict(kernel="conv3d_smallcin_dx", shape=list(shape), cout=n,
                  dtype="bfloat16", max_abs_err=err, rel_err=rel,
                  tol=TOL[dt], routes=dx_routes))
        check(dx_routes == {f"conv3d_dx.{route}": 1} and rel <= TOL[dt],
              f"conv3d_smallcin dx {list(shape)} rel err {rel}, routes "
              f"{dx_routes}")
        checked["conv3d_smallcin"] += 1
        del dy, dx

    keep = ("shape", "route", "kernel_ms", "plain_ms", "library_ms",
            "bound_ms", "bound_by", "parent_ms", "rel_err", "batch2_equal")
    return dict(timed[4], cin_rows={
        cin: {k: line.get(k) for k in keep}
        for cin, line in timed.items() if cin != 4})


def _int8_sites_equal(card, cpu, x, low, t):
    """One forward of ``card`` (an int8 model on the card) with every
    quantized site's input and output captured; each site's card output
    against the same site of ``cpu`` (the same weights) on that input.
    Returns (output, sites checked, [(site, max diff)] of unequal ones)."""
    io = []
    handles = [m.register_forward_hook(
        lambda mod, args, kwargs, out: io.append(
            (mod, args[0].cpu(), out.cpu(), bool(kwargs.get("upsample")))),
        with_kwargs=True) for m in card.modules()
        if getattr(m, "site", "") and m.int8_active()]
    names = {m: n for n, m in card.named_modules()}
    with torch.no_grad():
        out = card(x.cuda(), t.cuda(), low_res=low.cuda()).cpu()
        for h in handles:
            h.remove()
        unequal = []
        for mod, xin, yout, up in io:
            cpu_mod = cpu.get_submodule(names[mod])
            y_cpu = cpu_mod(xin, upsample=up) if up else cpu_mod(xin)
            if not torch.equal(y_cpu, yout):
                unequal.append((mod.site, (y_cpu - yout).abs().max().item()))
    return out, len(io), unequal


def phase_seg(seed: int, seg_models: dict, phase: str = "seg") -> dict:
    """The three Seg models (``phase`` "seg") or the two 6-channel aliases
    (``phase`` "seg_6c": SegModelv2_6c, SegModelv3_6c with a 3-channel
    conditioner, so input convs of Cin 4 and 3) at full width, bf16, 96^3:
    parameter count, forward ms and peak memory at batch 1 and 2, launches
    per forward by kernel and route (exactly SEG_LAUNCHES and SEG_ROUTES /
    SEG_6C_ROUTES); each f32 model on the card against the CPU
    (MODEL_TOL); the first model's forward by kernel family
    (``profile_<phase>``). Then int8 (all but midcat): K5 launches per
    forward (the JAX-derived site count of the fusion), K3 and the int8
    kernels on SEG_INT8_ROUTES / SEG_6C_INT8_ROUTES (the 1x1 sites,
    SEG_INT8_1X1, on csrc/conv1x1_s8.cu), every site's output equal to the
    plain int8 conv on its own input (the f32 int8 model, card against
    CPU), the bf16 int8 forward against bf16 (INT8_FORWARD_TOL). Returns
    {path: one forward's counts} (``phase``: the first model,
    ``<phase>_int8``: it in int8). The bf16 models are ``seg_models``'
    (_seg_models, on the host, returned there); the f32 ones are built
    here."""
    from ddpm3d_tpu_torch.ops import quant

    if phase == "seg_6c":
        models, cond = SEG_6C_MODELS, SEG_6C_COND
        routes_want, int8_routes_want = SEG_6C_ROUTES, SEG_6C_INT8_ROUTES
        build = _seg_6c_model
    else:
        models, cond = SEG_FUSIONS, 1
        routes_want, int8_routes_want = SEG_ROUTES, SEG_INT8_ROUTES
        build = _seg_model
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x1 = torch.randn((1, 96, 96, 96, 1), device="cuda", generator=gen)
    low1 = x1 if cond == 1 else torch.randn(
        (1, 96, 96, 96, cond), device="cuda", generator=gen)
    t1 = torch.tensor([500], device="cuda")
    rng = np.random.default_rng(seed)
    xs = torch.from_numpy(rng.standard_normal((1, 8, 32, 32, 1), np.float32))
    lows = torch.from_numpy(rng.standard_normal((1, 8, 32, 32, cond),
                                                np.float32))
    ts = torch.tensor([517])
    paths = {}
    for i, name in enumerate(models):
        model = seg_models[name].cuda()
        counts = _one_forward_counts(model, x1, t1, low1)
        routes = counts["routes"]
        launched = {k: v for k, v in counts.items() if k != "routes"}
        by_batch = {}
        with torch.no_grad():
            for B in (1, 2):
                x = torch.randn((B, 96, 96, 96, 1), device="cuda",
                                generator=gen)
                low = x if cond == 1 else torch.randn(
                    (B, 96, 96, 96, cond), device="cuda", generator=gen)
                t = torch.full((B,), 500, device="cuda")
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                ms = time_ms(lambda: model(x, t, low_res=low), reps=3,
                             warmup=1)
                by_batch[B] = {"forward_ms": ms, "max_memory_allocated_gb":
                               torch.cuda.max_memory_allocated() / 2 ** 30}
            del x, low
            ref16 = model(x1, t1, low_res=low1).float()
        m32 = build(name, False, seed)
        with torch.no_grad():
            ref = m32(xs, ts, low_res=lows)
            out = copy.deepcopy(m32).cuda()(
                xs.cuda(), ts.cuda(), low_res=lows.cuda()).cpu()
        f32_rel = rel_err(out, ref)[1]
        kind = "SegUNetModel" if phase == "seg" else name
        line = {"phase": phase, "fusion": model.fusion, "model": f"{kind}, "
                f"128 ch, (1,1,2,3,4), 2 res blocks, {cond}-channel "
                "conditioner, bf16 torso",
                "params": sum(p.numel() for p in model.parameters()),
                "patch": 96, "launches_per_forward": launched,
                "routes_per_forward": {k: v for k, v in routes.items() if v},
                "by_batch": by_batch,
                "f32_model": {"shape": list(xs.shape),
                              "cond_shape": list(lows.shape),
                              "rel_err_vs_cpu": f32_rel, "tol": MODEL_TOL,
                              "ref_abs_max": ref.abs().max().item()}}
        check(launched == SEG_LAUNCHES,
              f"{phase} {name} launches per forward {launched}")
        check(routes == routes_want, f"{phase} {name} conv routes {routes}")
        check(ref.abs().max().item() > 1e-3,
              f"f32 {phase} {name} non-trivial")
        check(f32_rel <= MODEL_TOL,
              f"f32 {phase} {name} card vs CPU {f32_rel}")
        check(bool(torch.isfinite(ref16).all()), f"{phase} {name} finite")
        if i == 0:
            paths[phase] = counts
            # device time by kernel family and the host's issue time
            phase_profile(model, phase=f"profile_{phase}",
                          cond_channels=cond)
        if model.fusion != "midcat":
            model.set_int8(quant.Int8Config())
            counts8 = _one_forward_counts(model, x1, t1, low1)
            with torch.no_grad():
                out8 = model(x1, t1, low_res=low1).float()
                ms8 = time_ms(lambda: model(x1, t1, low_res=low1), reps=3,
                              warmup=1)
            int8_rel = rel_err(out8, ref16)[1]
            m32.set_int8(quant.Int8Config())
            card = copy.deepcopy(m32).cuda()
            out32, n_sites, unequal = _int8_sites_equal(card, m32, xs, lows,
                                                        ts)
            del card
            n_s8 = SEG_INT8_S8[model.fusion]
            line["int8"] = {
                "launches_per_forward": {k: v for k, v in counts8.items()
                                         if k != "routes"},
                "routes_per_forward": {k: v for k, v in
                                       counts8["routes"].items() if v},
                "forward_ms_batch1": ms8,
                "forward_vs_bf16_rel": int8_rel, "tol": INT8_FORWARD_TOL,
                "sites_checked": n_sites, "sites_unequal": unequal}
            check(counts8["conv3d_s8"] == n_s8,
                  f"{phase} {name} int8: {counts8['conv3d_s8']} K5 launches")
            check(counts8["conv3d"] == 3 and counts8["routes"]
                  == int8_routes_want[model.fusion],
                  f"{phase} {name} int8 K3 and K5 routes {counts8}")
            check(n_sites == n_s8 and not unequal,
                  f"{phase} {name} int8 sites unequal: {unequal}")
            check(bool(torch.isfinite(out8).all() and torch.isfinite(
                out32).all()), f"{phase} {name} int8 finite")
            check(int8_rel <= INT8_FORWARD_TOL,
                  f"{phase} {name} int8 vs bf16 rel {int8_rel}")
            if i == 0:
                paths[f"{phase}_int8"] = counts8
            model.set_int8(None)
        emit(line)
        _to_host(model)
        del model, m32
        torch.cuda.empty_cache()
    return paths


def phase_seg_train(seed: int) -> dict:
    """Two TrainLoop steps at batch 1 on the bf16 midcat model (96^3, the
    training CLI's defaults: AdamW lr 1e-4, EMA 0.9999, uniform t): step
    ms, peak memory, finite loss/mse/vb, grad_norm > 0, launches per step
    by kernel and route. Returns the last step's counts."""
    from ddpm3d_tpu_torch import ops
    from ddpm3d_tpu_torch.models.factory import create_gaussian_diffusion
    from ddpm3d_tpu_torch.training import TrainLoop

    model = _seg_model("midcat", True, seed)
    sched, cfg = create_gaussian_diffusion(
        steps=1000, learn_sigma=True, noise_schedule="linear")
    loop = TrainLoop(model=model, sched=sched, cfg=cfg, data=iter(()),
                     batch_size=1, microbatch=-1, lr=1e-4,
                     ema_rate="0.9999", log_interval=10, save_interval=10000,
                     seed=seed, device="cuda")
    rng = np.random.default_rng(seed)
    steps, metrics = [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(SEG_TRAIN_STEPS):
        x = np.clip(rng.standard_normal((1, 96, 96, 96, 1), np.float32), -1,
                    1)
        low = rng.standard_normal((1, 96, 96, 96, 1), np.float32)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        m = loop.run_step(x, {"low_res": low})
        end.record()
        end.synchronize()
        counts = dict(ops.launch_counts(), routes=ops.route_counts())
        steps.append(start.elapsed_time(end))
        metrics.append({k: float(v.float().mean()) for k, v in m.items()
                        if k in ("loss", "mse", "vb", "grad_norm")})
    launched = {k: v for k, v in counts.items() if k != "routes"}
    emit({"phase": "seg_train", "fusion": "midcat", "batch": 1, "patch": 96,
          "step_ms": steps, "metrics": metrics,
          "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
          "launches_per_step": launched,
          "routes_per_step": {k: v for k, v in counts["routes"].items()
                              if v}})
    check(all(np.isfinite(v) for m in metrics for v in m.values()),
          "seg_train losses finite")
    check(all(m["grad_norm"] > 0 for m in metrics), "seg_train grad_norm > 0")
    check(launched == SEG_STEP_LAUNCHES, f"seg_train launches {launched}")
    check(counts["routes"] == SEG_STEP_ROUTES,
          f"seg_train routes {counts['routes']}")
    del loop, model
    torch.cuda.empty_cache()
    return counts


def phase_calibrate(seed: int) -> dict:
    """``python -m ddpm3d_tpu_torch.tools.calibrate_int8`` on the production
    SuperResModel (the denoise phase's weights as a ``.pt``, CALIB_FLAGS):
    exit 0, CALIB_SITES site scales, every meta key of the JAX tool, 3
    time bins; its ms per step. Then the denoise phase in int8 on that file
    (``denoise_int8_calibrated``: 3 bins used, exact launches). Returns that
    run's counts."""
    from ddpm3d_tpu_torch.models.factory import create_gaussian_diffusion

    model = _model(use_fp16=True, seed=seed)[0]
    tmp = tempfile.mkdtemp(prefix="calib_")
    ckpt = os.path.join(tmp, "model.pt")
    out = os.path.join(tmp, "scales.json")
    torch.save(model.state_dict(), ckpt)
    cmd = [sys.executable, "-m", "ddpm3d_tpu_torch.tools.calibrate_int8",
           *CALIB_FLAGS, "--load_ckpt", ckpt, "--seed", str(seed),
           "--out", out]
    t0 = time.monotonic()
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=CALIB_TIMEOUT_S,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    wall = time.monotonic() - t0
    check(proc.returncode == 0,
          f"calibrate_int8 exit {proc.returncode}: {proc.stderr[-2000:]}")
    with open(out) as f:
        data = json.load(f)
    ms = _ms_per_step(proc.stdout)
    meta = data["meta"]
    emit({"phase": "calibrate", "flags": CALIB_FLAGS, "wall_s": wall,
          "ms_per_step_median": ms[0] if ms else None,
          "first_step_ms": ms[1] if ms else None,
          "sites": len(data["scales"]),
          "binned_sites": len(data.get("scales_t", {})),
          "meta_keys": list(meta), "chain_steps": meta["chain_steps"],
          "max_step_spread": meta["max_step_spread"],
          "stdout_tail": proc.stdout[-400:]})
    check(len(data["scales"]) == CALIB_SITES and len(data["scales_t"])
          == CALIB_SITES, f"calibrated {len(data['scales'])} sites")
    check(tuple(meta) == CALIB_META_KEYS, f"meta keys {list(meta)}")
    check(meta["chain_steps"] == 3 and meta["time_bins"] == 3,
          "3 steps in 3 bins")
    check(bool(ms), "the tool printed its ms per step")
    schedule = create_gaussian_diffusion(
        steps=1000, learn_sigma=True, noise_schedule="linear",
        timestep_respacing="3")
    counts = phase_denoise_int8_static(
        model.cuda(), seed, fname=out, schedule=schedule, n_bins=3,
        phase="denoise_int8_calibrated")
    del model
    torch.cuda.empty_cache()
    return counts


def _ms_per_step(text: str) -> list:
    """The tool's "(median M ms per step, first F)" as [M, F]."""
    import re

    m = re.search(r"\(median ([0-9.]+) ms per step, first ([0-9.]+)\)",
                  text)
    return [float(m.group(1)), float(m.group(2))] if m else []


def phase_eps_calibration(seed: int) -> dict:
    """``estimate_eps_scale`` on the production model (bf16, batch 1, a
    96^3 patch of the synthetic volume as x0 and its conditioner), 3 t
    points, 1 draw from a ``torch.Generator`` on the card: a finite
    [1000] table; its ms. Returns the run's counts."""
    from ddpm3d_tpu_torch import ops
    from ddpm3d_tpu_torch.diffusion import estimate_eps_scale
    from ddpm3d_tpu_torch.models.factory import create_gaussian_diffusion

    model = _model(use_fp16=True, seed=seed)[0].cuda()
    sched, cfg = create_gaussian_diffusion(
        steps=1000, learn_sigma=True, noise_schedule="linear")
    rng = np.random.default_rng(seed)
    x0 = torch.from_numpy(np.clip(rng.gamma(2.0, 0.5, (1, 96, 96, 96, 1))
                                  .astype(np.float32) - 1, -1, 1)).cuda()
    low = x0 + 0.3 * torch.randn(x0.shape, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    t_points = [100, 500, 900]

    def model_fn(x, t, **kw):
        return model(x, t, **kw).float()

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.monotonic()
    table = estimate_eps_scale(model_fn, sched, cfg, x0,
                               model_kwargs={"low_res": low},
                               t_points=t_points, draws=1, generator=gen)
    torch.cuda.synchronize()
    ms = (time.monotonic() - t0) * 1e3
    counts = dict(ops.launch_counts(), routes=ops.route_counts())
    emit({"phase": "eps_calibration", "t_points": t_points, "draws": 1,
          "ms": ms, "lambda_at_points": [float(table[t]) for t in t_points],
          "finite": bool(np.isfinite(table).all()),
          "table_len": int(table.shape[0]),
          "conv3d_launches": counts["conv3d"]})
    check(table.shape == (1000,) and bool(np.isfinite(table).all()),
          "eps-scale table finite")
    check(counts["conv3d"] == 72 * len(t_points),
          f"eps calibration ran {counts['conv3d']} convs")
    del model
    torch.cuda.empty_cache()
    return counts


def phase_evaluate(seed: int, volume: np.ndarray) -> None:
    """``python -m ddpm3d_tpu_torch.scripts.evaluate`` on the card: the
    denoise phase's volume as the reference (.tif, (Z, H, W)) against a
    perturbed copy (.npz, (H, W, Z): the auto layout); exit 0, and its JSON
    equal to the same metrics on the CPU within EVAL_TOL."""
    from ddpm3d_tpu_torch.data import tiff_io
    from ddpm3d_tpu_torch.utils.metrics import volume_report

    tmp = tempfile.mkdtemp(prefix="evaluate_")
    ref = np.ascontiguousarray(volume.transpose(2, 0, 1), np.float32)
    noise = np.random.default_rng(seed).normal(0, 0.05, volume.shape)
    test = (volume + noise).astype(np.float32)
    ref_path, test_path = (os.path.join(tmp, "ref.tif"),
                           os.path.join(tmp, "test.npz"))
    tiff_io.imwrite(ref_path, ref)
    np.savez(test_path, test)
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "ddpm3d_tpu_torch.scripts.evaluate",
         "--reference", ref_path, "--test", test_path], capture_output=True,
        text=True, timeout=300, cwd=os.path.dirname(os.path.abspath(__file__)))
    wall = time.monotonic() - t0
    check(proc.returncode == 0, f"evaluate exit {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    want = volume_report(ref, test.transpose(2, 0, 1))
    diffs = {k: abs(got[k] - want[k]) / max(1.0, abs(want[k])) for k in want}
    emit({"phase": "evaluate", "wall_s": wall, "report": got,
          "cpu_report": want, "rel_diff": diffs, "tol": EVAL_TOL})
    check(got["shape"] == list(ref.shape), f"evaluate shape {got['shape']}")
    check(max(diffs.values()) <= EVAL_TOL, f"evaluate vs CPU {diffs}")



# the JSON keys the JAX tools print or write (tools/e2e_learning_check.py,
# tools/respacing_study.py: each row, its projection column renamed;
# tools/seg_int8_check.py: each fusion row and the encoder's)
E2E_KEYS = ("first_loss", "last_loss", "psnr_noisy_db", "ssim_noisy",
            "ema_rate", "train_steps", "train_time_s", "psnr_raw_db",
            "ssim_raw", "psnr_ema_db", "ssim_ema", "psnr_avg4_db",
            "ssim_avg4")
RESPACING_ROW_KEYS = ("setting", "steps", "psnr_vs_clean_db",
                      "psnr_vs_clean_db_std", "ssim_vs_clean",
                      "ssim_vs_clean_std", "psnr_vs_ddpm1000_db",
                      "ssim_vs_ddpm1000", "n_chains", "projected_volume_s",
                      "row_wall_s")
SEG_ROW_KEYS = ("psnr_noisy", "psnr_fp", "psnr_int8", "delta_db",
                "psnr_fp_vs_int8", "train_s")
SEG_ENCODER_KEYS = ("top1_agreement", "max_logit_drift", "mean_logit_drift",
                    "acc_fp", "acc_int8", "n_probes", "train_s")
# the respacing study at the production model (the serving path's full
# width: 128 channels, (1,1,2,3,4), 2 res blocks, 96^3 patches), 10
# training steps: it proves the path, it measures no quality
RESPACING_FULL_FLAGS = [
    "--size", "96", "--model_channels", "128", "--channel_mult", "1,1,2,3,4",
    "--num_res_blocks", "2", "--batch", "1", "--train_steps", "10",
    "--n_eval", "1"]
VOLUME_QUALITY_CONFIGS = "ddpm25:bf16@1,ddpm25:int8@1"


def _run_counted(fn):
    """``fn()`` with the launch counters zeroed just before and read just
    after (the card synchronized on both sides); returns (its result, the
    counts with ``routes``, seconds)."""
    from ddpm3d_tpu_torch import ops

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.monotonic()
    out = fn()
    torch.cuda.synchronize()
    seconds = time.monotonic() - t0
    return out, dict(ops.launch_counts(), routes=ops.route_counts()), seconds


def _finite(values) -> bool:
    return all(np.isfinite(float(v)) for v in values)


def _nonzero_routes(counts) -> dict:
    return {k: v for k, v in counts["routes"].items() if v}


def phase_e2e_learning(seed: int) -> dict:
    """``tools/e2e_learning_check.main`` in this process at its defaults:
    exit 0 (the loss fell, a PSNR above the noisy input's), its JSON's keys
    (JAX's), and launches on sm90, K1, K2 and the conv dx. Returns the
    run's counts."""
    import contextlib
    import io

    from ddpm3d_tpu_torch.tools import e2e_learning_check

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc, counts, seconds = _run_counted(
            lambda: e2e_learning_check.main(["--seed", str(seed)]))
    text = buf.getvalue()
    print(text, end="")
    result = json.loads([ln for ln in text.splitlines()
                         if ln.startswith("{")][-1])
    emit({"phase": "e2e_learning", "rc": rc, "seconds": seconds, **result,
          "launches": {k: v for k, v in counts.items() if k != "routes"},
          "routes": _nonzero_routes(counts)})
    check(rc == 0, "e2e learning check passed (loss fell, PSNR gained)")
    check(tuple(result) == E2E_KEYS, f"e2e keys {list(result)}")
    check(result["last_loss"] < result["first_loss"] and max(
        result["psnr_raw_db"], result["psnr_ema_db"],
        result["psnr_avg4_db"]) > result["psnr_noisy_db"], "e2e PSNR gain")
    for key in ("gn_stats", "gn_apply", "conv3d_dx"):
        check(counts[key] > 0, f"e2e launched {key}")
    check(counts["routes"]["conv3d.sm90"] > 0, "e2e launched sm90")
    return counts


def _check_study(phase: str, result: dict, counts: dict, seconds: float,
                 int8: bool, train_steps: int) -> None:
    """Finite rows with JAX's keys, the run's own step time as the
    flagship's, and the launches per forward of the served path: 70 sm90
    (bf16) or 88 K5 and 2 K3 (int8) a forward, each training step one
    forward and its dx."""
    rows = result["rows"]
    proto = result["protocol"]
    chain_steps = sum(r["steps"] * r["n_chains"] for r in rows)
    forwards = chain_steps + train_steps
    mean_ms = sum(r["ms_per_step"] * r["steps"] * r["n_chains"]
                  for r in rows) / chain_steps
    emit({"phase": phase, "seconds": seconds,
          "ms_per_step": {r["setting"]: r["ms_per_step"] for r in rows},
          "flagship_per_step_ms": proto["flagship_per_step_ms"],
          "rows": rows, "noisy_input": result["noisy_input"],
          "forwards": forwards,
          "launches": {k: v for k, v in counts.items() if k != "routes"},
          "routes": _nonzero_routes(counts)})
    for r in rows:
        check(all(k in r for k in RESPACING_ROW_KEYS),
              f"{phase} row keys {list(r)}")
        check(_finite([r["psnr_vs_clean_db"], r["ssim_vs_clean"],
                       r["ms_per_step"], r["projected_volume_s"]]),
              f"{phase} {r['setting']} finite")
    check(abs(proto["flagship_per_step_ms"] - mean_ms) <= 1e-9 * mean_ms,
          f"{phase} flagship_per_step_ms is the run's own step time")
    if int8:
        check(counts["conv3d_s8"] == 88 * forwards
              and counts["conv3d"] == 2 * forwards,
              f"{phase}: {counts['conv3d_s8']} K5 over {forwards} forwards")
    else:
        check(counts["routes"]["conv3d.sm90"] == 70 * forwards
              and counts["routes"]["conv3d_dx.sm90"] == 70 * train_steps,
              f"{phase}: {counts['routes']['conv3d.sm90']} sm90 over "
              f"{forwards} forwards")


def phase_respacing_full_width(seed: int, tmp: str) -> tuple:
    """``tools/respacing_study.main`` at the production model
    (RESPACING_FULL_FLAGS) in this process: 10 training steps, then
    ddpm25, ddim25 and dpm2m10 on one volume, its checkpoint saved; then
    the same checkpoint in int8 (ddpm25, ddim25). Returns the two runs'
    counts and the checkpoint."""
    from ddpm3d_tpu_torch.tools import respacing_study

    ckpt = os.path.join(tmp, "respacing_full.pt")
    result, counts, seconds = _run_counted(lambda: respacing_study.main(
        RESPACING_FULL_FLAGS + [
            "--settings", "ddpm25,ddim25,dpm2m10", "--seed", str(seed),
            "--save_ckpt", ckpt,
            "--out", os.path.join(tmp, "respacing_full.json")]))
    _check_study("respacing_full_width", result, counts, seconds, False, 10)
    torch.cuda.empty_cache()
    result8, counts8, seconds8 = _run_counted(lambda: respacing_study.main(
        RESPACING_FULL_FLAGS + [
            "--int8", "--load_ckpt", ckpt, "--settings", "ddpm25,ddim25",
            "--seed", str(seed),
            "--out", os.path.join(tmp, "respacing_full_int8.json")]))
    _check_study("respacing_full_width_int8", result8, counts8, seconds8,
                 True, 0)
    torch.cuda.empty_cache()
    return counts, counts8, ckpt


def phase_respacing_debug(seed: int, tmp: str) -> dict:
    """The study at its default model (50 steps, ddim10, one volume), then
    ``tools/respacing_debug.main`` on its checkpoint: every section (the
    teacher-forced table, the four chains, the four truncated chains)
    finite. Returns both runs' counts together."""
    from ddpm3d_tpu_torch.tools import respacing_debug, respacing_study

    ckpt = os.path.join(tmp, "respacing_small.pt")
    study, counts, seconds = _run_counted(lambda: respacing_study.main([
        "--train_steps", "50", "--settings", "ddim10", "--n_eval", "1",
        "--seed", str(seed), "--save_ckpt", ckpt,
        "--out", os.path.join(tmp, "respacing_small.json")]))
    debug, dcounts, dseconds = _run_counted(
        lambda: respacing_debug.main(["--ckpt", ckpt, "--seed", str(seed)]))
    emit({"phase": "respacing_debug", "study_seconds": seconds,
          "seconds": dseconds, "study_rows": study["rows"], **debug,
          "launches": {k: v for k, v in dcounts.items() if k != "routes"}})
    check(len(debug["teacher"]) == 14 and all(
        _finite(r.values()) for r in debug["teacher"]), "teacher table")
    check(sorted(debug["chains"]) == sorted(
        ["ddpm_full", "ddim_full", "ddpm250", "ddim250"])
        and sorted(debug["truncated"]) == sorted(["100", "250", "500",
                                                   "1000"]),
        "every chain and truncated chain")
    for section in ("chains", "truncated"):
        for name, r in debug[section].items():
            check(_finite(r.values()), f"respacing_debug {name} finite")
    check(dcounts["routes"]["conv3d.sm90"] > 0, "respacing_debug on sm90")
    return {k: (v + dcounts[k] if k != "routes" else {
        r: v[r] + dcounts["routes"][r] for r in v})
        for k, v in counts.items()}


def _cli_launches(log_path: str) -> dict:
    """The serving CLI's "kernel launches on rank 0: {json}" line."""
    with open(log_path) as f:
        lines = [ln for ln in f if "kernel launches on rank 0: " in ln]
    got = json.loads(lines[-1].split("kernel launches on rank 0: ", 1)[1])
    return dict(got["launches"], routes=got["routes"])


def phase_volume_quality(seed: int, tmp: str, ckpt: str) -> dict:
    """``make_synthetic_data`` writes one (100, 200, 200) volume, split into
    low and clean directories; ``python -m
    ddpm3d_tpu_torch.tools.volume_quality`` (a subprocess, which runs the
    serving CLI as one) on the full-width study checkpoint, ddpm25 in bf16
    and int8 over the 18-patch grid: exit 0, finite seam and interior
    rows, outputs of the input's shape, each config's sampling wall and
    the CLI's launches per forward (72/71/71; 88 K5 + 2 K3). Returns the
    counts by config."""
    from ddpm3d_tpu_torch.data import tiff_io
    from ddpm3d_tpu_torch.tools import make_synthetic_data

    syn = os.path.join(tmp, "synthetic")
    path = make_synthetic_data.main([syn, "--volumes", "1", "--shape", "100",
                                     "200", "200", "--seed", str(seed)])[0]
    vol = tiff_io.imread(path)
    name = os.path.basename(path)
    for sub, ch in (("low", 0), ("clean", 1)):
        os.makedirs(os.path.join(tmp, sub), exist_ok=True)
        tiff_io.imwrite(os.path.join(tmp, sub, name), vol[ch])
    workdir, out = os.path.join(tmp, "vq"), os.path.join(tmp, "vq.json")
    cmd = [sys.executable, "-m", "ddpm3d_tpu_torch.tools.volume_quality",
           "--eval_low_dir", os.path.join(tmp, "low"),
           "--eval_clean_dir", os.path.join(tmp, "clean"),
           "--model_path", ckpt, "--predict_v", "False",
           "--configs", VOLUME_QUALITY_CONFIGS, "--workdir", workdir,
           "--out", out]
    t0 = time.monotonic()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    wall = time.monotonic() - t0
    check(proc.returncode == 0, f"volume_quality exit {proc.returncode}: "
          f"{proc.stdout[-1500:]} {proc.stderr[-1500:]}")
    with open(out) as f:
        res = json.load(f)["results"]
    counts, line = {}, {}
    forwards = 25 * 6  # 18 patches at batch 3, 25 steps
    for spec in VOLUME_QUALITY_CONFIGS.split(","):
        spec = spec.split("@")[0]
        sampler_steps, precision = spec.split(":")
        cfg_dir = os.path.join(workdir, f"{sampler_steps}_{precision}")
        den = tiff_io.imread(os.path.join(cfg_dir, f"denoised_{name}"))
        c = counts[f"volume_quality_{precision}"] = _cli_launches(
            os.path.join(cfg_dir, "log.txt"))
        r = res[spec]
        line[spec] = dict(r, output_shape=list(den.shape), launches={
            k: v for k, v in c.items() if k != "routes"})
        check(den.shape == vol.shape[1:], f"{spec} shape {den.shape}")
        check(_finite([r["psnr_db"], r["ssim"], r["psnr_seam_db"],
                       r["psnr_interior_db"]]), f"{spec} rows finite")
        want = ({"conv3d_s8": 88, "conv3d": 2} if precision == "int8" else
                {"conv3d": 72, "gn_stats": 71, "gn_apply": 71})
        for k, n in want.items():
            check(c[k] == n * forwards, f"{spec}: {c[k]} {k} over "
                  f"{forwards} forwards")
    emit({"phase": "volume_quality", "configs": VOLUME_QUALITY_CONFIGS,
          "wall_s": wall, "noisy_input": res["noisy_input"],
          "sampling_wall_s": {k: v["sampling_wall_s_mean"]
                              for k, v in line.items()},
          "results": line})
    return counts


def phase_seg_int8_check(seed: int, tmp: str) -> dict:
    """``tools/seg_int8_check.main`` in this process (--steps 20 --n_eval
    1): every fusion row and the encoder's finite with JAX's keys; K5 and
    the Seg encoder's Cin = 1 conv (sm90_cin1) launched. Returns the
    counts."""
    from ddpm3d_tpu_torch.tools import seg_int8_check

    result, counts, seconds = _run_counted(lambda: seg_int8_check.main([
        "--steps", "20", "--n_eval", "1", "--seed", str(seed),
        "--out", os.path.join(tmp, "seg_int8.json")]))
    emit({"phase": "seg_int8_check", "seconds": seconds,
          "fusions": result["fusions"], "encoder": result["encoder"],
          "launches": {k: v for k, v in counts.items() if k != "routes"},
          "routes": _nonzero_routes(counts)})
    check(sorted(result["fusions"]) == ["add", "cat_conv", "midcat"],
          "every fusion row")
    for fusion, row in result["fusions"].items():
        check(tuple(row) == SEG_ROW_KEYS and _finite(row.values()),
              f"seg_int8_check {fusion} row")
    check(tuple(result["encoder"]) == SEG_ENCODER_KEYS
          and _finite(result["encoder"].values()), "encoder row")
    check(counts["conv3d_s8"] > 0, "seg_int8_check launched K5")
    check(counts["routes"]["conv3d.sm90_cin1"] > 0,
          "seg_int8_check launched sm90_cin1")
    return counts


def _best_ms(fn, reps: int = 3):
    """(best wall ms of ``reps`` calls, the last call's result)."""
    best, out = float("inf"), None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return best, out


HOST_LINE = re.compile(r"host tier: cut ([0-9.]+) ms, blend ([0-9.]+) ms; "
                       r"wall ([0-9.]+) s, of which ([0-9.]+) s sampling")


def phase_host_tier(seed: int, vq_workdir: str) -> None:
    """The host data tier (``ddpm3d_tpu_torch/native``, on the host CPU):
    a cold first use of the library into a fresh directory, the
    ``g++ -Q --help=target`` probe that names it and the compile (seconds),
    and the probe alone, which every process pays at first use; at the
    production volume, (2, 130, 200, 200) f32 written as a TIFF and read
    back, cut into the serving grid's 18 patches of 96^3 and blended, each
    through the native tier and through its numpy version: equal values
    (the blend within ``HOST_BLEND_REL`` of the larger value), ms (best of
    3); the serving pipeline's host share of each volume_quality config
    from its log (cut, blend and stats inside ``denoise_volume``; the
    volume's read and save are outside it); a ``mem://`` round trip of the
    production model's state dict (``utils/checkpoint.py`` through
    ``utils/blobio.py``), bit-equal, with the save and load seconds, after
    which the memory store is emptied."""
    from ddpm3d_tpu_torch import native
    from ddpm3d_tpu_torch.data import patches, tiff_io
    from ddpm3d_tpu_torch.utils import blobio
    from ddpm3d_tpu_torch.utils import checkpoint as ckpt

    check(native.available(), "native tier on ($DDPM3D_NATIVE unset)")
    build_dir = native.BUILD_DIR
    native.BUILD_DIR = tempfile.mkdtemp(prefix="native_build_")
    try:
        t0 = time.monotonic()
        native.build()
        build_s = time.monotonic() - t0
        t0 = time.monotonic()
        native.lib_path()
        probe_s = time.monotonic() - t0
    finally:
        native.BUILD_DIR = build_dir
    rng = np.random.default_rng(seed)
    pair = rng.uniform(0, 4, (2, 130, 200, 200)).astype(np.float32)
    path = os.path.join(tempfile.mkdtemp(prefix="host_tier_"), "pair.tif")
    write_ms, _ = _best_ms(lambda: tiff_io.imwrite(path, pair))
    read_ms, got = _best_ms(lambda: tiff_io.imread(path))
    read_plain_ms, plain = _best_ms(lambda: tiff_io._imread_builtin(path))
    check(got.dtype == np.float32 and np.array_equal(got, pair)
          and np.array_equal(plain, pair), "host_tier TIFF read")
    vol = pair[0] / 4.0
    Z, X, Y = vol.shape
    grid = patches.patch_grid(patches.test_xy_starts(X, 96),
                              patches.test_xy_starts(Y, 96),
                              patches.test_z_starts(Z, 96))
    check(len(grid) == 18, f"{len(grid)} patches")
    cut_ms, cut = _best_ms(lambda: patches.extract_patches_zxy(vol, grid, 96))
    cut_plain_ms, cut_plain = _best_ms(
        lambda: patches.extract_patches_zxy_plain(vol, grid, 96))
    check(np.array_equal(cut, cut_plain), "host_tier cut bit-equal")
    pxyz = np.transpose(cut, (0, 2, 3, 1))
    blend_ms, blend = _best_ms(
        lambda: patches.blend_patches_hann(pxyz, grid, (X, Y, Z), 96))
    blend_plain_ms, blend_plain = _best_ms(
        lambda: patches.blend_patches_hann_plain(pxyz, grid, (X, Y, Z), 96))
    blend_err = float(np.abs(blend - blend_plain).max())
    check(blend_err <= HOST_BLEND_REL * float(np.abs(blend_plain).max()),
          f"host_tier blend {blend_err}")
    share = {}
    for cfg in sorted(os.listdir(vq_workdir)):
        log_path = os.path.join(vq_workdir, cfg, "log.txt")
        if not os.path.exists(log_path):
            continue
        with open(log_path) as f:
            m = [HOST_LINE.search(ln) for ln in f]
        m = [x for x in m if x]
        check(len(m) == 1, f"{cfg}: one host tier line")
        cut_s, blend_s, wall, sample = (float(v) for v in m[0].groups())
        share[cfg] = {"wall_s": wall, "sample_wall_s": sample,
                      "cut_ms": cut_s, "blend_ms": blend_s,
                      "host_share": (wall - sample) / wall}
    check(len(share) == len(VOLUME_QUALITY_CONFIGS.split(",")),
          f"host share of every volume_quality config: {sorted(share)}")
    sd = _model(use_fp16=True, seed=seed)[0].state_dict()
    url = "mem://host_tier/model000001.pt"
    try:
        t0 = time.monotonic()
        ckpt.save_state_dict(url, sd)
        save_s = time.monotonic() - t0
        nbytes = len(blobio.read_bytes(url))  # the stored bytes, not a copy
        t0 = time.monotonic()
        back = ckpt.load(url)
        load_s = time.monotonic() - t0
        check(sorted(back) == sorted(sd) and all(
            torch.equal(back[k], sd[k]) for k in sd),
            "mem:// checkpoint bit-equal")
    finally:
        del sd
        blobio._SCHEMES["mem"].clear()  # 0.8 GB held for the process
    emit({"phase": "host_tier", "build_s": build_s, "probe_s": probe_s,
          "volume": list(pair.shape), "patches": len(grid),
          "tiff_write_ms": write_ms,
          "tiff_read_ms": {"native": read_ms, "numpy": read_plain_ms},
          "cut_ms": {"native": cut_ms, "numpy": cut_plain_ms},
          "blend_ms": {"native": blend_ms, "numpy": blend_plain_ms},
          "blend_max_abs_diff": blend_err, "pipeline": share,
          "mem_checkpoint": {"bytes": nbytes, "save_s": save_s,
                             "load_s": load_s, "bit_equal": True}})


def phase_quality_tools(seed: int) -> dict:
    """The quality tools' phases in order, with the host tier after
    volume_quality; the launches of each path."""
    tmp = tempfile.mkdtemp(prefix="quality_")
    counts = {"e2e_learning": phase_e2e_learning(seed)}
    (counts["respacing_full_width"], counts["respacing_full_width_int8"],
     ckpt) = phase_respacing_full_width(seed, tmp)
    counts["respacing_debug"] = phase_respacing_debug(seed, tmp)
    counts.update(phase_volume_quality(seed, tmp, ckpt))
    phase_host_tier(seed, os.path.join(tmp, "vq"))
    counts["seg_int8_check"] = phase_seg_int8_check(seed, tmp)
    return counts



def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--parent-s8", metavar="FILE",
                    help="a previous csrc/conv3d_s8.cu (same C entry point) "
                         "to time beside K5 at the timed int8 sites")
    ap.add_argument("--parent-conv", metavar="FILE",
                    help="a previous csrc/conv3d.cu whose bf16 mma.sync conv "
                         "(conv3d_ndhwc_launch) is timed beside the narrow "
                         "kernel's Cin = 1, Cin 3 to 7 and gather "
                         "instances on the same inputs")
    ap.add_argument("--parent-gn", metavar="FILE",
                    help="a previous csrc/groupnorm.cu whose K1 without "
                         "the fold, gn_stats_launch (x, part, ticket, "
                         "stats, ...), is timed beside K1 and its sums "
                         "held equal to K1's")
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
    # the guided-sampling path's GroupNorms are checked with the serving
    # path's (its other work is PyTorch calls)
    guided = _guided_models(args.seed)
    # the Seg models of every Seg phase, built once, on the host
    seg_models = _seg_models(args.seed)
    conv_shapes, gn_shapes = main_path_shapes(model)
    # the Seg models' shapes join the main path's (K1/K2/K3/K5 at each)
    seg_convs, seg_gns, seg_s8 = seg_path_shapes(seg_models)
    # and so do the spatial phases' shard shapes (K1-K5 on haloed rows;
    # the Seg models' input convs on sm90_cin1, sm90_narrow, sm90_smallcin)
    sp = spatial_path_shapes(args.seed, model, fused, int8m, SPATIAL_SHARDS)
    sps = spatial_seg_path_shapes(seg_models, SPATIAL_SHARDS)
    f32_shapes = f32_path_shapes(args.seed, seg_models)
    fused_shapes = fused_path_shapes(fused)
    s8_shapes = int8_path_shapes(int8m)
    emit({"phase": "spatial_shapes", "shards": SPATIAL_SHARDS,
          **{k: len(v) for k, v in sp.items()},
          "new": {k: len(v - set(old)) for k, v, old in (
              ("conv", sp["conv"], conv_shapes),
              ("fused", sp["fused"], fused_shapes),
              ("fused_f32", sp["fused_f32"], f32_shapes["fused"]),
              ("gn", sp["gn"], gn_shapes), ("s8", sp["s8"], s8_shapes))}})
    # the Seg shard shapes no other list holds, and each conv's route
    emit({"phase": "spatial_seg_shapes", "shards": SPATIAL_SHARDS,
          **{k: len(v) for k, v in sps.items()},
          "new": {k: len(sps[k] - set(old) - seg - sp[k]) for k, old, seg in (
              ("conv", conv_shapes, seg_convs), ("gn", gn_shapes, seg_gns),
              ("s8", s8_shapes, seg_s8))},
          "conv_routes": dict(collections.Counter(
              _shape_route(c) for c in sps["conv"]))})
    conv_shapes = sorted(set(conv_shapes) | seg_convs | sp["conv"]
                         | sps["conv"], key=str)
    gn_shapes = sorted(set(gn_shapes) | guided_path_gn_shapes(*guided)
                       | seg_gns | sp["gn"] | sps["gn"], key=str)
    f32_shapes["fused"] = sorted(set(f32_shapes["fused"]) | sp["fused_f32"])
    summary = phase_kernels(gen, conv_shapes, gn_shapes,
                            gn_parent=libs.get("gn_parent"))
    summary.update(phase_conv3d_cu(gen, f32_shapes,
                                   conv_parent=libs.get("conv_parent")))
    summary["conv3d_fused"] = phase_fused_kernels(
        gen, sorted(set(fused_shapes) | sp["fused"], key=str))
    summary["gn_fold"] = phase_fold_launch(gen, fused)
    summary.update(phase_s8_kernels(
        gen, sorted(set(s8_shapes) | seg_s8 | sp["s8"] | sps["s8"]), libs))
    from ddpm3d_tpu_torch.models.factory import create_gaussian_diffusion
    train_sched, train_cfg = create_gaussian_diffusion(
        steps=1000, learn_sigma=True, noise_schedule="linear")
    bwd = phase_backward(gen, *training_shapes(model, train_sched, train_cfg))
    model_counts = phase_model(args.seed)
    model_counts["model_f32_timed"] = phase_model_f32_timed(args.seed)
    phase_gn_fold_route(model)
    phase_model_int8(args.seed)
    denoise_counts, volume, eps = phase_denoise(model, sched, cfg, args.seed)
    phase_profile(model)
    serving_counts = phase_dpm(model, args.seed)
    serving_counts["distributed"] = phase_distributed(
        model, sched, cfg, args.seed, volume)
    serving_counts["spatial_one_rank"] = phase_spatial_one_rank(
        model, sched, cfg, args.seed, volume)
    serving_counts["cli"] = phase_cli(model, args.seed)
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
    spatial_counts = phase_spatial(args.seed, model, fused, int8m, sched,
                                   cfg)
    spatial_counts.update(phase_spatial_seg(args.seed, seg_models))
    del model, fused, int8m
    torch.cuda.empty_cache()
    attention, attention_counts = phase_attention(args.seed)
    attention_denoise_counts = phase_denoise(
        attention, sched, cfg, args.seed, phase="attention_denoise")[0]
    del attention
    torch.cuda.empty_cache()
    classifier_counts = phase_classifier_sample(args.seed, *guided)
    del guided
    torch.cuda.empty_cache()
    seg_counts = phase_seg(args.seed, seg_models)
    seg_counts.update(phase_seg(args.seed, seg_models, phase="seg_6c"))
    seg_counts["seg_denoise"] = phase_denoise(
        seg_models["add"].cuda(), sched, cfg, args.seed,
        phase="seg_denoise")[0]
    del seg_models
    torch.cuda.empty_cache()
    seg_counts["seg_train"] = phase_seg_train(args.seed)
    seg_counts["denoise_int8_calibrated"] = phase_calibrate(args.seed)
    seg_counts["eps_calibration"] = phase_eps_calibration(args.seed)
    phase_evaluate(args.seed, volume)
    quality_counts = phase_quality_tools(args.seed)
    train = phase_train(args.seed)
    phase_train_profile(train.pop("loop"))
    train_ddp_counts = phase_train_ddp(args.seed)
    distill_counts = phase_distill(args.seed)

    summary["conv3d_dx"] = bwd["conv3d_dx"]
    summary["conv3d_head_dx"] = bwd["conv3d_head_dx"]
    kernels = []
    for name, meta in KERNELS.items():
        s = summary[name]
        count = ((lambda c: c.get(name, 0)) if name not in ROUTE_OF
                 else (lambda c: c["routes"].get(ROUTE_OF[name], 0)))
        by_path = {"denoise": count(denoise_counts),
                   "denoise_fused": count(fused_counts),
                   "denoise_int8": count(int8_counts),
                   "denoise_int8_static": count(static_counts),
                   "train": count(train["launches"]),
                   "train_ddp": count(train_ddp_counts),
                   "distill": count(distill_counts),
                   "attention": count(attention_counts),
                   "attention_denoise": count(attention_denoise_counts),
                   "classifier_sample": count(classifier_counts),
                   **{path: count(c) for path, c in serving_counts.items()},
                   **{path: count(c) for path, c in spatial_counts.items()},
                   **{path: count(c) for path, c in model_counts.items()},
                   **{path: count(c) for path, c in seg_counts.items()},
                   **{path: count(c) for path, c in quality_counts.items()}}
        main_path = {"conv3d_fused": "denoise_fused",
                     "conv3d_s8": "denoise_int8",
                     "conv1x1_s8": "denoise_int8",
                     "conv3d_cin1": "seg",
                     "conv3d_smallcin": "seg_6c",
                     "conv3d_f32": "model",
                     "conv3d_f32_dx": "model_grads",
                     "conv3d_fused_f32": "model_fused",
                     "gn_fold": "denoise_fused"}.get(name, "train")
        check(by_path[main_path] > 0,
              f"{name} launched on its path {main_path}")
        extra = {}
        if name == "conv3d_fused":  # serving only: no single library call
            extra["unfused_sequence_ms"] = s["unfused_sequence_ms"]
            extra["routes_by_path"] = {
                path: {k: v for k, v in c["routes"].items()
                       if k.startswith("conv3d_fused.")}
                for path, c in (("denoise", denoise_counts),
                                ("denoise_fused", fused_counts),
                                ("denoise_int8", int8_counts),
                                ("train", train["launches"]))}
        if name == "gn_stats":  # the parent's K1 (or None), K1's fold
            extra["parent_ms"] = s["parent_ms"]
            for k in ("device_ms", "fold_ms", "fold_device_ms",
                      "torch_fold_ms", "parent_device_ms", "fold_ulps"):
                extra[k] = s.get(k)
        if name == "gn_fold":  # device ms alone, the worst ulps
            extra["device_ms"] = s["device_ms"]
            extra["fold_max_ulps"] = s["fold_max_ulps"]
        if name == "conv3d_s8":  # the bf16 conv it replaces at that site
            extra["k3_bf16_ms"] = s["k3_bf16_ms"]
            extra["parent_ms"] = s.get("parent_ms")
            extra["device_ms"] = s["device_ms"]
            extra["parent_device_ms"] = s.get("parent_device_ms")
        if name == "conv1x1_s8":
            # the previous K5's no-halo instance (--parent-s8, else None),
            # the three timed sites and every 1x1 shape alone, and both
            # int8 kernels' launches (launch_counts' "conv3d_s8")
            extra["parent_ms"] = s.get("parent_ms")
            extra["library"] = s.get("library")
            extra["device_ms"] = s["device_ms"]
            extra["library_device_ms"] = s["library_device_ms"]
            extra["parent_device_ms"] = s["parent_device_ms"]
            extra["shape"] = s["shape"] + [s["n"], s["dtype"]]
            extra["timed_sites"] = s["timed_sites"]
            extra["shapes_ms"] = s["shapes_ms"]
            extra["int8_launches_by_path"] = {
                path: c["conv3d_s8"] for path, c in (
                    ("denoise_int8", int8_counts),
                    ("denoise_int8_static", static_counts))}
        if name in ("conv3d_narrow", "conv3d_head", "conv3d_head_dx"):
            extra[_general_key(s["dtype"])] = s[_general_key(s["dtype"])]
        if name == "conv3d_smallcin":  # the other timed Cin, the gather's
            extra["cin_rows"] = s["cin_rows"]
        if name in ("conv3d_cin1", "conv3d_f32", "conv3d_f32_dx",
                    "conv3d_fused_f32", "conv3d_smallcin"):
            extra["shape"] = s["shape"] + [s["cout"], s["dtype"]]
        if name in ("conv3d_cin1", "conv3d_smallcin"):
            # the retired mma.sync conv on the same inputs (--parent-conv)
            extra["parent_ms"] = s["parent_ms"]
        if name == "conv3d_head_dx":  # F.conv3d on the flipped weight
            extra["conv_call_ms"] = s["conv_call_ms"]
        if name in ("conv3d", "conv3d_dx"):
            # the general kernel on the same inputs, and each path's
            # launches by route (ops.route_counts)
            extra[_general_key(s["dtype"])] = s[_general_key(s["dtype"])]
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
    emit({"phase": "total", "seconds": time.monotonic() - T_START})
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
