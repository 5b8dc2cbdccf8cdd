"""Hand-written Hopper kernels and their plain PyTorch versions.

* :mod:`.conv3d` — stride-1 SAME 3x3x3 conv, forward and the dx of its
  backward: ``csrc/conv3d_sm90.cu`` (bf16, wgmma/TMA),
  ``csrc/conv3d_narrow.cu`` (bf16 with Cin not a multiple of 8: the
  input convs, and a gather instance for Cin above 8), ``csrc/conv3d_head.cu``
  (f32 with Cout <= 8: the head conv; f32 with Cin = 2: the head's dx) or
  ``csrc/conv3d_f32.cu`` (the other f32 convs, FFMA), by
  :func:`.conv3d.conv3d_route`;
* :mod:`.conv3d_fused` — the fused ResBlock conv (GN/FiLM/SiLU prologue,
  bias/skip epilogue, next-GN stats): bf16 on the fused instance of
  ``csrc/conv3d_sm90.cu`` (wgmma/TMA), f32 on that of
  ``csrc/conv3d_f32.cu``, by :func:`.conv3d_fused.conv3d_fused_route`;
* :mod:`.groupnorm` — GroupNorm stats with the fold into the affine, and
  the fused normalize/FiLM/SiLU (``csrc/groupnorm.cu``);
* :mod:`.conv3d_s8` — the int8 (s8 x s8 -> s32) conv with its dequantize
  epilogue (``csrc/conv3d_s8.cu`` for 3x3x3 kernels, ``csrc/conv1x1_s8.cu``
  for 1x1x1 ones; wgmma s8 fed by TMA), under :mod:`.quant`
  (int8 serving) and
  :mod:`.phase_up` (the up sites' phase kernels).
"""

from typing import Dict

from ..utils import tracing
from . import conv3d, conv3d_fused, conv3d_s8, groupnorm
from .quant import quantize_act, quantize_kernel, static_scales

KERNELS = ("conv3d", "conv3d_dx", "conv3d_fused", "conv3d_s8", "gn_stats",
           "gn_apply", "gn_fold")


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts` (the
    recorder's ``launch.<kernel>`` counters)."""
    got = tracing.counters("launch.")
    return {k: got.get(f"launch.{k}", 0) for k in KERNELS}


def route_counts() -> Dict[str, int]:
    """The conv launches of :func:`launch_counts` by kernel route
    ("conv3d.<route>" and "conv3d_dx.<route>" for each of
    :data:`.conv3d.ROUTES`, "conv3d_fused.<route>" for each of
    :data:`.conv3d_fused.ROUTES`, "conv3d_s8.<route>" for each of
    :data:`.conv3d_s8.ROUTES`; the recorder's ``route.<kernel>.<route>``
    counters)."""
    got = tracing.counters("route.")
    keys = [f"{what}.{route}" for what, routes in (
        ("conv3d", conv3d.ROUTES), ("conv3d_dx", conv3d.ROUTES),
        ("conv3d_fused", conv3d_fused.ROUTES), ("conv3d_s8", conv3d_s8.ROUTES))
        for route in routes]
    return {k: got.get(f"route.{k}", 0) for k in keys}


def fold_counts() -> Dict[str, int]:
    """The GroupNorm folds since the last :func:`reset_launch_counts` by
    where they ran, each of :data:`.groupnorm.FOLD_ROUTES`: "k1" inside K1
    (``route.gn_fold.k1``), "launch" in the fold's own launch (its launch
    count, "gn_fold" of :func:`launch_counts`), "torch" in torch ops
    (``route.gn_fold.torch``)."""
    got = tracing.counters("route.gn_fold.")
    return {"k1": got.get("route.gn_fold.k1", 0),
            "launch": launch_counts()["gn_fold"],
            "torch": got.get("route.gn_fold.torch", 0)}


def reset_launch_counts() -> None:
    tracing.reset_counters("launch.")
    tracing.reset_counters("route.")


def counter_report() -> Dict[str, Dict[str, int]]:
    """The whole registry as the CLIs log it at the end of a run:
    ``launches`` (:func:`launch_counts`), ``routes`` (:func:`route_counts`),
    ``folds`` (:func:`fold_counts`) and ``counters``, every other counter
    (weight repacks, int8 requantizations, kernel builds, spatial
    collectives)."""
    return {"launches": launch_counts(), "routes": route_counts(),
            "folds": fold_counts(),
            "counters": {k: v for k, v in tracing.counters().items()
                         if not k.startswith(("launch.", "route."))}}
