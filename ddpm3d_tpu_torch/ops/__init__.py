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
* :mod:`.groupnorm` — GroupNorm stats and fused normalize/FiLM/SiLU
  (``csrc/groupnorm.cu``);
* :mod:`.conv3d_s8` — the int8 (s8 x s8 -> s32) conv with its dequantize
  epilogue (``csrc/conv3d_s8.cu`` for 3x3x3 kernels, ``csrc/conv1x1_s8.cu``
  for 1x1x1 ones; wgmma s8 fed by TMA), under :mod:`.quant`
  (int8 serving) and
  :mod:`.phase_up` (the up sites' phase kernels).
"""

from typing import Dict

from . import conv3d, conv3d_fused, conv3d_s8, groupnorm
from .quant import quantize_act, quantize_kernel, static_scales


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return {
        "conv3d": conv3d.launches,
        "conv3d_dx": conv3d.dx_launches,
        "conv3d_fused": conv3d_fused.launches,
        "conv3d_s8": conv3d_s8.launches,
        "gn_stats": groupnorm.stats_launches,
        "gn_apply": groupnorm.apply_launches,
    }


def route_counts() -> Dict[str, int]:
    """The conv launches of :func:`launch_counts` by kernel route
    ("conv3d.<route>" and "conv3d_dx.<route>" for each of
    :data:`.conv3d.ROUTES`, "conv3d_fused.<route>" for each of
    :data:`.conv3d_fused.ROUTES`, "conv3d_s8.<route>" for each of
    :data:`.conv3d_s8.ROUTES`)."""
    counts = {f"{what}.{route}": conv3d.route_launches.get(f"{what}.{route}", 0)
              for what in ("conv3d", "conv3d_dx") for route in conv3d.ROUTES}
    counts.update({f"conv3d_fused.{route}": conv3d_fused.route_launches.get(
        f"conv3d_fused.{route}", 0) for route in conv3d_fused.ROUTES})
    counts.update({f"conv3d_s8.{route}": conv3d_s8.route_launches.get(
        f"conv3d_s8.{route}", 0) for route in conv3d_s8.ROUTES})
    return counts


def reset_launch_counts() -> None:
    conv3d.route_launches.clear()
    conv3d_fused.route_launches.clear()
    conv3d_s8.route_launches.clear()
    conv3d.launches = 0
    conv3d.dx_launches = 0
    conv3d_fused.launches = 0
    conv3d_s8.launches = 0
    groupnorm.stats_launches = 0
    groupnorm.apply_launches = 0
