"""Kernel families of a trace breakdown, by substrings of the device
kernels' names (copied from ``chip_smoke.py``'s ``FORWARD_FAMILIES`` and
``INT8_FAMILIES``). A breakdown only: no metric's yardstick depends on a
kernel's name."""

from __future__ import annotations

from typing import Dict

FAMILIES = {
    # the fused instances of the sm90 conv and their stats finish first, so
    # that the conv families below take only the plain conv
    "conv3d_fused": ("conv3d_sm90_kernel<1, true>",
                     "conv3d_sm90_kernel<2, true>",
                     "conv3d_sm90_kernelILi1ELb1E",
                     "conv3d_sm90_kernelILi2ELb1E", "fused_stats_finish"),
    "conv3d_sm90": ("conv3d_sm90_kernel",),
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
    "conv3d_s8": ("conv3d_s8_kernel",),
    "conv1x1_s8": ("conv1x1_s8_kernel",),
    # the int8 quantize glue: the per-sample abs-max, the f32 division,
    # round and clamp (the cast to int8 is a plain copy kernel)
    "quantize": ("MinMax", "minmax", "DivFunctor", "div_true", "round_kernel",
                 "clamp"),
}


def family_of(name: str, families: Dict[str, tuple] = FAMILIES) -> str:
    """The family of a kernel name, or the name itself cut to 60 characters."""
    for fam, pats in families.items():
        if any(p in name for p in pats):
            return fam
    return name[:60]
