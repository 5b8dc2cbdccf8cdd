"""Hand-written Hopper kernels and their plain PyTorch versions.

* :mod:`.conv3d` — stride-1 SAME 3x3x3 conv (``csrc/conv3d.cu``);
* :mod:`.groupnorm` — GroupNorm stats and fused normalize/FiLM/SiLU
  (``csrc/groupnorm.cu``).
"""

from typing import Dict

from . import conv3d, groupnorm


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return {
        "conv3d": conv3d.launches,
        "gn_stats": groupnorm.stats_launches,
        "gn_apply": groupnorm.apply_launches,
    }


def reset_launch_counts() -> None:
    conv3d.launches = 0
    groupnorm.stats_launches = 0
    groupnorm.apply_launches = 0
