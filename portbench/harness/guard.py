"""The benchmark measures the PyTorch port alone: no module of JAX, of its
libraries or of the JAX package may be loaded in the process that prints
the result. Names are compared whole, by their top-level part (the port's
``ddpm3d_tpu_torch`` begins with the JAX package's ``ddpm3d_tpu``)."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "ddpm3d_tpu"})


def forbidden_modules(names: Iterable[str] = None) -> List[str]:
    """The forbidden top-level names among ``names`` (default: the loaded
    modules)."""
    names = sys.modules if names is None else names
    return sorted({n.split(".", 1)[0] for n in names} & FORBIDDEN)
