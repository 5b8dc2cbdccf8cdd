"""Model weights drawn from the run's seed on the device, in one call.

One uniform draw in [-1, 1) covers every parameter; each parameter takes
its slice, scaled by its kind:

- conv and 1x1 weights, dense weights: ``sqrt(3 / fan_in)`` (variance
  1 / fan_in), the output convs included (none is zeroed);
- biases: 0.1;
- GroupNorm scales: ``1 + 0.2 u``, GroupNorm shifts ``0.2 u``;
- with a learned variance, the head's variance rows (weights and bias)
  a further 0.25: its output v then spreads as a trained one does (std
  about 0.13, |v| under 2), inside the [-1, 1] range the learned-range
  variance interpolates over. Unscaled, random weights give |v| up to 50,
  and ``exp`` of the extrapolated log-variance turns v's last-bit
  differences into whole percents of a step (PERF.md, the check).

So every term of the forward is non-zero. Which parameters are norms and
which the head is the reference module's ``weight_rules``. The same seed
gives the same weights on the same device type; the program and the
reference take the same tensors, and the reference's copy is drawn again
after the program is freed.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

BIAS = 0.1
NORM = 0.2
VAR_HEAD = 0.25


def make_weights(shapes: Dict[str, Tuple[int, ...]], seed: int, device,
                 rules: dict) -> Dict[str, torch.Tensor]:
    """f32 parameters {name: tensor} on ``device`` from ``seed``. ``rules``:
    ``norm_suffixes`` (the GroupNorm affines' names end so), ``head`` (the
    head's parameter names) and ``var_rows`` (with a learned variance, the
    head's rows from there on are the variance head's; 0: none)."""
    norms, head = tuple(rules["norm_suffixes"]), tuple(rules["head"])
    var_rows = rules["var_rows"]
    total = sum(math.prod(s) for s in shapes.values())
    g = torch.Generator(device=device)
    g.manual_seed(seed & 0x7FFF_FFFF_FFFF_FFFF)
    u = torch.rand(total, generator=g, device=device).mul_(2.0).sub_(1.0)
    out, off = {}, 0
    for name in sorted(shapes):
        shape = shapes[name]
        n = math.prod(shape)
        v = u[off:off + n].view(shape)
        off += n
        if name.endswith(norms):
            v = v.mul_(NORM).add_(1.0 if name.endswith("weight") else 0.0)
        elif len(shape) == 1:
            v = v.mul_(BIAS)
        else:
            v = v.mul_(math.sqrt(3.0 / math.prod(shape[1:])))
        if var_rows and name in head:
            v[var_rows:] *= VAR_HEAD
        out[name] = v
    return out
