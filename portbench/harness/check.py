"""The comparison that decides ``correct``, from the readings of
:func:`.serve.judge`, each the worst over the checked calls, steps and
patches:

- ``start_max_abs``: the chain's first state against the harness's x_T
  (exact: limit 0);
- ``out_rel_l2``: ||program output - reference output|| / ||reference
  output|| of the model at the program's state of a step;
- ``step_rel_l2``: the same of the next state against the reference's
  ancestral step from that state with the same noise;
- ``site_rel_l2`` (where the cell judges sites): the same of each conv
  site's output planes against the reference's site on the program's own
  input planes.

A run is correct when every number is finite and at most its limit (the
cell's ``limits``), and every checked call came back. A number without a
limit cannot pass.
"""

from __future__ import annotations

import math
from typing import Dict


def compare(readings: Dict[str, float],
            limits: Dict[str, float]) -> Dict[str, dict]:
    """{name: {"value", "limit"}} for every number compared."""
    return {name: {"value": v, "limit": limits.get(name)}
            for name, v in readings.items()}


def is_correct(compared: Dict[str, dict]) -> bool:
    return bool(compared) and all(
        c["limit"] is not None and math.isfinite(c["value"])
        and c["value"] <= c["limit"] for c in compared.values())
