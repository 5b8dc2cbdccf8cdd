"""The 95th percentile of the chain steps' device-timeline intervals (one
served forward's end to the next within a chain, CUDA events recorded by a
forward hook) over the traced run's untraced calls: recurring stalls that
the rate averages away; ms."""

import numpy as np


def read(rec):
    ms = rec.get("step_ms") or []
    return float(np.percentile(ms, 95)) if ms else None
