"""The device trace of a traced window, and the reductions the per-layer
readers take from it.

The harness opens ``record_function`` ranges from module hooks (``pb.*``
names) while ``torch.profiler`` records. A device activity (kernel, copy,
set) belongs to a range when the host launched it while that range was
open: its correlation id leads to the runtime call that launched it, and
that call's host time lies inside the range. Time in a range is the sum of
its activities' device time, whatever their names, so a fused or renamed
kernel still counts as the same layer's work.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from typing import Dict, List, Optional, Tuple

from .families import family_of

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class Ranges:
    """The host intervals (us) of one ``pb.*`` range name, sorted; ranges
    of one name never overlap."""

    def __init__(self, spans: List[Tuple[float, float]]):
        self.spans = sorted(spans)
        self.starts = [s for s, _ in self.spans]

    def index(self, t: Optional[float]) -> int:
        """The range that holds host time ``t``, or -1."""
        if t is None:
            return -1
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and t <= self.spans[i][1]:
            return i
        return -1

    def __len__(self):
        return len(self.spans)


class Trace:
    """Device activities ``(start_us, end_us, name, cat, launch host us)``
    and the harness's ranges, from a chrome trace's events."""

    def __init__(self, events: List[dict]):
        launches: Dict[int, float] = {}
        spans: Dict[str, List[Tuple[float, float]]] = {}
        acts = []
        for ev in events:
            if ev.get("ph") != "X":
                continue
            cat = ev.get("cat", "")
            ts, dur = float(ev.get("ts", 0.0)), float(ev.get("dur", 0.0))
            args = ev.get("args") or {}
            if cat in DEVICE_CATS:
                acts.append((ts, ts + dur, ev.get("name", ""), cat,
                             args.get("correlation")))
            elif cat in LAUNCH_CATS and "correlation" in args:
                launches[args["correlation"]] = ts
            elif cat == "user_annotation" and ev.get("name", "").startswith(
                    "pb."):
                spans.setdefault(ev["name"], []).append((ts, ts + dur))
        self.activities = sorted(
            (s, e, n, c, launches.get(corr)) for s, e, n, c, corr in acts)
        self.ranges = {k: Ranges(v) for k, v in spans.items()}

    def range(self, name: str) -> Ranges:
        return self.ranges.get(name, Ranges([]))

    def busy(self, t0: float, t1: float) -> List[Tuple[float, float]]:
        """The union of device activity intervals clipped to [t0, t1]."""
        merged: List[List[float]] = []
        for s, e, *_ in self.activities:
            s, e = max(s, t0), min(e, t1)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]


def record(profiler) -> Trace:
    """The trace of a stopped ``torch.profiler.profile``, through a chrome
    trace file in the temporary directory (deleted after)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        profiler.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.remove(path)
    return Trace(data.get("traceEvents", data) if isinstance(data, dict)
                 else data)


def window(tr: Trace) -> Tuple[float, float]:
    """The traced window's host interval (the ``pb.window`` range)."""
    spans = tr.range("pb.window").spans
    return (spans[0][0], spans[-1][1]) if spans else (0.0, 0.0)


def breakdown(tr: Trace, families: Dict[str, tuple], top: int = 10) -> dict:
    """The device operations that took most time in the window, by kernel
    family (or name), and the idle gaps by what the host was doing."""
    t0, t1 = window(tr)
    ops: Dict[str, float] = {}
    for s, e, name, cat, _ in tr.activities:
        if e <= t0 or s >= t1:
            continue
        key = family_of(name, families) if cat == "kernel" else cat
        ops[key] = ops.get(key, 0.0) + (min(e, t1) - max(s, t0)) / 1e6
    gaps: Dict[str, float] = {}
    prev = t0
    for s, e in tr.busy(t0, t1) + [(t1, t1)]:
        if s > prev:
            label = host_doing(tr, (prev + s) / 2)
            gaps[label] = gaps.get(label, 0.0) + (s - prev) / 1e6
        prev = max(prev, e)
    order = lambda d: sorted(([k, v] for k, v in d.items()),  # noqa: E731
                             key=lambda kv: -kv[1])[:top]
    return {"device_ops": order(ops), "idle_gaps": order(gaps)}


HOST_LABELS = (("pb.conv", "host in a conv site"),
               ("pb.gn", "host in a GroupNorm"),
               ("pb.forward", "host in the forward, other"),
               ("pb.call", "host in the chain, outside the forward"))


def host_doing(tr: Trace, t: float) -> str:
    for name, label in HOST_LABELS:
        if tr.range(name).index(t) >= 0:
            return label
    return "host between calls"


def device_s(tr: Trace, inside: str, outside: Tuple[str, ...] = (),
             kernels_only: bool = False) -> float:
    """Seconds of device time of the activities launched inside an
    ``inside`` range and inside none of the ``outside`` ones."""
    rin = tr.range(inside)
    routs = [tr.range(n) for n in outside]
    total = 0.0
    for s, e, _, cat, t in tr.activities:
        if kernels_only and cat != "kernel":
            continue
        if rin.index(t) < 0 or any(r.index(t) >= 0 for r in routs):
            continue
        total += e - s
    return total / 1e6
