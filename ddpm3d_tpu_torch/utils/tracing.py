"""Spans and counters of the port's host path: one recorder per process.

Spans name where the host spends its time, ``ddpm.<layer>[.<part>]``, each
opened in the layer's own code (the pipeline, the sampler, the model's
forward, each GroupNorm and conv site, the spatial collectives, the kernel
build). They are off by default: :func:`span` then reads one module flag and
returns a shared null context, recording nothing. :func:`enable` turns them
on: each span keeps ``(name, start_ns, end_ns, parent, call)`` in memory on
``time.perf_counter_ns()``, ``parent`` the index of the span it opened in
(-1: none) and ``call`` the id the pipeline sets per ``denoise_patches``
call (:func:`new_call`). While a ``torch.profiler`` collects, an enabled
span also opens ``torch.profiler.record_function(name)``, so the device
trace holds the same ranges on its own clock; :func:`unix_us` puts an
in-memory time on that clock (a chrome trace's ``ts`` plus its
``baseTimeNanoseconds`` / 1e3 is unix time in microseconds). Spans are
meant for one thread, the one that drives the chain.

Counters (:func:`count`) are always on: the hand-written kernels' launches
(``launch.<kernel>``) and routes (``route.<kernel>.<route>``, read through
:func:`..ops.launch_counts` and :func:`..ops.route_counts`), the spatial
group's collectives (``spatial.<op>``), weight repacks and requantizations
on a cache miss (``pack.miss``, ``int8.requant``) and the kernel libraries
compiled and loaded (``build.compiled``, ``build.loaded``).
"""

from __future__ import annotations

import collections
import time
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple

import torch


class Span(NamedTuple):
    name: str
    start_ns: int  # time.perf_counter_ns()
    end_ns: int
    parent: int    # index of the enclosing span in the same list; -1: none
    call: int      # the pipeline's call id when the span opened


class _Null:
    """The context :func:`span` returns while spans are off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return False


_NULL = _Null()
_on = False
_anchor = (0, 0)            # (perf_counter_ns, time_ns) read at enable()
# (name, start, end, parent, call) in the order the spans opened; an open
# span's slot holds None. Tuples of strings and ints: the garbage collector
# stops tracking them, so a long record costs its collections nothing.
_spans: List[Optional[tuple]] = []
_stack: List[int] = []      # indices of the open spans
_call = 0
_counts: Dict[str, int] = collections.defaultdict(int)


class _Open:
    """An enabled span: its slot taken on entry, filled on exit."""

    __slots__ = ("name", "index", "parent", "call", "start", "rf")

    def __init__(self, name: str):
        self.name = name
        self.index = len(_spans)
        self.parent = _stack[-1] if _stack else -1
        self.call = _call
        self.rf = None
        _spans.append(None)

    def __enter__(self):
        _stack.append(self.index)
        self.start = time.perf_counter_ns()
        if torch._C._autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        return None

    def __exit__(self, exc_type, exc, tb):
        if self.rf is not None:
            self.rf.__exit__(exc_type, exc, tb)
        _spans[self.index] = (self.name, self.start, time.perf_counter_ns(),
                              self.parent, self.call)
        _stack.pop()
        return False


def span(name: str):
    """A context manager that records the block as span ``name`` while
    spans are on (:func:`enable`); a shared null context otherwise."""
    if not _on:
        return _NULL
    return _Open(name)


def enable() -> None:
    """Turn spans on and read the clock anchor of :func:`unix_us`."""
    global _on, _anchor
    _anchor = (time.perf_counter_ns(), time.time_ns())
    _on = True


def disable() -> None:
    """Turn spans off; what was recorded stays until :func:`drain`."""
    global _on
    _on = False


def enabled() -> bool:
    return _on


def new_call() -> int:
    """Start a new call id (one ``denoise_patches`` call): the spans
    opened from now on carry it. Returns it."""
    global _call
    _call += 1
    return _call


def unix_us(t_ns: int) -> float:
    """A span time (``perf_counter_ns``) as unix time in microseconds, the
    time base of a ``torch.profiler`` chrome trace (``ts`` +
    ``baseTimeNanoseconds`` / 1e3), by the anchor :func:`enable` read."""
    return (t_ns - _anchor[0] + _anchor[1]) / 1e3


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name``."""
    _counts[name] += n


def counters(prefix: str = "") -> Dict[str, int]:
    """The counters whose names start with ``prefix``, sorted by name."""
    return {k: v for k, v in sorted(_counts.items()) if k.startswith(prefix)}


def reset_counters(prefix: str = "") -> None:
    """Zero the counters whose names start with ``prefix``."""
    for k in [k for k in _counts if k.startswith(prefix)]:
        del _counts[k]


def drain(counters_too: bool = True) -> Tuple[List[Span], Dict[str, int]]:
    """The spans recorded (in the order they opened) and every counter;
    clears both, or the spans alone with ``counters_too=False`` (the
    counters then stay and come back empty). Raises while a span is open:
    its children's parent indices would point into the list handed out."""
    if _stack:
        raise RuntimeError(f"{len(_stack)} spans are open")
    spans = [Span(*rec) for rec in _spans]
    _spans.clear()
    got = {}
    if counters_too:
        got = counters()
        _counts.clear()
    return spans, got


def self_ms(spans: List[Span], name: str,
            children: Iterable[str] = ()) -> float:
    """Milliseconds inside the spans called ``name``, less what the spans
    called one of ``children`` nested in them cover (the outermost such at
    any depth; spans of one thread nest, so those never overlap)."""
    children = set(children) - {name}
    total = 0
    for s in spans:
        if s.name == name:
            total += s.end_ns - s.start_ns
        elif s.name in children:
            p = s.parent
            while p >= 0 and spans[p].name != name and (
                    spans[p].name not in children):
                p = spans[p].parent
            if p >= 0 and spans[p].name == name:
                total -= s.end_ns - s.start_ns
    return total / 1e6
