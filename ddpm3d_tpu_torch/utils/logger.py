"""Key-value metrics logger with human, JSON, CSV and TensorBoard writers.

Own copy of ``ddpm3d_tpu/utils/logger.py`` (the reference's
OpenAI-baselines logger API and file formats): ``logkv`` (last wins),
``logkv_mean`` (running mean), ``dumpkvs``, ``log`` lines at levels
(``debug`` ... ``error``, ``set_level``), ``profile_kv`` / ``profile``
host wall-time scopes (also spans of :mod:`.tracing`), and the boxed human
table, ``progress.json``
lines, the growing ``progress.csv`` and TensorBoard scalars (``tb/``,
through ``torch.utils.tensorboard``, which needs the ``tensorboard``
package: the format raises without it). Formats come from
``format_strs`` or ``$DDPM_LOG_FORMAT`` / ``$OPENAI_LOG_FORMAT`` (default
``stdout,log,csv``). Under a process group only rank 0 writes: the CLIs
configure the other ranks without formats, so there are no per-rank
files. :func:`gather_weighted_means` combines host-local values over the
ranks; :func:`start_trace` / :func:`stop_trace` wrap ``torch.profiler``
with the port's spans on (:mod:`.tracing`).
"""

from __future__ import annotations

import contextlib
import datetime
import functools
import json
import os
import os.path as osp
import sys
import tempfile
import time
from collections import defaultdict
from typing import Any, Dict, List, Optional

from . import tracing

DEBUG = 10
INFO = 20
WARN = 30
ERROR = 40
DISABLED = 50


class KVWriter:
    def writekvs(self, kvs: Dict[str, Any]) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class SeqWriter:
    def writeseq(self, seq) -> None:
        raise NotImplementedError


class HumanOutputFormat(KVWriter, SeqWriter):
    """Boxed ``| key | value |`` table, keys sorted case-insensitively and
    cut to 30 characters; also plain log lines."""

    def __init__(self, filename_or_file):
        if isinstance(filename_or_file, str):
            self.file = open(filename_or_file, "wt")
            self.own_file = True
        else:
            self.file = filename_or_file
            self.own_file = False

    def writekvs(self, kvs):
        if not kvs:
            print("WARNING: tried to write empty key-value dict")
            return
        row_map = {
            self._truncate(k): self._truncate(
                f"{v:<8.3g}" if hasattr(v, "__float__") else str(v))
            for k, v in kvs.items()
        }
        rows = sorted(row_map.items(), key=lambda r: r[0].lower())
        kw = max(len(k) for k, _ in rows)
        vw = max(len(v) for _, v in rows)
        rule = "-" * (kw + vw + 7)
        body = "".join(f"| {k.ljust(kw)} | {v.ljust(vw)} |\n" for k, v in rows)
        self.file.write(f"{rule}\n{body}{rule}\n")
        self.file.flush()

    @staticmethod
    def _truncate(s: str, maxlen: int = 30) -> str:
        return s[: maxlen - 3] + "..." if len(s) > maxlen else s

    def writeseq(self, seq):
        self.file.write(" ".join(seq) + "\n")
        self.file.flush()

    def close(self):
        if self.own_file:
            self.file.close()


class JSONOutputFormat(KVWriter):
    """One JSON object per dump."""

    def __init__(self, filename):
        self.file = open(filename, "wt")

    def writekvs(self, kvs):
        out = {k: float(v) if hasattr(v, "__float__") else v
               for k, v in sorted(kvs.items())}
        self.file.write(json.dumps(out) + "\n")
        self.file.flush()

    def close(self):
        self.file.close()


class CSVOutputFormat(KVWriter):
    """CSV whose header grows as keys appear; earlier rows keep empty cells
    for later columns (the file is rewritten when the columns grow)."""

    def __init__(self, filename):
        self.filename = filename
        self.file = open(filename, "wt")
        self.columns: List[str] = []
        self._rows: List[Dict[str, Any]] = []

    @staticmethod
    def _cell(row: Dict[str, Any], col: str) -> str:
        v = row.get(col)
        return "" if v is None else str(v)

    def _line(self, row) -> str:
        return ",".join(self._cell(row, c) for c in self.columns) + "\n"

    def writekvs(self, kvs):
        new_cols = sorted(k for k in kvs if k not in self.columns)
        self._rows.append(dict(kvs))
        if new_cols:
            self.columns.extend(new_cols)
            self.file.close()
            self.file = open(self.filename, "wt")
            self.file.write(",".join(self.columns) + "\n")
            for row in self._rows:
                self.file.write(self._line(row))
        else:
            self.file.write(self._line(kvs))
        self.file.flush()

    def close(self):
        self.file.close()


class TensorBoardOutputFormat(KVWriter):
    """Scalar summaries, one step per dump starting at 1; values that do
    not convert to float are left out."""

    def __init__(self, logdir):
        from torch.utils.tensorboard import SummaryWriter

        os.makedirs(logdir, exist_ok=True)
        self.step = 1
        self.writer = SummaryWriter(logdir)

    def writekvs(self, kvs):
        for k, v in kvs.items():
            try:
                self.writer.add_scalar(k, float(v), self.step)
            except (TypeError, ValueError):
                pass
        self.step += 1

    def close(self):
        self.writer.close()


def make_output_format(fmt: str, ev_dir: str, log_suffix: str = "") -> KVWriter:
    os.makedirs(ev_dir, exist_ok=True)
    if fmt == "stdout":
        return HumanOutputFormat(sys.stdout)
    if fmt == "log":
        return HumanOutputFormat(osp.join(ev_dir, f"log{log_suffix}.txt"))
    if fmt == "json":
        return JSONOutputFormat(osp.join(ev_dir, f"progress{log_suffix}.json"))
    if fmt == "csv":
        return CSVOutputFormat(osp.join(ev_dir, f"progress{log_suffix}.csv"))
    if fmt == "tensorboard":
        return TensorBoardOutputFormat(osp.join(ev_dir, f"tb{log_suffix}"))
    raise ValueError(f"unknown log format: {fmt}")


class Logger:
    CURRENT: Optional["Logger"] = None

    def __init__(self, dir: Optional[str], output_formats: List[KVWriter]):
        self.name2val: Dict[str, Any] = defaultdict(float)
        self.name2cnt: Dict[str, int] = defaultdict(int)
        self._mean_sum: Dict[str, float] = defaultdict(float)
        self.level = INFO
        self.dir = dir
        self.output_formats = output_formats

    def logkv(self, key, val):
        self.name2val[key] = val

    def logkv_mean(self, key, val):
        self._mean_sum[key] += val
        self.name2cnt[key] += 1
        self.name2val[key] = self._mean_sum[key] / self.name2cnt[key]

    def dumpkvs(self) -> Dict[str, Any]:
        if self.level == DISABLED:
            return {}
        out = self.name2val.copy()
        for fmt in self.output_formats:
            fmt.writekvs(self.name2val)
        self.name2val.clear()
        self.name2cnt.clear()
        self._mean_sum.clear()
        return out

    def log(self, *args, level=INFO):
        if self.level <= level:
            for fmt in self.output_formats:
                if isinstance(fmt, SeqWriter):
                    fmt.writeseq(map(str, args))

    def set_level(self, level):
        self.level = level

    def get_dir(self):
        return self.dir

    def close(self):
        for fmt in self.output_formats:
            fmt.close()


def configure(
    dir: Optional[str] = None,
    format_strs: Optional[List[str]] = None,
    log_suffix: str = "",
) -> Logger:
    """Make the current logger writing under ``dir`` (else $DDPM_LOGDIR /
    $OPENAI_LOGDIR, else a fresh timestamped directory under the temp dir)
    and return it."""
    if not dir:
        dir = os.getenv("DDPM_LOGDIR") or os.getenv("OPENAI_LOGDIR")
    if not dir:
        dir = osp.join(
            tempfile.gettempdir(),
            datetime.datetime.now().strftime("ddpm3d-%Y-%m-%d-%H-%M-%S-%f"),
        )
    os.makedirs(dir, exist_ok=True)
    if format_strs is None:
        format_strs = (os.getenv("DDPM_LOG_FORMAT")
                       or os.getenv("OPENAI_LOG_FORMAT")
                       or "stdout,log,csv").split(",")
    if Logger.CURRENT is not None:
        Logger.CURRENT.close()
    Logger.CURRENT = Logger(dir, [make_output_format(f, dir, log_suffix)
                                  for f in format_strs if f])
    log(f"Logging to {dir}")
    return Logger.CURRENT


def _current() -> Logger:
    if Logger.CURRENT is None:
        configure(format_strs=["stdout"])
    return Logger.CURRENT


def logkv(key, val):
    _current().logkv(key, val)


def logkv_mean(key, val):
    _current().logkv_mean(key, val)


def logkvs(d):
    for k, v in d.items():
        logkv(k, v)


def dumpkvs():
    return _current().dumpkvs()


def getkvs():
    return _current().name2val


def log(*args, level=INFO):
    _current().log(*args, level=level)


def debug(*args):
    log(*args, level=DEBUG)


def info(*args):
    log(*args, level=INFO)


def warn(*args):
    log(*args, level=WARN)


def error(*args):
    log(*args, level=ERROR)


def set_level(level):
    _current().set_level(level)


def get_dir():
    return _current().get_dir()


record_tabular = logkv
dump_tabular = dumpkvs


@contextlib.contextmanager
def profile_kv(scopename: str):
    """Add the host wall time of the block to ``wait_<scopename>`` (no
    device sync: queued GPU work is not waited for) and record it as the
    span ``ddpm.wait.<scopename>`` (:mod:`.tracing`, on its clock)."""
    logkey = "wait_" + scopename
    with tracing.span("ddpm.wait." + scopename):
        tstart = time.perf_counter()
        try:
            yield
        finally:
            _current().name2val[logkey] += time.perf_counter() - tstart


def profile(n: str):
    """Decorator form of :func:`profile_kv`."""

    def decorator_with_name(func):
        @functools.wraps(func)
        def func_wrapper(*args, **kwargs):
            with profile_kv(n):
                return func(*args, **kwargs)

        return func_wrapper

    return decorator_with_name


def gather_weighted_means(local_kvs: Dict[str, float],
                          local_counts: Optional[Dict[str, int]] = None
                          ) -> Dict[str, float]:
    """Cross-rank weighted mean of host-local kv dicts (the same keys on
    every rank): sum over ranks of value x count, over the sum of counts.
    The JAX package's ``gather_weighted_means`` on ``torch.distributed``;
    the identity without a process group. A collective: every rank
    calls it."""
    import torch
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return dict(local_kvs)
    keys = sorted(local_kvs)
    counts = local_counts or {k: 1 for k in keys}
    device = ("cuda" if dist.get_backend() == "nccl" else "cpu")
    vals = torch.tensor(
        [[local_kvs[k] * counts.get(k, 1) for k in keys],
         [counts.get(k, 1) for k in keys]], dtype=torch.float64,
        device=device)
    dist.all_reduce(vals)
    sums, cnts = vals.cpu().tolist()
    return {k: float(s / max(c, 1e-12)) for k, s, c in zip(keys, sums, cnts)}


_trace = None
_trace_spans = False  # start_trace turned the spans on


def start_trace(logdir: Optional[str] = None, device=None) -> str:
    """Start a ``torch.profiler`` trace of CPU and CUDA activity, or of
    CPU activity alone when the caller asks for ``device="cpu"`` (the
    card by default, as every entry point of the port; raises when there
    is none); :func:`stop_trace` writes it under ``logdir`` (default
    ``get_dir()/trace``) as a Chrome/TensorBoard trace file. The port's
    spans (:mod:`.tracing`) are on while it runs, so the trace holds their
    ``ddpm.*`` ranges. Returns the directory."""
    global _trace, _trace_spans
    import torch

    from .. import resolve_device

    if _trace is not None:
        raise RuntimeError("a trace is already running")
    cuda = resolve_device(device).type == "cuda"
    logdir = logdir or osp.join(get_dir() or tempfile.gettempdir(), "trace")
    os.makedirs(logdir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    _trace = torch.profiler.profile(
        activities=acts,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir))
    _trace_spans = not tracing.enabled()
    if _trace_spans:
        tracing.enable()
    _trace.start()
    return logdir


def stop_trace() -> None:
    """Stop the trace that :func:`start_trace` began and write it. If
    :func:`start_trace` turned the spans on, they go off and what they
    recorded is dropped (the trace file holds their ranges); the counters
    stay."""
    global _trace, _trace_spans
    if _trace is None:
        raise RuntimeError("no trace is running")
    prof, _trace = _trace, None
    prof.stop()
    if _trace_spans:
        tracing.disable()
        tracing.drain(counters_too=False)
        _trace_spans = False
