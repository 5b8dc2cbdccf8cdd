"""Each per-layer reader on a synthetic trace whose answers are known."""

import os

import pytest

from harness import manifest, trace
from harness.families import FAMILIES

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _span(name, ts, end, cat="user_annotation"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": end - ts}


def _launch(corr, host, start, end, name="k", cat="kernel"):
    return [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
             "ts": host, "dur": 1, "args": {"correlation": corr}},
            {"ph": "X", "cat": cat, "name": name, "ts": start,
             "dur": end - start, "args": {"correlation": corr}}]


def synthetic():
    """Two calls, three forwards (times in us)."""
    ev = [_span("pb.window", 0, 1000),
          _span("pb.call", 0, 400), _span("pb.call", 500, 900),
          _span("pb.forward", 10, 100), _span("pb.forward", 200, 300),
          _span("pb.forward", 510, 600),
          _span("pb.conv", 20, 40), _span("pb.gn", 50, 60),
          _span("pb.conv", 205, 240), _span("pb.conv", 515, 530)]
    ev += _launch(1, 25, 30, 50, "conv3d_sm90_kernel<2, false>")
    ev += _launch(2, 55, 50, 60, "gn_apply_kernel")
    ev += _launch(3, 70, 60, 65, "elementwise_add")
    ev += _launch(4, 150, 150, 155, "randn")          # sampler
    ev += _launch(5, 160, 160, 170, "Memcpy HtoD", "gpu_memcpy")
    ev += _launch(6, 210, 210, 250, "conv3d_sm90_kernel<2, false>")
    ev += _launch(7, 260, 250, 252, "elementwise_add")
    ev += _launch(8, 350, 380, 390, "clamp")          # last of call 0
    ev += _launch(9, 520, 540, 560, "conv3d_s8_kernel")
    ev += _launch(10, 800, 800, 820, "mul")           # last of call 1
    return trace.Trace(ev)


@pytest.fixture
def rec():
    tr = synthetic()
    t0, t1 = trace.window(tr)
    return {"trace": tr, "traced_forwards": 3, "traced_calls": 2,
            "steps_per_call": 2, "batch": 2,
            "work": {"conv_bound_s": 1e-5, "conv_peak_s": 1e-5,
                     "gn_bound_s": 2e-6},
            "host_forward_ms": [40.0, 60.0], "step_ms": [float(i) for i in
                                                        range(1, 101)],
            "untraced_step_s": 2e-4,
            "window_s": (t1 - t0) / 1e6,
            "busy_s": sum(e - s for s, e in tr.busy(t0, t1)) / 1e6}


def read(name, rec):
    return manifest.reader(HERE, name)(rec)


def test_busy_union(rec):
    assert rec["busy_s"] == pytest.approx(142e-6)


@pytest.mark.parametrize("name,want", [
    ("chain_overhead_ms.serve", 0.150),
    ("sampler_ms_per_step.serve", 35e-3 / 3),
    ("glue_ms_per_forward.serve", 7e-3 / 3),
    ("conv_roofline.serve", 100 * 30 / 80),
    ("gn_roofline.serve", 100 * 6 / 10),
    ("idle_share.serve", 100 * (1 - 142 / 1000)),
    ("mfu.serve", 5.0),
    ("step_ms_p95.serve", 95.05),
    ("host_issue_ms_per_forward.serve", 50.0),
])
def test_reader(rec, name, want):
    assert read(name, rec) == pytest.approx(want)


@pytest.mark.parametrize("name", [
    "chain_overhead_ms.serve", "sampler_ms_per_step.serve",
    "glue_ms_per_forward.serve", "conv_roofline.serve", "gn_roofline.serve",
    "idle_share.serve", "mfu.serve", "host_issue_ms_per_forward.serve",
    "step_ms_p95.serve"])
def test_reader_finds_nothing_on_an_empty_trace(name):
    empty = {"trace": trace.Trace([]), "traced_forwards": 0, "work": {},
             "host_forward_ms": [], "step_ms": [], "untraced_step_s": None,
             "window_s": 0.0, "busy_s": 0.0}
    assert read(name, empty) is None


def test_breakdown(rec):
    b = trace.breakdown(rec["trace"], FAMILIES)
    ops = dict(b["device_ops"])
    assert ops["conv3d_sm90"] == pytest.approx(60e-6)
    assert ops["conv3d_s8"] == pytest.approx(20e-6)
    assert ops["gpu_memcpy"] == pytest.approx(10e-6)
    gaps = dict(b["idle_gaps"])
    # each gap is put where the host was at its middle
    assert gaps == pytest.approx({
        "host in the forward, other": 30e-6,
        "host in the chain, outside the forward": (85 + 5 + 40 + 128 + 240) * 1e-6,
        "host between calls": (150 + 180) * 1e-6})
