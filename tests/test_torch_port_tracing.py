"""The port's span-and-counter recorder (``ddpm3d_tpu_torch/utils/
tracing.py``) on the CPU: spans off record nothing and open no profiler
range; nesting, parents, call ids and self time; an enabled span under a
CPU ``torch.profiler`` lands in the trace as a ``ddpm.*`` range at the time
the recorder mapped it to; a tiny SuperResModel chain through
``denoise_patches`` opens one forward span per step, one GroupNorm span per
``GroupNorm32`` call and one conv span per conv site call; the counters
behind ``ops.launch_counts`` / ``ops.route_counts``, the logger's scopes
and trace, and a spatial group's counters and spans.
"""

import json
import os
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ddpm3d_tpu_torch import ops
from ddpm3d_tpu_torch.inference import denoise_patches
from ddpm3d_tpu_torch.models import SuperResModel
from ddpm3d_tpu_torch.models import factory
from ddpm3d_tpu_torch.models.nn import Conv1x1x1, Conv3x3x3, GroupNorm32
from ddpm3d_tpu_torch.ops import quant
from ddpm3d_tpu_torch.utils import logger, tracing
from ddpm3d_tpu_torch.utils.tracing import Span

TINY = dict(model_channels=32, out_channels=2, num_res_blocks=1,
            attention_resolutions=(), channel_mult=(1, 2), dims=3,
            use_scale_shift_norm=True, resblock_updown=True,
            middle_attention=False)
STEPS = 3


@pytest.fixture(autouse=True)
def _fresh():
    """Spans off and nothing recorded, before and after each test; two
    torch threads (the suite's workers share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    tracing.disable()
    tracing.drain()
    yield
    tracing.disable()
    tracing.drain()
    torch.set_num_threads(threads)


def _trace_events(prof, tmp_path):
    path = os.path.join(tmp_path, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        data = json.load(f)
    return data, [e for e in data["traceEvents"]
                  if e.get("cat") == "user_annotation"
                  and e.get("name", "").startswith("ddpm.")]


def test_spans_off_record_nothing_and_open_no_range(tmp_path):
    assert not tracing.enabled()
    assert tracing.span("ddpm.a") is tracing.span("ddpm.b")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("ddpm.a"):
            with tracing.span("ddpm.b"):
                torch.ones(4).sum()
    _, ranges = _trace_events(prof, tmp_path)
    assert ranges == []
    assert tracing.drain() == ([], {})


def test_nesting_parents_and_call_ids():
    tracing.enable()
    first = tracing.new_call()
    with tracing.span("ddpm.a"):
        with tracing.span("ddpm.b"):
            with tracing.span("ddpm.c"):
                pass
        with tracing.span("ddpm.b"):
            pass
    second = tracing.new_call()
    with tracing.span("ddpm.a"):
        pass
    tracing.disable()
    with tracing.span("ddpm.off"):
        pass
    spans, _ = tracing.drain()
    assert second == first + 1
    assert [(s.name, s.parent, s.call) for s in spans] == [
        ("ddpm.a", -1, first), ("ddpm.b", 0, first), ("ddpm.c", 1, first),
        ("ddpm.b", 0, first), ("ddpm.a", -1, second)]
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns


def test_drain_refuses_while_a_span_is_open():
    tracing.enable()
    with tracing.span("ddpm.a"):
        with pytest.raises(RuntimeError):
            tracing.drain()
    assert [s.name for s in tracing.drain()[0]] == ["ddpm.a"]


@pytest.mark.parametrize("children, want", [
    ((), 100),
    (("ddpm.c",), 100 - 10 - 5),        # c through b, which is not listed
    (("ddpm.b",), 100 - 40),
    (("ddpm.b", "ddpm.c"), 100 - 40 - 5),  # the outermost: b, not b's c
])
def test_self_ms(children, want):
    ms = 1_000_000
    spans = [Span("ddpm.a", 0, 100 * ms, -1, 1),
             Span("ddpm.b", 10 * ms, 50 * ms, 0, 1),
             Span("ddpm.c", 20 * ms, 30 * ms, 1, 1),
             Span("ddpm.c", 60 * ms, 65 * ms, 0, 1),
             Span("ddpm.c", 200 * ms, 210 * ms, -1, 1)]  # outside any a
    assert tracing.self_ms(spans, "ddpm.a", children) == pytest.approx(want)


def test_enabled_spans_land_in_the_profiler_trace(tmp_path):
    """Every enabled span is a ``ddpm.*`` range of the trace, in the same
    order and nesting; each span holds its range (its clock is read just
    outside the profiler's), and the anchor maps the spans onto the
    trace's clock: the median offset within 1 ms. A single span may stall
    between the two clocks (up to 6.3 ms on a card host under load), so
    each one is held to 10 ms of the median."""
    tracing.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("ddpm.outer"):
            time.sleep(0.004)
            for _ in range(3):
                with tracing.span("ddpm.inner"):
                    time.sleep(0.002)
    spans, _ = tracing.drain()
    data, ranges = _trace_events(prof, tmp_path)
    base_us = data.get("baseTimeNanoseconds", 0) / 1e3
    ranges.sort(key=lambda e: e["ts"])
    assert [e["name"] for e in ranges] == [s.name for s in spans] == [
        "ddpm.outer"] + ["ddpm.inner"] * 3
    assert [s.parent for s in spans] == [-1, 0, 0, 0]
    outer = ranges[0]
    for e in ranges[1:]:
        assert outer["ts"] <= e["ts"]
        assert e["ts"] + e["dur"] <= outer["ts"] + outer["dur"]
    for a, b in zip(ranges[1:], ranges[2:]):
        assert a["ts"] + a["dur"] <= b["ts"]
    offsets = []
    for s, e in zip(spans, ranges):
        assert e["dur"] <= (s.end_ns - s.start_ns) / 1e3 + 20, s
        offsets += [tracing.unix_us(s.start_ns) - (e["ts"] + base_us),
                    tracing.unix_us(s.end_ns) - (e["ts"] + e["dur"]
                                                 + base_us)]
    mid = float(np.median(offsets))
    assert abs(mid) < 1000, offsets
    assert all(abs(o - mid) < 10_000 for o in offsets), offsets


def _tiny(**kw):
    model = SuperResModel(in_channels=1, **dict(TINY, **kw)).eval()
    torch.manual_seed(3)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn_like(p))
    return model


def _counting_hooks(model):
    """Calls per module kind, counted by forward hooks."""
    calls = {"gn": 0, "conv": 0}

    def hook(kind):
        def fn(mod, args, out):
            calls[kind] += 1
        return fn

    handles = [m.register_forward_hook(hook("gn")) for m in model.modules()
               if isinstance(m, GroupNorm32)]
    handles += [m.register_forward_hook(hook("conv"))
                for m in model.modules()
                if isinstance(m, (Conv3x3x3, Conv1x1x1))]
    return calls, handles


def _chain(model, patches):
    sched, cfg = factory.create_gaussian_diffusion(
        steps=1000, learn_sigma=True, noise_schedule="linear",
        timestep_respacing=str(STEPS))
    low = np.random.default_rng(0).standard_normal(
        (patches, 4, 16, 16)).astype(np.float32)
    return denoise_patches(model, sched, cfg, low, seed=5, batch_size=1,
                           device="cpu")


def test_a_tiny_chain_opens_a_span_per_layer_call():
    model = _tiny()
    n_gn = sum(isinstance(m, GroupNorm32) for m in model.modules())
    n_conv = sum(isinstance(m, (Conv3x3x3, Conv1x1x1))
                 for m in model.modules())
    calls, handles = _counting_hooks(model)
    tracing.enable()
    try:
        _chain(model, 2)
        _chain(model, 1)
    finally:
        for h in handles:
            h.remove()
    spans, _ = tracing.drain()
    forwards = 3 * STEPS
    # every GroupNorm32 and conv module runs once a forward
    assert calls == {"gn": forwards * n_gn, "conv": forwards * n_conv}
    names = [s.name for s in spans]
    count = {n: names.count(n) for n in set(names)}
    assert count == {
        "ddpm.pipeline.call": 2, "ddpm.pipeline.upload": 3,
        "ddpm.pipeline.chain": 3, "ddpm.pipeline.gather": 2,
        "ddpm.pipeline.download": 2, "ddpm.sampler.step": forwards,
        "ddpm.model.forward": forwards, "ddpm.gn": forwards * n_gn,
        "ddpm.gn.fold": forwards * n_gn, "ddpm.conv": forwards * n_conv}
    parent_of = {"ddpm.pipeline.upload": "ddpm.pipeline.call",
                 "ddpm.pipeline.chain": "ddpm.pipeline.call",
                 "ddpm.pipeline.gather": "ddpm.pipeline.call",
                 "ddpm.pipeline.download": "ddpm.pipeline.call",
                 "ddpm.sampler.step": "ddpm.pipeline.chain",
                 "ddpm.model.forward": "ddpm.sampler.step",
                 "ddpm.gn": "ddpm.model.forward",
                 "ddpm.gn.fold": "ddpm.gn",
                 "ddpm.conv": "ddpm.model.forward"}
    for s in spans:
        want = parent_of.get(s.name)
        assert (spans[s.parent].name if s.parent >= 0 else None) == want, s
        if s.parent >= 0:
            assert s.call == spans[s.parent].call
    ids = sorted({s.call for s in spans})
    assert len(ids) == 2
    # each step's forward splits into GroupNorm, conv and the rest
    fwd = tracing.self_ms(spans, "ddpm.model.forward")
    parts = (tracing.self_ms(spans, "ddpm.gn")
             + tracing.self_ms(spans, "ddpm.conv")
             + tracing.self_ms(spans, "ddpm.model.forward",
                               ("ddpm.gn", "ddpm.conv")))
    assert parts == pytest.approx(fwd, rel=1e-9)
    assert 0 < tracing.self_ms(spans, "ddpm.sampler.step",
                               ("ddpm.model.forward",)) < tracing.self_ms(
        spans, "ddpm.sampler.step")


def test_int8_sites_open_quantize_spans_and_requantize_once():
    model = _tiny(int8=quant.Int8Config(exclude=()))
    sites = sum(isinstance(m, (Conv3x3x3, Conv1x1x1)) and m.int8_active()
                for m in model.modules())
    assert sites > 0
    tracing.enable()
    _chain(model, 1)
    spans, counts = tracing.drain()
    names = [s.name for s in spans]
    assert names.count("ddpm.conv.quantize") == STEPS * sites
    assert names.count("ddpm.conv.pack") == sites
    assert counts["int8.requant"] == sites
    assert all(spans[s.parent].name == "ddpm.conv" for s in spans
               if s.name in ("ddpm.conv.quantize", "ddpm.conv.pack"))
    _chain(model, 1)
    assert "int8.requant" not in tracing.drain()[1]


def test_launch_and_route_counts_read_the_registry():
    ops.reset_launch_counts()
    assert set(ops.launch_counts()) == {
        "conv3d", "conv3d_dx", "conv3d_fused", "conv3d_s8", "gn_stats",
        "gn_apply", "gn_fold"}
    routes = ops.route_counts()
    assert set(routes) == (
        {f"{w}.{r}" for w in ("conv3d", "conv3d_dx")
         for r in ops.conv3d.ROUTES}
        | {f"conv3d_fused.{r}" for r in ops.conv3d_fused.ROUTES}
        | {f"conv3d_s8.{r}" for r in ops.conv3d_s8.ROUTES})
    assert ops.fold_counts() == {"k1": 0, "launch": 0, "torch": 0}
    assert not any(ops.launch_counts().values()) and not any(routes.values())
    tracing.count("launch.gn_stats", 2)
    tracing.count("route.conv3d_s8.conv1x1")
    tracing.count("spatial.halo")
    assert ops.launch_counts()["gn_stats"] == 2
    assert ops.route_counts()["conv3d_s8.conv1x1"] == 1
    report = ops.counter_report()
    assert report["counters"] == {"spatial.halo": 1}
    assert report["launches"] == ops.launch_counts()
    assert report["folds"] == ops.fold_counts()
    ops.reset_launch_counts()
    assert ops.launch_counts()["gn_stats"] == 0
    assert tracing.counters() == {"spatial.halo": 1}


@pytest.fixture
def _own_logger(tmp_path):
    saved = logger.Logger.CURRENT
    own = logger.configure(str(tmp_path / "log"), format_strs=[])
    yield
    own.close()
    logger.Logger.CURRENT = saved


def test_logger_scopes_and_trace_turn_spans_on(tmp_path, _own_logger):
    tracing.enable()
    with logger.profile_kv("io"):
        time.sleep(0.001)
    spans, _ = tracing.drain()
    assert [s.name for s in spans] == ["ddpm.wait.io"]
    assert logger.getkvs()["wait_io"] == pytest.approx(
        (spans[0].end_ns - spans[0].start_ns) / 1e9, abs=5e-4)
    tracing.disable()
    logger.start_trace(str(tmp_path / "trace"), "cpu")
    assert tracing.enabled()
    with tracing.span("ddpm.in_trace"):
        tracing.count("launch.gn_stats")
    logger.stop_trace()
    assert not tracing.enabled()
    # the spans it turned on are dropped, their ranges are in the trace
    # file; the counters stay for the CLIs' end line
    assert tracing.drain(counters_too=False) == ([], {})
    assert ops.launch_counts()["gn_stats"] == 1
    written = ""
    for root, _, files in os.walk(tmp_path / "trace"):
        for name in files:
            with open(os.path.join(root, name)) as f:
                written += f.read()
    assert '"ddpm.in_trace"' in written
    tracing.enable()
    logger.start_trace(str(tmp_path / "trace2"), "cpu")
    with tracing.span("ddpm.in_trace"):
        pass
    logger.stop_trace()
    assert tracing.enabled()  # on before the trace: left on, spans kept
    assert [s.name for s in tracing.drain()[0]] == ["ddpm.in_trace"]


def test_spatial_operations_count_and_open_spans():
    """A spatial group's halo and reductions (over a stand-in transport:
    no process group) count ``spatial.<op>`` and open their spans."""
    from ddpm3d_tpu_torch.parallel import SpatialGroup

    class Loopback(SpatialGroup):
        def _exchange(self, sends):
            return {p: torch.zeros_like(t) for p, t in sends.items()}

        def _reduce(self, t, op):
            return t.clone()

        def _gather(self, t):
            return [t] * self.size

    group = Loopback([0, 1, 2], 1)
    x = torch.ones((1, 2, 4, 3, 2))
    tracing.enable()
    y, pad = group.halo(x)
    group.all_reduce_sum(x)
    group.all_reduce_max(x)
    group.all_gather_h(x)
    spans, counts = tracing.drain()
    assert y.shape == (1, 2, 6, 3, 2) and pad == (1, 1)
    assert [s.name for s in spans] == [
        "ddpm.spatial.halo", "ddpm.spatial.reduce", "ddpm.spatial.reduce"]
    assert counts == {"spatial.halo": 1, "spatial.all_reduce_sum": 1,
                      "spatial.all_reduce_max": 1, "spatial.all_gather_h": 1}
