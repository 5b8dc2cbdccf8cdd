"""A serving cell: the port's ``denoise_patches`` driven back to back, one
call per batch of patch-draws, a closed loop over one job's queue.

Set-up builds the configured model, draws its weights on the device from
the seed, makes the traffic (:mod:`harness.traffic`) and runs one short
chain of the cell's own shapes. The window then calls the entry until
``seconds`` have passed; every call runs the whole respaced chain. A
forward hook on the model records a CUDA event at each forward's end; the
intervals between two such events of one chain are the step times, read
after each call. With ``trace`` the first ``trace_calls`` calls run under
``torch.profiler`` with ``pb.*`` ranges opened from module hooks, and the
window goes on untraced.

After the window the program is freed and the plain reference recomputes
the calls drawn from the seed, from the same inputs and weights
(:func:`harness.serve.judge`); :mod:`harness.check` judges the outputs.
"""

from __future__ import annotations

import gc
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from harness import manifest, serve
from harness import trace as trace_mod
from harness import work
from harness.check import compare
from harness.families import FAMILIES
from harness.traffic import ServeTraffic


def check_calls(params: dict, seed: int) -> List[int]:
    """The calls the check compares: ``check_calls`` of the ``check_from``
    calls after the traced ones, drawn from the seed (a run's window holds
    them all; it goes on until they have returned)."""
    lo = params["trace_calls"]
    rng = np.random.default_rng(np.random.SeedSequence([seed, 11]))
    return sorted((lo + rng.choice(params["check_from"],
                                   size=params["check_calls"],
                                   replace=False)).tolist())


def sites_per_forward(cfg: dict, params: dict) -> int:
    """The conv sites of one forward (0 where the cell judges none alone)."""
    if not params.get("site_rows"):
        return 0
    return len(manifest.reference(cfg).layout(cfg, (params["patch"],) * 3)[0])


def run(workload: dict, cfg: dict, seed: int, seconds: float, traced: bool,
        device, t_start: float, startup: Optional[dict] = None,
        fault: Optional[Callable] = None) -> dict:
    """One run of a serving cell; -> the pieces of the result line.
    ``startup``: the entry's own set-up parts (seconds). ``fault`` (tests
    only) wraps the entry's outputs: ``fault(k, out)``."""
    params = workload["params"]
    cuda = device.type == "cuda"
    parts = dict(startup or {}, start_s=time.perf_counter() - t_start)
    mark = time.perf_counter()

    def part(name):
        nonlocal mark
        now = time.perf_counter()
        parts[name] = now - mark
        mark = now

    model = serve.build_program(cfg, device)
    part("program_s")
    serve.load_weights(model, cfg, seed, device)
    part("weights_s")
    sched, warm, dcfg = serve.schedules(cfg, params)
    traffic = ServeTraffic(params, seed, device)
    part("traffic_s")
    steps = sched.num_timesteps
    clock = serve.StepClock(model, cuda)
    chosen = check_calls(params, seed)
    capture = serve.Capture(model, serve.site_plan(params, seed, chosen,
                                                   steps))

    # warm-up: the cell's own shapes, a short chain (builds the kernels on
    # a checkout's first run)
    serve.run_call(model, warm, dcfg, traffic, 0, device, params)
    clock.end_call(keep=False)
    clock.host_ms.clear()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    part("warmup_s")
    setup_s = time.perf_counter() - t_start

    finite = True
    n_trace = params["trace_calls"] if traced else 0
    prof = hooks = win = None
    tr = None
    k = 0
    call_s: List[float] = []
    t0 = time.perf_counter()
    while True:
        if k == 0 and n_trace:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if cuda else [])
            hooks = serve.RangeHooks(model)
            clock.count_host = False
            prof = profile(activities=acts)
            prof.start()
            win = torch.profiler.record_function("pb.window")
            win.__enter__()
        capture.start(k if k in chosen else None)
        c0 = time.perf_counter()
        if k < n_trace:
            with torch.profiler.record_function("pb.call"):
                out = serve.run_call(model, sched, dcfg, traffic, k, device,
                                     params)
        else:
            out = serve.run_call(model, sched, dcfg, traffic, k, device,
                                 params)
        call_s.append(time.perf_counter() - c0)
        # a traced call's steps carry the profiler's cost: not timed
        clock.end_call(keep=k >= n_trace)
        out = out if fault is None else fault(k, out)
        if k in chosen:
            capture.traj.setdefault(k, {"xs": [], "outs": [],
                                        "sites": []})["final"] = out
        finite &= bool(np.isfinite(out).all())
        k += 1
        if n_trace and k == n_trace:
            win.__exit__(None, None, None)
            prof.stop()
            hooks.remove()
            clock.count_host = True
        if time.perf_counter() - t0 >= seconds and k > max(chosen):
            break
    window_s = time.perf_counter() - t0
    clock.remove()
    capture.remove()
    memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if prof is not None:
        tr = trace_mod.record(prof)
        del prof
    del model
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    readings = serve.judge(cfg, params, traffic, capture.traj, chosen, seed,
                           device, sites_per_forward(cfg, params))
    compared = compare(readings, workload.get("limits", {}))
    ref_s = time.perf_counter() - t_ref

    b = traffic.batch
    res = {
        "attempted": k * b,
        "failed": 0 if finite else k * b,
        "compared": compared,
        "memory_peak_bytes": int(memory_peak),
        "e2e": {
            "setup_s": setup_s,
            "patch_steps_per_s": k * b * steps / window_s,
        },
        "run": {"calls": k, "steps_timed": len(clock.step_ms),
                "step_ms_p50_p95": ([float(v) for v in np.percentile(
                    clock.step_ms, [50, 95])] if clock.step_ms else None),
                "window_s": window_s, "reference_s": ref_s, "setup": parts,
                "call_s": call_s},
    }
    if tr is not None:
        t_w0, t_w1 = trace_mod.window(tr)
        busy = sum(e - s for s, e in tr.busy(t_w0, t_w1)) / 1e6
        res["records"] = {
            "trace": tr,
            "work": work.per_forward(cfg, (params["patch"],) * 3, b),
            "traced_calls": n_trace,
            "traced_forwards": n_trace * steps,
            "steps_per_call": steps,
            "batch": b,
            "host_forward_ms": list(clock.host_ms),
            "step_ms": list(clock.step_ms),
            "untraced_step_s": (sum(call_s[n_trace:])
                                / ((k - n_trace) * steps) if k > n_trace
                                else None),
            "window_s": (t_w1 - t_w0) / 1e6,
            "busy_s": busy,
        }
        res["breakdown"] = trace_mod.breakdown(tr, FAMILIES)
    return res
