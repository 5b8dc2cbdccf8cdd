"""The result line's keys, their order and what decides ``correct``."""

import math
import os

import torch

from harness import manifest, report
from harness.check import compare, is_correct

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
CELL = {"name": "superres_prod.ddpm25_b1", "chips": 1}


def _res(value=0.01):
    return {"attempted": 24, "failed": 0, "memory_peak_bytes": 123,
            "compared": compare({"start_max_abs": 0.0, "out_rel_l2": value},
                                {"start_max_abs": 0.0, "out_rel_l2": 0.05}),
            "e2e": {"setup_s": 20.5, "patch_steps_per_s": 21.0}}


def test_untraced_line():
    bench = manifest.load_benchmark(ROOT)
    line = report.result_line(bench, HERE, CELL, _res(), False,
                              torch.device("cpu"))
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "compared"]
    assert line["correct"] is True
    assert set(line["metrics"]) == {"setup_s", "patch_steps_per_s"}
    assert line["metrics"]["patch_steps_per_s"] == {
        "value": 21.0, "unit": "patch-steps/s"}
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert report.compared_lines(line["compared"])[1] == (
        "compared out_rel_l2 0.01 limit 0.05")


def test_traced_line_has_breakdown_and_busy():
    bench = manifest.load_benchmark(ROOT)
    res = _res()
    res["records"] = {"trace": None, "host_forward_ms": [50.0],
                      "step_ms": [60.0, 62.0], "busy_s": 1.5, "window_s": 2.0}
    res["breakdown"] = {"device_ops": [["conv3d_sm90", 1.0]],
                        "idle_gaps": [["host between calls", 0.5]]}
    line = report.result_line(bench, HERE, CELL, res, True,
                              torch.device("cpu"))
    assert list(line)[-2:] == ["breakdown", "compared"]
    assert line["device"]["busy_s"] == 1.5 and line["device"]["window_s"] == 2.0
    # a reader that finds nothing leaves its metric out
    assert set(line["metrics"]) == {"host_issue_ms_per_forward.serve",
                                    "idle_share.serve", "step_ms_p95.serve"}


def test_correct_needs_every_number_within_its_limit():
    assert not is_correct(compare({"a": 0.2}, {"a": 0.1}))
    assert not is_correct(compare({"a": math.inf}, {"a": 1.0}))
    assert not is_correct(compare({"a": 0.0}, {}))
    assert not is_correct({})
    assert is_correct(compare({"a": 0.0, "b": 0.1}, {"a": 0.0, "b": 0.1}))
