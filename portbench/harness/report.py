"""The result line of a run, and the numbers compared as text."""

from __future__ import annotations

import math
from typing import Dict, List

from . import manifest
from .check import is_correct


def _metric(entry: dict, value) -> dict:
    return {"value": float(value), "unit": entry["unit"]}


def result_line(bench: dict, here: str, cell: dict, res: dict, traced: bool,
                device) -> dict:
    """``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
    end-to-end metrics, or with ``traced`` its per-layer ones), ``device``,
    with ``traced`` ``breakdown``, and last ``compared``."""
    import torch

    metrics = {}
    if traced:
        for m in manifest.per_layer_for(bench, cell["name"]):
            v = manifest.reader(here, m["name"])(res["records"])
            if v is not None and math.isfinite(v):
                metrics[m["name"]] = _metric(m, v)
    else:
        for m in manifest.end_to_end_for(bench, cell["name"]):
            v = res["e2e"].get(m["name"])
            if v is not None and math.isfinite(v):
                metrics[m["name"]] = _metric(m, v)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell["chips"],
           "memory_peak_bytes": res["memory_peak_bytes"]}
    line = {"correct": is_correct(res["compared"]) and not res["failed"],
            "attempted": res["attempted"], "failed": res["failed"],
            "metrics": metrics, "device": dev}
    if traced:
        dev["busy_s"] = res["records"]["busy_s"]
        dev["window_s"] = res["records"]["window_s"]
        line["breakdown"] = res["breakdown"]
    if "run" in res:
        line["run"] = res["run"]
    line["compared"] = res["compared"]
    return line


def compared_lines(compared: Dict[str, dict]) -> List[str]:
    return [f"compared {name} {c['value']!r} limit {c['limit']!r}"
            for name, c in compared.items()]
