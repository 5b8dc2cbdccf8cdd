"""``BENCHMARK.json`` and the files it names by name:

- a cell's workload file (``workloads/<cell>.json``: its driver, the
  check's sizes, its control and limits) and the traffic mix it names
  (``traffic/<traffic>.json``, parameters for the one generator);
- a configuration's file (``configs/<config>.json``), whose ``model`` names
  the program's builder (``programs/<model>.py``) and whose ``reference``
  names the plain reference (``reference/<reference>.py``);
- the driver a workload names (``drivers/<driver>.py``), the sampler a mix
  names (``samplers/<sampler>.py``) and a per-layer metric's reader
  (``metrics/<metric>.py``).

A later cell, configuration, model, sampler, driver or metric is a new
file and a new entry; no file here needs an edit for it."""

from __future__ import annotations

import functools
import importlib
import importlib.util
import json
import os
import re
from typing import Callable, Dict, List

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE_RE = re.compile(r"^[^\t\n\r]{1,200}$")
FORBIDDEN_WORKLOAD_KEYS = ("name", "config", "traffic", "chips")


def load_benchmark(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_entry(bench: dict, cell: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == cell:
            return w
    raise KeyError(f"no workload {cell!r} in BENCHMARK.json")


def traffic(here: str, name: str) -> dict:
    """A traffic mix's parameters (``traffic/<name>.json``)."""
    with open(os.path.join(here, "traffic", name + ".json")) as f:
        return json.load(f)


def workload(here: str, bench: dict, cell: str) -> dict:
    """The cell's workload file, checked against its BENCHMARK.json entry;
    ``params`` holds its traffic mix's parameters and its ``check``."""
    entry = cell_entry(bench, cell)
    with open(os.path.join(here, "workloads", cell + ".json")) as f:
        w = json.load(f)
    for key in FORBIDDEN_WORKLOAD_KEYS:
        if w.get(key) != entry[key]:
            raise ValueError(f"workloads/{cell}.json: {key} {w.get(key)!r} "
                             f"differs from BENCHMARK.json's {entry[key]!r}")
    w["params"] = dict(traffic(here, w["traffic"]), **w.get("check", {}))
    return w


def config(here: str, name: str) -> dict:
    """A configuration's file; an int8 entry's scales file resolved beside
    it (``scales_path``)."""
    with open(os.path.join(here, "configs", name + ".json")) as f:
        cfg = json.load(f)
    if cfg.get("int8"):
        cfg["int8"]["scales_path"] = os.path.join(here, "configs",
                                                  cfg["int8"]["scales"])
    return cfg


def _applies(metric: dict, cell: str, reported: List[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in reported


def end_to_end_for(bench: dict, cell: str) -> List[dict]:
    return [m for m in bench["end_to_end"]
            if "workloads" not in m or cell in m["workloads"]]


def per_layer_for(bench: dict, cell: str) -> List[dict]:
    reported = [m["name"] for m in end_to_end_for(bench, cell)]
    return [m for m in bench["per_layer"] if _applies(m, cell, reported)]


@functools.lru_cache(maxsize=None)
def module(here: str, folder: str, name: str):
    """``<folder>/<name>.py`` as a module (a name may hold dots), loaded
    once a process."""
    if not NAME_RE.match(name):
        raise ValueError(f"bad name {name!r}")
    path = os.path.join(here, folder, name + ".py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"{folder}/{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{folder}_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(here: str, metric: str) -> Callable[[dict], object]:
    """``metrics/<metric>.py``'s ``read``."""
    return module(here, "metrics", metric).read


def reference(cfg: dict):
    """The plain reference a configuration names (``reference/<name>.py``)."""
    if not NAME_RE.match(cfg["reference"]):
        raise ValueError(f"bad reference {cfg['reference']!r}")
    return importlib.import_module("reference." + cfg["reference"])


def _missing_modules(here: str, w: dict) -> List[str]:
    """The driver, program, reference and sampler files a cell's files
    name and the repository lacks."""
    try:
        cell = workload(here, {"workloads": [w]}, w["name"])
        cfg = config(here, w["config"])
    except (OSError, ValueError, KeyError) as e:
        return [f"{w['name']}: {e}"]
    want = [("drivers", cell["driver"]), ("programs", cfg["model"]),
            ("reference", cfg["reference"])]
    if "sampler" in cell["params"]:
        want.append(("samplers", cell["params"]["sampler"]))
    return [f"missing {d}/{n}.py" for d, n in want
            if not os.path.exists(os.path.join(here, d, n + ".py"))]


def problems(bench: dict, here: str) -> List[str]:
    """What in BENCHMARK.json breaks the contract's name, unit and
    cross-reference rules, or names a file that is missing."""
    out = []
    configs = {c["name"]: c for c in bench.get("configs", [])}
    cells = {w["name"]: w for w in bench.get("workloads", [])}
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in bench.get(group, []):
            names.append(e["name"])
            if not NAME_RE.match(e["name"]):
                out.append(f"bad name {e['name']!r}")
            if "unit" in e and not UNIT_RE.match(e["unit"]):
                out.append(f"bad unit {e['unit']!r}")
            for key in ("why", "layer", "source"):
                if key in e and not LINE_RE.match(e[key]):
                    out.append(f"bad {key} of {e['name']}")
    if len(set(names)) != len(names):
        out.append("a name is used twice")
    for c in configs.values():
        for k in c.get("reduced", []):
            if not NAME_RE.match(k):
                out.append(f"bad reduced key {k!r}")
        if not os.path.exists(os.path.join(os.path.dirname(os.path.abspath(here)), c["file"])):
            out.append(f"missing {c['file']}")
    for w in cells.values():
        if w["config"] not in configs:
            out.append(f"{w['name']}: unknown config")
        if not NAME_RE.match(w["traffic"]):
            out.append(f"bad traffic {w['traffic']!r}")
        if w["chips"] not in (1, 4):
            out.append(f"{w['name']}: chips")
        for folder, name in (("workloads", w["name"]),
                             ("traffic", w["traffic"])):
            if not os.path.exists(os.path.join(here, folder, name + ".json")):
                out.append(f"missing {folder}/{name}.json")
        out += _missing_modules(here, w)
    e2e = {m["name"] for m in bench.get("end_to_end", [])}
    if "setup_s" not in e2e:
        out.append("no setup_s")
    for m in bench.get("end_to_end", []):
        if m["source"] not in ("host_clock", "device_trace"):
            out.append(f"{m['name']}: source")
        if not 0.01 <= m["bound"] <= 0.25:
            out.append(f"{m['name']}: bound")
    for m in bench.get("per_layer", []):
        if m["moves"] not in e2e:
            out.append(f"{m['name']}: moves")
        if m["source"] not in ("host_clock", "device_trace", "program_span",
                               "program_counter"):
            out.append(f"{m['name']}: source")
        if not os.path.exists(os.path.join(here, "metrics",
                                           m["name"] + ".py")):
            out.append(f"missing metrics/{m['name']}.py")
        for c in m.get("workloads", []):
            if c not in cells:
                out.append(f"{m['name']}: unknown cell {c}")
    for c in cells:
        reported = [m["name"] for m in end_to_end_for(bench, c)]
        if "setup_s" not in reported or len(reported) < 2:
            out.append(f"{c}: end-to-end metrics")
        if not per_layer_for(bench, c):
            out.append(f"{c}: no per-layer metric")
    return out
