"""BENCHMARK.json against the contract's rules, and the files it names."""

import copy
import json
import os

import pytest

from harness import manifest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


@pytest.fixture
def bench():
    return manifest.load_benchmark(ROOT)


def test_no_problems(bench):
    assert manifest.problems(bench, HERE) == []


def test_top_level_keys_and_entry_keys(bench):
    assert set(bench) == KEYS
    assert bench["command"] == ["python3", "portbench/run.py"]
    assert bench["paths"] == ["portbench"]
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["better"] in ("lower", "higher")
    assert len(json.dumps(bench)) < 64 * 1024


def test_run_seconds_fits_the_full_check(bench):
    rs = bench["run_seconds"]
    assert 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_four_chip_share(bench):
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(bench["workloads"]) // 4)


@pytest.mark.parametrize("bad", ["a b", "a,b", "a/b", "", "x" * 65, "é"])
def test_bad_names_are_refused(bench, bad):
    b = copy.deepcopy(bench)
    b["per_layer"][0]["name"] = bad
    assert any("bad name" in p for p in manifest.problems(b, HERE))


def test_bad_units_are_refused(bench):
    b = copy.deepcopy(bench)
    b["end_to_end"][0]["unit"] = "patch steps"
    assert any("bad unit" in p for p in manifest.problems(b, HERE))


def test_every_cell_reports_setup_another_e2e_and_a_layer(bench):
    for w in bench["workloads"]:
        e2e = [m["name"] for m in manifest.end_to_end_for(bench, w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = manifest.per_layer_for(bench, w["name"])
        assert layer and all(m["moves"] in e2e for m in layer)


def test_files_found_by_name(bench):
    for w in bench["workloads"]:
        cell = manifest.workload(HERE, bench, w["name"])
        cfg = manifest.config(HERE, cell["config"])
        assert cfg["name"] == cell["config"]
        assert cfg["reduced"] == next(
            c for c in bench["configs"] if c["name"] == cfg["name"])["reduced"]
        assert callable(manifest.reader(HERE, manifest.per_layer_for(
            bench, w["name"])[0]["name"]))
        if cfg.get("int8"):
            assert os.path.exists(cfg["int8"]["scales_path"])


def test_workload_file_must_agree_with_the_manifest(bench, tmp_path):
    b = copy.deepcopy(bench)
    b["workloads"][0]["chips"] = 4
    with pytest.raises(ValueError):
        manifest.workload(HERE, b, b["workloads"][0]["name"])


def test_files_a_cell_names_are_found_by_name(bench):
    """The driver, program, reference and sampler a cell's files name are
    files of their own; one that is missing is a problem."""
    w = bench["workloads"][0]
    cell = manifest.workload(HERE, bench, w["name"])
    cfg = manifest.config(HERE, cell["config"])
    assert callable(manifest.module(HERE, "drivers", cell["driver"]).run)
    assert callable(manifest.module(HERE, "programs", cfg["model"]).build)
    assert callable(manifest.module(HERE, "samplers",
                                    cell["params"]["sampler"]).step)
    assert callable(manifest.reference(cfg).build)
    assert manifest._missing_modules(HERE, w) == []
    with pytest.raises(FileNotFoundError):
        manifest.module(HERE, "drivers", "no_such_driver")
