"""BENCHMARK.json keeps to its schema: names, units and keys; and every
cell's configuration, workload and metric files exist."""
import json
import os
import re

import pytest

from conftest import ROOT
from gnnbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "gnnbench/run.py"]
    assert bench["paths"] == ["gnnbench"]
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_and_units(bench):
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in bench[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads"):
        assert len({x["name"] for x in bench[k]}) == len(bench[k])
    metrics = bench["end_to_end"] + bench["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") for m in metrics)
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]


def test_entry_keys(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}


def test_every_file_exists(bench):
    cells = {w["name"] for w in bench["workloads"]}
    for c in bench["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        for name in (cfg["model"]["arch"],):
            assert os.path.exists(os.path.join(ROOT, "gnnbench", "reference", f"{name}.py"))
            assert os.path.exists(os.path.join(ROOT, "gnnbench", "flops", f"{name}.py"))
    for w in bench["workloads"]:
        wl, cfg = harness.load_cell(w["name"])
        assert wl["config"] == w["config"] == cfg["name"] and wl["chips"] == w["chips"]
        assert os.path.exists(os.path.join(ROOT, "gnnbench", "paths", f"{wl['path']}.py"))
        e2e, per = harness.cell_metrics(bench, w["name"])
        assert {m["name"] for m in e2e} >= {"setup_s"} and len(e2e) >= 2 and per
    for m in bench["per_layer"]:
        assert os.path.exists(os.path.join(ROOT, "gnnbench", "metrics", f"{m['name']}.py"))
        assert set(m.get("workloads", cells)) <= cells


def test_run_seconds_fit_the_full_check(bench):
    rs = bench["run_seconds"]
    assert 24 * (14 * (rs + 60) + 2 * 90) + 2 * (rs + 60) + 1200 <= 43200
