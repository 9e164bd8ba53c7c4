"""BENCHMARK.json and the files it names: every configuration, workload,
driver and metric file is there and parses, and the file keeps the
benchmark contract's shape."""
from __future__ import annotations

import json
import os
import re

import pytest

from benchmark.tests.conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def bench() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys_and_command():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["command"] == ["python3", "benchmark/run.py"]
    assert b["paths"] == ["benchmark"]
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


@pytest.mark.parametrize("conf", bench()["configs"], ids=lambda c: c["name"])
def test_config_file(conf):
    assert set(conf) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(conf["name"]) and conf["file"].startswith("benchmark/configs/")
    with open(os.path.join(ROOT, conf["file"])) as f:
        data = json.load(f)
    assert data["name"] == conf["name"] and "assumed" in data
    assert data["reduced"] == conf["reduced"]


@pytest.mark.parametrize("cell", bench()["workloads"], ids=lambda w: w["name"])
def test_workload_file(cell):
    b = bench()
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"]) and cell["chips"] in (1, 4)
    assert len(cell["why"]) <= 200 and "\n" not in cell["why"]
    with open(os.path.join(BENCH, "workloads", f"{cell['name']}.json")) as f:
        wl = json.load(f)
    for k in ("config", "traffic", "chips", "why"):
        assert wl[k] == cell[k], k
    assert cell["config"] in {c["name"] for c in b["configs"]}
    assert os.path.exists(os.path.join(BENCH, "drivers", f"{wl['entry']}.py"))
    assert wl["limits"] and all(v > 0 for v in wl["limits"].values())
    e2e = [m["name"] for m in b["end_to_end"] if cell["name"] in m.get("workloads", [cell["name"]])]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(cell["name"] in m.get("workloads", [cell["name"]]) for m in b["per_layer"])


def all_metrics():
    b = bench()
    return [("end_to_end", m) for m in b["end_to_end"]] + [("per_layer", m) for m in b["per_layer"]]


@pytest.mark.parametrize("group,metric", all_metrics(),
                         ids=lambda x: x if isinstance(x, str) else x["name"])
def test_metric_file(group, metric):
    b = bench()
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert os.path.exists(os.path.join(BENCH, "metrics", f"{metric['name']}.py"))
    cells = {w["name"] for w in b["workloads"]}
    assert set(metric.get("workloads", [])) <= cells
    if group == "end_to_end":
        assert set(metric) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert set(metric) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        moved = next(m for m in b["end_to_end"] if m["name"] == metric["moves"])
        for cell in metric.get("workloads", cells):
            assert cell in moved.get("workloads", [cell]), (metric["name"], cell)


def test_names_unique_and_one_layer_name_each():
    b = bench()
    for group in ("configs", "workloads"):
        names = [x["name"] for x in b[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(metrics) == len(set(metrics))
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(1, len(b["workloads"]) // 4)


def test_run_seconds_fits_the_check_with_24_cells():
    rs = bench()["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
