"""Every file the benchmark names loads and is found by name, and
BENCHMARK.json keeps to the benchmark's contract."""

import json
import os
import re

import pytest

from gkmbench import harness

ROOT = harness.ROOT
BENCH = harness.read_json(os.path.join(ROOT, "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "gkmbench/run.py"]
    assert BENCH["paths"] == ["gkmbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_loads_by_name(cell):
    c = harness.load_cell(cell)
    assert c.workload["chips"] == 1
    assert c.config["name"] == c.workload["config"]
    assert harness.load_module("loaders", c.config["loader"]).load
    assert harness.check_names(c) == set(c.limits)
    names = {m["name"] for m in c.end_to_end}
    assert {"job_s", "setup_s"} <= names
    assert c.per_layer, "every cell reports a per-layer metric"


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_metric_reader_loads_by_name(metric):
    assert callable(harness.load_module("metrics", metric).read)


def test_entries_keep_to_the_contract():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("gkmbench/")
        assert harness.read_json(os.path.join(ROOT, c["file"]))["reduced"] == c["reduced"] == []
        assert 1 <= len(c["why"]) <= 200 and 1 <= len(c["source"]) <= 200
    seen = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in seen
        seen.add((w["config"], w["traffic"]))
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and set(m["workloads"]) <= set(CELLS)
    for m in METRICS:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert len({m["name"] for m in METRICS}) == len(METRICS)
