"""The benchmark's files: ``BENCHMARK.json`` keeps to its format, and
every configuration, traffic mix and metric it names loads by name."""

import json
import re
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[0:0] = [str(ROOT), str(ROOT / "src")]

from vmbench import harness  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
CELLS = [w["name"] for w in BENCH["workloads"]]


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "vmbench/run.py"]
    assert BENCH["paths"] == ["vmbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_entry(conf):
    assert set(conf) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(conf["name"]) and _line(conf["source"])
    assert _line(conf["why"]) and conf["file"].startswith("vmbench/")
    data = json.loads((ROOT / conf["file"]).read_text())
    assert data["name"] == conf["name"] and data["source"] == conf["source"]
    assert data["reduced"] == conf["reduced"] == []
    for key in ("rows", "dim", "index", "batcher", "limits", "assumed",
                "guarantees"):
        assert key in data
    assert any(w["config"] == conf["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_entry_loads(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
    assert cell["chips"] == 1 and _line(cell["why"])
    loaded = harness.load_cell(cell["name"])
    assert loaded.traffic["name"] == cell["traffic"]
    assert loaded.config["name"] == cell["config"]
    names = {m["name"] for m in loaded.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert loaded.per_layer


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_entry_and_reader(metric):
    keys = {"name", "unit", "better", "source"}
    if metric in BENCH["end_to_end"]:
        keys |= {"bound"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        keys |= {"layer", "moves"}
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        assert _line(metric["layer"])
    assert set(metric) - {"workloads"} == keys
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert set(metric.get("workloads", CELLS)) <= set(CELLS)
    assert callable(harness.load_reader(metric["name"]))


@pytest.mark.parametrize("mix", sorted(
    {w["traffic"] for w in BENCH["workloads"]}))
def test_traffic_file(mix):
    t = json.loads((ROOT / "vmbench" / "traffic" / f"{mix}.json").read_text())
    assert t["name"] == mix and t["loop"] == "closed"
    assert t["outstanding"] > 0 and t["k"] > 0
    total = sum(c for _, c in t["block"])
    assert t["query_pool"] % total == 0
