"""BENCHMARK.json names every piece, and each is found by its name; the
file keeps to the rules of its format."""

import json
import re

import pytest

import mpbench_small
from mpbench import registry

BENCH = registry.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["mpbench"]
    assert BENCH["command"] == ["python3", "mpbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((mpbench_small.ROOT / "BENCHMARK.json").read_bytes()) <= 65536


@pytest.mark.parametrize("cell", mpbench_small.cells())
def test_cell_finds_its_pieces(cell):
    w = registry.cell(BENCH, cell)
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(w["name"]) and w["chips"] in (1, 4)
    assert 1 <= len(w["why"]) <= 200
    cfg = registry.config(BENCH, w["config"])
    traffic = registry.traffic(w["traffic"])
    assert callable(registry.job(traffic["job"]).make)
    kind = registry.kind(cfg["kind"])
    assert callable(kind.inputs) and callable(kind.readings)
    assert callable(kind.control) and isinstance(kind.EXACT, tuple)
    ref = registry.reference(cfg["reference"])
    assert callable(ref.best_rows) and callable(ref.pair_corr)
    assert all(v is not None and v > 0 for v in cfg["limits"].values())
    e2e = [m["name"] for m in registry.metrics_of(BENCH, cell, False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert registry.metrics_of(BENCH, cell, True)


@pytest.mark.parametrize(
    "metric", [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
def test_metric_has_reader(metric):
    assert callable(registry.reader(metric).read)


def test_names_units_and_bounds():
    names = set()
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in names
        names.add(m["name"])
        assert set(m.get("workloads", [])) <= cells
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used and c["file"].startswith("mpbench/")
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert json.loads((mpbench_small.ROOT / c["file"]).read_text())
