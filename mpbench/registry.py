"""Find every piece of the benchmark by the name `BENCHMARK.json` gives it.

A cell names a configuration (`configs/<config>.json`) and a traffic mix
(`traffic/<traffic>.json`); a configuration names its kind
(`kinds/<kind>.py`: its inputs and comparison) and its plain reference
(`references/<reference>.py`); a mix names its kind of job
(`jobs/<job>.py`); every metric, end to end or per layer, is read by
`metrics/<name>.py`. Adding a cell, a mix, a kind of job or input, or a
metric adds files and entries and edits none.
"""

from __future__ import annotations

import importlib
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark(root: pathlib.Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    known = ", ".join(w["name"] for w in bench["workloads"])
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; one of {known}")


def config(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return json.loads((ROOT / c["file"]).read_text())
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def kind(name: str):
    return importlib.import_module(f"mpbench.kinds.{name}")


def job(name: str):
    return importlib.import_module(f"mpbench.jobs.{name}")


def reference(name: str):
    return importlib.import_module(f"mpbench.references.{name}")


def reader(metric: str):
    """The module whose `read(obs)` gives this process's reading of
    `metric`, or None where the run has nothing to read it from; its
    `combine(readings)`, where it has one, makes the cell's number from
    every rank's reading (else their mean)."""
    return importlib.import_module(f"mpbench.metrics.{metric}")


def applies(metric: dict, cell_name: str) -> bool:
    """Whether a cell reports `metric`: the cells its `workloads` lists, or
    without that key every cell."""
    return cell_name in metric.get("workloads", [cell_name])


def metrics_of(bench: dict, cell_name: str, trace: bool) -> list[dict]:
    """The metrics a run of `cell_name` prints: its end-to-end metrics, or
    with `trace` its per-layer metrics."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if applies(m, cell_name)]
