"""Shared by the benchmark's CPU tests: the repository on the path, and a
cell's configuration cut to a size the CPU sweeps in a moment, with the
cell's own limits."""

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from mpbench import registry  # noqa: E402

SMALL = dict(n=2048, window=64, exclusion=16, sample_rows=128)


def small(cell_name: str) -> tuple[dict, dict, dict, dict]:
    """(benchmark, cell, configuration at the small size, traffic)."""
    bench = registry.benchmark()
    cell = registry.cell(bench, cell_name)
    cfg = dict(registry.config(bench, cell["config"]), **SMALL)
    return bench, cell, cfg, registry.traffic(cell["traffic"])


def cells() -> list[str]:
    return [w["name"] for w in registry.benchmark()["workloads"]]


def run(cell_name: str, seed: int, seconds: float, trace: bool = False,
        rank_cmd=None):
    """One run of the cell at the small size on the CPU, past the look for
    a card: in this process on one card, or as one gloo rank a card (the
    ranks it starts with one thread each, as the test workers share the
    host's cores)."""
    import os
    import time

    from mpbench import harness, ranks

    bench, cell, cfg, traffic = small(cell_name)
    if cell["chips"] > 1:
        threads = os.environ.get("OMP_NUM_THREADS")
        os.environ["OMP_NUM_THREADS"] = "1"
        try:
            return ranks.launch(cell, cfg, traffic, seed, seconds, trace,
                                bench, time.perf_counter(), "cpu",
                                backend="gloo", rank_cmd=rank_cmd)
        finally:
            if threads is None:
                del os.environ["OMP_NUM_THREADS"]
            else:
                os.environ["OMP_NUM_THREADS"] = threads
    return harness.run_cell(cell, cfg, traffic, seed, seconds, trace, "cpu",
                            bench, time.perf_counter())
