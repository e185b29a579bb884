"""A run of each cell, driven on the CPU at a small size through everything
but the look for a card: the result line's keys, the metrics the cell
names, the compared numbers last; and the entry point's refusals."""

import json
import shutil
import subprocess
import sys
import pytest

import mpbench_small
from mpbench import harness, registry


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell_name", mpbench_small.cells())
def test_result_line(cell_name, trace):
    bench = mpbench_small.small(cell_name)[0]
    out, checks = mpbench_small.run(cell_name, 2 ** 31 + 3, 0.2, bool(trace))
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks" and out["checks"] == checks
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 1
    assert set(checks) == {"bad_rows", "value_gap", "best_gap",
                           "jobs_differing", "jobs_unfinished"}
    assert all(c["value"] <= c["limit"] for c in checks.values())
    names = {m["name"] for m in registry.metrics_of(bench, cell_name, trace)}
    assert set(out["metrics"]) <= names
    if trace:
        assert {"busy_s", "window_s"} <= set(out["device"])
        assert "stream_prep_s" in out["metrics"]
    else:
        assert set(out["metrics"]) == names
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] >= 0
    json.dumps(out)


def test_run_loads_no_jax():
    """Rank 0 (this subprocess) by its modules; the other ranks of a cell
    on several cards (gloo, their own processes) by the run, which would
    raise `ForbiddenLoaded` had one of them JAX loaded."""
    four = next(c for c in mpbench_small.cells()
                if mpbench_small.small(c)[1]["chips"] > 1)
    code = ("import sys, time; sys.path[:0] = sys.argv[1:3]; "
            "import mpbench_small; from mpbench import harness; "
            "b, c, cfg, tr = mpbench_small.small('ecg-256k.anytime'); "
            "harness.run_cell(c, cfg, tr, 5, 0.1, False, 'cpu', b, "
            "time.perf_counter()); "
            f"out, _ = mpbench_small.run({four!r}, 5, 0.1); "
            "assert out['correct']; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    here = str(mpbench_small.ROOT / "mpbench" / "tests")
    out = subprocess.run([sys.executable, "-c", code, here,
                          str(mpbench_small.ROOT / "src")],
                         capture_output=True, text=True, check=True).stdout
    loaded = set(eval(out.strip().splitlines()[-1]))
    assert "repro_torch" in loaded
    assert not loaded & set(harness.FORBIDDEN)


RANK_WITH_FLAX = """import sys, types
sys.path[:0] = {paths!r}
sys.modules["flax"] = types.ModuleType("flax")
from mpbench import ranks
sys.exit(ranks.rank_main(sys.argv[1]))
"""


def test_rank_with_jax_loaded_refuses_the_run(tmp_path):
    four = next(c for c in mpbench_small.cells()
                if mpbench_small.small(c)[1]["chips"] > 1)
    rank = tmp_path / "rank.py"
    rank.write_text(RANK_WITH_FLAX.format(paths=sys.path[:]))
    with pytest.raises(harness.ForbiddenLoaded, match="flax"):
        mpbench_small.run(four, 2 ** 31 + 5, 0.1,
                          rank_cmd=[sys.executable, str(rank)])


def test_main_prints_no_result_when_a_rank_loaded_jax(monkeypatch, capsys):
    import types

    import torch

    from mpbench import ranks

    four = next(c for c in mpbench_small.cells()
                if mpbench_small.small(c)[1]["chips"] > 1)

    def launch(*args, **kw):
        raise harness.ForbiddenLoaded("rank 2 had flax loaded")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "card")
    monkeypatch.setattr(ranks, "launch", launch)
    args = types.SimpleNamespace(workload=four, seed=1, seconds=1.0, trace=0)
    assert harness.main(args, 0.0) == 3
    out, err = capsys.readouterr()
    assert out == "" and "flax" in err


def _run_py(root, env_extra=None):
    import os
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    return subprocess.run(
        [sys.executable, "mpbench/run.py", "--workload",
         "ecg-256k.oneshot", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=root, env=env, capture_output=True, text=True)


def test_no_card_no_result():
    proc = _run_py(mpbench_small.ROOT)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_benchmark_alone_no_result(tmp_path):
    shutil.copy(mpbench_small.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(mpbench_small.ROOT / "mpbench", tmp_path / "mpbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run_py(tmp_path, {"PYTHONPATH": ""})
    assert proc.returncode != 0 and proc.stdout.strip() == ""
