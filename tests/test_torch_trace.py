"""The port's spans and counters (`repro_torch.utils.trace`): a shared
no-op without a profiler, user annotations nested on the profiler's clock
with one, and the NATSA kernel's counters against its launch geometry."""

import json
import pathlib
import re

import numpy as np
import pytest
import torch

from repro_torch.core.zstats import compute_stats_host
from repro_torch.kernels import DEFAULT_DT, flash_attn, natsa_mp, ops
from repro_torch.utils import trace

CU = (pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
      / "kernels" / "csrc" / "natsa_mp.cu")


def _annotations(prof, tmp_path) -> dict[str, list[tuple[float, float]]]:
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    out: dict[str, list[tuple[float, float]]] = {}
    for e in json.loads(path.read_text())["traceEvents"]:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            out.setdefault(e["name"], []).append(
                (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))))
    return out


def test_span_is_one_shared_no_op_without_a_profiler():
    a, b = trace.span("repro_torch.x.a"), trace.span("repro_torch.x.b")
    assert a is b
    with a:
        with b:
            pass


def test_span_is_a_nested_user_annotation_under_the_profiler(tmp_path):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace.span("repro_torch.test.outer"):
            with trace.span("repro_torch.test.inner"):
                torch.ones(8).sum()
    assert trace.span("repro_torch.test.after") is trace.span("x")
    got = _annotations(prof, tmp_path)
    (o0, o1), = got["repro_torch.test.outer"]
    (i0, i1), = got["repro_torch.test.inner"]
    assert o0 <= i0 <= i1 <= o1


def test_counters_count_copy_and_reset(monkeypatch):
    monkeypatch.setattr(trace, "_COUNTS", {})
    trace.count("natsa.launches")
    trace.count("natsa.blocks", 5)
    trace.count("natsa.blocks", 2)
    snap = trace.counters()
    assert snap == {"natsa.launches": 1, "natsa.blocks": 7}
    snap["natsa.blocks"] = 0
    assert trace.counters()["natsa.blocks"] == 7
    assert natsa_mp.LAUNCHES == 1
    trace.reset()
    assert trace.counters() == {} and natsa_mp.LAUNCHES == 0
    assert flash_attn.LAUNCHES_BY_ROUTE == {"wgmma": 0, "fma": 0}


def test_natsa_blocks_is_the_kernels_grid():
    """`launch_blocks` is the .cu's `(n_diag + DB - 1) / DB` with its DB."""
    src = CU.read_text()
    dpt = int(re.search(r"constexpr int DPT = (\d+);", src).group(1))
    db = eval(re.search(r"constexpr int DB = ([^;]+);", src).group(1),
              {"DPT": dpt})
    assert re.search(r"const int blocks = \(n_diag \+ DB - 1\) / DB;", src)
    assert db == natsa_mp.DIAGONALS_PER_BLOCK
    for n_diag in [0, 1, 8, 127, 128, 129, 255, 256, 262_016, 523_009]:
        assert natsa_mp.launch_blocks(n_diag) == (n_diag + db - 1) // db


def test_plain_sweep_counts_no_launch(monkeypatch):
    monkeypatch.setattr(trace, "_COUNTS", {})
    ts = np.cumsum(np.random.default_rng(3).normal(size=600))
    stats = compute_stats_host(ts, 32, device="cpu")
    ops.rowmax_chunk(stats, 8, stats.n_subsequences)
    assert trace.counters() == {}


@pytest.mark.gpu
def test_natsa_counters_on_card():
    """Each launch counts one and its grid of one-warp blocks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (and nvcc) to run the NATSA kernel")
    ts = np.cumsum(np.random.default_rng(4).normal(size=20000))
    stats = compute_stats_host(ts, 64, device="cuda")
    l = stats.n_subsequences
    spans = [(16, l), (16, 1000), (5000, 5001)]
    before = trace.counters()
    for k0, k1 in spans:
        ops.rowmax_chunk(stats, k0, k1)
    torch.cuda.synchronize()
    after = trace.counters()
    # the padded streams carry whole tiles of DEFAULT_DT diagonals
    blocks = sum(natsa_mp.launch_blocks(-(-(k1 - k0) // DEFAULT_DT)
                                        * DEFAULT_DT) for k0, k1 in spans)
    assert after["natsa.launches"] - before.get("natsa.launches", 0) == 3
    assert after["natsa.blocks"] - before.get("natsa.blocks", 0) == blocks
