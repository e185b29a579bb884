"""Per-layer readers on a made-up trace, and how a cell's number is made
from every rank's reading."""

import types

import pytest

import mpbench_small  # noqa: F401
from mpbench import harness
from mpbench.metrics import merge_collective_ms, round_device_ms
from mpbench.trace import Trace


def _trace(rounds):
    """A trace of one rank: each round a span of 100 us from `start`, with
    (name, launch offset, kernel start offset, kernel length) in us."""
    ev, corr = [], 0
    for start, kernels in rounds:
        ev.append({"ph": "X", "cat": "user_annotation", "name": "mpbench.round",
                   "ts": start, "dur": 100})
        for name, at, k0, length in kernels:
            corr += 1
            ev.append({"ph": "X", "cat": "cuda_runtime", "name": "launch",
                       "ts": start + at, "dur": 1,
                       "args": {"correlation": corr}})
            ev.append({"ph": "X", "cat": "kernel", "name": name,
                       "ts": start + k0, "dur": length,
                       "args": {"correlation": corr}})
    return Trace(ev)


def _obs(rounds):
    return types.SimpleNamespace(trace=_trace(rounds))


NCCL = "ncclDevKernel_AllReduce_Sum_f32_RING_LL"


def test_merge_time_is_the_last_rank_to_arrive():
    # rank 0 sweeps long and arrives last in round 1; rank 1 in round 2
    r0 = _obs([(0, [("natsa_sweep", 1, 2, 60), (NCCL, 70, 70, 4)]),
               (1000, [("natsa_sweep", 1, 2, 10), (NCCL, 20, 20, 44)])])
    r1 = _obs([(0, [("natsa_sweep", 1, 2, 10), (NCCL, 20, 20, 54)]),
               (1000, [("natsa_sweep", 1, 2, 50), (NCCL, 60, 60, 6)])])
    a, b = merge_collective_ms.read(r0), merge_collective_ms.read(r1)
    assert a == pytest.approx([0.004, 0.044]) and b == pytest.approx(
        [0.054, 0.006])
    assert merge_collective_ms.combine([a, b]) == pytest.approx(0.005)
    assert harness._combine([{"merge_collective_ms": a},
                             {"merge_collective_ms": b}]) == {
        "merge_collective_ms": pytest.approx(0.005)}


def test_merge_reads_nothing_without_collectives():
    assert merge_collective_ms.read(
        _obs([(0, [("natsa_sweep", 1, 2, 60)])])) is None


def test_other_metrics_are_the_mean_over_ranks():
    r0 = _obs([(0, [("natsa_sweep", 1, 2, 60)])])
    r1 = _obs([(0, [("natsa_sweep", 1, 2, 20)])])
    got = harness._combine([{"round_device_ms": round_device_ms.read(r0)},
                            {"round_device_ms": round_device_ms.read(r1)}])
    assert got["round_device_ms"] == pytest.approx(0.040)
