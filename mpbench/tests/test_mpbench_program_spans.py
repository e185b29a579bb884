"""The program's spans (`repro_torch.*`) beside the harness's trace: on its
clock and nested inside the harness's spans in small traced runs, read by
their four readers on made-up traces, and changing no earlier reader's
value."""

import json
import types

import pytest
import torch

import mpbench_small
from mpbench import harness, jobs, program_spans, registry
from mpbench.metrics import (checkpoint_read_ms, device_idle_pct,
                             job_host_ms, merge_collective_ms, merge_wait_ms,
                             natsa_warps_per_sm, program_idle_pct,
                             round_device_ms, round_launches, sweep_roofline)
from mpbench.trace import US, Trace
from repro_torch.utils import trace as program_trace

NCCL = "ncclDevKernel_AllReduce_Sum_f32_RING_LL"
CARD = "NVIDIA H100 80GB HBM3"


class _Events:
    """Chrome-trace events in us: spans, and kernels with their launch."""

    def __init__(self):
        self.ev, self.corr = [], 0

    def span(self, name, t0, t1):
        self.ev.append({"ph": "X", "cat": "user_annotation", "name": name,
                        "ts": t0, "dur": t1 - t0})

    def kernel(self, name, at, k0, k1):
        self.corr += 1
        self.ev.append({"ph": "X", "cat": "cuda_runtime", "name": "launch",
                        "ts": at, "dur": 1,
                        "args": {"correlation": self.corr}})
        self.ev.append({"ph": "X", "cat": "kernel", "name": name, "ts": k0,
                        "dur": k1 - k0, "args": {"correlation": self.corr}})


def _anytime(program: bool, sweeps=((10, 60), (10, 30)), nccl=(4, 30)):
    """One rank's window of two jobs, 1000 us apart: each resumes over 100
    us (its checkpoint read 40 us of them), then steps two rounds of 200
    us, each a sweep of `sweeps[r]` (launch offset, length) and a merge
    whose collective lasts `nccl[r]`; the program's spans with `program`."""
    e = _Events()
    e.span("mpbench.window", 0, 2000)
    for j in (0, 1000):
        e.span("mpbench.job", j, j + 600)
        e.span("mpbench.resume", j, j + 100)
        if program:
            e.span("repro_torch.scheduler.resume", j + 2, j + 98)
            e.span("repro_torch.scheduler.checkpoint_read", j + 5, j + 45)
            e.span("repro_torch.scheduler.upload", j + 50, j + 60)
        e.kernel("Memcpy HtoD", j + 55, j + 80, j + 82)
        for r, ((at, length), coll) in enumerate(zip(sweeps, nccl)):
            r0 = j + 100 + 200 * r
            e.span("mpbench.round", r0, r0 + 200)
            if program:
                e.span("repro_torch.scheduler.step_round", r0 + 1, r0 + 199)
                e.span("repro_torch.distributed.sweep", r0 + 2, r0 + 20)
                e.span("repro_torch.distributed.merge", r0 + 25, r0 + 40)
            e.kernel("natsa_sweep", r0 + at, r0 + at + 5,
                     r0 + at + 5 + length)
            e.kernel(NCCL, r0 + 30, r0 + at + 5 + length,
                     r0 + at + 5 + length + coll)
        e.span("mpbench.deliver", j + 500, j + 600)
        if program:
            e.span("repro_torch.scheduler.result", j + 505, j + 520)
    return e.ev


def _spans(events):
    """The program's spans of chrome-trace events, as `program_spans`
    keeps them."""
    out = {}
    for e in events:
        if e.get("cat") == "user_annotation" and e["name"].startswith(
                program_spans.PREFIX):
            t0 = e["ts"] * US
            out.setdefault(e["name"], []).append((t0, t0 + e["dur"] * US))
    return {k: sorted(v) for k, v in out.items()}


def _obs(events):
    return types.SimpleNamespace(
        trace=None if events is None else Trace(events),
        program_spans=None if events is None else _spans(events),
        sweep_span="mpbench.round", cells_per_job=10 ** 9,
        bytes_per_job=10 ** 6, kind=CARD, chips=1)


EARLIER = [device_idle_pct, job_host_ms, round_device_ms, round_launches,
           merge_collective_ms, sweep_roofline]


@pytest.mark.parametrize("reader", EARLIER, ids=lambda m: m.__name__)
def test_earlier_readers_ignore_the_programs_spans(reader):
    bare, full = _obs(_anytime(False)), _obs(_anytime(True))
    assert full.program_spans
    assert reader.read(bare) is not None
    assert reader.read(full) == reader.read(bare)
    # and so they would on a trace that kept the program's spans itself
    joined = types.SimpleNamespace(**dict(vars(full),
                                          trace=program_spans.of(full)))
    assert any(n.startswith("repro_torch.") for n in joined.trace.spans)
    assert reader.read(joined) == reader.read(bare)


def test_breakdown_names_the_innermost_span():
    bare = _obs(_anytime(False)).trace.breakdown()
    assert _obs(_anytime(True)).trace.breakdown() == bare
    full = program_spans.of(_obs(_anytime(True))).breakdown()
    assert full["device_ops"] == bare["device_ops"]
    assert [g for _, g in full["idle_gaps"]] == [g for _, g in
                                                 bare["idle_gaps"]]
    # the window's first gap, before the upload's copy, is the read's
    assert "repro_torch.scheduler.checkpoint_read" in [
        n for n, _ in full["idle_gaps"]]
    assert all(n.startswith("mpbench.") or n == "outside the window"
               for n, _ in bare["idle_gaps"])


def test_program_idle_is_idle_under_a_program_span():
    t = _anytime(True)
    got = program_idle_pct.read(_obs(t))
    # a job: resume 2..98 less the copy 80..82; each step_round
    # r0+1..r0+199 less its sweep and collective (60 + 4, 30 + 30 us); the
    # result 505..520
    idle_us = (96 - 2) + (198 - 64) + (198 - 60) + 15
    assert got == pytest.approx(100.0 * 2 * idle_us / 2000)
    assert got <= device_idle_pct.read(_obs(t))
    assert program_idle_pct.read(_obs(_anytime(False))) is None


def test_checkpoint_read_is_its_wall_a_job():
    assert checkpoint_read_ms.read(_obs(_anytime(True))) == pytest.approx(
        0.040)
    assert checkpoint_read_ms.read(_obs(_anytime(False))) is None


def test_merge_wait_is_the_mean_over_ranks_less_the_last():
    # rank 0 sweeps longest in round 1, rank 1 in round 2
    r0 = _obs(_anytime(True, sweeps=((10, 60), (10, 10)), nccl=(4, 44)))
    r1 = _obs(_anytime(True, sweeps=((10, 10), (10, 50)), nccl=(54, 4)))
    a, b = merge_wait_ms.read(r0), merge_wait_ms.read(r1)
    assert a == pytest.approx([0.004, 0.044] * 2)
    assert b == pytest.approx([0.054, 0.004] * 2)
    # round by round (a + b) / 2 - min(a, b): 0.025, 0.020, 0.025, 0.020
    assert merge_wait_ms.combine([a, b]) == pytest.approx(0.0225)
    assert harness._combine([{"merge_wait_ms": a}, {"merge_wait_ms": b}]) \
        == {"merge_wait_ms": pytest.approx(0.0225)}
    assert merge_wait_ms.read(_obs(_anytime(False))) is None


def test_warps_per_sm_from_the_programs_counters(monkeypatch):
    monkeypatch.setattr(program_trace, "_COUNTS", {})
    obs = _obs(None)
    assert natsa_warps_per_sm.read(obs) is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(
        torch.cuda, "get_device_properties",
        lambda d: types.SimpleNamespace(multi_processor_count=132))
    assert natsa_warps_per_sm.read(obs) is None
    program_trace.count("natsa.launches", 2)
    program_trace.count("natsa.blocks", 2044 + 2044)
    assert natsa_warps_per_sm.read(obs) == pytest.approx(2044 / 132)


def test_no_profiler_no_program_spans():
    # what a program that opens no span of its own gives the readers
    obs = types.SimpleNamespace(trace=Trace(_anytime(False)))
    assert program_spans.of(obs) is None
    assert obs.program_spans == {}
    for reader in (program_idle_pct, checkpoint_read_ms, merge_wait_ms):
        assert reader.read(obs) is None
    assert program_spans.of(types.SimpleNamespace(trace=None)) is None


def test_program_spans_sit_on_the_traces_clock(tmp_path):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("mpbench.window"):
            with program_trace.span("repro_torch.plan.execute"):
                torch.ones(64).sum()
                with program_trace.span("repro_torch.kernels.pad"):
                    torch.ones(64).sum()
            with program_trace.span("repro_torch.plan.execute"):
                torch.ones(64).sum()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    want = _spans(events)
    got = program_spans.from_profiler(prof, Trace(events))
    assert sorted(got) == ["repro_torch.kernels.pad",
                           "repro_torch.plan.execute"]
    assert len(got["repro_torch.plan.execute"]) == 2
    for name, spans in want.items():
        flat = [t for span in spans for t in span]
        assert [t for span in got[name] for t in span] == pytest.approx(
            flat, rel=0, abs=1e-9)


def _traced_window(cell_name, tmp_path):
    """A small job of the cell run in the harness's traced window on the
    CPU, with the harness's spans on; its trace with the program's spans,
    found as the readers find them."""
    bench, cell, cfg, traffic = mpbench_small.small(cell_name)
    data = registry.kind(cfg["kind"]).inputs(cfg, 2 ** 31 + 9)
    span = torch.profiler.record_function
    job = jobs.build(cfg, traffic, data, "cpu", span=span,
                     ckpt_dir=str(tmp_path))
    job.run()
    prof, *_ = harness._window(job, 0.01, True, "cpu", span, None, False)
    job.close()
    t = Trace.from_profiler(prof)
    assert not any(n.startswith("repro_torch.") for n in t.spans)
    return program_spans.of(types.SimpleNamespace(trace=t))


def _inside(t, child, parent):
    """Every `child` span lies inside some `parent` span, and there is
    one."""
    spans = t.spans.get(child, [])
    assert spans, child
    for a, b in spans:
        assert any(p0 <= a and b <= p1 for p0, p1 in t.spans[parent]), \
            (child, parent)


@pytest.mark.parametrize("cell_name,nesting", [
    ("ecg-256k.oneshot", [
        ("repro_torch.plan.plan_sweep", "mpbench.plan"),
        ("repro_torch.plan.execute", "mpbench.sweep"),
        ("repro_torch.kernels.pad", "repro_torch.plan.execute"),
        ("repro_torch.kernels.harvest", "repro_torch.plan.execute")]),
    ("ecg-256k.anytime", [
        ("repro_torch.scheduler.resume", "mpbench.resume"),
        ("repro_torch.scheduler.checkpoint_read",
         "repro_torch.scheduler.resume"),
        ("repro_torch.scheduler.upload", "repro_torch.scheduler.resume"),
        ("repro_torch.scheduler.replan", "repro_torch.scheduler.resume"),
        ("repro_torch.scheduler.step_round", "mpbench.round"),
        ("repro_torch.scheduler.bounds", "repro_torch.scheduler.step_round"),
        ("repro_torch.distributed.sweep", "repro_torch.scheduler.step_round"),
        ("repro_torch.kernels.pad", "repro_torch.distributed.sweep"),
        ("repro_torch.distributed.merge", "repro_torch.scheduler.step_round"),
        ("repro_torch.scheduler.result", "mpbench.deliver")]),
])
def test_small_traced_run_nests_the_programs_spans(cell_name, nesting,
                                                   tmp_path):
    t = _traced_window(cell_name, tmp_path)
    for child, parent in nesting:
        _inside(t, child, parent)
    # each round of the one-worker plan sweeps one chunk and merges once
    if cell_name.endswith("anytime"):
        rounds = len(t.spans["mpbench.round"])
        assert len(t.spans["repro_torch.distributed.sweep"]) == rounds
        assert len(t.spans["repro_torch.distributed.merge"]) == rounds
