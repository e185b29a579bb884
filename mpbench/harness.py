"""One run of one cell: set-up, warm-up, the measured window, the traced
reading of the per-layer metrics, and the comparison that decides
`correct`; then the result line.

`run_cell` does the work on any device, so the tests drive it on the CPU;
`main` is the entry `run.py` calls, which insists on the cards. A cell on
several cards runs one process a card (`ranks`): every rank runs the same
window, rank 0 decides when it closes, reports the times and checks the
answer; each per-layer metric is made from every rank's reading (its
reader's `combine`, else their mean), and every rank looks for JAX in its
own modules once the window has closed.
"""

from __future__ import annotations

import contextlib
import json
import sys
import tempfile
import time
import traceback
import types

import numpy as np
import torch

from mpbench import check, jobs, registry

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
WARMUP_JOBS = 2


class ForbiddenLoaded(RuntimeError):
    """A rank of the run had JAX or the JAX package loaded once the window
    closed: the run prints no result."""


def _span(enabled: bool):
    if not enabled:
        return lambda name: contextlib.nullcontext()
    return torch.profiler.record_function


def _profiler(device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def _window(job, seconds, trace, device, span, group, keep: bool):
    """The measured window: whole jobs, started while `seconds` have not
    passed (rank 0's clock decides on several cards). With `keep`, the
    first job's answer is copied and every later one compared with it in
    place, after its latency is taken; the last answer is returned."""
    lat_ms, rounds_ms, unfinished, failed = [], [], 0, 0
    first, answer, differing = None, None, 0
    prof = _profiler(device) if trace else contextlib.nullcontext()
    with prof:
        with span("mpbench.window"):
            w0 = time.perf_counter()
            while True:
                go = time.perf_counter() - w0 < seconds
                if group is not None:
                    go = group.agree(go)
                if not go:
                    break
                t0 = time.perf_counter()
                try:
                    with span("mpbench.job"):
                        answer = job.run()
                except Exception:
                    if group is not None:    # the other ranks would wait
                        raise
                    traceback.print_exc()    # a failed job counts; go on
                    failed += 1
                    continue
                lat_ms.append(1e3 * (time.perf_counter() - t0))
                rounds_ms.extend(job.rounds_ms)
                unfinished += job.fraction_done < 1.0
                if not keep:
                    continue
                if first is None:
                    first = tuple(a.copy() for a in answer)
                else:
                    differing += not all(np.array_equal(a, b) for a, b in
                                         zip(answer, first))
            w1 = time.perf_counter()
    last = None if answer is None else tuple(a.copy() for a in answer)
    return prof, dict(window_s=w1 - w0, jobs_ms=lat_ms, rounds_ms=rounds_ms,
                      jobs_done=len(lat_ms)), (last, differing), unfinished, \
        failed


def _per_layer(bench, cell, obs) -> dict:
    """This process's reading of each per-layer metric it finds."""
    out = {}
    for m in registry.metrics_of(bench, cell["name"], True):
        v = registry.reader(m["name"]).read(obs)
        if v is not None:
            out[m["name"]] = v
    return out


def _combine(readings: list[dict]) -> dict:
    """Each metric's number from every rank's readings."""
    out = {}
    for name in dict.fromkeys(n for r in readings for n in r):
        vals = [r[name] for r in readings if name in r]
        reader = registry.reader(name)
        combine = getattr(reader, "combine", None)
        out[name] = float(combine(vals) if combine else np.mean(vals))
    return out


def run_cell(cell: dict, cfg: dict, traffic: dict, seed: int, seconds: float,
             trace: bool, device, bench: dict, t_start: float,
             kind: str = "cpu", group=None, tmp: str | None = None):
    """One run. Returns (the result line's object, the compared numbers
    with their limits); on a rank other than 0, (None, None). Rank 0
    raises `ForbiddenLoaded` where another rank had JAX loaded. `tmp` is a
    directory every rank reads (the anytime checkpoint)."""
    with contextlib.ExitStack() as stack:
        if tmp is None:
            tmp = stack.enter_context(
                tempfile.TemporaryDirectory(prefix="mpbench-"))
        return _run(cell, cfg, traffic, seed, seconds, trace, device, bench,
                    t_start, kind, group, tmp)


def _run(cell, cfg, traffic, seed, seconds, trace, device, bench, t_start,
         kind, group, tmp):
    lead = group is None or group.rank == 0
    kind_mod = registry.kind(cfg["kind"])
    data = kind_mod.inputs(cfg, seed)
    span = _span(trace)
    job = jobs.build(cfg, traffic, data, device, span=span, ckpt_dir=tmp,
                     mesh=None if group is None else group.mesh)
    for _ in range(WARMUP_JOBS):
        job.run()
    jobs.sync(device)
    setup_s = time.perf_counter() - t_start

    prof, timed, (last, differing), unfinished, failed = _window(
        job, seconds, trace, device, span, group, keep=lead)
    peak = (torch.cuda.max_memory_allocated(device)
            if torch.device(device).type == "cuda" else 0)
    # what the metric readers read: host-clock times of the window, its
    # jobs and rounds, set-up by part, the harness's count of cells and
    # bytes, the card, and with `--trace 1` the reduced trace
    obs = types.SimpleNamespace(
        cell=cell, cfg=cfg, traffic=traffic, chips=cell["chips"], kind=kind,
        setup_s=setup_s, setup_parts=job.setup_parts, cells_per_job=job.cells,
        bytes_per_job=job.bytes, sweep_span=job.sweep_span, trace=None,
        **timed)
    layer, busy, bd, window_s = {}, 0.0, None, obs.window_s
    if trace:
        from mpbench.trace import Trace
        obs.trace = Trace.from_profiler(prof)
        layer = _per_layer(bench, cell, obs)
        w = obs.trace.window()
        busy = sum(b - a for a, b in obs.trace.busy(*w)) if w else 0.0
        window_s = (w[1] - w[0]) if w else window_s
        bd = obs.trace.breakdown()
    job.close()
    del job
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    # each other rank's JAX modules; rank 0 prints, and `main` looks at
    # its own last
    parts = [(peak, busy, layer, [] if lead else forbidden_modules())]
    if group is not None:
        parts = group.gather(parts[0])
        if not lead:
            return None, None
    found = {r: bad for r, (*_, bad) in enumerate(parts) if bad}
    if found:
        raise ForbiddenLoaded(
            "mpbench: once the window closed, " + "; ".join(
                f"rank {r} had {', '.join(bad)} loaded"
                for r, bad in found.items()))
    peak = max(p for p, _, _, _ in parts)
    busy = sum(b for _, b, _, _ in parts) / len(parts)
    layer = _combine([lay for _, _, lay, _ in parts])

    t0 = time.perf_counter()
    values = kind_mod.readings(data, cfg, last,
                               registry.reference(cfg["reference"]), device)
    print(f"mpbench: the reference's check took "
          f"{time.perf_counter() - t0:.3f} s", file=sys.stderr)
    values["jobs_differing"] = int(differing)
    values["jobs_unfinished"] = int(unfinished)
    correct, checks = check.judge(values, cfg["limits"], kind_mod.EXACT)
    correct = correct and failed == 0 and obs.jobs_done > 0

    metrics = layer if trace else {}
    if not trace:
        for m in registry.metrics_of(bench, cell["name"], False):
            v = registry.reader(m["name"]).read(obs)
            if v is None:
                raise RuntimeError(f"end-to-end metric {m['name']} has no "
                                   "reading")
            metrics[m["name"]] = float(v)
    units = {m["name"]: m["unit"]
             for m in bench["end_to_end"] + bench["per_layer"]}
    dev = {"platform": "gpu" if kind != "cpu" else "cpu", "kind": kind,
           "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": obs.jobs_done + failed,
           "failed": failed,
           "metrics": {k: {"value": v, "unit": units[k]}
                       for k, v in metrics.items()},
           "device": dev}
    if trace:
        dev["busy_s"] = busy
        dev["window_s"] = window_s
        if bd is not None:
            out["breakdown"] = bd
    out["checks"] = checks
    return out, checks


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def main(args, t_start: float) -> int:
    bench = registry.benchmark()
    cell = registry.cell(bench, args.workload)
    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"mpbench: {args.workload} needs {chips} CUDA card(s), this "
              f"machine has {n}", file=sys.stderr)
        return 2
    cfg = registry.config(bench, cell["config"])
    traffic = registry.traffic(cell["traffic"])
    kind = torch.cuda.get_device_name(0)
    try:
        if chips > 1:
            from mpbench import ranks
            out, checks = ranks.launch(cell, cfg, traffic, args.seed,
                                       args.seconds, bool(args.trace), bench,
                                       t_start, kind)
        else:
            out, checks = run_cell(cell, cfg, traffic, args.seed,
                                   args.seconds, bool(args.trace), "cuda:0",
                                   bench, t_start, kind=kind)
    except ForbiddenLoaded as e:
        print(e, file=sys.stderr)
        return 3
    bad = forbidden_modules()
    if bad:
        print(f"mpbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0
