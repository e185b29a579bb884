"""The program's own spans, for the readers that read them.

`mpbench.trace.Trace` keeps the harness's spans (`mpbench.*`) alone. The
program opens its own, named `repro_torch.<module>.<step>`, as
`torch.profiler` user annotations in the same profile. `of(obs)` gives the
run's trace with those spans beside the harness's. They are read once from
the window's finished profiler, which the harness holds in a frame that
calls the readers, and kept on `obs` as `obs.program_spans`. A profile
exports its trace once, so they come from the profiler's own events, put on
the trace's clock by the window's span, which both hold.
"""

from __future__ import annotations

import copy
import sys

import torch
from torch.autograd import DeviceType

from mpbench.trace import US, Trace

PREFIX = "repro_torch."
WINDOW = "mpbench.window"


def joined(trace: Trace, program: dict) -> Trace:
    """A copy of `trace` that holds the program's spans beside its own."""
    out = copy.copy(trace)
    out.spans = {**trace.spans, **program}
    return out


def from_profiler(prof, trace: Trace) -> dict[str, list[tuple[float, float]]]:
    """The program's host spans by name, on `trace`'s clock, from a finished
    `torch.profiler.profile`; empty where it holds none, or no window."""
    w = trace.window()
    kineto = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if w is None or kineto is None:
        return {}
    host = [(ev.name(), ev.start_ns(), ev.duration_ns())
            for ev in kineto.events() if ev.device_type() == DeviceType.CPU
            and (ev.name() == WINDOW or ev.name().startswith(PREFIX))]
    starts = [t for name, t, _ in host if name == WINDOW]
    if not starts:
        return {}
    # the trace's time of an event is (start_ns - base) / 1000 us
    base = starts[0] - round(w[0] * 1e9)
    out: dict[str, list[tuple[float, float]]] = {}
    for name, t, d in host:
        if name != WINDOW:
            out.setdefault(name, []).append(
                ((t - base) / 1000 * US, (t + d - base) / 1000 * US))
    for v in out.values():
        v.sort()
    return out


def _window_profiler():
    """The nearest finished profiler held by a calling frame, or None."""
    f = sys._getframe(1)
    while f is not None:
        for v in list(f.f_locals.values()):
            if isinstance(v, torch.profiler.profile):
                return v
        f = f.f_back
    return None


def of(obs) -> Trace | None:
    """`obs.trace` with the program's spans, or None where the run was not
    traced or its trace holds no span of the program."""
    if getattr(obs, "trace", None) is None:
        return None
    program = getattr(obs, "program_spans", None)
    if program is None:
        prof = _window_profiler()
        program = {} if prof is None else from_profiler(prof, obs.trace)
        obs.program_spans = program
    return joined(obs.trace, program) if program else None
