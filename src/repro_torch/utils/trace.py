"""Spans and counters of the library, for an operator who profiles it.

`span(name)` marks a step of the library in a `torch.profiler` trace: while
a profiler session is collecting it is `torch.profiler.record_function`,
so the step lands in the trace as a user annotation on the clock of the
device operations, nested under the span that encloses it on the same
thread; otherwise it is one shared no-op context, at the cost of one
attribute read. Span names are `repro_torch.<module>.<step>`:

  repro_torch.scheduler.resume            AnytimeScheduler.resume, with
    .checkpoint_read                        np.load and the crc32 checks
    .agree                                  the ranks' all-gather (a mesh)
    .upload                                 the resumed state to the device
    .replan                                 replan_remaining + round fn
  repro_torch.scheduler.step_round        one round, with
    .bounds                                 the round's chunk bounds
  repro_torch.scheduler.result            the running answer's result
  repro_torch.distributed.sweep           one worker's chunk in a round
  repro_torch.distributed.merge           a round's merge of the workers
  repro_torch.plan.plan_sweep             the planner
  repro_torch.plan.execute                a plan run on its payload
  repro_torch.kernels.pad                 the NATSA kernel's padded streams
  repro_torch.kernels.natsa_launch        its launch and accumulators
  repro_torch.kernels.harvest             the self-join's side merge and
                                            distance

`count(name, n)` adds to a counter of the process; `counters()` is a copy
of them all and `reset()` clears them. The counters are

  natsa.launches          launches of the NATSA kernel
  natsa.blocks            its one-warp blocks, ceil(n_diag / 128) a launch
  flash_attn.wgmma        flash-attention launches on the wgmma route
  flash_attn.fma          and on the fma route
"""

from __future__ import annotations

import contextlib

import torch
import torch.autograd.profiler as _profiler

_OFF = contextlib.nullcontext()
_COUNTS: dict[str, int] = {}


def span(name: str):
    """A context manager marking `name` in a profiler trace, or a no-op
    when no profiler is collecting."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF


def count(name: str, n: int = 1) -> None:
    _COUNTS[name] = _COUNTS.get(name, 0) + n


def counters() -> dict[str, int]:
    return dict(_COUNTS)


def reset() -> None:
    _COUNTS.clear()
