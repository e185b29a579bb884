"""The general generator: the jobs a traffic mix sends. A mix's `job` key
names a module of this package (`jobs/<job>.py`), whose `make` builds the
job; a new kind of job is a new module, found by that name.

Each job builds in set-up what the input needs once, and runs one job at a
time (a closed loop of one client). A job returns the answer it delivered
to host memory, as (distance, index) NumPy arrays. The harness opens a
span around each call into the program (`span(name)`); a job names the
span its sweeps run in (`sweep_span`), which `sweep_roofline` reads.

Delivery copies the profile and its indices into host buffers pinned once
in set-up (plain host memory on the CPU), and the job returns NumPy views
of them: the next job overwrites them. Cells swept are the harness's own
count (`arith`), never the program's.
"""

from __future__ import annotations

import contextlib

import torch

from mpbench import arith, registry


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Job:
    """What every kind gives the harness: `setup_parts` (host seconds by
    part), `cells` and `bytes` of one job, `sweep_span`, and `run`. The
    input is a self-join's (`data.ts`); a job of another kind of input
    sets its own `cells`."""

    sweep_span = "mpbench.sweep"

    def __init__(self, cfg: dict, traffic: dict, data, device, span):
        self.m = int(cfg["window"])
        self.excl = int(cfg["exclusion"])
        self.l = len(data.ts) - self.m + 1
        self.device = device
        self.span = span
        self.setup_parts: dict[str, float] = {}
        self.cells = arith.selfjoin_cells(self.l, self.excl)
        self.rounds_ms: list[float] = []
        self.fraction_done = 1.0
        self.host = None

    def deliver(self, dist: torch.Tensor, index: torch.Tensor):
        """Copy the answer into the host buffers, waiting for the copy."""
        if self.host is None:
            pin = torch.device(self.device).type == "cuda"
            self.host = tuple(torch.empty(t.shape, dtype=t.dtype,
                                          pin_memory=pin)
                              for t in (dist, index))
        for buf, t in zip(self.host, (dist, index)):
            buf.copy_(t)
        return tuple(buf.numpy() for buf in self.host)

    def close(self) -> None:
        """Free the program's state before the reference runs."""


def build(cfg, traffic, data, device, span=None, ckpt_dir=None, mesh=None,
          **kw) -> Job:
    """The job of `traffic["job"]` over the input `data`. `ckpt_dir` is a
    directory every rank reads; `mesh` the worker mesh on several cards."""
    span = span or (lambda name: contextlib.nullcontext())
    return registry.job(traffic["job"]).make(
        cfg, traffic, data, device, span, ckpt_dir=ckpt_dir, mesh=mesh, **kw)
