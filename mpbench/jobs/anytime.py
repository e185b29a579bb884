"""anytime: the anytime scheduler. Each job resumes from the empty plan's
checkpoint and steps every round, each to its synchronize. On one card it
has one worker; on several, a 1-D mesh of one rank a card, merging by
collectives, with rank 0 writing the checkpoint every rank resumes from.
Spans: mpbench.resume (`AnytimeScheduler.resume`), mpbench.round (each
`step_round` to its synchronize; the sweep span), mpbench.deliver."""

from __future__ import annotations

import os
import time

from mpbench import arith
from mpbench.jobs import Job, sync


class Anytime(Job):
    sweep_span = "mpbench.round"

    def __init__(self, cfg, traffic, data, device, span, ckpt_dir, mesh=None):
        super().__init__(cfg, traffic, data, device, span)
        from repro_torch.core.scheduler import AnytimeScheduler

        t0 = time.perf_counter()
        self.sch = AnytimeScheduler(
            data.ts, self.m, [device] if mesh is None else mesh,
            band=int(traffic["band"]),
            chunks_per_worker=int(traffic["chunks_per_worker"]),
            exclusion=self.excl)
        sync(device)
        self.setup_parts["stream_prep_s"] = time.perf_counter() - t0
        self.ckpt = os.path.join(ckpt_dir, "empty.npz")
        self.sch.checkpoint(self.ckpt)
        chunks = self.sch.plan.chunks
        self.bytes = sum(arith.sweep_bytes(self.l, max(k1 - k0, 0))
                         for k0, k1 in chunks)
        covered = sum(arith.diagonal_cells(self.l, k0, k1)
                      for k0, k1 in chunks)
        if covered != self.cells:
            raise RuntimeError(f"the scheduler's chunks cover {covered} "
                               f"cells, the self-join {self.cells}")

    def run(self):
        sch = self.sch
        with self.span("mpbench.resume"):
            sch.resume(self.ckpt)
        self.rounds_ms = []
        for _ in range(sch.state.plan.n_rounds):
            t0 = time.perf_counter()
            with self.span("mpbench.round"):
                sch.step_round()
                sync(self.device)
            self.rounds_ms.append(1e3 * (time.perf_counter() - t0))
        self.fraction_done = sch.state.fraction_done
        with self.span("mpbench.deliver"):
            res = sch.result()
            return self.deliver(res.p, res.i)

    def close(self):
        del self.sch


def make(cfg, traffic, data, device, span, ckpt_dir=None, mesh=None, **kw):
    return Anytime(cfg, traffic, data, device, span, ckpt_dir, mesh, **kw)
