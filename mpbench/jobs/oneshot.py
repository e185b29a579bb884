"""oneshot: plan_sweep + execute over streams set-up built once; the merged
profile and its indices delivered to host memory. Spans: mpbench.plan
(`core.plan.plan_sweep`), mpbench.sweep (`core.plan.execute`; the sweep
span), mpbench.deliver (the profile to host)."""

from __future__ import annotations

import time

from mpbench import arith
from mpbench.jobs import Job, sync


class OneShot(Job):
    """`precision` is the program's preset; the cells run its default,
    "f32"."""

    def __init__(self, cfg, traffic, data, device, span, precision="f32"):
        super().__init__(cfg, traffic, data, device, span)
        from repro_torch.core import plan as plan_mod
        from repro_torch.core import zstats

        self.plan_mod = plan_mod
        self.precision = precision
        plan = self._plan()
        t0 = time.perf_counter()
        self.stats = zstats.compute_stats_host(
            data.ts, self.m, **plan_mod.stats_dtypes_for(plan), device=device)
        sync(device)
        self.setup_parts["stream_prep_s"] = time.perf_counter() - t0
        self.bytes = arith.sweep_bytes(self.l, self.l - self.excl)

    def _plan(self):
        return self.plan_mod.plan_sweep(
            self.m, self.l, exclusion=self.excl, device=self.device,
            precision=self.precision)

    def run(self):
        with self.span("mpbench.plan"):
            plan = self._plan()
        with self.span("mpbench.sweep"):
            res = self.plan_mod.execute(plan, self.stats)
        with self.span("mpbench.deliver"):
            return self.deliver(res.dist, res.index)

    def close(self):
        del self.stats


def make(cfg, traffic, data, device, span, ckpt_dir=None, mesh=None, **kw):
    if mesh is not None:
        raise ValueError("a oneshot job runs on one card")
    return OneShot(cfg, traffic, data, device, span, **kw)
