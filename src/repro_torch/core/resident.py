"""Resident corpus-side sweep state — port of `repro.core.resident`.

A query-against-corpus join has an asymmetric cost: the corpus side's
streams and centered windows do not change between queries, the query side
changes every call. Two subsystems keep a corpus resident through this
cache — `StreamingProfile.query` (a growing monitored series queried
between appends) and `serve.ShardedCorpus` (N series loaded once behind
the profile service) — in three layers:

  * a `ResidentSide`: the corpus's host-f64 `ZStats` (on the device) and
    centered-window matrix (z-normalized mode), or its f32 series (raw
    mode), built once per corpus content;
  * an LRU of those sides keyed by the caller's content key — a GENERATION
    counter, not a length, so a content change that keeps the length can
    never serve stale streams;
  * an LRU of `SweepPlan`s keyed by query geometry, so repeated queries of
    one shape skip planning.

Query-time assembly (the query's streams + `cross_stats_from_parts`,
honoring `plan.swap_ab`) is `core.plan.resident_stats`.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ResidentSide:
    """One corpus side, built once and reused across queries.

    z-normalized mode holds `(stats, windows)`: the exact
    `compute_stats_host(..., return_centered_windows=True)` pair, so a
    `cross_stats_from_parts` payload is bitwise what building both sides
    fresh gives. Raw mode holds the f32 series instead. `l` is the side's
    subsequence count, the plans' geometry key."""

    window: int
    normalize: bool
    l: int
    stats: Any = None        # ZStats on the device | None
    windows: Any = None      # (l, m) f64 centered windows, numpy | None
    ts: Any = None           # f32 series on the device (raw mode) | None


def build_side(ts, window: int, normalize: bool = True, *,
               device=None) -> ResidentSide:
    """One corpus side from a raw series (host f64 stream prep), on
    `device` (default the CUDA card)."""
    from repro_torch.core.zstats import compute_stats_host

    dev = resolve_device(device)
    t = np.asarray(ts, np.float64)
    if t.ndim != 1 or t.shape[0] < window:
        raise ValueError(f"resident series must be 1-D with >= {window} "
                         f"points, got shape {t.shape}")
    l = t.shape[0] - window + 1
    if normalize:
        stats, windows = compute_stats_host(t, window, min_subsequences=1,
                                            return_centered_windows=True,
                                            device=dev)
        return ResidentSide(window=window, normalize=True, l=l,
                            stats=stats, windows=windows)
    return ResidentSide(window=window, normalize=False, l=l,
                        ts=torch.as_tensor(t, dtype=torch.float32,
                                           device=dev))


class ReferenceCache:
    """Generation-keyed LRU of `ResidentSide`s and an LRU of query plans.

    `side_max` bounds how many corpus contents or modes stay resident (a
    monitor that appends between queries, or flips distance modes, would
    otherwise keep one O(n·m) window matrix per content it ever queried);
    `plan_max` bounds the plans (one per distinct query length). Plans are
    made for `device` (default the CUDA card)."""

    def __init__(self, window: int, side_max: int = 4, plan_max: int = 8,
                 *, device=None):
        self.window = int(window)
        self.side_max = int(side_max)
        self.plan_max = int(plan_max)
        self.device = str(resolve_device(device))
        self._sides: OrderedDict = OrderedDict()
        self._plans: OrderedDict = OrderedDict()   # geometry-keyed

    def side(self, key, build: Callable[[], ResidentSide]) -> ResidentSide:
        """The resident side for `key` — any hashable that changes whenever
        the content may have (`StreamingProfile` keys `(generation,
        normalize)`; `ShardedCorpus` keys `(series_id, generation,
        normalize)`) — built and LRU-evicting on a miss. `build` must
        return a side of this cache's window."""
        side = self._sides.get(key)
        if side is None:
            side = build()
            if side.window != self.window:
                raise ValueError(f"built side has window {side.window}, "
                                 f"cache expects {self.window}")
            self._sides[key] = side
            while len(self._sides) > self.side_max:
                self._sides.popitem(last=False)
        else:
            self._sides.move_to_end(key)
        return side

    def plan_for(self, side: ResidentSide, l_q: int, *, k: int = 1):
        """The plan of an AB row-harvest sweep of an l_q-subsequence query
        against the resident side, no exclusion (different series), as
        `ab_join` resolves it (a k = 1 z-normalized query runs the NATSA
        kernel). Plans depend on GEOMETRY only — (corpus l, normalize,
        query l, k) — so sides of equal length share one entry (a 64-series
        equal-length corpus plans once, not 64 times)."""
        from repro_torch.core import plan as plan_mod

        key = (side.l, side.normalize, int(l_q), int(k))
        plan = self._plans.get(key)
        if plan is None:
            plan = plan_mod.plan_sweep(
                self.window, int(l_q), side.l, exclusion=0,
                normalize=side.normalize, harvest="row", k=k,
                device=self.device)
            self._plans[key] = plan
            while len(self._plans) > self.plan_max:
                self._plans.popitem(last=False)
        else:
            self._plans.move_to_end(key)
        return plan
