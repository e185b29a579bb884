"""Resident sharded corpus — the data the profile service serves against;
port of `repro.serve.corpus`.

`ShardedCorpus` loads N reference series ONCE: each series' z-stats and
centered-window matrix are computed host-side in f64 (`core.resident.
build_side`, the path `StreamingProfile.query` caches through) and stay
resident for the corpus's lifetime; the f32 streams live on the device of
the series' shard (shards round-robin over `devices`, by default the one
CUDA card), so a sweep runs against streams that already live where it
runs — a query ships O(l_q) query streams and seeds, never corpus state
(NATSA's near-data move, applied to serving).

Series are grouped by (shard, length): a group is the unit of dispatch.
`assemble_pairs` yields the (query, series) pair payloads of one group,
query-major, each a `CrossStats` built by `zstats.cross_stats_from_parts`
— the seed-dot path `compute_cross_stats_host` uses — so every pair is
bitwise what a fresh two-sided build of the same two series gives. The
reference stacks a group's pairs into one vmapped plan (`assemble_batch`);
the port sweeps each pair with the plan `ab_join` would run for it
(ROADMAP.md §C (14)), so it has no stacked payload. Content changes go
through `reload(sid, values)`, which bumps the series' generation — the shared
`ReferenceCache` keys sides by it, so stale streams can never be served.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.resident import ReferenceCache, ResidentSide, build_side
from repro_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ShardGroup:
    """One (shard, geometry) execution group: the series of one shard that
    share a subsequence count, swept together in every batch."""

    shard: int
    l_ref: int                    # per-series subsequence count
    sids: tuple[int, ...]         # series ids, ascending
    device: object = None         # torch device the shard's streams live on


class ShardedCorpus:
    """N reference series resident behind the profile service.

    `devices` (a list of torch devices, default the CUDA card) are where
    shards are placed, round-robin; `n_shards` (default one per device) is
    a LOGICAL count independent of them — it sets the fault granularity (a
    failed shard degrades answers by its series only). On one card every
    shard lives on that card."""

    def __init__(self, series, window: int, *, devices=None,
                 n_shards: int | None = None, normalize: bool = True,
                 plan_max: int = 16):
        self.window = int(window)
        self.normalize = bool(normalize)
        if not self.normalize:
            raise ValueError("ShardedCorpus serves z-normalized joins only, "
                             "as the reference's does; use "
                             "StreamingProfile.query for raw distances")
        self._series = [np.asarray(s, np.float64) for s in series]
        if not self._series:
            raise ValueError("corpus needs at least one series")
        for i, s in enumerate(self._series):
            if s.ndim != 1 or s.shape[0] < self.window:
                raise ValueError(f"series {i} must be 1-D with >= "
                                 f"{self.window} points, got shape {s.shape}")
        self._devices = [resolve_device(d) for d in
                         (devices if devices is not None else [None])]
        if not self._devices:
            raise ValueError("devices must name at least one device")
        if n_shards is None:
            n_shards = len(self._devices)
        self.n_shards = min(int(n_shards), len(self._series))
        if self.n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        # per-series generation counters: reload() bumps, and the shared
        # ReferenceCache keys sides by (sid, gen, normalize)
        self._gens = [0] * len(self._series)
        self._refs = ReferenceCache(self.window,
                                    side_max=2 * len(self._series) + 2,
                                    plan_max=plan_max,
                                    device=self._devices[0])
        for sid in range(len(self._series)):
            self.side(sid)               # load once, resident from here on

    # -- residency ---------------------------------------------------------

    @property
    def n_series(self) -> int:
        return len(self._series)

    def shard_of(self, sid: int) -> int:
        return sid % self.n_shards

    def device_of(self, shard: int):
        return self._devices[shard % len(self._devices)]

    def side(self, sid: int) -> ResidentSide:
        """Series `sid`'s resident side (streams on its shard's device +
        f64 centered windows on the host), built on first access and cached
        by (sid, generation, normalize)."""
        norm = self.normalize
        return self._refs.side(
            (sid, self._gens[sid], norm),
            lambda: build_side(self._series[sid], self.window,
                               normalize=norm,
                               device=self.device_of(self.shard_of(sid))))

    def reload(self, sid: int, values) -> None:
        """Replace series `sid`'s content. Bumps its generation, so every
        cached side consumer sees fresh streams on next access — a
        same-length reload can never serve stale streams."""
        v = np.asarray(values, np.float64)
        if v.ndim != 1 or v.shape[0] < self.window:
            raise ValueError(f"reload needs a 1-D series with >= "
                             f"{self.window} points, got shape {v.shape}")
        self._series[sid] = v
        self._gens[sid] += 1
        self.side(sid)                   # re-resident immediately

    def groups(self) -> list[ShardGroup]:
        """Execution groups, shard-major then length-major — the batcher's
        fan-out order."""
        by_key: dict[tuple[int, int], list[int]] = {}
        for sid, s in enumerate(self._series):
            key = (self.shard_of(sid), s.shape[0] - self.window + 1)
            by_key.setdefault(key, []).append(sid)
        return [ShardGroup(shard=sh, l_ref=l, sids=tuple(sids),
                           device=self.device_of(sh))
                for (sh, l), sids in sorted(by_key.items())]

    # -- sweep assembly ----------------------------------------------------

    def plan_for(self, group: ShardGroup, l_q: int, *, k: int = 1):
        """The per-pair plan of the group's query geometry (shared
        geometry-keyed LRU), on the group's device."""
        plan = self._refs.plan_for(self.side(group.sids[0]), l_q, k=k)
        dev = str(group.device)
        return plan if plan.device == dev else dataclasses.replace(
            plan, device=dev)

    def assemble_pairs(self, group: ShardGroup, queries: list, plan):
        """Yield the (query, series) pair payloads of one group sweep, one
        `CrossStats` each, in the plan's SWEPT orientation (`plan.swap_ab`
        puts the series on rows).

        `queries` holds `(s_q, w_q)` parts (query z-stats + centered
        windows, computed ONCE per query by the front-end and reused across
        every group). Pairs come query-major — pair `q * S + s` is query q
        against `group.sids[s]` — and lazily, so a caller that launches
        each pair's sweep as it comes overlaps the card's work with the
        next pair's host seeds. The seeds are `cross_stats_from_parts`'
        f64 `wa[1:] @ wb[0]` / `wb @ wa[0]`, rounded to f32 once, so each
        pair's streams are bitwise a fresh `compute_cross_stats_host`
        build of the same two series."""
        from repro_torch.core.zstats import cross_stats_from_parts

        sides = [self.side(sid) for sid in group.sids]
        for s_q, w_q in queries:
            s_q = s_q.to(group.device)
            for side in sides:
                if plan.swap_ab:
                    yield cross_stats_from_parts(side.stats, side.windows,
                                                 s_q, w_q)
                else:
                    yield cross_stats_from_parts(s_q, w_q, side.stats,
                                                 side.windows)
