"""Anytime rounds over a list of devices in one process — port of
`repro.core.distributed`.

Each worker executes one equal-work diagonal chunk per round, and the
workers' states are merged into the running profile: the reference's
argmax-carrying all-reduce (`pmax_profile`) and its gather + union top-k
(`allreduce_topk`) become local merges over the workers' states, in worker
order, with the reference's tie rules. Worker w runs on `devices[w]` (one
card may repeat; the payload is moved there, a no-op where it already
lives), and the merge happens on `devices[0]`; the workers run one after
another.

Chunks are TWO-SIDED: every cell a worker streams updates both the row
profile P[i] and the column profile P[j] (for AB joins, A's and B's
profiles), so the round plan covers each diagonal exactly once.

At k = 1 a worker's sweep is ONE launch of the NATSA kernel over its chunk
(`kernels.ops.rowmax_chunk` / `ab_rowmax_chunk`; its plain version on CPU
tensors), where the reference sweeps its band engine (ROADMAP.md §C (15)).
At k > 1 the workers sweep the band engine's exact top-k tiles, as the
reference's do. An empty chunk (idle worker, or one already done) sweeps
and launches nothing.

Multi-process rounds over `torch.distributed` are not ported
(ROADMAP.md §A6 (ii)); `plan.round_executor` refuses them.
"""

from __future__ import annotations

import torch

from repro_torch.core.matrix_profile import (
    DEFAULT_RESEED, ProfileState, TopKState, chunk_topk, chunk_topk_ab,
)
from repro_torch.core.zstats import CrossStats, ZStats
from repro_torch.kernels import DEFAULT_DT, DEFAULT_IT, ops


def pmax_profile(states: list[ProfileState]) -> ProfileState:
    """The reference's `pmax_profile` over the workers' states: the max
    correlation, and at a tie the HIGHEST index among the states holding
    it (deterministic)."""
    gmax = states[0].corr
    for s in states[1:]:
        gmax = torch.maximum(gmax, s.corr)
    gidx = torch.full_like(states[0].index, -1)
    for s in states:
        gidx = torch.maximum(gidx, torch.where(s.corr >= gmax, s.index, -1))
    return ProfileState(corr=gmax, index=gidx)


def allreduce_topk(states: list[TopKState]) -> TopKState:
    """The reference's `allreduce_topk` over the workers' `(l, k)` sets:
    candidates ordered slot-major, then by worker, and a stable best-first
    top-k of them (equal values keep that order, as `lax.top_k` does).
    Workers' candidate sets are disjoint (each diagonal belongs to exactly
    one chunk), so the union stays an exact top-k."""
    k = states[0].k
    c = torch.stack([s.corr for s in states], dim=-1)     # (l, k, P)
    i = torch.stack([s.index for s in states], dim=-1)
    c, i = c.reshape(c.shape[0], -1), i.reshape(i.shape[0], -1)
    vals, pos = torch.sort(c, dim=-1, descending=True, stable=True)
    return TopKState(corr=vals[:, :k], index=torch.gather(i, -1, pos[:, :k]))


def live_bands(k0: int, k1: int, n_bands: int, band: int) -> int:
    """Number of band tiles a chunk [k0, k1) touches, capped at the plan's
    `n_bands` (the widest chunk's count)."""
    return min(max(-(-(k1 - k0) // band), 0), n_bands)


def worker_chunk(stats: ZStats, k0: int, k1: int, it: int = DEFAULT_IT,
                 dt: int = DEFAULT_DT) -> ProfileState:
    """Two-sided harvest over the self-join diagonals [k0, k1) in one NATSA
    launch, the row side merged with the column side (row first)."""
    corr_r, idx_r, corr_c, idx_c = ops.rowmax_chunk(stats, k0, k1, it=it,
                                                    dt=dt)
    return ProfileState(corr_r, idx_r).merge(ProfileState(corr_c, idx_c))


def worker_chunk_ab(cross: CrossStats, k0: int, k1: int,
                    it: int = DEFAULT_IT, dt: int = DEFAULT_DT
                    ) -> tuple[ProfileState, ProfileState]:
    """A's row harvest and B's column harvest over the signed diagonals
    [k0, k1) of the AB rectangle, in one NATSA launch: (state_a (l_a,),
    state_b (l_b,))."""
    ca, ia, cb, ib = ops.ab_rowmax_chunk(cross, k0, k1, it=it, dt=dt)
    return ProfileState(ca, ia), ProfileState(cb, ib)


def worker_chunk_topk(stats: ZStats, k0: int, k1: int, n_bands: int,
                      band: int, k: int,
                      reseed_every: int | None = DEFAULT_RESEED) -> TopKState:
    """The merged (l, k) best-first set of every row AND column update of
    the band-aligned chunk [k0, k1): the band engine's top-k tiles, rows
    merged with columns (rows first)."""
    nb = live_bands(k0, k1, n_bands, band)
    rows, col = chunk_topk(stats, k0, nb * band, band, k, reseed_every)
    return rows.merge(col)


def worker_chunk_ab_topk(cross: CrossStats, k0: int, k1: int, n_bands: int,
                         band: int, k: int,
                         reseed_every: int | None = DEFAULT_RESEED
                         ) -> tuple[TopKState, TopKState]:
    """Exact top-k of both AB sides over the signed chunk [k0, k1): the
    band engine's row-clamped top-k tiles, masked per diagonal at k1 (AB
    chunks are not always band-aligned)."""
    nb = live_bands(k0, k1, n_bands, band)
    return chunk_topk_ab(cross, k0, nb * band, band, k, reseed_every,
                         k_hi=k1)


def _chunks(k0s, k1s, devices):
    """(worker, k0, k1) of each non-empty chunk of a round."""
    if len(k0s) != len(devices) or len(k1s) != len(devices):
        raise ValueError(f"a round takes one (k0, k1) per worker: "
                         f"{len(devices)} devices, got {len(k0s)} k0s and "
                         f"{len(k1s)} k1s")
    return [(w, int(a), int(b)) for w, (a, b) in enumerate(zip(k0s, k1s))
            if int(b) > int(a)]


def _on(state, device):
    return type(state)(state.corr.to(device), state.index.to(device))


def make_round_fn(plan, devices: list[torch.device]):
    """The round function of a self-join `SweepPlan` (`plan.round_executor`
    is the only caller; tiling and reseed knobs come off the plan).

    Signature: (stats, running, k0s (P,), k1s (P,)) -> merged state, with
    one (k0, k1) per device; idle workers pass k0 == k1. At k = 1 the
    result is exactly `pmax_profile` over the workers of
    `running.merge(local_w)`, an empty local for an idle worker; plans
    with `harvest.k > 1` merge the workers' locals first
    (`allreduce_topk`), then the running state once, as the reference
    does (a union over P copies of every prior winner would evict true
    top-k entries)."""
    n_bands, band, reseed = plan.n_bands, plan.band, plan.reseed_every
    k, it, dt = plan.harvest.k, plan.it, plan.dt

    def round_fn(stats: ZStats, running, k0s, k1s):
        locals_ = []
        for w, k0, k1 in _chunks(k0s, k1s, devices):
            s = stats.to(devices[w])
            if k > 1:
                loc = worker_chunk_topk(s, k0, k1, n_bands, band, k, reseed)
            else:
                loc = worker_chunk(s, k0, k1, it, dt)
            locals_.append(_on(loc, devices[0]))
        if not locals_:            # every worker idle: nothing merges
            return running
        if k > 1:
            return running.merge(allreduce_topk(locals_))
        return pmax_profile([running.merge(loc) for loc in locals_])

    return round_fn


def make_round_fn_ab(plan, devices: list[torch.device]):
    """AB analogue of `make_round_fn`, carrying both profiles.

    Signature: (cross, running_a, running_b, k0s (P,), k1s (P,))
    -> (merged_a, merged_b). Idle workers pass k0 == k1. The chunks are
    signed diagonal ranges of the rectangle in `cross`'s orientation (A on
    rows, never swapped)."""
    n_bands, band, reseed = plan.n_bands, plan.band, plan.reseed_every
    k, it, dt = plan.harvest.k, plan.it, plan.dt

    def round_fn(cross: CrossStats, running_a, running_b, k0s, k1s):
        loc_a, loc_b = [], []
        for w, k0, k1 in _chunks(k0s, k1s, devices):
            c = cross.to(devices[w])
            if k > 1:
                a, b = worker_chunk_ab_topk(c, k0, k1, n_bands, band, k,
                                            reseed)
            else:
                a, b = worker_chunk_ab(c, k0, k1, it, dt)
            loc_a.append(_on(a, devices[0]))
            loc_b.append(_on(b, devices[0]))
        if not loc_a:
            return running_a, running_b
        if k > 1:
            return (running_a.merge(allreduce_topk(loc_a)),
                    running_b.merge(allreduce_topk(loc_b)))
        return (pmax_profile([running_a.merge(x) for x in loc_a]),
                pmax_profile([running_b.merge(x) for x in loc_b]))

    return round_fn
