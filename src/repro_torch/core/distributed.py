"""Anytime rounds, one worker per device or one per rank — port of
`repro.core.distributed`.

Each worker executes one equal-work diagonal chunk per round, and the
workers' states are merged into the running profile with the reference's
argmax-carrying all-reduce (`pmax_profile`) and its gather + union top-k
(`allreduce_topk`), under the reference's tie rules. The workers are
either

  * a list of torch devices in one process: worker w runs on
    `devices[w]` (one card may repeat; the payload is moved there, a no-op
    where it already lives), the workers run one after another, idle ones
    are skipped, and the merges are local ones on `devices[0]`; or
  * a 1-D `DeviceMesh` (`launch.mesh.make_worker_mesh()`), one rank per
    worker, which takes the place of the reference's `(mesh, axis)`: rank
    r sweeps chunk r on its own device (`cuda:LOCAL_RANK` under NCCL, the
    CPU under gloo) and the merges are collectives over the mesh's group
    (`_pmax_group`: two MAX all-reduces, O(l) a side; `_allreduce_topk_group`:
    one all-gather of each side's (l, k) set). An idle rank merges an empty
    state, as the reference's idle workers do; that gives the list path's
    bits (`tests/test_torch_distributed_mp.py`).

Chunks are TWO-SIDED: every cell a worker streams updates both the row
profile P[i] and the column profile P[j] (for AB joins, A's and B's
profiles), so the round plan covers each diagonal exactly once.

At k = 1 a worker's sweep is ONE launch of the NATSA kernel over its chunk
(`kernels.ops.rowmax_chunk` / `ab_rowmax_chunk`; its plain version on CPU
tensors), where the reference sweeps its band engine (ROADMAP.md §C (15)).
At k > 1 the workers sweep the band engine's exact top-k tiles, as the
reference's do. An empty chunk (idle worker, or one already done) sweeps
and launches nothing.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core.matrix_profile import (
    DEFAULT_RESEED, NEG, ProfileState, TopKState, chunk_topk, chunk_topk_ab,
)
from repro_torch.core.zstats import CrossStats, ZStats
from repro_torch.kernels import DEFAULT_DT, DEFAULT_IT, ops
from repro_torch.utils import trace


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


def _is_mesh(devices) -> bool:
    from torch.distributed.device_mesh import DeviceMesh

    return isinstance(devices, DeviceMesh)


def _group_size() -> int:
    """Ranks in the default process group (1 where none is up)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def _rank_device(mesh) -> torch.device:
    """This rank's device on `mesh`: the card `launch.mesh.init_group`
    selected (LOCAL_RANK) under NCCL, the host under gloo."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _worker_group(mesh):
    """(group, size, this rank's worker index) of a 1-D worker mesh; the
    index is the rank's place in the group, the order of `all_gather`."""
    if mesh.ndim != 1:
        raise ValueError(f"rounds take a 1-D mesh of workers, got "
                         f"{mesh.ndim} dims {mesh.mesh_dim_names}: pass "
                         "mesh['workers']")
    group = mesh.get_group()
    return group, mesh.size(), dist.get_rank(group)


def _agree(mesh, what: str, values) -> None:
    """Raise ValueError on EVERY rank unless all ranks of `mesh` hold the
    same int64 `values` (one all-gather): ranks handed different inputs
    stop here rather than merge unrelated profiles."""
    group, size, _ = _worker_group(mesh)
    mine = torch.tensor([int(v) for v in values], dtype=torch.int64,
                        device=_rank_device(mesh))
    got = [torch.empty_like(mine) for _ in range(size)]
    dist.all_gather(got, mine, group=group)
    rows = [g.tolist() for g in got]
    bad = [r for r, v in enumerate(rows) if v != rows[0]]
    if bad:
        raise ValueError(f"ranks {bad} hold another {what} than rank 0: "
                         f"{rows}")


def _pmax_group(state: ProfileState, group) -> ProfileState:
    """`pmax_profile` over the ranks of `group`, as the reference's: a MAX
    all-reduce of the correlations, then a MAX all-reduce of the indices
    of the states holding the maximum (ties -> the highest index)."""
    gmax = state.corr.clone()
    dist.all_reduce(gmax, op=dist.ReduceOp.MAX, group=group)
    gidx = torch.where(state.corr >= gmax, state.index, -1)
    dist.all_reduce(gidx, op=dist.ReduceOp.MAX, group=group)
    return ProfileState(corr=gmax, index=gidx)


def _allreduce_topk_group(state: TopKState, group, size: int) -> TopKState:
    """`allreduce_topk` over the ranks of `group`: each rank's (l, k) set
    gathered in rank order, then the list union."""
    cs = [torch.empty_like(state.corr) for _ in range(size)]
    ids = [torch.empty_like(state.index) for _ in range(size)]
    dist.all_gather(cs, state.corr.contiguous(), group=group)
    dist.all_gather(ids, state.index.contiguous(), group=group)
    return allreduce_topk([TopKState(c, i) for c, i in zip(cs, ids)])


def _empty_like(state):
    return type(state)(torch.full_like(state.corr, NEG),
                       torch.full_like(state.index, -1))


def _chunks(k0s, k1s, n: int):
    """(worker, k0, k1) of each non-empty chunk of a round of n workers."""
    if len(k0s) != n or len(k1s) != n:
        raise ValueError(f"a round takes one (k0, k1) per worker: "
                         f"{n} workers, got {len(k0s)} k0s and "
                         f"{len(k1s)} k1s")
    return [(w, int(a), int(b)) for w, (a, b) in enumerate(zip(k0s, k1s))
            if int(b) > int(a)]


def _on(state, device):
    return type(state)(state.corr.to(device), state.index.to(device))


def _sweep(plan, payload, k0: int, k1: int) -> tuple:
    """One worker's chunk: (state,) of a self-join, (state_a, state_b) of
    an AB join."""
    n_bands, band, reseed = plan.n_bands, plan.band, plan.reseed_every
    k, it, dt = plan.harvest.k, plan.it, plan.dt
    if plan.kind == "ab":
        if k > 1:
            return worker_chunk_ab_topk(payload, k0, k1, n_bands, band, k,
                                        reseed)
        return worker_chunk_ab(payload, k0, k1, it, dt)
    if k > 1:
        return (worker_chunk_topk(payload, k0, k1, n_bands, band, k,
                                  reseed),)
    return (worker_chunk(payload, k0, k1, it, dt),)


def _list_round(plan, devices: list[torch.device]):
    """(payload, running states, k0s, k1s) -> merged states: the workers
    one after another in this process, merged on `devices[0]`."""
    k = plan.harvest.k

    def round_fn(payload, runnings, k0s, k1s):
        locals_ = []
        for w, k0, k1 in _chunks(k0s, k1s, len(devices)):
            with trace.span("repro_torch.distributed.sweep"):
                locals_.append([_on(x, devices[0]) for x in
                                _sweep(plan, payload.to(devices[w]), k0,
                                       k1)])
        if not locals_:            # every worker idle: nothing merges
            return runnings
        sides = zip(runnings, zip(*locals_))
        with trace.span("repro_torch.distributed.merge"):
            if k > 1:
                return tuple(run.merge(allreduce_topk(list(locs)))
                             for run, locs in sides)
            return tuple(pmax_profile([run.merge(x) for x in locs])
                         for run, locs in sides)

    return round_fn


def _mesh_round(plan, mesh):
    """The same round with one rank per worker: rank r sweeps chunk r (an
    idle rank an empty state) and the merges are collectives. A round in
    which every worker is idle returns the running states on every rank
    without a collective (every rank sees the same bounds)."""
    group, size, rank = _worker_group(mesh)
    dev = _rank_device(mesh)
    k = plan.harvest.k

    def round_fn(payload, runnings, k0s, k1s):
        if not _chunks(k0s, k1s, size):
            return runnings
        k0, k1 = int(k0s[rank]), int(k1s[rank])
        if k1 > k0:
            with trace.span("repro_torch.distributed.sweep"):
                loc = _sweep(plan, payload.to(dev), k0, k1)
        else:
            loc = tuple(_empty_like(run) for run in runnings)
        with trace.span("repro_torch.distributed.merge"):
            if k > 1:
                return tuple(run.merge(_allreduce_topk_group(x, group, size))
                             for run, x in zip(runnings, loc))
            return tuple(_pmax_group(run.merge(x), group)
                         for run, x in zip(runnings, loc))

    return round_fn


def _round(plan, devices):
    return (_mesh_round(plan, devices) if _is_mesh(devices)
            else _list_round(plan, devices))


def make_round_fn(plan, devices):
    """The round function of a self-join `SweepPlan` (`plan.round_executor`
    is the only caller; tiling and reseed knobs come off the plan).
    `devices` is a list of torch devices, one per worker, or a 1-D
    `DeviceMesh`, one rank per worker.

    Signature: (stats, running, k0s (P,), k1s (P,)) -> merged state, with
    one (k0, k1) per worker; idle workers pass k0 == k1. At k = 1 the
    result is exactly `pmax_profile` over the workers of
    `running.merge(local_w)`, an empty local for an idle worker; plans
    with `harvest.k > 1` merge the workers' locals first
    (`allreduce_topk`), then the running state once, as the reference
    does (a union over P copies of every prior winner would evict true
    top-k entries)."""
    round_ = _round(plan, devices)

    def round_fn(stats: ZStats, running, k0s, k1s):
        return round_(stats, (running,), k0s, k1s)[0]

    return round_fn


def make_round_fn_ab(plan, devices):
    """AB analogue of `make_round_fn`, carrying both profiles.

    Signature: (cross, running_a, running_b, k0s (P,), k1s (P,))
    -> (merged_a, merged_b). Idle workers pass k0 == k1. The chunks are
    signed diagonal ranges of the rectangle in `cross`'s orientation (A on
    rows, never swapped)."""
    round_ = _round(plan, devices)

    def round_fn(cross: CrossStats, running_a, running_b, k0s, k1s):
        return round_(cross, (running_a, running_b), k0s, k1s)

    return round_fn
