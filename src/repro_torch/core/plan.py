"""Declarative sweep planning: one plan + executor behind every entry point.

Port of `repro.core.plan`. Every entry point builds a frozen `SweepPlan`
with `plan_sweep(...)` and hands it to `execute(...)`. Four backends are
ported: the CUDA NATSA kernel ("kernel"), the band engine ("engine", the
plain-tensor sweep of `core.matrix_profile`, with its exact top-k, its
nonnorm recurrence and the 16-bit self-join tile sweep), the
row-streamed AB sweep ("rowstream") and the anytime scheduler's rounds
("distributed", run round by round through `round_executor` over a list
of devices in one process or a 1-D `DeviceMesh`, one rank per worker;
k = 1 chunks launch the NATSA kernel). `backend=None` resolves an unbatched
k = 1 z-normalized plan to the kernel unless the call asks for what only
the engine does — a non-default `band`, `clamp_rows=False`, a
`reseed_every` other than its default or None, or `accum="float64"`;
every other plan (k > 1, `batch=`, `normalize=False`) resolves as the
reference resolves it (rowstream for short z-normalized AB sides, else the
engine). The plan records the choice. Batched plans sweep each series of a
stacked payload as the unbatched plan would. What the reference plans onto
other sweeps raises `NotImplementedError` here rather than quietly taking
another path: on the kernel backend a non-default `band` or `clamp_rows`,
and a `reseed_every` other than its default or None (on a k = 1
distributed plan `clamp_rows=False` and such a `reseed_every`) — the CUDA
kernel, like the TPU kernel it replaces, never reseeds, so the default is
recorded for plan parity and any other period would be silently ignored. `_NOT_PORTED` is empty: nothing of the
reference's planner is left to port.

Kept from the reference: AB orientation (`swap_ab`, the short side on rows
for the kernel and rowstream; the engine's row clamp makes it moot), the
exclusion default, the harvest spec, every `ValueError` guard rail, and
`col_tile` resolved as the reference resolves it so plans compare field
by field — the CUDA kernel accumulates columns in one flat array and does
not read it; the engine banks its k = 1 column state by it. `interpret`
becomes `device`: the device the streams, the sweep and the result live
on.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.matrix_profile import (
    AB_ROWSTREAM_MAX_ROWS, DEFAULT_BAND, DEFAULT_RESEED, default_exclusion,
    profile_distance,
)
from repro_torch.core.precision import (
    DEFAULT_PRECISION, PrecisionSpec, as_precision,
)
from repro_torch.core.result import HarvestSpec
from repro_torch.core.zstats import CrossStats, ZStats
from repro_torch.kernels import DEFAULT_DT, DEFAULT_IT
from repro_torch.utils import trace
from repro_torch.utils.device import resolve_device

BACKENDS = ("engine", "rowstream", "kernel", "distributed")

# what is not ported yet -> the ROADMAP.md item that brings it
_NOT_PORTED: dict[str, str] = {}


@dataclasses.dataclass(frozen=True)
class SweepPlan:
    """Frozen description of one exact matrix-profile sweep.

    Geometry is in the CALLER's orientation; `swap_ab` records that the
    executor sweeps the transposed rectangle (short side on rows) and maps
    the outputs back. `k_min/k_max` are the signed diagonal span. `it`/`dt`
    pad the streams as the reference pads them; `col_tile` is the
    reference's column-bank policy, resolved identically; the CUDA kernel
    does not read it (one flat column accumulator), the engine banks its
    AB column state by it. `band`, `clamp_rows` and `reseed_every` are the
    band engine's; a kernel plan holds their defaults (or
    `reseed_every=None`). `n_bands` is a distributed plan's band count of
    its widest chunk, stamped in after partitioning.
    """

    # -- geometry ----------------------------------------------------------
    kind: str                       # "self" | "ab"
    l_a: int
    l_b: int | None
    window: int
    exclusion: int
    # -- normalization -----------------------------------------------------
    normalize: bool = True
    # -- harvest -----------------------------------------------------------
    harvest: HarvestSpec = HarvestSpec()
    swap_ab: bool = False
    # -- tiling ------------------------------------------------------------
    band: int = DEFAULT_BAND
    clamp_rows: bool = True
    col_tile: int | None = None
    n_bands: int | None = None
    it: int = DEFAULT_IT
    dt: int = DEFAULT_DT
    # -- reseed policy -----------------------------------------------------
    reseed_every: int | None = DEFAULT_RESEED
    # -- backend -----------------------------------------------------------
    backend: str = "kernel"
    device: str = "cuda"            # where streams, sweep and result live
    batch: int | None = None
    # -- precision ---------------------------------------------------------
    precision: PrecisionSpec = DEFAULT_PRECISION

    @property
    def k_min(self) -> int:
        return self.exclusion if self.kind == "self" else -(self.l_a - 1)

    @property
    def k_max(self) -> int:
        return self.l_a if self.kind == "self" else self.l_b


@dataclasses.dataclass
class SweepResult:
    """Everything an executed plan harvested, in the caller's orientation:
    the merged profile, the B side of an AB join, the left/right split of
    a self-join, top-k sets, and `raw` — `{group: closure}` finishes over
    retained tensors that `ProfileResult`'s lazy attributes call."""

    dist: torch.Tensor
    index: torch.Tensor
    dist_b: torch.Tensor | None = None
    index_b: torch.Tensor | None = None
    left_dist: torch.Tensor | None = None
    left_index: torch.Tensor | None = None
    right_dist: torch.Tensor | None = None
    right_index: torch.Tensor | None = None
    topk_dist: torch.Tensor | None = None
    topk_index: torch.Tensor | None = None
    topk_dist_b: torch.Tensor | None = None
    topk_index_b: torch.Tensor | None = None
    raw: dict | None = None


def _kernel_self_col_tile(l: int, excl: int, it: int, dt: int,
                          col_tile: int | None) -> int:
    """The reference's plan-time column-bank policy for kernel self-joins:
    0 = one flat bank, else the bank width."""
    from repro_torch.kernels import ops

    n_rows = -(-l // it)
    n_diags = -(-max(l - excl, 1) // dt)
    flat_len = n_rows * it + excl + n_diags * dt
    ct = ops.auto_col_tile(flat_len, it, dt, col_tile)
    return 0 if ct is None else ct


def plan_sweep(window: int, l_a: int, l_b: int | None = None, *,
               exclusion: int | None = None, normalize: bool = True,
               harvest: str | HarvestSpec = "merged", k: int = 1,
               backend: str | None = None,
               band: int = DEFAULT_BAND, clamp_rows: bool = True,
               col_tile: int | None = None,
               reseed_every: int | None = DEFAULT_RESEED,
               it: int = DEFAULT_IT, dt: int = DEFAULT_DT,
               device=None,
               batch: int | None = None,
               precision: PrecisionSpec | str | None = None) -> SweepPlan:
    """Planner: fill in every sweep decision. `l_a`/`l_b` are SUBSEQUENCE
    counts (n - window + 1). `device=None` is the CUDA card and raises on a
    host without one. Rules pinned here:
      * `backend=None` for an unbatched k = 1 z-normalized plan -> "engine"
        where the call asks for a non-default `band`, `clamp_rows=False`, a
        `reseed_every` other than its default or None, or
        `accum="float64"`; else "kernel";
      * `backend=None` for any other plan (k > 1, `batch`, nonnorm) ->
        resolved as the reference resolves it: "rowstream" for an
        unbatched, row-clamped z-normalized AB join whose short side has at
        most AB_ROWSTREAM_MAX_ROWS rows (and at least k), else "engine";
        16-bit self-join streams on the engine take the tile sweep;
      * k > 1 on `backend="kernel"` plans the engine instead, with
        `col_tile` dropped (the kernel's accumulators are k = 1); top-k
        needs exclusion >= 1 on a self-join, k <= band, k <= min(l_a, l_b)
        on rowstream, flat accumulation, row clamping and f32 or wider
        streams;
      * batched plans run the engine or the AB rowstream;
      * the kernel accumulates in f32 (`accum="float64"` raises
        `ValueError`) and reads f32/bf16/f16 streams: f64 streams are
        rounded to f32 once before the launch, as the reference's kernel
        rounds them on load;
      * distributed plans accumulate in f32; `round_executor` runs them;
      * every `ValueError` of the reference's planner is raised here too,
        before the port's own refusals (`NotImplementedError`): the kernel
        takes none of the engine's band options, and a k = 1 distributed
        plan, whose chunks run the kernel, takes neither `clamp_rows=False`
        nor a `reseed_every` other than its default or None (its `band`
        still aligns the chunks).
    """
    with trace.span("repro_torch.plan.plan_sweep"):
        m = int(window)
        prec = as_precision(precision)
        kind = "self" if l_b is None else "ab"
        if exclusion is None:
            excl = default_exclusion(m) if kind == "self" else 0
        else:
            excl = int(exclusion)
        if isinstance(harvest, HarvestSpec):
            spec = harvest if int(k) == 1 else dataclasses.replace(harvest,
                                                                   k=int(k))
        else:
            spec = HarvestSpec(sides=harvest, k=int(k))
        topk = spec.k > 1

        if topk and not normalize:
            raise ValueError("top-k (k > 1) harvests are z-normalized only: "
                             "the nonnorm engines carry no top-k "
                             "accumulator")
        if topk and backend == "kernel":
            # the CUDA kernel's accumulators are k = 1: the band engine answers
            # the same plan from one sweep; col_tile was the kernel's knob
            backend = "engine"
            col_tile = None
        if topk and kind == "self" and excl == 0:
            raise ValueError(
                "self-join top-k needs exclusion >= 1: with exclusion=0 "
                "every cell (i, i) is harvested by both the row and column "
                "sides, so the union would hold the self-match twice")
        if topk and spec.k > int(band):
            raise ValueError(f"k={spec.k} exceeds band={band}: the band "
                             "engines reduce top-k over the band axis; raise "
                             "band or lower k")

        band_options = (band != DEFAULT_BAND or clamp_rows is not True
                        or reseed_every not in (DEFAULT_RESEED, None))
        if backend is None:
            if not topk and batch is None and normalize:
                backend = ("engine" if band_options or prec.accum != "float32"
                           else "kernel")
            elif (kind == "ab" and normalize and batch is None and clamp_rows
                  and min(l_a, l_b) <= AB_ROWSTREAM_MAX_ROWS
                  and spec.k <= min(l_a, l_b)):
                backend = "rowstream"
            else:
                backend = "engine"
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
        if backend in ("rowstream", "kernel") and not normalize:
            raise ValueError(f"backend {backend!r} is z-normalized only")
        if backend == "rowstream" and kind != "ab":
            raise ValueError("rowstream sweeps the AB rectangle; self-joins "
                             "use the band engine (or the kernel)")
        if backend == "rowstream" and spec.k > min(l_a, l_b):
            raise ValueError(f"rowstream top-k needs k <= min(l_a, l_b) = "
                             f"{min(l_a, l_b)}, got k={spec.k}")
        if batch is not None and backend not in ("engine", "rowstream"):
            raise ValueError("batched plans run the band engine or the AB "
                             f"rowstream; backend {backend!r} cannot batch")
        if batch is not None and not normalize:
            raise ValueError("batched plans are z-normalized only")
        if topk and col_tile is not None:
            raise ValueError("the banked column accumulator (col_tile) is "
                             "k=1-only; top-k plans accumulate flat")
        if topk and not clamp_rows:
            raise ValueError("clamp_rows=False is the k=1 A/B-comparison "
                             "sweep; top-k plans always row-clamp")
        if prec.reduced_stream and not normalize:
            raise ValueError("16-bit streams are z-normalized only")
        if not normalize and kind == "ab" and not prec.is_default:
            raise ValueError("nonnorm AB joins run the fixed f32 pipeline")
        if prec.reduced_stream and topk:
            raise ValueError("top-k harvests with 16-bit streams are not "
                             "supported: use f32 streams")
        if backend in ("kernel", "distributed") and prec.accum != "float32":
            raise ValueError(f"backend {backend!r} accumulates in f32; "
                             f"accum={prec.accum!r} is engine/rowstream-only")

        if backend == "kernel" and band_options:
            raise NotImplementedError(
                "the band engine's band, clamp_rows and reseed_every options "
                "are not the CUDA kernel's: it never reseeds its f32 "
                "covariance carry; plan backend='engine' (or leave "
                "backend=None) for them")
        if backend == "distributed" and not topk and (
                clamp_rows is not True
                or reseed_every not in (DEFAULT_RESEED, None)):
            raise NotImplementedError(
                "the band engine's clamp_rows and reseed_every options are "
                "not the CUDA kernel's, which runs the k = 1 distributed "
                "chunks (ROADMAP.md §C (15)): it never reseeds its f32 "
                "covariance carry; band still sets the chunk alignment")
        dev = resolve_device(device)

        # short side onto rows for the backends whose row axis is streamed
        swap_ab = (kind == "ab" and backend in ("rowstream", "kernel")
                   and l_b < l_a)
        if backend == "kernel" and kind == "self":
            col_tile = _kernel_self_col_tile(l_a, excl, it, dt, col_tile)

        return SweepPlan(kind=kind, l_a=int(l_a),
                         l_b=None if l_b is None else int(l_b),
                         window=m, exclusion=excl, normalize=normalize,
                         harvest=spec, swap_ab=swap_ab, band=int(band),
                         clamp_rows=clamp_rows, col_tile=col_tile,
                         it=int(it), dt=int(dt), reseed_every=reseed_every,
                         backend=backend, device=str(dev), batch=batch,
                         precision=prec)


def stats_dtypes_for(plan: SweepPlan) -> dict:
    """The `(out_dtype, seed_dtype)` kwargs host stream prep needs under a
    plan. The 16-bit self-join on the engine (the tile sweep) takes f32
    stats and rounds only the CENTERED windows to the 16-bit dtype inside
    the sweep: rounding the series first would scale the centering error
    by the series' level, not the window's deviation. Every other sweep
    streams the stats themselves, emitted in the plan's stream dtype."""
    prec = plan.precision
    if (plan.kind == "self" and plan.normalize and prec.reduced_stream
            and plan.backend == "engine"):
        return dict(out_dtype=torch.float32, seed_dtype=prec.seed_dtype)
    return dict(out_dtype=prec.stream_dtype, seed_dtype=prec.seed_dtype)


def raw_series(plan: SweepPlan, ts) -> torch.Tensor:
    """A nonnorm plan's payload: the raw series in the plan's stream dtype,
    on its device (an AB plan executes the `(ts_a, ts_b)` pair)."""
    return torch.as_tensor(ts, dtype=plan.precision.stream_dtype,
                           device=plan.device)


def cross_stats_for(plan: SweepPlan, ts_a, ts_b) -> CrossStats:
    """Host-side stream prep for an AB plan, in the plan's SWEPT
    orientation (the one place that honors `swap_ab`), on the plan's
    device."""
    from repro_torch.core.zstats import compute_cross_stats_host

    if plan.kind != "ab" or not plan.normalize:
        raise ValueError("cross_stats_for prepares z-normalized AB plans; "
                         f"got kind={plan.kind!r} "
                         f"normalize={plan.normalize}")
    kw = dict(stats_dtypes_for(plan), device=plan.device)
    if plan.swap_ab:               # stream the short side as rows
        return compute_cross_stats_host(ts_b, ts_a, plan.window, **kw)
    return compute_cross_stats_host(ts_a, ts_b, plan.window, **kw)


def resident_stats(plan: SweepPlan, query, resident):
    """`cross_stats_for`'s resident twin: the `execute` payload of an AB
    plan whose corpus side (`core.resident.ResidentSide`) was built once
    and stays cached across queries. Only the QUERY's streams are computed
    here; `plan.swap_ab` is honored here, so resident callers never orient
    the rectangle by hand. Assembly is `cross_stats_from_parts`, the seed
    path of `compute_cross_stats_host`, so the payload is bitwise what
    building both sides fresh gives. A nonnorm plan gets the `(query,
    corpus series)` pair. Resident sides hold default-precision streams
    only, so other precisions are refused."""
    if plan.kind != "ab":
        raise ValueError(f"resident_stats prepares AB plans, got "
                         f"kind={plan.kind!r}")
    if not plan.precision.is_default:
        raise ValueError("resident corpus sides cache default-precision "
                         "streams only; plan a default-precision sweep or "
                         "build CrossStats directly via cross_stats_for")
    if resident.normalize != plan.normalize:
        raise ValueError(f"resident side is "
                         f"normalize={resident.normalize}, plan wants "
                         f"normalize={plan.normalize}")
    if not plan.normalize:
        return (raw_series(plan, query), resident.ts.to(plan.device))
    from repro_torch.core.zstats import (
        compute_stats_host, cross_stats_from_parts,
    )

    s_q, w_q = compute_stats_host(query, plan.window, min_subsequences=1,
                                  return_centered_windows=True,
                                  device=plan.device)
    s_c = resident.stats.to(plan.device)
    if plan.swap_ab:               # corpus shorter than the query: B on rows
        return cross_stats_from_parts(s_c, resident.windows, s_q, w_q)
    return cross_stats_from_parts(s_q, w_q, s_c, resident.windows)


# -- executor -----------------------------------------------------------------


def _check_stats(plan: SweepPlan, stats) -> None:
    if not plan.normalize:
        ok = (isinstance(stats, tuple) if plan.kind == "ab"
              else isinstance(stats, torch.Tensor))
        what = "(ts_a, ts_b) raw series" if plan.kind == "ab" else "raw series"
    elif plan.kind == "ab":
        ok, what = isinstance(stats, CrossStats), "CrossStats"
    else:
        ok, what = isinstance(stats, ZStats), "ZStats"
    if not ok:
        raise TypeError(f"{plan.kind}/{'z-norm' if plan.normalize else 'raw'} "
                        f"plan expects {what}, got {type(stats).__name__}")


def execute(plan: SweepPlan, stats) -> SweepResult:
    """Run a plan on its payload: `ZStats` (self) or `CrossStats` in the
    plan's SWEPT orientation (AB; see `cross_stats_for`), or for a nonnorm
    plan the raw series tensor (self) or the `(ts_a, ts_b)` pair (AB; see
    `raw_series`). A batched plan takes the same payload stacked
    (`zstats.stack_stats`) and sweeps each series as the unbatched plan
    would, so every stacked field equals the sequential calls bit for
    bit. Distributed plans run round by round through `round_executor`."""
    with trace.span("repro_torch.plan.execute"):
        if plan.batch is not None:
            return _execute_batched(plan, stats)
        _check_stats(plan, stats)
        if plan.backend == "distributed":
            raise ValueError("distributed plans execute round-by-round: "
                             "build the round fn with round_executor(plan, "
                             "devices) — AnytimeScheduler drives it")
        if plan.kind == "self":
            return _execute_self(plan, stats)
        return _execute_ab(plan, stats)


_RESULT_FIELDS = tuple(f.name for f in dataclasses.fields(SweepResult)
                       if f.name != "raw")


def _execute_batched(plan: SweepPlan, stack) -> SweepResult:
    from repro_torch.core.zstats import unstack_stats

    one = dataclasses.replace(plan, batch=None)
    parts = unstack_stats(stack)
    if len(parts) != plan.batch:
        raise ValueError(f"plan batches {plan.batch} series, the payload "
                         f"stacks {len(parts)}")
    outs = [execute(one, p) for p in parts]
    res = SweepResult(**{
        f: torch.stack([getattr(o, f) for o in outs])
        for f in _RESULT_FIELDS if getattr(outs[0], f) is not None})
    if outs[0].raw:
        def stacked(fns):
            def fin():
                done = [fn() for fn in fns]
                return {key: torch.stack([d[key] for d in done])
                        for key in done[0]}
            return fin

        res.raw = {g: stacked([o.raw[g] for o in outs])
                   for g in outs[0].raw}
    return res


# public lazy-field name -> SweepResult field, for eager materialization
_SWEEP_FIELD_OF = {
    "left_p": "left_dist", "left_i": "left_index",
    "right_p": "right_dist", "right_i": "right_index",
    "b_p": "dist_b", "b_i": "index_b",
    "b_topk_p": "topk_dist_b", "b_topk_i": "topk_index_b",
}


def _attach(res: SweepResult, groups: tuple[str, ...], fin, eager: bool):
    """Wire a finish closure for `groups` into `res`: materialized now
    under sides="both", else installed as a zero-sweep `raw` provider."""
    if eager:
        for pub, val in fin().items():
            setattr(res, _SWEEP_FIELD_OF[pub], val)
    else:
        if res.raw is None:
            res.raw = {}
        for g in groups:
            res.raw[g] = fin
    return res


def _execute_self(plan: SweepPlan, stats) -> SweepResult:
    m = plan.window
    eager_split = plan.harvest.sides == "both"
    if not plan.normalize:
        from repro_torch.core.matrix_profile import (
            nonnorm_profile_from_ts, nonnorm_to_distance,
        )

        split = nonnorm_profile_from_ts(
            stats.to(plan.precision.stream_dtype), m, plan.exclusion,
            plan.band, accum_dtype=plan.precision.accum)
        res = SweepResult(nonnorm_to_distance(split.merged),
                          split.merged.index)

        def fin_nonnorm_split():
            return dict(left_p=nonnorm_to_distance(split.left),
                        left_i=split.left.index,
                        right_p=nonnorm_to_distance(split.right),
                        right_i=split.right.index)

        return _attach(res, ("split",), fin_nonnorm_split, eager_split)
    if plan.harvest.k > 1:
        from repro_torch.core.matrix_profile import profile_topk_from_stats

        merged, rows, col = profile_topk_from_stats(
            stats, plan.exclusion, plan.band, plan.reseed_every,
            plan.harvest.k, accum_dtype=plan.precision.accum)
        # the merged profile IS slot 0 of the top-k conversion, so the
        # top-k fields come at no extra cost; the split stays deferred
        dk = merged.to_distance(m)
        res = SweepResult(dk[..., 0], merged.index[..., 0], topk_dist=dk,
                          topk_index=merged.index)

        def fin_topk_split():
            return dict(left_p=col.to_distance(m)[..., 0],
                        left_i=col.index[..., 0],
                        right_p=rows.to_distance(m)[..., 0],
                        right_i=rows.index[..., 0])

        return _attach(res, ("split",), fin_topk_split, eager_split)
    if plan.backend == "engine":
        from repro_torch.core.matrix_profile import (
            profile_from_stats, tile_profile_from_stats,
        )

        if plan.precision.reduced_stream:
            # the recurrence-free tile sweep: the engine's one self-join
            # path for 16-bit streams
            split = tile_profile_from_stats(
                stats, plan.exclusion, stream_dtype=plan.precision.stream,
                accum_dtype=plan.precision.accum)
        else:
            split = profile_from_stats(stats, plan.exclusion, plan.band,
                                       plan.reseed_every,
                                       accum_dtype=plan.precision.accum)
        res = SweepResult(split.merged.to_distance(m), split.merged.index)

        def fin_split():
            return dict(left_p=split.left.to_distance(m),
                        left_i=split.left.index,
                        right_p=split.right.to_distance(m),
                        right_i=split.right.index)

        return _attach(res, ("split",), fin_split, eager_split)
    from repro_torch.kernels import ops

    # the kernel's two halves ARE the split: row half = right profile
    # (j > i), column half = left profile (j < i)
    corr_r, idx_r, corr_c, idx_c = ops.rowmax_from_stats(
        stats, excl=plan.exclusion, it=plan.it, dt=plan.dt)
    with trace.span("repro_torch.kernels.harvest"):
        corr, idx = ops._merge_corr(corr_r, idx_r, corr_c, idx_c)
        res = SweepResult(profile_distance(corr, m), idx)

    def fin_split():
        return dict(left_p=profile_distance(corr_c, m), left_i=idx_c,
                    right_p=profile_distance(corr_r, m), right_i=idx_r)

    return _attach(res, ("split",), fin_split, eager_split)


def _execute_ab(plan: SweepPlan, stats) -> SweepResult:
    m = plan.window
    two_sided = plan.harvest.sides == "both"
    if not plan.normalize:
        from repro_torch.core.matrix_profile import ab_join_nonnorm

        # the nonnorm sweep really skips the column harvest when one-sided:
        # a lazily read B side recomputes through the same plan
        ts_a, ts_b = stats
        return SweepResult(*ab_join_nonnorm(
            ts_a, ts_b, m, plan.exclusion, plan.band, two_sided=two_sided,
            clamp_rows=plan.clamp_rows))
    if plan.harvest.k > 1:
        return _execute_ab_topk(plan, stats, two_sided)
    if plan.backend == "rowstream":
        from repro_torch.core.matrix_profile import ab_join_rowstream

        sa, sb = ab_join_rowstream(stats, plan.exclusion, plan.reseed_every,
                                   accum_dtype=plan.precision.accum)
        if plan.swap_ab:
            sa, sb = sb, sa
        res = SweepResult(sa.to_distance(m), sa.index)

        def fin_b_rowstream():
            # B's state IS rowstream's running accumulator
            return dict(b_p=sb.to_distance(m), b_i=sb.index)

        return _attach(res, ("b",), fin_b_rowstream, two_sided)
    if plan.backend == "engine":
        from repro_torch.core.matrix_profile import ab_join_from_stats

        # the row clamp makes orientation moot (never swapped); a minimal
        # plan really skips B's column state, so B has no raw finish: lazy
        # access re-executes the same plan with sides="both"
        sa, sb = ab_join_from_stats(stats, plan.exclusion, plan.band,
                                    plan.reseed_every, two_sided,
                                    plan.clamp_rows, plan.col_tile,
                                    accum_dtype=plan.precision.accum)
        return SweepResult(sa.to_distance(m), sa.index,
                           sb.to_distance(m) if two_sided else None,
                           sb.index if two_sided else None)
    from repro_torch.kernels import ops

    corr, idx, corr_b, idx_b = ops.ab_rowmax_from_stats(
        stats, exclusion=plan.exclusion, it=plan.it, dt=plan.dt)
    if plan.swap_ab:
        corr, idx, corr_b, idx_b = corr_b, idx_b, corr, idx
    res = SweepResult(profile_distance(corr, m), idx)

    def fin_b():
        # the kernel launch always harvests both halves
        return dict(b_p=profile_distance(corr_b, m), b_i=idx_b)

    return _attach(res, ("b",), fin_b, two_sided)


def _execute_ab_topk(plan: SweepPlan, stats: CrossStats,
                     two_sided: bool) -> SweepResult:
    """k > 1 AB plans: rowstream's per-row top-k with B's union, or the
    band engine's `(l, k)` accumulators — one sweep either way. Rowstream
    always carries both sides, so a minimal plan defers B, not drops it."""
    from repro_torch.core.matrix_profile import (
        ab_join_rowstream_topk, ab_join_topk_from_stats,
    )

    m = plan.window
    k = plan.harvest.k
    if plan.backend == "rowstream":
        ta, tb = ab_join_rowstream_topk(stats, plan.exclusion,
                                           plan.reseed_every, k,
                                           accum_dtype=plan.precision.accum)
        if plan.swap_ab:
            ta, tb = tb, ta
    else:
        ta, tb = ab_join_topk_from_stats(stats, plan.exclusion, plan.band,
                                         plan.reseed_every, two_sided, k,
                                         accum_dtype=plan.precision.accum)
    da = ta.to_distance(m)
    res = SweepResult(da[..., 0], ta.index[..., 0], topk_dist=da,
                      topk_index=ta.index)
    if tb is None:
        return res

    def fin_b_topk():
        db = tb.to_distance(m)        # one conversion serves both groups
        return dict(b_p=db[..., 0], b_i=tb.index[..., 0], b_topk_p=db,
                    b_topk_i=tb.index)

    return _attach(res, ("b", "b_topk"), fin_b_topk, two_sided)


def round_executor(plan: SweepPlan, devices):
    """Executor entry for distributed plans: the round function the
    `AnytimeScheduler` steps (the only caller of
    `distributed.make_round_fn` / `make_round_fn_ab`). `devices` takes the
    place of the reference's `(mesh, axis)`: either one torch device per
    worker, where one card may repeat (the workers run in this process,
    one after another, and their states merge on `devices[0]`), or a 1-D
    `DeviceMesh` of workers (`launch.mesh.make_worker_mesh()`; from a
    larger mesh, `mesh["workers"]`), one rank per worker, merged by
    collectives. Under a group of more than one rank a device list raises
    `ValueError`: every rank would run all the workers. The plan must
    carry `n_bands` — the band count of the widest chunk — which the
    scheduler knows only after partitioning (use `dataclasses.replace`)."""
    if plan.backend != "distributed":
        raise ValueError(f"round_executor needs a distributed plan, got "
                         f"backend {plan.backend!r}")
    if plan.n_bands is None:
        raise ValueError("distributed plan lacks n_bands: "
                         "dataclasses.replace(plan, n_bands=...) after "
                         "partitioning")
    from repro_torch.core import distributed

    make = (distributed.make_round_fn_ab if plan.kind == "ab"
            else distributed.make_round_fn)
    if distributed._is_mesh(devices):
        return make(plan, devices)
    ranks = distributed._group_size()
    if ranks > 1:
        raise ValueError(f"a device list runs every worker on each of the "
                         f"torch.distributed group's {ranks} ranks: pass a "
                         "1-D DeviceMesh of workers "
                         "(launch.mesh.make_worker_mesh())")
    devs = [resolve_device(d) for d in devices]
    if not devs:
        raise ValueError("devices must name at least one device")
    return make(plan, devs)
