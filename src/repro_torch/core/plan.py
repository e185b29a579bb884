"""Declarative sweep planning: one plan + executor behind every entry point.

Port of `repro.core.plan`. Every entry point builds a frozen `SweepPlan`
with `plan_sweep(...)` and hands it to `execute(...)`. Two backends are
ported: the CUDA NATSA kernel ("kernel") and the band engine ("engine", the
plain-tensor sweep of `core.matrix_profile`). `backend=None` resolves to
the kernel unless the call asks for what only the engine does — a
non-default `band`, `clamp_rows=False`, a `reseed_every` other than its
default or None, or `accum="float64"` — and the plan records the choice.
(The reference's planner picks its engine by default; the port's hot path
is the kernel.) What the reference plans onto other sweeps raises
`NotImplementedError` here, naming the ROADMAP.md item that brings it,
rather than quietly taking another path:

  * `backend="rowstream"`, `"distributed"`;
  * `k > 1` (the reference plans a fallback to its band engine);
  * `normalize=False` and batched plans (`batch=`);
  * 16-bit self-join streams on the engine (the reference's tile sweep);
  * on the kernel backend, a non-default `band` or `clamp_rows`, and a
    `reseed_every` other than its default or None: the CUDA kernel, like
    the TPU kernel it replaces, never reseeds, so the default is recorded
    for plan parity and any other period would be silently ignored.

Kept from the reference: AB orientation (`swap_ab`, the short side on rows
for the kernel; the engine's row clamp makes it moot), the exclusion
default, the harvest spec, the precision guard rails, and `col_tile`
resolved as the reference resolves it so plans compare field by field —
the CUDA kernel accumulates columns in one flat array and does not read
it; the engine banks its column state by it. `interpret` becomes
`device`: the device the streams, the sweep and the result live on.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.matrix_profile import (
    DEFAULT_BAND, DEFAULT_RESEED, default_exclusion, profile_distance,
)
from repro_torch.core.precision import (
    DEFAULT_PRECISION, PrecisionSpec, as_precision,
)
from repro_torch.core.result import HarvestSpec
from repro_torch.core.zstats import CrossStats, ZStats
from repro_torch.kernels import DEFAULT_DT, DEFAULT_IT
from repro_torch.utils.device import resolve_device

BACKENDS = ("engine", "rowstream", "kernel", "distributed")

# what is not ported yet -> the ROADMAP.md item that brings it
_NOT_PORTED = {
    "rowstream": "the rowstream AB sweep (ROADMAP.md §A2)",
    "distributed": "distributed rounds (ROADMAP.md §A6)",
    "topk": "exact top-k harvests, k > 1 (ROADMAP.md §A2)",
    "nonnorm": "non-normalized sweeps, normalize=False (ROADMAP.md §A2)",
    "batch": "batched plans (ROADMAP.md §A2)",
    "tile": ("the reduced-precision self-join tile sweep that 16-bit streams "
             "take on the band engine, tile_profile_from_stats "
             "(ROADMAP.md §A2)"),
}


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{_NOT_PORTED[what]} is not ported to "
                               "repro_torch yet")


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
    `reseed_every=None`). `n_bands` belongs to distributed plans, not yet
    ported.
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
      * `backend=None` -> "engine" where the call asks for a non-default
        `band`, `clamp_rows=False`, a `reseed_every` other than its default
        or None, or `accum="float64"`; else "kernel";
      * the kernel accumulates in f32 (`accum="float64"` raises
        `ValueError`) and reads f32/bf16/f16 streams: f64 streams are
        rounded to f32 once before the launch, as the reference's kernel
        rounds them on load;
      * the kernel takes none of the engine's band options
        (`NotImplementedError`), and the engine's 16-bit self-join tile
        sweep, `k > 1`, `normalize=False`, `batch` and the other backends
        are not ported (`NotImplementedError`).
    """
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

    band_options = (band != DEFAULT_BAND or clamp_rows is not True
                    or reseed_every not in (DEFAULT_RESEED, None))
    if backend is None:
        backend = ("engine" if band_options or prec.accum != "float32"
                   else "kernel")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    if backend in ("rowstream", "distributed"):
        raise _not_ported(backend)
    if spec.k > 1:
        raise _not_ported("topk")
    if not normalize:
        raise _not_ported("nonnorm")
    if batch is not None:
        raise _not_ported("batch")
    if backend == "kernel":
        if band_options:
            raise NotImplementedError(
                "the band engine's band, clamp_rows and reseed_every options "
                "are not the CUDA kernel's: it never reseeds its f32 "
                "covariance carry; plan backend='engine' (or leave "
                "backend=None) for them")
        if prec.accum != "float32":
            raise ValueError(f"backend 'kernel' accumulates in f32; "
                             f"accum={prec.accum!r} is engine-only")
    elif kind == "self" and prec.reduced_stream:
        raise _not_ported("tile")
    dev = resolve_device(device)

    swap_ab = kind == "ab" and backend == "kernel" and l_b < l_a
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
    plan: both ported sweeps stream the stats arrays themselves, so they
    are emitted directly in the plan's stream dtype."""
    prec = plan.precision
    return dict(out_dtype=prec.stream_dtype, seed_dtype=prec.seed_dtype)


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


# -- executor -----------------------------------------------------------------


def _check_stats(plan: SweepPlan, stats) -> None:
    if plan.kind == "ab":
        ok, what = isinstance(stats, CrossStats), "CrossStats"
    else:
        ok, what = isinstance(stats, ZStats), "ZStats"
    if not ok:
        raise TypeError(f"{plan.kind}/z-norm plan expects {what}, got "
                        f"{type(stats).__name__}")


def execute(plan: SweepPlan, stats) -> SweepResult:
    """Run a plan on its payload: `ZStats` (self) or `CrossStats` in the
    plan's SWEPT orientation (AB; see `cross_stats_for`)."""
    _check_stats(plan, stats)
    if plan.kind == "self":
        return _execute_self(plan, stats)
    return _execute_ab(plan, stats)


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


def _execute_self(plan: SweepPlan, stats: ZStats) -> SweepResult:
    m = plan.window
    eager_split = plan.harvest.sides == "both"
    if plan.backend == "engine":
        from repro_torch.core.matrix_profile import profile_from_stats

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
    corr, idx = ops._merge_corr(corr_r, idx_r, corr_c, idx_c)
    res = SweepResult(profile_distance(corr, m), idx)

    def fin_split():
        return dict(left_p=profile_distance(corr_c, m), left_i=idx_c,
                    right_p=profile_distance(corr_r, m), right_i=idx_r)

    return _attach(res, ("split",), fin_split, eager_split)


def _execute_ab(plan: SweepPlan, stats: CrossStats) -> SweepResult:
    m = plan.window
    two_sided = plan.harvest.sides == "both"
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
