"""Declarative sweep planning: one plan + executor behind every entry point.

Port of `repro.core.plan`. Every entry point builds a frozen `SweepPlan`
with `plan_sweep(...)` and hands it to `execute(...)`. The port has one
backend so far, the CUDA NATSA kernel ("kernel"), and `backend=None`
resolves to it. What the reference plans onto other backends raises
`NotImplementedError` here, naming the ROADMAP.md item that brings it,
rather than quietly taking another path:

  * `backend="engine"`, `"rowstream"`, `"distributed"`;
  * `k > 1` (the reference plans a fallback to its band engine);
  * `normalize=False` and batched plans (`batch=`);
  * a non-default `band` or `clamp_rows`, and a `reseed_every` other than
    its default or None: the CUDA kernel, like the TPU kernel it
    replaces, never reseeds, so the default is recorded for plan parity
    and any other period would be silently ignored.

Kept from the reference: AB orientation (`swap_ab`, the short side on
rows), the exclusion default, the harvest spec, the precision guard rails,
and `col_tile` resolved as the reference resolves it so plans compare
field by field — the CUDA kernel accumulates columns in one flat array and
does not read it. `interpret` becomes `device`: the device the streams,
the sweep and the result live on.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.matrix_profile import (
    DEFAULT_BAND, DEFAULT_RESEED, default_exclusion,
)
from repro_torch.core.precision import (
    DEFAULT_PRECISION, PrecisionSpec, as_precision,
)
from repro_torch.core.result import HarvestSpec
from repro_torch.core.zstats import CrossStats, ZStats, corr_to_dist
from repro_torch.kernels import DEFAULT_DT, DEFAULT_IT
from repro_torch.utils.device import resolve_device

BACKENDS = ("engine", "rowstream", "kernel", "distributed")

# what is not ported yet -> the ROADMAP.md item that brings it
_NOT_PORTED = {
    "engine": "the band engine (ROADMAP.md §A1)",
    "band": ("the band engine's band, clamp_rows and reseed_every options "
             "(ROADMAP.md §A1)"),
    "rowstream": "the rowstream AB sweep (ROADMAP.md §A2)",
    "distributed": "distributed rounds (ROADMAP.md §A6)",
    "topk": "exact top-k harvests, k > 1 (ROADMAP.md §A2)",
    "nonnorm": "non-normalized sweeps, normalize=False (ROADMAP.md §A2)",
    "batch": "batched plans (ROADMAP.md §A2)",
}


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{_NOT_PORTED[what]} is not ported to "
                               "repro_torch yet; the port sweeps through "
                               "the CUDA kernel backend only")


@dataclasses.dataclass(frozen=True)
class SweepPlan:
    """Frozen description of one exact matrix-profile sweep.

    Geometry is in the CALLER's orientation; `swap_ab` records that the
    executor sweeps the transposed rectangle (short side on rows) and maps
    the outputs back. `k_min/k_max` are the signed diagonal span. `it`/`dt`
    pad the streams as the reference pads them; `col_tile` is the
    reference's column-bank policy, resolved identically and unused by the
    CUDA kernel (one flat column accumulator). `band`, `clamp_rows`,
    `n_bands` and `reseed_every` belong to backends not yet ported; the
    planner accepts only their defaults (and `reseed_every=None`).
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
      * `backend=None` -> "kernel"; the other backends, `k > 1`,
        `normalize=False`, `batch`, a non-default `band`/`clamp_rows` and
        a `reseed_every` other than its default or None raise
        `NotImplementedError`;
      * the kernel accumulates in f32 and streams f32/bf16/f16:
        `accum="float64"` and f64 streams raise `ValueError`.
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

    if backend is None:
        backend = "kernel"
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    if backend != "kernel":
        raise _not_ported(backend)
    if spec.k > 1:
        raise _not_ported("topk")
    if not normalize:
        raise _not_ported("nonnorm")
    if batch is not None:
        raise _not_ported("batch")
    if (band != DEFAULT_BAND or clamp_rows is not True
            or reseed_every not in (DEFAULT_RESEED, None)):
        raise _not_ported("band")
    if prec.accum != "float32":
        raise ValueError(f"backend 'kernel' accumulates in f32; "
                         f"accum={prec.accum!r} is engine/rowstream-only")
    if prec.stream == "float64":
        raise ValueError("the CUDA kernel streams float32, bfloat16 or "
                         "float16; stream='float64' is engine-only")
    dev = resolve_device(device)

    swap_ab = kind == "ab" and l_b < l_a
    if kind == "self":
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
    plan: the kernel streams the stats arrays themselves, so they are
    emitted directly in the plan's stream dtype."""
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


def _kernel_dist(corr: torch.Tensor, m: int) -> torch.Tensor:
    from repro_torch.kernels import ops

    return torch.where(corr <= ops.NEG + 1e-6,
                       torch.full((), torch.inf, dtype=corr.dtype,
                                  device=corr.device),
                       corr_to_dist(torch.clamp(corr, -1.0, 1.0), m))


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
    from repro_torch.kernels import ops

    m = plan.window
    # the kernel's two halves ARE the split: row half = right profile
    # (j > i), column half = left profile (j < i)
    corr_r, idx_r, corr_c, idx_c = ops.rowmax_from_stats(
        stats, excl=plan.exclusion, it=plan.it, dt=plan.dt)
    corr, idx = ops._merge_corr(corr_r, idx_r, corr_c, idx_c)
    res = SweepResult(_kernel_dist(corr, m), idx)

    def fin_split():
        return dict(left_p=_kernel_dist(corr_c, m), left_i=idx_c,
                    right_p=_kernel_dist(corr_r, m), right_i=idx_r)

    return _attach(res, ("split",), fin_split, plan.harvest.sides == "both")


def _execute_ab(plan: SweepPlan, stats: CrossStats) -> SweepResult:
    from repro_torch.kernels import ops

    m = plan.window
    corr, idx, corr_b, idx_b = ops.ab_rowmax_from_stats(
        stats, exclusion=plan.exclusion, it=plan.it, dt=plan.dt)
    if plan.swap_ab:
        corr, idx, corr_b, idx_b = corr_b, idx_b, corr, idx
    res = SweepResult(_kernel_dist(corr, m), idx)

    def fin_b():
        # the kernel launch always harvests both halves
        return dict(b_p=_kernel_dist(corr_b, m), b_i=idx_b)

    return _attach(res, ("b",), fin_b, plan.harvest.sides == "both")
