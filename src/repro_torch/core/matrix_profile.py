"""Public entry points of the exact z-normalized join — port of the entry
layer of `repro.core.matrix_profile`.

`matrix_profile(ts, m)` is the self-join and `ab_join(a, b, m)` the AB
join. Each validates its series, plans a sweep (`core.plan.plan_sweep`),
builds the f64 host streams, executes the plan and wraps a
`ProfileResult`. In this port the sweep is the CUDA NATSA kernel
(`kernels/csrc/natsa_mp.cu`), which harvests both profile sides of each
cell from one pass. The reference's band engine, rowstream, top-k,
non-normalized and batched sweeps are not ported yet: asking for them
raises `NotImplementedError` at plan time, as do a non-default `band`
and a `reseed_every` other than its default or None: the kernel never
reseeds its f32 covariance carry.
"""

from __future__ import annotations

# plan fields the reference's planner fills from these (kept so plans
# compare field by field; the kernel backend does not read them)
DEFAULT_RESEED = 512
DEFAULT_BAND = 256


def default_exclusion(window: int) -> int:
    return max(1, -(-int(window) // 4))


def matrix_profile(ts, window: int, exclusion: int | None = None,
                   band: int = DEFAULT_BAND,
                   reseed_every: int | None = DEFAULT_RESEED, *,
                   k: int = 1, harvest: str = "merged",
                   normalize: bool = True, precision=None,
                   device=None) -> "ProfileResult":
    """Full exact matrix profile -> `ProfileResult` on `device` (default
    the CUDA card; `device="cpu"` runs the kernel's plain version).

    `result.p` / `result.i` are the merged profile; the LEFT/RIGHT split
    (`result.left_p` / `result.right_p`, the sweep's column and row halves)
    finishes lazily from the retained halves, or eagerly with
    `harvest="both"`. `precision` (None, "bf16", "f16" or a
    `PrecisionSpec`) sets the stream dtype; accumulation is f32.
    """
    from repro_torch.core import plan as plan_mod
    from repro_torch.core.result import build_result
    from repro_torch.core.validate import validate_series
    from repro_torch.core.zstats import compute_stats_host

    m = int(window)
    arr = validate_series(ts, m, require_finite=not normalize)
    plan = plan_mod.plan_sweep(m, arr.shape[0] - m + 1, exclusion=exclusion,
                               normalize=normalize, band=band,
                               reseed_every=reseed_every, k=k,
                               harvest=harvest, precision=precision,
                               device=device)
    stats = compute_stats_host(arr, m, device=plan.device,
                               **plan_mod.stats_dtypes_for(plan))
    res = plan_mod.execute(plan, stats)
    return build_result(plan, res, stats)


def ab_join(ts_a, ts_b, window: int, *, exclusion: int | None = None,
            band: int = DEFAULT_BAND,
            reseed_every: int | None = DEFAULT_RESEED,
            normalize: bool = True, return_b: bool = False,
            k: int = 1, precision=None, device=None) -> "ProfileResult":
    """AB join: for every subsequence of A, its nearest neighbour in B.

    `result.p[i]` is the distance and `result.i[i]` the matching start in
    B. With `return_b=True` B's profile against A (`result.b_p/b_i`) comes
    eagerly from the same sweep; otherwise it finishes lazily. No exclusion
    zone by default; with one, ab_join(ts, ts, m, exclusion=e) equals
    matrix_profile(ts, m, exclusion=e). The rectangle is swept with its
    short side on rows (`swap_ab`); callers never see the orientation.
    """
    from repro_torch.core import plan as plan_mod
    from repro_torch.core.result import build_result
    from repro_torch.core.validate import validate_series

    m = int(window)
    a = validate_series(ts_a, m, name="ts_a", require_finite=not normalize)
    b = validate_series(ts_b, m, name="ts_b", require_finite=not normalize)
    plan = plan_mod.plan_sweep(m, a.shape[0] - m + 1, b.shape[0] - m + 1,
                               exclusion=exclusion, normalize=normalize,
                               harvest="both" if return_b else "merged",
                               band=band, reseed_every=reseed_every, k=k,
                               precision=precision, device=device)
    stats = plan_mod.cross_stats_for(plan, a, b)
    res = plan_mod.execute(plan, stats)
    return build_result(plan, res, stats)
