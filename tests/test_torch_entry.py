"""The port's slice end to end on the CPU (`device="cpu"`): entry points,
planner and result object against the reference package.

Profiles are compared in correlation space (distances amplify ~1e-6 corr
error near corr = 1): within 1e-4, indices equal except at near-ties.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import ab_join as ref_ab_join
from repro.core import matrix_profile as ref_matrix_profile
from repro.core import plan as rplan
from repro.kernels import ops as rops
from repro_torch.core import ab_join, matrix_profile
from repro_torch.core import plan as tplan
from repro_torch.core.result import ProfileResult
from repro_torch.kernels import ops as tops

TOL = 1e-4


def _walk(n, seed):
    return np.cumsum(np.random.default_rng(seed).normal(size=n))


def _corr(dist, m):
    d = np.asarray(dist, np.float64)
    return np.where(np.isfinite(d), 1.0 - d * d / (2.0 * m), -np.inf)


def _assert_profile(ref_p, ref_i, port_p, port_i, m):
    assert isinstance(port_p, torch.Tensor) and port_p.dtype == torch.float32
    assert port_i.dtype == torch.int32
    cr, cp = _corr(ref_p, m), _corr(port_p.numpy(), m)
    assert cr.shape == cp.shape
    np.testing.assert_array_equal(np.isfinite(cp), np.isfinite(cr))
    fin = np.isfinite(cr)
    np.testing.assert_allclose(cp[fin], cr[fin], rtol=0, atol=TOL)
    mism = np.asarray(ref_i) != port_i.numpy()
    assert np.abs(cp[mism & fin] - cr[mism & fin]).max(initial=0) < TOL


@pytest.mark.parametrize("n,m,excl", [(400, 16, None), (700, 24, None),
                                      (513, 20, 0), (360, 12, 7)])
def test_matrix_profile_matches_reference(n, m, excl):
    ts = _walk(n, seed=n + m)
    port = matrix_profile(ts, m, exclusion=excl, device="cpu")
    kern = rops.natsa_matrix_profile(ts, m, exclusion=excl, it=128, dt=8)
    eng = ref_matrix_profile(ts, m, exclusion=excl)
    for ref in (kern, eng):
        _assert_profile(ref.p, ref.i, port.p, port.i, m)
        _assert_profile(ref.left_p, ref.left_i, port.left_p, port.left_i, m)
        _assert_profile(ref.right_p, ref.right_i, port.right_p,
                        port.right_i, m)


def test_matrix_profile_missing_data():
    ts = _walk(600, seed=3)
    ts[200:205] = np.nan
    port = matrix_profile(ts, 20, device="cpu")
    ref = ref_matrix_profile(ts, 20)
    _assert_profile(ref.p, ref.i, port.p, port.i, 20)
    assert np.isinf(port.p.numpy()).any()


@pytest.mark.parametrize("na,nb,m,excl", [
    (500, 260, 16, None),      # l_b < l_a: the plan swaps (short side on rows)
    (240, 520, 16, None),
    (420, 380, 20, 9),         # exclusion split into two spans
])
def test_ab_join_matches_reference(na, nb, m, excl):
    a, b = _walk(na, seed=na), _walk(nb, seed=nb + 1)
    port = ab_join(a, b, m, exclusion=excl, return_b=True, device="cpu")
    kern = rops.natsa_ab_join(a, b, m, exclusion=excl, it=128, dt=8,
                              return_b=True)
    eng = ref_ab_join(a, b, m, exclusion=excl, return_b=True)
    for ref in (kern, eng):
        _assert_profile(ref.p, ref.i, port.p, port.i, m)
        _assert_profile(ref.b_p, ref.b_i, port.b_p, port.b_i, m)


def test_ab_join_with_exclusion_equals_self_join():
    ts = _walk(500, seed=21)
    self_res = matrix_profile(ts, 16, exclusion=4, device="cpu")
    ab_res = ab_join(ts, ts, 16, exclusion=4, device="cpu")
    torch.testing.assert_close(ab_res.p, self_res.p, rtol=0, atol=1e-3)


def _plan_fields(plan) -> dict:
    out = {}
    for f in dataclasses.fields(plan):
        if f.name in ("interpret", "device"):
            continue
        v = getattr(plan, f.name)
        out[f.name] = dataclasses.asdict(v) if dataclasses.is_dataclass(v) \
            else v
    return out


@pytest.mark.parametrize("args,kw", [
    ((64, 9000), {}),                                  # banked col_tile
    ((16, 485), {}),
    ((16, 485), dict(exclusion=0, col_tile=0)),
    ((32, 600), dict(harvest="both", precision="bf16")),
    ((16, 300, 900), {}),
    ((16, 900, 300), dict(harvest="both")),             # swap_ab
    ((16, 500, 400), dict(exclusion=7, precision="f16", it=64, dt=16)),
    ((16, 485), dict(reseed_every=None)),
])
def test_plan_matches_reference(args, kw):
    ref = rplan.plan_sweep(*args, backend="kernel", **kw)
    port = tplan.plan_sweep(*args, device="cpu", **kw)
    assert {f.name for f in dataclasses.fields(port)} - {"device"} == \
        {f.name for f in dataclasses.fields(ref)} - {"interpret"}
    assert _plan_fields(port) == _plan_fields(ref)
    assert (port.k_min, port.k_max) == (ref.k_min, ref.k_max)
    assert port.device == "cpu"


def test_result_fields_and_metadata_match_reference():
    ts = _walk(400, seed=5)
    port = matrix_profile(ts, 16, device="cpu")
    ref = rops.natsa_matrix_profile(ts, 16, it=128, dt=8)
    assert isinstance(port, ProfileResult)
    assert port.LAZY_FIELDS == type(ref).LAZY_FIELDS
    assert port._META == type(ref)._META
    for f in port._META:
        assert getattr(port, f) == getattr(ref, f), f
    assert port.has_split() and not port.has_topk()
    assert port.b_p is None and port.topk_p is None
    assert port.n_subsequences == ref.n_subsequences
    assert repr(port).startswith("ProfileResult(l=385")
    with pytest.raises(dataclasses.FrozenInstanceError):
        port.p = None
    for op in (lambda r: list(r), lambda r: r[0], lambda r: len(r)):
        with pytest.raises(TypeError):
            op(port)


def test_lazy_sides_resolve_without_resweep():
    a, b = _walk(300, seed=1), _walk(200, seed=2)
    res = ab_join(a, b, 16, device="cpu")
    eager = ab_join(a, b, 16, return_b=True, device="cpu")
    assert object.__getattribute__(res, "_b_p") is None
    torch.testing.assert_close(res.b_p, eager.b_p, rtol=0, atol=0)
    torch.testing.assert_close(res.b_i, eager.b_i, rtol=0, atol=0)
    assert object.__getattribute__(res, "_lazy").recomputes == 0
    ts = _walk(300, seed=3)
    lazy = matrix_profile(ts, 16, device="cpu")
    both = matrix_profile(ts, 16, harvest="both", device="cpu")
    torch.testing.assert_close(lazy.left_p, both.left_p, rtol=0, atol=0)
    torch.testing.assert_close(lazy.right_i, both.right_i, rtol=0, atol=0)
    merged = torch.minimum(lazy.left_p, lazy.right_p)
    torch.testing.assert_close(merged, lazy.p, rtol=0, atol=0)


def test_recompute_path_matches_eager():
    from repro_torch.core.result import build_result
    from repro_torch.core.zstats import compute_stats_host

    ts = _walk(300, seed=4)
    plan = tplan.plan_sweep(16, 285, device="cpu")
    stats = compute_stats_host(ts, 16, device="cpu")
    res = tplan.execute(plan, stats)
    res.raw = None                       # drop the zero-sweep finish
    out = build_result(plan, res, stats)
    eager = matrix_profile(ts, 16, harvest="both", device="cpu")
    torch.testing.assert_close(out.left_p, eager.left_p, rtol=0, atol=0)
    assert object.__getattribute__(out, "_lazy").recomputes == 1


@pytest.mark.parametrize("kw,match", [
    # 16-bit self-join streams on the engine take the tile sweep (§A2)
    (dict(backend="engine", precision="bf16"), "band engine"),
    (dict(backend="rowstream"), "rowstream"),
    (dict(backend="distributed"), "distributed"),
    (dict(k=2), "top-k"),
    (dict(normalize=False), "normalize=False"),
    (dict(batch=4), "batched"),
    # the kernel never reseeds: the engine's options refuse the kernel
    (dict(band=128, backend="kernel"), "band engine's band"),
    (dict(clamp_rows=False, backend="kernel"), "clamp_rows"),
    (dict(reseed_every=64, backend="kernel"), "reseed_every"),
])
def test_not_ported_raises(kw, match):
    with pytest.raises(NotImplementedError, match=match):
        tplan.plan_sweep(16, 300, device="cpu", **kw)


def test_entry_points_raise_for_unported_options():
    ts = _walk(300, seed=6)
    with pytest.raises(NotImplementedError):
        matrix_profile(ts, 16, k=3, device="cpu")
    with pytest.raises(NotImplementedError):
        matrix_profile(ts, 16, normalize=False, device="cpu")
    with pytest.raises(NotImplementedError):
        ab_join(ts, ts[:200], 16, k=2, device="cpu")
    with pytest.raises(NotImplementedError):
        tops.natsa_matrix_profile(ts, 16, k=2, device="cpu")
    with pytest.raises(NotImplementedError, match="tile sweep"):
        matrix_profile(ts, 16, band=64, precision="bf16", device="cpu")
    # the kernel never reseeds: a reseed period or band it would ignore
    # plans the band engine instead
    assert matrix_profile(ts, 16, reseed_every=64,
                          device="cpu").backend == "engine"
    assert ab_join(ts, ts[:200], 16, band=64,
                   device="cpu").backend == "engine"
    torch.testing.assert_close(
        matrix_profile(ts, 16, reseed_every=None, device="cpu").p,
        matrix_profile(ts, 16, device="cpu").p, rtol=0, atol=0)


@pytest.mark.parametrize("kw,exc", [
    (dict(backend="nope"), ValueError),
    # the kernel accumulates in f32 (an f64 plan goes to the engine)
    (dict(precision="f64", backend="kernel"), ValueError),
    (dict(precision="nope"), ValueError),
    (dict(harvest="all"), ValueError),
])
def test_plan_guard_rails(kw, exc):
    with pytest.raises(exc):
        tplan.plan_sweep(16, 300, device="cpu", **kw)


def test_f64_precision_plans_the_engine():
    plan = tplan.plan_sweep(16, 300, device="cpu", precision="f64")
    assert plan.backend == "engine"
    assert plan.precision.accum == "float64"


@pytest.mark.filterwarnings("ignore:Explicitly requested dtype float64")
@pytest.mark.parametrize("kind", ["self", "ab"])
def test_f64_stream_kernel_plan_matches_reference(kind):
    """stream="float64" with f32 accumulation plans the kernel, as the
    reference does; the f64 streams are rounded to f32 once before the
    launch, as the reference's kernel rounds them on load."""
    import jax

    from repro.core import zstats as rz
    from repro.core.precision import PrecisionSpec as RefSpec
    from repro_torch.core.precision import PrecisionSpec
    from repro_torch.core.zstats import compute_stats_host

    spec = dict(stream="float64", accum="float32")
    ts, m = _walk(420, seed=31), 16
    # The reference's interpret-mode kernel does not trace with x64 on (an
    # int32/int64 `lax.rem` at repro/kernels/natsa_mp.py:148), so it runs
    # with x64 off: jnp.asarray then rounds its f64 streams to f32 once,
    # the rounding its kernel's load applies under x64. The f64 streams
    # themselves are checked under x64 below.
    if kind == "self":
        port = matrix_profile(ts, m, precision=PrecisionSpec(**spec),
                              harvest="both", device="cpu")
        ref = rops.natsa_matrix_profile(ts, m, it=128, dt=8, harvest="both",
                                        precision=RefSpec(**spec))
        _assert_profile(ref.p, ref.i, port.p, port.i, m)
        _assert_profile(ref.left_p, ref.left_i, port.left_p, port.left_i, m)
    else:
        b = _walk(300, seed=32)
        port = ab_join(ts, b, m, precision=PrecisionSpec(**spec),
                       return_b=True, device="cpu")
        ref = rops.natsa_ab_join(ts, b, m, it=128, dt=8, return_b=True,
                                 precision=RefSpec(**spec))
        _assert_profile(ref.p, ref.i, port.p, port.i, m)
        _assert_profile(ref.b_p, ref.b_i, port.b_p, port.b_i, m)
    assert port.backend == "kernel"
    # the streams stay f64 in the stats and reach the kernel rounded once
    stats = compute_stats_host(ts, m, out_dtype=torch.float64, device="cpu")
    with jax.enable_x64(True):
        ref_df = np.asarray(rz.compute_stats_host(ts, m,
                                                  out_dtype=np.float64).df)
    assert stats.df.dtype == torch.float64
    df = tops._pad_streams(stats, 128, 8, 4)[0]
    assert df.dtype == torch.float32
    np.testing.assert_array_equal(df[:ref_df.shape[0]].numpy(),
                                  ref_df.astype(np.float32))


def test_kernel_ops_entries_match_entry_points():
    ts = _walk(450, seed=9)
    a = tops.natsa_matrix_profile(ts, 16, device="cpu")
    b = matrix_profile(ts, 16, device="cpu")
    torch.testing.assert_close(a.p, b.p, rtol=0, atol=0)
    x, y = _walk(300, seed=10), _walk(180, seed=11)
    c = tops.natsa_ab_join(x, y, 16, return_b=True, device="cpu")
    d = ab_join(x, y, 16, return_b=True, device="cpu")
    torch.testing.assert_close(c.b_p, d.b_p, rtol=0, atol=0)


def test_bruteforce_oracles_agree_with_entry_points():
    from repro_torch.core import ref

    ts, m = _walk(300, seed=12), 16
    p_ref, i_ref = ref.matrix_profile_bruteforce(torch.from_numpy(ts), m)
    got = matrix_profile(ts, m, device="cpu")
    _assert_profile(p_ref.numpy(), i_ref.numpy(), got.p, got.i, m)
    rows = np.array([0, 17, 150, 284])
    p_rows, i_rows = ref.profile_rows(ts, ts, m, rows, exclusion=4)
    torch.testing.assert_close(p_rows, p_ref[rows], rtol=0, atol=0)
    assert torch.equal(i_rows, i_ref[rows])
    a, b = _walk(260, seed=13), _walk(180, seed=14)
    pa, ia = ref.ab_join_bruteforce(a, b, m, exclusion=3)
    got = ab_join(a, b, m, exclusion=3, device="cpu")
    _assert_profile(pa.numpy(), ia.numpy(), got.p, got.i, m)
    pr, _ = ref.profile_rows(a, b, m, np.arange(5), exclusion=3)
    torch.testing.assert_close(pr, pa[:5], rtol=0, atol=0)
    d = ref.cross_distance_matrix(a, b, m)
    assert d.shape == (245, 165) and d.dtype == torch.float64
