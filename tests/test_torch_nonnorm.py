"""The port's non-normalized sweeps (`normalize=False`) against the
reference, on the CPU.

Both packages run the raw squared-distance recurrence in f32 and add in
other orders (`torch.cumsum` vs XLA), so squared distances agree within
1e-4 relative (|d2_port - d2_ref| <= 1e-4 max(1, d2_ref)); indices are
equal except at near-ties, where the exact f64 squared distances of the two
picked pairs are within the same tolerance. Against the f64 oracle the
reference's own tolerance holds: rtol = atol = 2e-3 on distances
(`tests/test_ab_join.py:148`). On a drifting or offset series the f32
recurrence rounds with the level squared in both packages; the port's error
there is held to the reference's; f64 accumulation (`precision="f64"`)
removes it. Run as a script, this file prints both packages' readings at
n=16384, m=256:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_nonnorm.py Geometries come from the reference's
`test_ab_join.py`, `test_tiling2d.py`, `test_fused_twoside.py`,
`test_missing_data.py`, `test_lazy_result.py` and `test_plan.py`.
"""

import importlib
import json

import jax
import numpy as np
import pytest
import torch

from repro.core import ab_join as ref_ab_join
from repro.core import matrix_profile as ref_matrix_profile
from repro.core import plan as rplan
from repro_torch.core import ab_join, matrix_profile
from repro_torch.core import plan as tplan
from repro_torch.core import ref as tref
from repro_torch.core.matrix_profile import default_exclusion

tmp = importlib.import_module("repro_torch.core.matrix_profile")

TOL = 1e-4


def _noise(n, seed, level=0.0):
    return level + np.random.default_rng(seed).normal(size=n)


def _windows(ts, m):
    return np.lib.stride_tricks.sliding_window_view(
        np.asarray(ts, np.float64), m)


def _assert_raw(ref_p, ref_i, port_p, port_i, wa, wb, tol=TOL):
    """Raw profiles in squared distance: values within `tol` relative,
    indices equal except at near-ties of the exact f64 distances."""
    assert isinstance(port_p, torch.Tensor) and port_i.dtype == torch.int32
    rp = np.asarray(ref_p, np.float64)
    pp = port_p.double().numpy()
    assert rp.shape == pp.shape
    np.testing.assert_array_equal(np.isfinite(pp), np.isfinite(rp))
    fin = np.isfinite(rp)
    d2r, d2p = rp[fin] ** 2, pp[fin] ** 2
    assert np.all(np.abs(d2p - d2r) <= tol * np.maximum(1.0, d2r))
    ri, pi = np.asarray(ref_i), port_i.numpy()
    rows = np.nonzero(fin & (ri != pi))[0]
    if rows.size:
        e_r = ((wa[rows] - wb[ri[rows]]) ** 2).sum(1)
        e_p = ((wa[rows] - wb[pi[rows]]) ** 2).sum(1)
        assert np.all(np.abs(e_r - e_p) <= tol * np.maximum(1.0, e_r))


@pytest.mark.parametrize("n,m,excl", [
    (300, 16, 4),        # tests/test_fused_twoside.py:220
    (300, 16, 0),        # exclusion 0: each window's self-match
    (513, 20, None),
    (600, 12, 7),
])
def test_nonnorm_self_matches_reference(n, m, excl):
    ts = _noise(n, seed=n + m)
    ref = ref_matrix_profile(ts, m, excl, normalize=False, harvest="both")
    port = matrix_profile(ts, m, excl, normalize=False, harvest="both",
                          device="cpu")
    assert (port.backend, port.normalize) == ("engine", False)
    w = _windows(ts, m)
    for fp, fi in (("p", "i"), ("left_p", "left_i"), ("right_p", "right_i")):
        _assert_raw(getattr(ref, fp), getattr(ref, fi), getattr(port, fp),
                    getattr(port, fi), w, w)


@pytest.mark.parametrize("na,nb,m,excl,level", [
    (400, 90, 10, None, 0.0),    # tests/test_tiling2d.py:106
    (200, 80, 10, None, 0.0),    # tests/test_fused_twoside.py:131
    (90, 400, 10, 0, 0.0),       # the short side on A
    (300, 260, 16, 3, 0.0),      # an exclusion split into two spans
    (350, 120, 12, None, 100.0),  # a shared level: the common shift
])
def test_nonnorm_ab_matches_reference(na, nb, m, excl, level):
    a, b = _noise(na, seed=na, level=level), _noise(nb, seed=nb, level=level)
    ref = ref_ab_join(a, b, m, exclusion=excl, normalize=False,
                      return_b=True)
    port = ab_join(a, b, m, exclusion=excl, normalize=False, return_b=True,
                   device="cpu")
    wa, wb = _windows(a, m), _windows(b, m)
    _assert_raw(ref.p, ref.i, port.p, port.i, wa, wb)
    _assert_raw(ref.b_p, ref.b_i, port.b_p, port.b_i, wb, wa)


def test_nonnorm_matches_oracle():
    """tests/test_fused_twoside.py:220 and :131 against the port's own f64
    oracle, at the reference's tolerance."""
    ts = _noise(300, seed=11)
    res = matrix_profile(ts, 16, 4, normalize=False, device="cpu")
    want, _ = tref.profile_rows(ts, ts, 16, np.arange(285), exclusion=4,
                                normalize=False)
    np.testing.assert_allclose(res.p.numpy(), want.numpy(), rtol=2e-3,
                               atol=2e-3)
    a, b = _noise(200, seed=3), _noise(80, seed=4)
    res = ab_join(a, b, 10, normalize=False, return_b=True, device="cpu")
    d = tref.cross_distance_matrix(a, b, 10, normalize=False).numpy()
    np.testing.assert_allclose(res.p.numpy(), d.min(1), rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(res.b_p.numpy(), d.min(0), rtol=2e-3,
                               atol=2e-3)
    da, ia = tref.ab_join_bruteforce(a, b, 10, normalize=False)
    np.testing.assert_allclose(res.p.numpy(), da.numpy(), rtol=2e-3,
                               atol=2e-3)


def _level_series(kind, n, seed):
    """`telemetry`: smoothed noise around 0 (std ~3); `walk`: a random walk;
    `offset_walk`: the walk at level 1000."""
    rng = np.random.default_rng(seed)
    if kind == "telemetry":
        kern = 0.95 ** np.arange(128)
        return np.convolve(rng.standard_normal(n + 127), kern)[127:n + 127]
    return np.cumsum(rng.standard_normal(n)) + (
        1000.0 if kind == "offset_walk" else 0.0)


def raw_self_join_errors(kind, n, m, seed=0, n_rows=64, precision="f32"):
    """Both packages' raw self-join (f32, or f64 accumulation) against the
    f64 oracle on `n_rows` sampled rows: max abs and relative distance
    error, and the rows outside 2e-3 + 2e-3 d64."""
    ts = _level_series(kind, n, seed)
    excl = default_exclusion(m)
    l = n - m + 1
    rows = np.sort(np.random.default_rng(seed + 1).choice(
        l, n_rows, replace=False))
    d64 = tref.profile_rows(ts, ts, m, rows, exclusion=excl,
                            normalize=False)[0].numpy()
    with jax.enable_x64(precision == "f64"):
        ref_p = np.asarray(ref_matrix_profile(
            ts, m, excl, normalize=False, precision=precision).p, np.float64)
    got = {"ref": ref_p,
           "port": matrix_profile(ts, m, excl, normalize=False,
                                  precision=precision,
                                  device="cpu").p.double().numpy()}
    out = {"kind": kind, "precision": precision, "n": n, "m": m,
           "level_span": float(ts.max() - ts.min()),
           "level_max_abs": float(np.abs(ts).max())}
    for name, p in got.items():
        err = np.abs(p[rows] - d64)
        out[name] = {"max_abs_err": float(err.max()),
                     "max_rel_err": float((err / d64).max()),
                     "violations": int((err > 2e-3 + 2e-3 * d64).sum())}
    return out


@pytest.mark.parametrize("kind", ["walk", "offset_walk"])
def test_nonnorm_level_rounding_is_the_references(kind):
    """A drifting (random walk) or offset series: the f32 raw recurrence
    rounds with the level squared in both packages; the port's error
    against the f64 oracle stays within twice the reference's."""
    r = raw_self_join_errors(kind, 2048, 256)
    assert r["port"]["max_rel_err"] <= 2 * r["ref"]["max_rel_err"] + 1e-6, r


def test_nonnorm_self_join_is_ab_special_case():
    """tests/test_ab_join.py:144."""
    t = np.arange(300)
    ts = np.sin(2 * np.pi * t / 37) + 0.05 * np.random.default_rng(9).normal(
        size=300)
    p_ab = ab_join(ts, ts, 16, exclusion=4, normalize=False, device="cpu").p
    p_mp = matrix_profile(ts, 16, 4, normalize=False, device="cpu").p
    np.testing.assert_allclose(p_ab.numpy(), p_mp.numpy(), rtol=2e-3,
                               atol=2e-3)


def test_nonnorm_clamped_equals_unclamped():
    """tests/test_tiling2d.py:106: the full-height sweep is an
    A/B-comparison plan; both agree to f32 cumsum reassociation."""
    a, b = _noise(400, seed=1), _noise(90, seed=2)
    m = 10
    res_c = ab_join(a, b, m, normalize=False, return_b=True, device="cpu")
    plan_u = tplan.plan_sweep(m, 400 - m + 1, 90 - m + 1, normalize=False,
                              clamp_rows=False, harvest="both", device="cpu")
    res_u = tplan.execute(plan_u, (tplan.raw_series(plan_u, a),
                                   tplan.raw_series(plan_u, b)))
    torch.testing.assert_close(res_c.p, res_u.dist, rtol=0, atol=1e-4)
    torch.testing.assert_close(res_c.b_p, res_u.dist_b, rtol=0, atol=1e-4)
    ref_u = rplan.execute(
        rplan.plan_sweep(m, 391, 81, normalize=False, clamp_rows=False,
                         harvest="both"),
        (np.asarray(a, np.float32), np.asarray(b, np.float32)))
    _assert_raw(ref_u.dist, ref_u.index, res_u.dist, res_u.index,
                _windows(a, m), _windows(b, m))


def test_nonnorm_self_split_lazy_equals_eager_no_recompute():
    """tests/test_lazy_result.py:107 inside the port."""
    ts = _noise(300, seed=6)
    lazy = matrix_profile(ts, 16, 4, normalize=False, device="cpu")
    eager = matrix_profile(ts, 16, 4, normalize=False, harvest="both",
                           device="cpu")
    for f in ("left_p", "left_i", "right_p", "right_i"):
        torch.testing.assert_close(getattr(lazy, f), getattr(eager, f),
                                   rtol=0, atol=0)
    assert object.__getattribute__(lazy, "_lazy").recomputes == 0
    torch.testing.assert_close(torch.minimum(lazy.left_p, lazy.right_p),
                               lazy.p, rtol=0, atol=0)


def test_nonnorm_ab_b_side_recomputes_bitwise():
    """A one-sided nonnorm AB sweep skips B's column harvest: reading `b_p`
    re-executes the same plan two-sided, bit for bit the eager ask."""
    a, b = _noise(260, seed=7), _noise(120, seed=8)
    lazy = ab_join(a, b, 12, normalize=False, device="cpu")
    assert object.__getattribute__(lazy, "_b_p") is None
    eager = ab_join(a, b, 12, normalize=False, return_b=True, device="cpu")
    torch.testing.assert_close(lazy.b_p, eager.b_p, rtol=0, atol=0)
    torch.testing.assert_close(lazy.b_i, eager.b_i, rtol=0, atol=0)
    torch.testing.assert_close(lazy.p, eager.p, rtol=0, atol=0)
    assert object.__getattribute__(lazy, "_lazy").recomputes == 1


def test_nonnorm_plan_equals_direct_engine_call():
    """tests/test_plan.py:57: the entry point is the planned sweep, bit for
    bit."""
    ts = _noise(280, seed=12)
    res = matrix_profile(ts, 14, 3, normalize=False, device="cpu")
    split = tmp.nonnorm_profile_from_ts(torch.as_tensor(ts, dtype=torch.float32),
                                        14, 3)
    torch.testing.assert_close(res.p, tmp.nonnorm_to_distance(split.merged),
                               rtol=0, atol=0)
    torch.testing.assert_close(res.i, split.merged.index, rtol=0, atol=0)


@pytest.mark.parametrize("band", [7, 64, 256])
def test_nonnorm_band_invariance(band):
    """The answer does not depend on the band width."""
    ts = _noise(330, seed=13)
    ref = matrix_profile(ts, 12, 3, normalize=False, device="cpu")
    got = matrix_profile(ts, 12, 3, band=band, normalize=False,
                         device="cpu")
    w = _windows(ts, 12)
    _assert_raw(ref.p.numpy(), ref.i.numpy(), got.p, got.i, w, w)


def test_nonnorm_f64_accumulation_matches_reference():
    ts = _noise(320, seed=14, level=3.0)
    with jax.enable_x64(True):
        ref = ref_matrix_profile(ts, 16, normalize=False, precision="f64")
        rp, ri = np.asarray(ref.p), np.asarray(ref.i)
    port = matrix_profile(ts, 16, normalize=False, precision="f64",
                          device="cpu")
    assert port.p.dtype == torch.float64
    np.testing.assert_allclose(port.p.numpy(), rp, rtol=0, atol=1e-10)
    np.testing.assert_array_equal(port.i.numpy(), ri)


@pytest.mark.parametrize("entry", ["self", "ab"])
def test_nonnorm_entry_rejects_nonfinite(entry):
    """tests/test_missing_data.py:218: raw distances have no missing-data
    sentinel, so a NaN gap is refused where the z-normalized path masks
    it; both packages raise the same error."""
    t = _noise(120, seed=12)
    t[30] = np.nan
    if entry == "self":
        calls = (lambda: ref_matrix_profile(t, 8, normalize=False),
                 lambda: matrix_profile(t, 8, normalize=False, device="cpu"))
    else:
        calls = (lambda: ref_ab_join(t, t[:60] * 0, 8, normalize=False),
                 lambda: ab_join(t, t[:60] * 0, 8, normalize=False,
                                 device="cpu"))
    for call in calls:
        with pytest.raises(ValueError, match="non-finite"):
            call()


def test_nonnorm_refusals_match_reference():
    """The planner's nonnorm ValueErrors (`repro/core/plan.py:235-297`) in
    both packages."""
    asks = [dict(k=2), dict(backend="kernel"), dict(backend="rowstream"),
            dict(batch=3), dict(precision="bf16")]
    for kw in asks:
        with pytest.raises(ValueError):
            rplan.plan_sweep(16, 100, 50, normalize=False, **kw)
        with pytest.raises(ValueError):
            tplan.plan_sweep(16, 100, 50, normalize=False, device="cpu",
                             **kw)
    with pytest.raises(ValueError, match="fixed f32"):
        tplan.plan_sweep(16, 100, 50, normalize=False, precision="f64",
                         device="cpu")
    with pytest.raises(ValueError, match="only k=1"):
        matrix_profile(_noise(100, 1), 16, normalize=False, k=2,
                       device="cpu")
    with pytest.raises(TypeError, match="raw series"):
        tplan.execute(tplan.plan_sweep(16, 85, normalize=False,
                                       device="cpu"),
                      (torch.zeros(100), torch.zeros(100)))


if __name__ == "__main__":
    for kind in ("telemetry", "walk", "offset_walk"):
        print(json.dumps(raw_self_join_errors(kind, 16384, 256)))
    for kind in ("walk", "offset_walk"):
        print(json.dumps(raw_self_join_errors(kind, 16384, 256,
                                              precision="f64")))
