"""The port's reduced-precision self-join tile sweep
(`tile_profile_from_stats`, what 16-bit streams take on the band engine)
against the f64 oracle and the reference's tile sweep, on the CPU.

Against the oracle the bound is the reference's analytic one,
`precision.corr_tolerance(spec, m)` in correlation. Against the
reference's sweep: on TIE-HEAVY tiles — a zero-mean integer series of
repeats with m a power of two, whose centered windows are exact in 16 bits,
so every product and sum is exact in f32 in both packages — values AND
indices must be equal bit for bit, which pins the tie rule (largest index
inside a tile, earlier tile across tiles, tile rows merged in order).
"""

import importlib

import numpy as np
import pytest
import torch

from repro.core import matrix_profile as ref_matrix_profile
from repro.core import plan as rplan
from repro.core import zstats as rz
from repro_torch.core import matrix_profile
from repro_torch.core import plan as tplan
from repro_torch.core import ref as tref
from repro_torch.core import zstats as tz
from repro_torch.core.precision import as_precision, corr_tolerance

rmp = importlib.import_module("repro.core.matrix_profile")
tmp = importlib.import_module("repro_torch.core.matrix_profile")

FIELDS = ("ts", "mu", "invn", "df", "dg", "cov0")
SPLIT = ("merged", "right", "left")


def _walk(n, seed):
    return np.cumsum(np.random.default_rng(seed).normal(size=n))


def _tie_heavy(n, period, seed):
    """Integers in [-3, 3] repeating with `period`, summing to 0 over the
    series, so the series' mean and every window mean are exact."""
    assert n % period == 0
    rng = np.random.default_rng(seed)
    pat = rng.integers(-3, 4, size=period).astype(np.float64)
    pat[-1] -= pat.sum()
    return np.tile(pat, n // period)


def _corr(dist, m):
    d = np.asarray(dist, np.float64)
    return np.where(np.isfinite(d), 1.0 - d * d / (2.0 * m), -np.inf)


def _carry(stats, m):
    return tz.stats_from_arrays({f: np.asarray(getattr(stats, f))
                                 for f in FIELDS}, m, device="cpu")


@pytest.mark.parametrize("precision", ["bf16", "f16"])
@pytest.mark.parametrize("n,m,excl", [(1536, 32, None), (1100, 24, 0),
                                      (900, 16, 9)])
def test_tile_within_budget_of_f64_oracle(precision, n, m, excl):
    """The port's tile sweep within `corr_tolerance` of the exact f64
    profile (`tests/test_precision.py:87`'s route)."""
    ts = _walk(n, seed=n + m)
    res = matrix_profile(ts, m, excl, backend="engine", precision=precision,
                         harvest="both", device="cpu")
    assert res.backend == "engine"
    tol = corr_tolerance(as_precision(precision), m)
    e = tmp.default_exclusion(m) if excl is None else excl
    rows = np.arange(n - m + 1)
    want, _ = tref.profile_rows(ts, ts, m, rows, exclusion=e)
    got = _corr(res.p.numpy(), m)
    assert np.abs(got - _corr(want.numpy(), m)).max() <= tol
    # each pick's own exact correlation is within the bound of the best
    w = np.lib.stride_tricks.sliding_window_view(ts, m)
    wz = w - w.mean(axis=1, keepdims=True)
    wz /= np.linalg.norm(wz, axis=1, keepdims=True)
    i = res.i.numpy()
    own = np.einsum("ij,ij->i", wz, wz[i])
    assert np.all(own >= _corr(want.numpy(), m) - tol)


@pytest.mark.parametrize("stream", ["bfloat16", "float16"])
@pytest.mark.parametrize("n,m,period,tile,excl", [
    (1280, 16, 40, 128, 4),     # ties across tiles and inside them
    (1024, 32, 64, 512, 8),     # the default tile edge, two tiles
    (960, 16, 24, 64, 0),       # exclusion 0: the self-match on the diagonal
])
def test_tile_bitwise_reference_on_tie_heavy_tiles(stream, n, m, period,
                                                    tile, excl):
    ts = _tie_heavy(n, period, seed=period)
    stats = rz.compute_stats_host(ts, m)
    ref = rmp.tile_profile_from_stats(stats, excl, tile=tile,
                                      stream_dtype=stream)
    port = tmp.tile_profile_from_stats(_carry(stats, m), excl, tile=tile,
                                       stream_dtype=stream)
    for side in SPLIT:
        r, p = getattr(ref, side), getattr(port, side)
        np.testing.assert_array_equal(p.corr.numpy(), np.asarray(r.corr))
        np.testing.assert_array_equal(p.index.numpy(), np.asarray(r.index))
    # the data really are tie-heavy: most rows have several best neighbours
    assert (np.asarray(ref.merged.corr) > 0.999).mean() > 0.5


def test_tile_matches_reference_entry():
    """The planned entry points on a walk: within 1e-5 in correlation of
    each other (the same exact products, summed in other orders), indices
    equal but at near-ties."""
    ts = _walk(1400, seed=5)
    m = 32
    ref = ref_matrix_profile(ts, m, precision="bf16", harvest="both")
    port = matrix_profile(ts, m, backend="engine", precision="bf16",
                          harvest="both", device="cpu")
    for fp, fi in (("p", "i"), ("left_p", "left_i"), ("right_p", "right_i")):
        cr, cp = _corr(getattr(ref, fp), m), _corr(getattr(port, fp), m)
        np.testing.assert_allclose(cp, cr, rtol=0, atol=1e-5)
        mism = ((np.asarray(getattr(ref, fi)) != getattr(port, fi).numpy())
                & np.isfinite(cr))
        assert np.abs(cp[mism] - cr[mism]).max(initial=0) < 1e-5


def test_tile_masks_gaps_and_flat_windows():
    """Missing data (invn -1) are never selected and have no neighbour;
    flat windows (invn 0) correlate with nothing — as in the reference."""
    ts = _walk(1000, seed=7)
    ts[300:304] = np.nan
    ts[600:680] = 2.0
    m = 16
    ref = ref_matrix_profile(ts, m, precision="bf16")
    port = matrix_profile(ts, m, backend="engine", precision="bf16",
                          device="cpu")
    np.testing.assert_array_equal(np.isfinite(port.p.numpy()),
                                  np.isfinite(np.asarray(ref.p)))
    bad = np.arange(300 - m + 1, 304)
    assert np.isinf(port.p.numpy()[bad]).all()
    assert (port.i.numpy()[bad] == -1).all()
    assert not np.isin(port.i.numpy(), bad).any()
    cr, cp = _corr(ref.p, m), _corr(port.p, m)
    fin = np.isfinite(cr)
    np.testing.assert_allclose(cp[fin], cr[fin], rtol=0, atol=1e-5)


def test_tile_keeps_its_bits_whatever_the_matmul_precision():
    """The product runs in full f32 whatever the caller set, and the
    caller's setting is restored."""
    ts = _walk(700, seed=9)
    base = matrix_profile(ts, 16, backend="engine", precision="bf16",
                          device="cpu")
    prev = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("medium")
        again = matrix_profile(ts, 16, backend="engine", precision="bf16",
                               device="cpu")
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision(prev)
    torch.testing.assert_close(again.p, base.p, rtol=0, atol=0)
    torch.testing.assert_close(again.i, base.i, rtol=0, atol=0)


def test_tile_plan_and_stream_dtypes_match_reference():
    """`tests/test_precision.py:290`: a 16-bit self-join on the engine
    takes f32 stats (the windows are rounded in the sweep); AB plans stream
    the 16-bit stats themselves."""
    for kw in (dict(backend="engine"), dict(band=64)):
        port = tplan.plan_sweep(32, 2000, precision="bf16", device="cpu",
                                **kw)
        ref = rplan.plan_sweep(32, 2000, precision="bf16", **kw)
        assert port.backend == ref.backend == "engine"
        assert tplan.stats_dtypes_for(port)["out_dtype"] == torch.float32
    ab = tplan.plan_sweep(32, 2000, 500, backend="rowstream",
                          precision="bf16", device="cpu")
    assert tplan.stats_dtypes_for(ab)["out_dtype"] == torch.bfloat16
    # the kernel streams 16-bit stats itself (the port's k = 1 rule)
    kern = tplan.plan_sweep(32, 2000, precision="bf16", device="cpu")
    assert kern.backend == "kernel"
    assert tplan.stats_dtypes_for(kern)["out_dtype"] == torch.bfloat16


def test_tile_planted_motif_and_lazy_split():
    """`tests/test_precision.py:167` on the port's tile sweep, and the
    split finishing lazily from the retained sides, bit for bit eager."""
    ts = _walk(1024, seed=7)
    a_pos, b_pos, m = 100, 700, 32
    ts[b_pos:b_pos + m] = ts[a_pos:a_pos + m]
    res = matrix_profile(ts, m, backend="engine", precision="bf16",
                         device="cpu")
    i = res.i.numpy()
    assert i[a_pos] == b_pos and i[b_pos] == a_pos
    eager = matrix_profile(ts, m, backend="engine", precision="bf16",
                           harvest="both", device="cpu")
    for f in ("left_p", "left_i", "right_p", "right_i"):
        torch.testing.assert_close(getattr(res, f), getattr(eager, f),
                                   rtol=0, atol=0)
    assert object.__getattribute__(res, "_lazy").recomputes == 0
    torch.testing.assert_close(torch.minimum(res.left_p, res.right_p),
                               res.p, rtol=0, atol=0)
