"""Port stream prep (`repro_torch.core.zstats`) against the reference.

Both packages compute the streams in f64 numpy and round once, so the
port's streams must be BITWISE equal to `repro`'s for every stream dtype.
The reference emits f64 only under jax's x64 flag, which the test turns on
around its own call (`jax.enable_x64`); nothing in `repro` changes.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import precision as rprec
from repro.core import zstats as rz
from repro_torch.core import precision as tprec
from repro_torch.core import zstats as tz

FIELDS = ("ts", "mu", "invn", "df", "dg", "cov0")
DTYPES = ("float32", "bfloat16", "float16", "float64")


def _series(kind: str, n: int = 320, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    ts = np.cumsum(rng.normal(size=n)) + 50.0
    if kind == "flat":
        ts[40:120] = 3.0                      # flat windows -> invn 0
        ts[200:230] = ts[199]
    elif kind == "nan":
        ts[17] = np.nan                       # missing data -> invn -1
        ts[n // 2:n // 2 + 5] = np.nan
        ts[n - 40] = np.inf
    return ts


def _x64(dtype: str):
    return jax.enable_x64(True) if dtype == "float64" \
        else contextlib.nullcontext()


def _bits_ref(x) -> np.ndarray:
    a = np.asarray(x)
    return a.view(np.dtype(f"u{a.dtype.itemsize}"))


def _bits_port(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    a = t.numpy()
    return a.view(np.dtype(f"u{a.dtype.itemsize}"))


def _assert_bitwise(ref_stats, port_stats, fields=FIELDS):
    for f in fields:
        r, p = _bits_ref(getattr(ref_stats, f)), _bits_port(
            getattr(port_stats, f))
        assert r.dtype == p.dtype and r.shape == p.shape, f
        np.testing.assert_array_equal(p, r, err_msg=f)


@pytest.mark.parametrize("kind", ["walk", "flat", "nan"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_stats_bitwise(dtype, kind):
    ts, m = _series(kind, seed=len(kind)), 24
    with _x64(dtype):
        ref = rz.compute_stats_host(ts, m, out_dtype=jnp.dtype(dtype))
        ref = jax.tree.map(np.asarray, ref)
    port = tz.compute_stats_host(ts, m, out_dtype=dtype, device="cpu")
    assert port.window == ref.window
    _assert_bitwise(ref, port)


@pytest.mark.parametrize("stream,seed", [("bfloat16", "float32"),
                                         ("float16", "float32"),
                                         ("float32", "bfloat16")])
def test_seed_dtype_bitwise(stream, seed):
    ts, m = _series("walk", seed=3), 16
    ref = rz.compute_stats_host(ts, m, out_dtype=jnp.dtype(stream),
                                seed_dtype=jnp.dtype(seed))
    port = tz.compute_stats_host(ts, m, out_dtype=stream, seed_dtype=seed,
                                 device="cpu")
    _assert_bitwise(ref, port)


@pytest.mark.parametrize("kind", ["walk", "nan"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("na,nb", [(300, 120), (90, 260)])
def test_cross_stats_bitwise(dtype, kind, na, nb):
    a, b = _series(kind, na, seed=1), _series("walk", nb, seed=2)
    m = 20
    with _x64(dtype):
        ref = rz.compute_cross_stats_host(a, b, m, out_dtype=jnp.dtype(dtype))
        ref = jax.tree.map(np.asarray, ref)
    port = tz.compute_cross_stats_host(a, b, m, out_dtype=dtype,
                                       device="cpu")
    assert (port.l_a, port.l_b, port.k_min, port.k_max, port.window) == (
        ref.l_a, ref.l_b, ref.k_min, ref.k_max, ref.window)
    _assert_bitwise(ref.a, port.a)
    _assert_bitwise(ref.b, port.b)
    np.testing.assert_array_equal(_bits_port(port.cov0s),
                                  _bits_ref(ref.cov0s))


def test_short_side_and_length_errors():
    ts = _series("walk", 40)
    port = tz.compute_stats_host(ts, 40, min_subsequences=1, device="cpu")
    assert port.n_subsequences == 1
    with pytest.raises(ValueError, match="too short"):
        tz.compute_stats_host(ts, 30, device="cpu")
    with pytest.raises(ValueError, match="1-D"):
        tz.compute_stats_host(np.zeros((4, 40)), 8, device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_carry_over_keeps_bits(dtype):
    """`stats_from_arrays` builds the port's stats from the reference's
    arrays bit for bit (bf16 included), so tests can feed both packages
    identical streams."""
    a, b = _series("nan", 200, seed=5), _series("walk", 150, seed=6)
    ref = rz.compute_cross_stats_host(a, b, 16, out_dtype=jnp.dtype(dtype))
    fields = {s: {f: np.asarray(getattr(getattr(ref, s), f)) for f in FIELDS}
              for s in ("a", "b")}
    fields["cov0s"] = np.asarray(ref.cov0s)
    port = tz.cross_stats_from_arrays(fields, 16, device="cpu")
    _assert_bitwise(ref.a, port.a)
    _assert_bitwise(ref.b, port.b)
    np.testing.assert_array_equal(_bits_port(port.cov0s),
                                  _bits_ref(ref.cov0s))
    self_port = tz.stats_from_arrays(fields["a"], 16, device="cpu")
    _assert_bitwise(ref.a, self_port)


def test_self_cross_matches_reference():
    ts = _series("walk", 200, seed=9)
    ref = rz.self_cross(rz.compute_stats_host(ts, 12))
    port = tz.self_cross(tz.compute_stats_host(ts, 12, device="cpu"))
    np.testing.assert_array_equal(_bits_port(port.cov0s),
                                  _bits_ref(ref.cov0s))


def test_corr_dist_conversions():
    rng = np.random.default_rng(0)
    corr = rng.uniform(-1, 1, size=64).astype(np.float32)
    d_ref = np.asarray(rz.corr_to_dist(jnp.asarray(corr), 32))
    d_port = tz.corr_to_dist(torch.from_numpy(corr), 32).numpy()
    np.testing.assert_allclose(d_port, d_ref, rtol=1e-6, atol=1e-6)
    back_ref = np.asarray(rz.dist_to_corr(jnp.asarray(d_ref), 32))
    back = tz.dist_to_corr(torch.from_numpy(d_ref.copy()), 32).numpy()
    np.testing.assert_allclose(back, back_ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("preset", ["f32", "default", "bf16", "f16", "f64"])
@pytest.mark.parametrize("window", [8, 128, 512])
def test_precision_presets_and_budgets(preset, window):
    r, p = rprec.as_precision(preset), tprec.as_precision(preset)
    assert (p.stream, p.accum, p.seed_dot) == (r.stream, r.accum, r.seed_dot)
    assert (p.reduced_stream, p.stream_bytes, p.is_default) == (
        r.reduced_stream, r.stream_bytes, r.is_default)
    assert p.stream_dtype == tprec.TORCH_DTYPES[r.stream]
    assert tprec.corr_tolerance(p, window) == rprec.corr_tolerance(r, window)
    assert tprec.profile_tolerance(p, window) == rprec.profile_tolerance(
        r, window)


def test_precision_validation():
    with pytest.raises(ValueError):
        tprec.PrecisionSpec(stream="int8")
    with pytest.raises(ValueError):
        tprec.PrecisionSpec(accum="bfloat16")
    with pytest.raises(ValueError):
        tprec.as_precision("fp8")
    with pytest.raises(TypeError):
        tprec.as_precision(3)
    assert tprec.torch_dtype(None) == torch.float32
    assert tprec.torch_dtype(torch.float16) == torch.float16


# -- in-graph stats (compute_stats, moving_mean_var, sliding_dot, cov_row) --
#
# f64: the reference runs under `jax.enable_x64(True)` on the same f64
# series; each array agrees within 1e-12 of its own scale (max |ref|): the
# two packages add their cumulative sums in other orders. On a series with
# a level, invn and cov0 cancel (E[x^2] - E[x]^2, qt0 - m mu0 muk, as the
# reference's docstring says): there the order gap grows by the level's
# square over the window variance, and the test states that bound. f32: held
# on zero-mean series only, within F32_TOL of each array's scale. Flat
# windows are not compared: the in-graph variance of a constant window is a
# cumsum residue, so its invn is 0 in one order and huge in another (the
# host prep's relative guard exists for that).

F32_TOL = 2e-5
LEVEL_TOL = 1e-10      # level 50 over window variances of ~2: ~1e3 x 1e-13
INGRAPH = ("mu", "invn", "df", "dg", "cov0")


def _zero_mean(kind: str, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "noise":
        return rng.normal(size=n)
    if kind == "walk":
        return np.cumsum(rng.normal(size=n))
    t = np.arange(n)
    return np.sin(2 * np.pi * t / 29) + 0.1 * rng.normal(size=n)


def _assert_scaled(port, ref, tol, name=""):
    r = np.asarray(ref, np.float64)
    p = port.double().numpy() if isinstance(port, torch.Tensor) else port
    assert p.shape == r.shape, name
    np.testing.assert_allclose(p, r, rtol=0, atol=tol * np.abs(r).max(),
                               err_msg=name)


def _ref_ingraph(ts, m, row):
    with jax.enable_x64(True):
        x = jnp.asarray(ts, jnp.float64)
        ref = jax.tree.map(np.asarray, rz.compute_stats(x, m))
        ref_jit = jax.tree.map(np.asarray, rz.compute_stats_jit(x, m))
        mv = tuple(np.asarray(v) for v in rz.moving_mean_var(x, m))
        ref_row = np.asarray(rz.cov_row(rz.compute_stats(x, m), row))
    return ref, ref_jit, mv, ref_row


@pytest.mark.parametrize("kind", ["walk", "noise", "sine"])
@pytest.mark.parametrize("n,m", [(320, 24), (257, 16)])
def test_compute_stats_matches_reference_f64(kind, n, m):
    ts = _zero_mean(kind, n, seed=n)
    ref, ref_jit, (ref_mu, ref_var), ref_row = _ref_ingraph(ts, m, 37)
    port = tz.compute_stats(ts, m, device="cpu")
    port_jit = tz.compute_stats_jit(ts, m, device="cpu")
    assert port.df.dtype == torch.float64 and port.window == m
    for f in INGRAPH:
        _assert_scaled(getattr(port, f), getattr(ref, f), 1e-12, f)
        _assert_scaled(getattr(port_jit, f), getattr(ref_jit, f), 1e-12, f)
    mu, var = tz.moving_mean_var(torch.from_numpy(ts), m)
    _assert_scaled(mu, ref_mu, 1e-12, "mu")
    _assert_scaled(var, ref_var, 1e-12, "var")
    _assert_scaled(tz.cov_row(port, 37), ref_row, 1e-12, "cov_row")


def test_compute_stats_with_a_level_f64():
    ts = _zero_mean("walk", 320, seed=1) + 50.0
    ref, _, _, ref_row = _ref_ingraph(ts, 24, 37)
    port = tz.compute_stats(ts, 24, device="cpu")
    for f in ("mu", "df", "dg"):
        _assert_scaled(getattr(port, f), getattr(ref, f), 1e-12, f)
    for f in ("invn", "cov0"):
        _assert_scaled(getattr(port, f), getattr(ref, f), LEVEL_TOL, f)
    _assert_scaled(tz.cov_row(port, 37), ref_row, LEVEL_TOL, "cov_row")


@pytest.mark.parametrize("kind", ["noise", "sine"])
def test_compute_stats_matches_reference_f32_zero_mean(kind):
    ts = _zero_mean(kind, 400, seed=3).astype(np.float32)
    m = 20
    ref = jax.tree.map(np.asarray, rz.compute_stats(jnp.asarray(ts), m))
    port = tz.compute_stats(torch.from_numpy(ts), m, device="cpu")
    assert port.df.dtype == torch.float32
    for f in INGRAPH:
        _assert_scaled(getattr(port, f), getattr(ref, f), F32_TOL, f)
    q = ts[5:5 + m]
    _assert_scaled(tz.sliding_dot(torch.from_numpy(q), torch.from_numpy(ts)),
                   rz.sliding_dot(jnp.asarray(q), jnp.asarray(ts)), F32_TOL,
                   "sliding_dot")
    _assert_scaled(tz.cov_row(port, 101),
                   rz.cov_row(rz.compute_stats(jnp.asarray(ts), m), 101),
                   F32_TOL, "cov_row")


def test_cov_row_checks_the_recurrence():
    """`cov_row` is the direct evaluation the recurrence must reproduce:
    cov(i, i + k) from `cov0` plus the deltas equals the direct dots."""
    ts = _zero_mean("noise", 300, seed=4)
    s = tz.compute_stats(ts, 16, device="cpu")
    k = torch.arange(s.n_subsequences - 40)
    cov = s.cov0[k].clone()
    for i in range(1, 41):
        cov = cov + s.df[i] * s.dg[i + k] + s.df[i + k] * s.dg[i]
    torch.testing.assert_close(cov, tz.cov_row(s, 40), rtol=0, atol=1e-10)


def test_compute_stats_errors():
    with pytest.raises(ValueError, match="too short"):
        tz.compute_stats(np.zeros(30), 16, device="cpu")
    with pytest.raises(ValueError, match="1-D"):
        tz.compute_stats(np.zeros((2, 64)), 8, device="cpu")


def test_batched_carry_over_and_stacks():
    """A batched reference stack carries over bit for bit, and
    `unstack_stats(stack_stats(x))` gives each series back."""
    series = [_series("walk", 200, seed=s) for s in range(3)]
    ref = [rz.compute_stats_host(s, 16) for s in series]
    stacked = jax.tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs]),
                           *ref)
    port = tz.stats_from_arrays({f: getattr(stacked, f) for f in FIELDS}, 16,
                                device="cpu")
    assert port.df.shape == (3, 185)
    for r, one in enumerate(tz.unstack_stats(port)):
        _assert_bitwise(ref[r], one)
    cross = [tz.compute_cross_stats_host(s, series[0][:90], 16, device="cpu")
             for s in series]
    back = tz.unstack_stats(tz.stack_stats(cross))
    for c, d in zip(cross, back):
        assert torch.equal(c.cov0s, d.cov0s) and torch.equal(c.b.df, d.b.df)


# -- the f64 block kernels of the incremental surfaces ---------------------------
#
# The same op sequence as `repro/core/zstats.py:404-494` (products and sums,
# no matmul) in f64, within 1e-12 of the reference's (run under
# `jax.enable_x64` on the test's side); the port's sums run in a fixed
# order, so a block's bits do not depend on its shape.


def _block_windows(seed, p, q, m, level=0.0):
    rng = np.random.default_rng(seed)
    wa = level + np.cumsum(rng.normal(size=(p, m)), axis=1)
    wb = level + np.cumsum(rng.normal(size=(q, m)), axis=1)
    wb[1] = 4.0                                 # a flat window: corr 0
    return wa, wb


def _ref_block(fn, *arrays, **kw):
    with jax.enable_x64(True):
        out = fn(*(jnp.asarray(a, jnp.float64) for a in arrays), **kw)
        return jax.tree.map(np.asarray, out)


def _t(a):
    return torch.as_tensor(np.array(a), dtype=torch.float64)


def _close(port, ref, scale=1.0):
    np.testing.assert_allclose(port.numpy(), ref, rtol=0, atol=1e-12 * scale)


@pytest.mark.parametrize("m", [16, 23])
def test_centered_block_and_sumsq_match_reference(m):
    wa, _ = _block_windows(1, 7, 5, m, level=10.0)
    c, n = tz.centered_block(_t(wa))
    rc, rn = _ref_block(rz.centered_block, wa)
    _close(c, rc, 10.0)
    _close(n, rn, float(np.abs(rn).max()))
    s = tz.window_sumsq(_t(wa))
    _close(s, _ref_block(rz.window_sumsq, wa), float(s.abs().max()))


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("p,q,m", [(6, 9, 16), (1, 13, 12), (4, 4, 7)])
def test_sqdist_block_matches_reference(normalize, p, q, m):
    wa, wb = _block_windows(p * q + m, p, q, m)
    got = tz.sqdist_block(_t(wa), _t(wb), window=m, normalize=normalize)
    want = _ref_block(rz.sqdist_block_jit, wa, wb, window=m,
                      normalize=normalize)
    assert got.shape == (p, q) and got.dtype == torch.float64
    _close(got, want, max(1.0, float(np.abs(want).max())))
    same = tz.sqdist_block_jit(_t(wa), _t(wb), window=m, normalize=normalize)
    assert torch.equal(same, got)
    if normalize:                    # the flat window correlates with nothing
        np.testing.assert_allclose(got[:, 1].numpy(), 2.0 * m, rtol=0,
                                   atol=1e-12)


def test_block_parts_match_reference():
    """The factored parts the fleet keeps resident, and batched blocks."""
    m = 12
    wa, wb = _block_windows(5, 3, 8, m)
    ac, an = _ref_block(rz.centered_block, wa)
    bc, bn = _ref_block(rz.centered_block, wb)
    z = tz.sqdist_znorm_from_parts(_t(ac), _t(an), _t(bc), _t(bn), window=m)
    _close(z, _ref_block(rz.sqdist_znorm_from_parts, ac, an, bc, bn,
                         window=m), 2.0 * m)
    sa = _ref_block(rz.window_sumsq, wa)
    sb = _ref_block(rz.window_sumsq, wb)
    r = tz.sqdist_nonnorm_from_parts(_t(wa), _t(sa), _t(wb), _t(sb))
    want = _ref_block(rz.sqdist_nonnorm_from_parts, wa, sa, wb, sb)
    _close(r, want, float(np.abs(want).max()))
    stacked = tz.sqdist_block(_t(np.stack([wa, wa + 1.0])),
                              _t(np.stack([wb, wb])), window=m)
    assert stacked.shape == (2, 3, 8)
    assert torch.equal(stacked[0], tz.sqdist_block(_t(wa), _t(wb), window=m))


@pytest.mark.parametrize("normalize", [True, False])
def test_sqdist_block_rows_are_shape_independent(normalize):
    """One row evaluated alone equals the same row of the whole block, bit
    for bit: each output depends on its own pair of windows only."""
    m = 20
    wa, wb = _block_windows(9, 11, 30, m, level=3.0)
    block = tz.sqdist_block(_t(wa), _t(wb), window=m, normalize=normalize)
    for r in (0, 5, 10):
        row = tz.sqdist_block(_t(wa[r:r + 1]), _t(wb), window=m,
                              normalize=normalize)
        assert torch.equal(row[0], block[r])
        col = tz.sqdist_block(_t(wa), _t(wb[r:r + 1]), window=m,
                              normalize=normalize)
        assert torch.equal(col[:, 0], block[:, r])


def test_window_finite_mask_matches_reference():
    w = np.arange(40.0).reshape(8, 5)
    w[2, 3] = np.nan
    w[6, 0] = np.inf
    got = tz.window_finite_mask(_t(w)).numpy()
    np.testing.assert_array_equal(got, _ref_block(rz.window_finite_mask, w))
    assert got.tolist() == [True, True, False, True, True, True, False, True]
