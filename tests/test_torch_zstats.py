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
