"""The NATSA kernel's plain version (`repro_torch.kernels.natsa_mp`) against
the reference Pallas kernel in interpret mode.

Both sides sweep IDENTICAL streams: the reference's are carried into the
port bit for bit (`zstats.stats_from_arrays`) and padded by the same rules.
Standard (the reference's own, `tests/test_kernel_natsa.py`): correlations
within 1e-4; an index may differ only where the two correlations are within
1e-4 of each other.
"""

import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import zstats as rz
from repro.kernels import natsa_mp as rk
from repro.kernels import ops as rops
from repro_torch.core import zstats as tz
from repro_torch.kernels import natsa_mp as tk
from repro_torch.kernels import ops as tops

TOL = 1e-4
FIELDS = ("ts", "mu", "invn", "df", "dg", "cov0")

_SMOKE = importlib.util.spec_from_file_location(
    "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_SMOKE)
_SMOKE.loader.exec_module(chip_smoke)


def _series(n, seed=0, kind="walk"):
    rng = np.random.default_rng(seed)
    if kind == "walk":
        return np.cumsum(rng.normal(size=n)).astype(np.float32)
    if kind == "noise":
        return rng.normal(size=n).astype(np.float32)
    t = np.arange(n, dtype=np.float32)
    return (np.sin(2 * np.pi * t / 40)
            + 0.1 * rng.normal(size=n)).astype(np.float32)


def _fields(stats) -> dict:
    return {f: np.asarray(getattr(stats, f)) for f in FIELDS}


def _to_torch(x) -> torch.Tensor:
    a = np.array(x, copy=True, order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _assert_agree(ref, port):
    """(corr, idx) pairs: values within TOL, indices equal except where the
    correlations are near-ties."""
    for (cr, ir), (cp, ip) in zip(ref, port):
        cr, ir = np.asarray(cr), np.asarray(ir)
        cp, ip = cp.numpy(), ip.numpy()
        assert cr.shape == cp.shape
        np.testing.assert_allclose(cp, cr, rtol=TOL, atol=TOL)
        mism = ir != ip
        assert np.abs(cp[mism] - cr[mism]).max(initial=0) < TOL


@pytest.mark.parametrize("n,m,it,dt,kind", [
    (400, 16, 128, 8, "walk"),
    (400, 16, 64, 16, "noise"),
    (513, 24, 128, 8, "sine"),     # l not divisible by IT
    (300, 8, 256, 4, "walk"),      # single row tile
    (260, 50, 32, 8, "noise"),     # tiny tiles, big window
    (1024, 32, 128, 32, "walk"),
])
def test_self_join_matches_reference_kernel(n, m, it, dt, kind):
    ts = _series(n, seed=n + m + it, kind=kind)
    ref_stats = rz.compute_stats_host(ts, m)
    excl = max(1, m // 4)
    ref = rops.rowmax_from_stats(ref_stats, excl=excl, it=it, dt=dt)
    port_stats = tz.stats_from_arrays(_fields(ref_stats), m, device="cpu")
    port = tops.rowmax_from_stats(port_stats, excl=excl, it=it, dt=dt)
    _assert_agree([(ref[0], ref[1]), (ref[2], ref[3])],
                  [(port[0], port[1]), (port[2], port[3])])


def _ab_inputs(ref_cross, it, dt, s0, s1):
    ins = rops._pad_streams_ab(ref_cross, it, dt, s0, s1)
    return ins[:7], ins[9]


@pytest.mark.parametrize("na,nb,m,span,dtype", [
    (300, 200, 16, "full", "float32"),      # k_start = -(l_a-1) < 0
    (200, 340, 12, "neg", "float32"),       # negative span only
    (260, 180, 16, "pos", "float32"),
    (300, 200, 16, "full", "bfloat16"),     # bf16 streams
    (257, 190, 20, "full", "float16"),
])
def test_ab_spans_match_reference_kernel(na, nb, m, span, dtype):
    """The raw kernel contract, `rowmax_profile_ab`, over signed spans
    (negative `k_start` with the `jpad` prepad), row AND column outputs in
    the shifted column layout."""
    it, dt, excl = 64, 8, 5
    a, b = _series(na, seed=na), _series(nb, seed=nb, kind="sine")
    cross = rz.compute_cross_stats_host(a, b, m, out_dtype=jnp.dtype(dtype))
    la, lb = cross.l_a, cross.l_b
    s0, s1 = {"full": (-(la - 1), lb), "neg": (-(la - 1), -excl + 1),
              "pos": (excl, lb)}[span]
    ins, jpad = _ab_inputs(cross, it, dt, s0, s1)
    kw = dict(k_start=s0, k_end=s1, l_i=la, l_j=lb, jpad=jpad)
    ref = rk.rowmax_profile_ab(*ins, it=it, dt=dt, **kw)
    port = tk.rowmax_profile_ab(*(_to_torch(x) for x in ins), **kw)
    _assert_agree([(ref[0], ref[1]), (ref[2], ref[3])],
                  [(port[0], port[1]), (port[2], port[3])])


def test_missing_data_matches_reference_kernel():
    ts = _series(600, seed=11)
    ts[100:104] = np.nan
    ts[333] = np.inf
    m, it, dt = 20, 128, 8
    ref_stats = rz.compute_stats_host(ts, m)
    ref = rops.rowmax_from_stats(ref_stats, excl=5, it=it, dt=dt)
    port = tops.rowmax_from_stats(
        tz.stats_from_arrays(_fields(ref_stats), m, device="cpu"),
        excl=5, it=it, dt=dt)
    _assert_agree([(ref[0], ref[1]), (ref[2], ref[3])],
                  [(port[0], port[1]), (port[2], port[3])])
    masked = np.asarray(ref_stats.invn) < 0
    assert masked.any()
    assert (port[1].numpy()[masked] == -1).all()
    assert (port[0].numpy()[masked] == tk.NEG).all()


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_reduced_streams_match_reference_kernel(dtype):
    ts, m, it, dt = _series(700, seed=4), 24, 128, 16
    ref_stats = rz.compute_stats_host(ts, m, out_dtype=jnp.dtype(dtype))
    ref = rops.rowmax_from_stats(ref_stats, excl=6, it=it, dt=dt)
    port_stats = tz.stats_from_arrays(_fields(ref_stats), m, device="cpu")
    assert port_stats.df.dtype == getattr(torch, dtype)
    port = tops.rowmax_from_stats(port_stats, excl=6, it=it, dt=dt)
    _assert_agree([(ref[0], ref[1]), (ref[2], ref[3])],
                  [(port[0], port[1]), (port[2], port[3])])


@pytest.mark.parametrize("case", chip_smoke.natsa_edge_cases(),
                         ids=lambda c: c["name"])
def test_edge_geometries_match_reference_kernel(case):
    """The geometries cut around the CUDA kernel's tiles (one list with
    `chip_smoke.py` and the card tests): stage and block edges, fewer
    diagonals than a block or rows than a stage, a span ending inside a
    block, negative diagonals, a NaN gap across a stage boundary."""
    series = chip_smoke.edge_case_series(case)
    m, it, dt = case["m"], case["it"], 8
    if case["kind"] == "self":
        ref_stats = rz.compute_stats_host(series[0], m)
        ref = rops.rowmax_from_stats(ref_stats, excl=case["excl"], it=it,
                                     dt=dt)
        port_stats = tz.stats_from_arrays(_fields(ref_stats), m,
                                          device="cpu")
        port = tops.rowmax_from_stats(port_stats, excl=case["excl"], it=it,
                                      dt=dt)
        _assert_agree([(ref[0], ref[1]), (ref[2], ref[3])],
                      [(port[0], port[1]), (port[2], port[3])])
        return
    cross = rz.compute_cross_stats_host(*series, m)
    spans = tops.ab_spans(cross.l_a, cross.l_b, case["excl"])
    assert spans
    for s0, s1 in spans:
        ins, jpad = _ab_inputs(cross, it, dt, s0, s1)
        kw = dict(k_start=s0, k_end=s1, l_i=cross.l_a, l_j=cross.l_b,
                  jpad=jpad)
        ref = rk.rowmax_profile_ab(*ins, it=it, dt=dt, **kw)
        port = tk.rowmax_profile_ab(*(_to_torch(x) for x in ins), **kw)
        _assert_agree([(ref[0], ref[1]), (ref[2], ref[3])],
                      [(port[0], port[1]), (port[2], port[3])])


@pytest.mark.parametrize("block_elems", [1, 700, 1 << 24])
def test_plain_version_is_block_size_invariant(block_elems):
    """Blocks of diagonals change only the tie order, never the values."""
    ts, m = _series(500, seed=8, kind="noise"), 16
    stats = tz.compute_stats_host(ts, m, device="cpu")
    df, dg, invn, cov0p, n_rows, _, l = tops._pad_streams(stats, 128, 8, 4)
    rows = n_rows * 128
    args = (df[:rows], dg[:rows], invn[:rows], df, dg, invn, cov0p)
    kw = dict(k_start=4, k_end=l, l_i=l, l_j=l, jpad=0)
    base = tk.rowmax_profile_ab_plain(*args, **kw)
    got = tk.rowmax_profile_ab_plain(*args, **kw, block_elems=block_elems)
    for x, y in zip(base[::2], got[::2]):
        torch.testing.assert_close(y, x, rtol=1e-5, atol=1e-5)


def test_geometry_checks():
    z = torch.zeros(16)
    with pytest.raises(ValueError, match="j streams"):
        tk.rowmax_profile_ab(z, z, z, z[:8], z[:8], z[:8], z[:4],
                             k_start=0, k_end=4, l_i=16, l_j=8)
    with pytest.raises(ValueError, match="jpad"):
        tk.rowmax_profile_ab(z, z, z, torch.zeros(64), torch.zeros(64),
                             torch.zeros(64), z[:4], k_start=-3, k_end=4,
                             l_i=16, l_j=8, jpad=0)


def test_packed_accumulator_init_key():
    # order-preserving bits of -2.0 (0xC0000000 -> ~ = 0x3FFFFFFF) high,
    # index -1 (0xFFFFFFFF) low
    assert tk._PACKED_INIT == 0x3FFFFFFFFFFFFFFF
