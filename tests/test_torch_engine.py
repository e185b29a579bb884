"""The port's band engine (`repro_torch.core.matrix_profile`,
`backend="engine"`) against the reference's, on the CPU.

Both engines sweep IDENTICAL streams (the reference's, carried over bit for
bit by `zstats.stats_from_arrays`). Standard: correlations within 1e-4 —
`torch.cumsum` adds in another order than XLA — and indices equal except
where the two correlations are within 1e-4 (near-ties). Geometries come from
the reference's `tests/test_plan.py`, `tests/test_fused_twoside.py` and
`tests/test_ab_join.py`. The reference's own bitwise promises (lazy ==
eager, the split merging to the profile) are re-proved inside the port.
"""

import dataclasses
import importlib

import jax
import numpy as np
import pytest
import torch

from repro.core import plan as rplan
from repro.core import zstats as rz
from repro_torch.core import ab_join, matrix_profile
from repro_torch.core import plan as tplan
from repro_torch.core import zstats as tz
from repro_torch.core.precision import PrecisionSpec
from repro_torch.kernels import natsa_mp, ops
from repro_torch.kernels import ref as tref

# the packages' `core` namespaces rebind `matrix_profile` to the entry
# point; the engine lives in the module of that name
rmp = importlib.import_module("repro.core.matrix_profile")
tmp = importlib.import_module("repro_torch.core.matrix_profile")

TOL = 1e-4
FIELDS = ("ts", "mu", "invn", "df", "dg", "cov0")


def _series(n, seed=0, kind="walk"):
    rng = np.random.default_rng(seed)
    if kind == "walk":
        return np.cumsum(rng.normal(size=n)).astype(np.float32)
    if kind == "noise":
        return rng.normal(size=n).astype(np.float32)
    if kind == "flat":
        ts = rng.normal(size=n).astype(np.float32)
        ts[n // 3: n // 3 + n // 4] = 2.5
        return ts
    if kind == "gaps":
        ts = np.cumsum(rng.normal(size=n))
        ts[n // 4: n // 4 + 3] = np.nan
        ts[(2 * n) // 3] = np.nan
        return ts
    t = np.arange(n, dtype=np.float32)
    return (np.sin(2 * np.pi * t / 37)
            + 0.05 * rng.normal(size=n)).astype(np.float32)


def _fields(stats) -> dict:
    return {f: np.asarray(getattr(stats, f)) for f in FIELDS}


def _port_stats(ref_stats, m):
    return tz.stats_from_arrays(_fields(ref_stats), m, device="cpu")


def _port_cross(ref_cross, m):
    return tz.cross_stats_from_arrays(
        {"a": _fields(ref_cross.a), "b": _fields(ref_cross.b),
         "cov0s": np.asarray(ref_cross.cov0s)}, m, device="cpu")


def _assert_state(ref, port, tol=TOL):
    """ProfileStates (corr, index): values within tol, indices equal except
    at near-ties."""
    cr, ir = np.asarray(ref.corr, np.float64), np.asarray(ref.index)
    cp, ip = port.corr.double().numpy(), port.index.numpy()
    assert port.index.dtype == torch.int32
    assert cr.shape == cp.shape
    np.testing.assert_allclose(cp, cr, rtol=0, atol=tol)
    mism = ir != ip
    assert np.abs(cp[mism] - cr[mism]).max(initial=0) < tol


# -- self-join engine ---------------------------------------------------------


@pytest.mark.parametrize("n,m,excl,kind", [
    (400, 16, 4, "walk"),      # test_plan / test_fused_twoside
    (257, 10, 3, "noise"),     # sizes not aligned to band
    (500, 32, 8, "sine"),
    (300, 12, 0, "walk"),      # exclusion 0: the diagonal itself
    (360, 14, 4, "flat"),      # zero-variance windows
    (420, 16, 4, "gaps"),      # NaN gaps: invn = -1 windows
])
@pytest.mark.parametrize("band,reseed", [(16, None), (64, 64), (256, 512)])
def test_self_engine_matches_reference(n, m, excl, kind, band, reseed):
    ts = _series(n, seed=n + m, kind=kind)
    rs = rz.compute_stats_host(ts, m)
    ref = rmp.profile_from_stats(rs, excl, band, reseed)
    port = tmp.profile_from_stats(_port_stats(rs, m), excl, band, reseed)
    for r, p in ((ref.merged, port.merged), (ref.right, port.right),
                 (ref.left, port.left)):
        _assert_state(r, p)


@pytest.mark.parametrize("k0,width,band", [(4, 90, 32), (150, 200, 64)])
def test_chunk_rowmax_matches_reference(k0, width, band):
    """The anytime unit of work: one chunk of diagonals [k0, k0 + width),
    both sides merged; a chunk running past the last diagonal is fill."""
    ts, m = _series(330, seed=21), 12
    rs = rz.compute_stats_host(ts, m)
    ref = rmp.chunk_rowmax(rs, k0, width, band, 64)
    port = tmp.chunk_rowmax(_port_stats(rs, m), k0, width, band, 64)
    _assert_state(ref, port)


def test_self_engine_f64_accumulation_matches_reference():
    ts, m = _series(400, seed=3), 16
    with jax.enable_x64(True):
        rs = rz.compute_stats_host(ts, m, out_dtype=np.float64,
                                   seed_dtype=np.float64)
        ref = rmp.profile_from_stats(rs, 4, 64, 128, accum_dtype="float64")
        fields = _fields(rs)
    port = tmp.profile_from_stats(tz.stats_from_arrays(fields, m, "cpu"),
                                  4, 64, 128, accum_dtype="float64")
    assert port.merged.corr.dtype == torch.float64
    _assert_state(ref.merged, port.merged, tol=1e-12)
    _assert_state(ref.left, port.left, tol=1e-12)


# -- AB engine ----------------------------------------------------------------


@pytest.mark.parametrize("na,nb,m,kind", [
    (220, 90, 12, "walk"),     # l_a > l_b
    (90, 220, 12, "walk"),     # l_a < l_b
    (150, 150, 8, "noise"),
    (200, 61, 16, "sine"),
    (180, 120, 10, "flat"),
    (130, 25, 20, "noise"),    # l_b = 6: query-against-corpus shape
    (25, 130, 20, "noise"),    # short query side
    (300, 260, 16, "gaps"),
])
@pytest.mark.parametrize("excl,band,reseed", [(0, 64, 512), (5, 16, 64),
                                              (0, 256, None)])
def test_ab_engine_matches_reference(na, nb, m, kind, excl, band, reseed):
    a = _series(na, seed=na + nb, kind=kind)
    b = _series(nb, seed=abs(na - nb) + 7, kind=kind)
    rc = rz.compute_cross_stats_host(a, b, m)
    ra, rb = rmp.ab_join_from_stats(rc, excl, band, reseed, True, True, None)
    ta, tb = tmp.ab_join_from_stats(_port_cross(rc, m), excl, band, reseed,
                                    True, True, None)
    _assert_state(ra, ta)
    _assert_state(rb, tb)


@pytest.mark.parametrize("col_tile,clamp_rows,two_sided", [
    (None, False, True),       # the unclamped full-height sweep
    (400, True, True),         # banked column state (width > li + band)
    (1000, False, True),
    (None, True, False),       # one-sided: B's state skipped
])
def test_ab_engine_options_match_reference(col_tile, clamp_rows, two_sided):
    a, b, m = _series(340, seed=1), _series(120, seed=2, kind="sine"), 12
    rc = rz.compute_cross_stats_host(a, b, m)
    pc = _port_cross(rc, m)
    for excl in (0, 4):
        ra, rb = rmp.ab_join_from_stats(rc, excl, 32, 64, two_sided,
                                        clamp_rows, col_tile)
        ta, tb = tmp.ab_join_from_stats(pc, excl, 32, 64, two_sided,
                                        clamp_rows, col_tile)
        _assert_state(ra, ta)
        if two_sided:
            _assert_state(rb, tb)
        else:
            assert rb is None and tb is None


def test_banked_col_state_refuses_narrow_banks():
    with pytest.raises(ValueError, match="bank width"):
        tmp.BankedColState.empty(100, 40, 40)


@pytest.mark.parametrize("stream", ["bfloat16", "float16"])
def test_ab_engine_reduced_streams_match_reference(stream):
    a, b, m = _series(260, seed=5), _series(200, seed=6), 16
    rc = rz.compute_cross_stats_host(a, b, m, out_dtype=np.dtype(stream)
                                     if stream == "float16" else stream)
    pc = _port_cross(rc, m)
    assert pc.a.df.dtype == getattr(torch, stream)
    ra, rb = rmp.ab_join_from_stats(rc, 0, 64, 128, True, True, None)
    ta, tb = tmp.ab_join_from_stats(pc, 0, 64, 128, True, True, None)
    _assert_state(ra, ta)
    _assert_state(rb, tb)


# -- kernels/ref.py -----------------------------------------------------------


@pytest.mark.parametrize("n,m,excl", [(400, 16, 4), (513, 24, 6),
                                      (300, 8, 0)])
def test_rowmax_profile_ref_matches_reference(n, m, excl):
    from repro.kernels import ref as rref

    ts = _series(n, seed=n, kind="noise")
    rs = rz.compute_stats_host(ts, m)
    l = n - m + 1
    ins = (rs.df, rs.dg, rs.invn, rs.cov0[excl:])
    ref = rref.rowmax_profile_ref(*ins, excl=excl, l=l)
    ps = _port_stats(rs, m)
    port = tref.rowmax_profile_ref(ps.df, ps.dg, ps.invn, ps.cov0[excl:],
                                   excl=excl, l=l)
    for (cr, ir), (cp, ip) in (((ref[0], ref[1]), (port[0], port[1])),
                               ((ref[2], ref[3]), (port[2], port[3]))):
        _assert_state(tmp.ProfileState(cr, ir), tmp.ProfileState(cp, ip))


@pytest.mark.parametrize("span", ["full", "neg", "pos"])
def test_rowmax_profile_ab_ref_matches_reference(span):
    from repro.kernels import ref as rref

    a, b, m = _series(260, seed=3), _series(180, seed=4, kind="sine"), 16
    rc = rz.compute_cross_stats_host(a, b, m)
    la, lb = rc.l_a, rc.l_b
    k_lo, k_hi = {"full": (-(la - 1), lb), "neg": (-(la - 1), -4),
                  "pos": (5, lb)}[span]
    ref = rref.rowmax_profile_ab_ref(rc, k_lo, k_hi)
    port = tref.rowmax_profile_ab_ref(_port_cross(rc, m), k_lo, k_hi)
    assert int(ref[4]) == port[4]
    _assert_state(tmp.ProfileState(ref[0], ref[1]),
                  tmp.ProfileState(port[0], port[1]))
    _assert_state(tmp.ProfileState(ref[2], ref[3]),
                  tmp.ProfileState(port[2], port[3]))


def test_ref_oracle_matches_kernel_plain_version():
    """`rowmax_profile_ref` and the NATSA kernel's plain version compute the
    same function of the same padded streams."""
    ts, m, excl = _series(700, seed=9), 20, 5
    stats = tz.compute_stats_host(ts, m, device="cpu")
    df, dg, invn, cov0p, n_rows, n_diags, l = ops._pad_streams(stats, 128,
                                                               8, excl)
    rows = n_rows * 128
    plain = natsa_mp.rowmax_profile_ab_plain(
        df[:rows], dg[:rows], invn[:rows], df, dg, invn, cov0p,
        k_start=excl, k_end=l, l_i=l, l_j=l)
    ref = tref.rowmax_profile_ref(df, dg, invn, stats.cov0[excl:].float(),
                                  excl=excl, l=l)
    _assert_state(tmp.ProfileState(ref[0], ref[1]),
                  tmp.ProfileState(plain[0][:l], plain[1][:l]))
    _assert_state(tmp.ProfileState(ref[2], ref[3]),
                  tmp.ProfileState(plain[2][:l], plain[3][:l]))


# -- planner and executor -----------------------------------------------------


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
    ((16, 485), {}),
    ((16, 485), dict(band=64, reseed_every=None, harvest="both")),
    ((128, 16257), dict(exclusion=0)),
    ((16, 300, 900), {}),
    ((16, 900, 300), dict(harvest="both", col_tile=512)),
    ((16, 900, 300), dict(clamp_rows=False, band=32)),
    ((16, 500, 400), dict(exclusion=7, precision="f64")),
    ((16, 500, 400), dict(precision="bf16", reseed_every=64)),
])
def test_engine_plan_matches_reference(args, kw):
    ref = rplan.plan_sweep(*args, backend="engine", **kw)
    port = tplan.plan_sweep(*args, backend="engine", device="cpu", **kw)
    assert _plan_fields(port) == _plan_fields(ref)
    assert port.backend == "engine" and not port.swap_ab


@pytest.mark.parametrize("kw,backend", [
    ({}, "kernel"),
    (dict(reseed_every=None), "kernel"),
    (dict(precision=PrecisionSpec(stream="float64")), "kernel"),
    (dict(band=64), "engine"),
    (dict(clamp_rows=False), "engine"),
    (dict(reseed_every=128), "engine"),
    (dict(precision="f64"), "engine"),
    (dict(precision=PrecisionSpec(accum="float64")), "engine"),
])
def test_default_backend_rule(kw, backend):
    for args in ((16, 300), (16, 300, 200)):
        plan = tplan.plan_sweep(*args, device="cpu", **kw)
        assert plan.backend == backend
        assert plan.swap_ab == (backend == "kernel" and len(args) == 3)


@pytest.mark.parametrize("kind", ["self", "ab"])
def test_engine_plan_execute_matches_reference(kind):
    m = 14
    if kind == "self":
        ts = _series(420, seed=5)
        rs = rz.compute_stats_host(ts, m)
        args, ps = (m, rs.n_subsequences), _port_stats(rs, m)
    else:
        a, b = _series(420, seed=5), _series(200, seed=6)
        rs = rz.compute_cross_stats_host(a, b, m)
        args, ps = (m, rs.l_a, rs.l_b), _port_cross(rs, m)
    kw = dict(backend="engine", harvest="both", band=64)
    ref = rplan.execute(rplan.plan_sweep(*args, **kw), rs)
    port = tplan.execute(tplan.plan_sweep(*args, device="cpu", **kw), ps)
    pairs = ((ref.dist, ref.index, port.dist, port.index),)
    if kind == "self":
        pairs += ((ref.left_dist, ref.left_index, port.left_dist,
                   port.left_index),
                  (ref.right_dist, ref.right_index, port.right_dist,
                   port.right_index))
    else:
        pairs += ((ref.dist_b, ref.index_b, port.dist_b, port.index_b),)
    for rd, ri, pd, pi in pairs:
        rcorr = 1.0 - np.asarray(rd, np.float64) ** 2 / (2 * m)
        _assert_state(tmp.ProfileState(rcorr, ri), tmp.ProfileState(
            tz.dist_to_corr(pd.double(), m), pi))


def test_engine_ab_minimal_plan_skips_b_and_recomputes_bitwise():
    a, b, m = _series(300, seed=7), _series(120, seed=8), 12
    cross = tz.compute_cross_stats_host(a, b, m, device="cpu")
    plan = tplan.plan_sweep(m, cross.l_a, cross.l_b, backend="engine",
                            device="cpu")
    res = tplan.execute(plan, cross)
    assert res.dist_b is None and not (res.raw or {}).get("b")
    from repro_torch.core.result import build_result

    wrapped = build_result(plan, res, cross)
    eager = tplan.execute(dataclasses.replace(
        plan, harvest=dataclasses.replace(plan.harvest, sides="both")),
        cross)
    assert torch.equal(wrapped.b_p, eager.dist_b)
    assert torch.equal(wrapped.b_i, eager.index_b)
    lazy = object.__getattribute__(wrapped, "_lazy")
    assert lazy.recomputes == 1
    wrapped.b_p
    assert lazy.recomputes == 1
    assert build_result(plan, res, stats=None).b_p is None


# -- entry points and the port's own contracts ---------------------------------


def test_entry_engine_split_lazy_equals_eager_bitwise():
    ts = _series(360, seed=1)
    lazy = matrix_profile(ts, 16, 4, band=64, device="cpu")
    eager = matrix_profile(ts, 16, 4, band=64, harvest="both", device="cpu")
    assert lazy.backend == "engine"
    fields = ("left_p", "left_i", "right_p", "right_i")
    assert all(object.__getattribute__(lazy, "_" + f) is None
               for f in fields)
    for f in fields:
        assert torch.equal(getattr(lazy, f), getattr(eager, f))
    assert object.__getattribute__(lazy, "_lazy").recomputes == 0
    assert torch.equal(torch.minimum(lazy.left_p, lazy.right_p), lazy.p)


def test_entry_engine_ab_lazy_b_equals_return_b_bitwise():
    a, b = _series(300, seed=2), _series(140, seed=3)
    lazy = ab_join(a, b, 12, band=32, device="cpu")
    eager = ab_join(a, b, 12, band=32, return_b=True, device="cpu")
    assert lazy.backend == eager.backend == "engine"
    assert torch.equal(lazy.p, eager.p)
    assert torch.equal(lazy.b_p, eager.b_p)
    assert torch.equal(lazy.b_i, eager.b_i)
    assert object.__getattribute__(lazy, "_lazy").recomputes == 1


@pytest.mark.parametrize("kind", ["walk", "noise"])
def test_engine_band_size_invariance(kind):
    """The answer does not depend on the band, bit for bit: each diagonal's
    cumsum and reseeds are the same whatever band holds it."""
    ts, m = _series(350, seed=5, kind=kind), 20
    stats = tz.compute_stats_host(ts, m, device="cpu")
    base = tmp.profile_from_stats(stats, 5, 256)
    for band in (7, 16, 64):
        got = tmp.profile_from_stats(stats, 5, band)
        for side in ("merged", "right", "left"):
            assert torch.equal(getattr(got, side).corr,
                               getattr(base, side).corr), (band, side)
    p16 = matrix_profile(ts, m, band=16, device="cpu")
    p64 = matrix_profile(ts, m, band=64, device="cpu")
    assert p16.backend == p64.backend == "engine"
    assert torch.equal(p16.p, p64.p)


@pytest.mark.parametrize("n,m,excl,kind", [(300, 16, 4, "walk"),
                                           (257, 10, 3, "noise"),
                                           (400, 32, 8, "sine")])
def test_engine_ab_join_with_exclusion_equals_self_join(n, m, excl, kind):
    ts = _series(n, seed=n, kind=kind)
    ab = ab_join(ts, ts, m, exclusion=excl, band=64, device="cpu")
    sj = matrix_profile(ts, m, exclusion=excl, band=64, device="cpu")
    assert ab.backend == sj.backend == "engine"
    ca, cs = tz.dist_to_corr(ab.p.double(), m), tz.dist_to_corr(sj.p.double(),
                                                                m)
    torch.testing.assert_close(ca, cs, rtol=0, atol=TOL)
    pos = torch.arange(ab.i.shape[0])
    assert bool(((ab.i - pos).abs() >= excl).all())


@pytest.mark.parametrize("entry", ["self", "ab"])
def test_engine_matches_kernel_plain_version(entry):
    """Both backends of the port on the same series: the band engine
    (reseeded) against the kernel path (its plain version on the host)."""
    m = 16
    if entry == "self":
        ts = _series(600, seed=11)
        eng = matrix_profile(ts, m, band=64, harvest="both", device="cpu")
        ker = matrix_profile(ts, m, harvest="both", device="cpu")
        pairs = [("p", "i"), ("left_p", "left_i"), ("right_p", "right_i")]
    else:
        a, b = _series(500, seed=12), _series(230, seed=13)
        eng = ab_join(a, b, m, band=64, return_b=True, device="cpu")
        ker = ab_join(a, b, m, return_b=True, device="cpu")
        pairs = [("p", "i"), ("b_p", "b_i")]
    assert (eng.backend, ker.backend) == ("engine", "kernel")
    for fp, fi in pairs:
        _assert_state(
            tmp.ProfileState(tz.dist_to_corr(getattr(ker, fp).double(), m),
                             getattr(ker, fi)),
            tmp.ProfileState(tz.dist_to_corr(getattr(eng, fp).double(), m),
                             getattr(eng, fi)))


def test_engine_f64_entry_matches_reference():
    from repro.core import matrix_profile as ref_matrix_profile

    ts, m = _series(380, seed=14, kind="noise"), 16
    with jax.enable_x64(True):
        ref = ref_matrix_profile(ts, m, precision="f64")
        rp, ri = np.asarray(ref.p), np.asarray(ref.i)
    port = matrix_profile(ts, m, precision="f64", device="cpu")
    assert port.backend == "engine" and port.p.dtype == torch.float64
    np.testing.assert_allclose(port.p.numpy(), rp, rtol=0, atol=1e-10)
    assert (port.i.numpy() == ri).all()


def test_engine_runs_reduced_ab_streams_but_not_self():
    """16-bit AB streams run the band engine's recurrence; a 16-bit
    self-join on the engine takes the tile sweep instead (slice 6; once
    refused here), within 1e-4 in correlation of the reference's."""
    from repro.core import matrix_profile as ref_matrix_profile

    a, b = _series(300, seed=15), _series(200, seed=16)
    res = ab_join(a, b, 16, band=64, precision="bf16", device="cpu")
    assert res.backend == "engine" and bool(torch.isfinite(res.p).all())
    port = matrix_profile(a, 16, band=64, precision="f16", device="cpu")
    ref = ref_matrix_profile(a, 16, band=64, precision="f16")
    assert port.backend == "engine"
    rp = np.asarray(ref.p, np.float64)
    _assert_state(rmp.ProfileState(1.0 - rp * rp / 32.0, np.asarray(ref.i)),
                  tmp.ProfileState(tz.dist_to_corr(port.p.double(), 16),
                                   port.i))
