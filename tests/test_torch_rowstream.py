"""The rowstream AB sweep in the port against the reference, on the CPU.

`ab_join_rowstream` and `ab_join_rowstream_topk` on identical streams
(carried over bit for bit), the planner's rowstream rules and the
executor's branch, held to the standard of `tests/test_torch_topk.py`:
correlations within 1e-4, indices equal except at near-ties of the dense f64
oracle. Inside the port, rowstream top-k slot 0 equals rowstream k = 1 bit
for bit, and a lazily finished B side equals an eager one. Geometries
mirror the reference's `tests/test_tiling2d.py`, `tests/test_plan.py`,
`tests/test_missing_data.py`, `tests/test_lazy_result.py` and
`tests/test_result.py`.
"""

import importlib

import numpy as np
import pytest
import torch

from repro.core import ab_join as ref_ab_join
from repro.core import plan as rplan
from repro.core import zstats as rz
from repro_torch.core import ab_join
from repro_torch.core import plan as tplan
from repro_torch.core import zstats as tz
from test_torch_topk import (
    assert_result_topk, assert_topk, corr_of, dense_corr, port_cross, walk,
)

rmp = importlib.import_module("repro.core.matrix_profile")
tmp = importlib.import_module("repro_torch.core.matrix_profile")


def _as_topk(state):
    """A k = 1 `ProfileState` as (l, 1) sets, for `assert_topk`."""
    return (np.asarray(state.corr)[:, None], np.asarray(state.index)[:, None])


def _assert_side(ref_state, port_state, dense):
    rc, ri = _as_topk(ref_state)
    assert_topk(rc, ri, port_state.corr[:, None], port_state.index[:, None],
                dense)


@pytest.mark.parametrize("na,nb,m,excl,reseed", [
    (600, 150, 16, 0, 512),        # tests/test_tiling2d.py:138
    (150, 600, 16, 0, 512),
    (400, 400, 24, 12, 512),       # exclusion (self-join-as-AB shape)
    (700, 700, 16, 0, 128),        # rows past one reseed period
])
def test_rowstream_matches_reference(na, nb, m, excl, reseed):
    a = walk(na, seed=na + 11).astype(np.float32)
    b = a if na == nb and excl else walk(nb, seed=nb + 13)
    rc = rz.compute_cross_stats_host(a, b, m)
    pc = port_cross(rc, m)
    dense = dense_corr(a, b, m, excl)
    ra, rb = rmp.ab_join_rowstream(rc, excl, reseed)
    pa, pb = tmp.ab_join_rowstream(pc, excl, reseed)
    assert pa.index.dtype == pb.index.dtype == torch.int32
    _assert_side(ra, pa, dense)
    _assert_side(rb, pb, dense.T)
    # and against the port's own band engine on the same streams
    ea, eb = tmp.ab_join_from_stats(pc, excl, 64, reseed)
    torch.testing.assert_close(pa.corr, ea.corr, rtol=0, atol=1e-4)
    torch.testing.assert_close(pb.corr, eb.corr, rtol=0, atol=1e-4)


@pytest.mark.parametrize("k,excl", [(2, 0), (4, 0), (3, 7)])
def test_rowstream_topk_matches_reference(k, excl):
    a, b = walk(260, seed=13).astype(np.float32), walk(120, seed=14)
    m = 12
    rc = rz.compute_cross_stats_host(a, b, m)
    pc = port_cross(rc, m)
    dense = dense_corr(a, b, m, excl)
    ra, rb = rmp.ab_join_rowstream_topk(rc, excl, 512, k)
    pa, pb = tmp.ab_join_rowstream_topk(pc, excl, 512, k)
    assert_topk(ra.corr, ra.index, pa.corr, pa.index, dense)
    assert_topk(rb.corr, rb.index, pb.corr, pb.index, dense.T)
    # slot 0 == the k = 1 rowstream, bit for bit (values)
    sa, sb = tmp.ab_join_rowstream(pc, excl, 512)
    torch.testing.assert_close(pa.corr[:, 0], sa.corr, rtol=0, atol=0)
    torch.testing.assert_close(pb.corr[:, 0], sb.corr, rtol=0, atol=0)


def test_rowstream_plan_equals_direct_call():
    """tests/test_plan.py:71: the planned rowstream (short side on rows)
    is, bit for bit, the direct sweep of the swapped rectangle."""
    a, b = walk(500, seed=3), walk(120, seed=4)
    m = 12
    res = ab_join(a, b, m, return_b=True, backend="rowstream", device="cpu")
    assert res.backend == "rowstream"
    cross = tz.compute_cross_stats_host(b, a, m, device="cpu")
    sb, sa = tmp.ab_join_rowstream(cross, 0, tmp.DEFAULT_RESEED)
    torch.testing.assert_close(res.p, sa.to_distance(m), rtol=0, atol=0)
    assert torch.equal(res.i, sa.index)
    torch.testing.assert_close(res.b_p, sb.to_distance(m), rtol=0, atol=0)
    assert torch.equal(res.b_i, sb.index)
    ref = ref_ab_join(a, b, m, return_b=True)
    assert ref.backend == "rowstream"
    dense = dense_corr(a, b, m)
    for rp, ri, pp, pi, d in ((ref.p, ref.i, res.p, res.i, dense),
                              (ref.b_p, ref.b_i, res.b_p, res.b_i, dense.T)):
        assert_topk(corr_of(rp, m)[:, None], np.asarray(ri)[:, None],
                    corr_of(pp, m)[:, None], pi[:, None], d)


def test_rowstream_missing_data():
    """tests/test_missing_data.py:143."""
    ta, tb = walk(150, seed=6), walk(400, seed=7)
    ta[40], tb[90] = np.nan, -np.inf
    m = 16
    res = ab_join(ta, tb, m, return_b=True, backend="rowstream",
                  device="cpu")
    ref = ref_ab_join(ta, tb, m, return_b=True)
    dense = dense_corr(ta, tb, m)
    for rp, ri, pp, pi, d in ((ref.p, ref.i, res.p, res.i, dense),
                              (ref.b_p, ref.b_i, res.b_p, res.b_i, dense.T)):
        assert_topk(corr_of(rp, m)[:, None], np.asarray(ri)[:, None],
                    corr_of(pp, m)[:, None], pi[:, None], d)
        bad = np.isneginf(d).all(axis=1)
        assert bad.any() and np.isinf(pp.numpy()[bad]).all()


def test_rowstream_b_side_lazy_equals_eager_no_recompute():
    """tests/test_lazy_result.py:94."""
    a, b = walk(300, seed=4), walk(120, seed=5)
    lazy = ab_join(a, b, 12, backend="rowstream", device="cpu")
    eager = ab_join(a, b, 12, return_b=True, backend="rowstream",
                    device="cpu")
    assert object.__getattribute__(lazy, "_b_p") is None
    for f in ("p", "i", "b_p", "b_i"):
        torch.testing.assert_close(getattr(lazy, f), getattr(eager, f),
                                   rtol=0, atol=0)
    assert object.__getattribute__(lazy, "_lazy").recomputes == 0


@pytest.mark.parametrize("return_b", [True, False])
def test_rowstream_topk_entry_and_slot0(return_b):
    """tests/test_result.py:128 and :148 on rowstream: both sides' top-k
    against the reference, slot 0 bit for bit the k = 1 rowstream."""
    a, b = walk(400, seed=10), walk(90, seed=11)
    m, k = 12, 3
    abk = ab_join(a, b, m, return_b=return_b, k=k, device="cpu")
    ab1 = ab_join(a, b, m, return_b=return_b, backend="rowstream",
                  device="cpu")
    ref = ref_ab_join(a, b, m, return_b=return_b, k=k)
    assert abk.backend == ref.backend == "rowstream"
    dense = dense_corr(a, b, m)
    assert_result_topk(ref, abk, dense, m)
    assert_result_topk(ref, abk, dense.T, m, side="b_")
    torch.testing.assert_close(abk.topk_p[:, 0], ab1.p, rtol=0, atol=0)
    torch.testing.assert_close(abk.b_topk_p[:, 0], ab1.b_p, rtol=0, atol=0)
    torch.testing.assert_close(abk.b_p, ab1.b_p, rtol=0, atol=0)


@pytest.mark.parametrize("kw,expect", [
    # tests/test_plan.py:211: skewed k > 1 joins -> rowstream, short side
    # on rows; a near-square large one -> the engine
    (dict(l_a=3969, l_b=385, k=2), dict(backend="rowstream", swap_ab=True)),
    (dict(l_a=385, l_b=3969, k=2), dict(backend="rowstream", swap_ab=False)),
    (dict(l_a=8000, l_b=6000, k=2), dict(backend="engine", swap_ab=False)),
    # k must fit the short side
    (dict(l_a=3969, l_b=3, k=4), dict(backend="engine", swap_ab=False)),
    # an explicit rowstream at k = 1 (the port's default there is the
    # kernel, ROADMAP §C (1))
    (dict(l_a=3969, l_b=385, backend="rowstream"),
     dict(backend="rowstream", swap_ab=True)),
    (dict(l_a=3969, l_b=385), dict(backend="kernel", swap_ab=True)),
])
def test_rowstream_planner_choices(kw, expect):
    got = tplan.plan_sweep(128, device="cpu", **kw)
    for f, v in expect.items():
        assert getattr(got, f) == v, f
    if "backend" in kw or kw.get("k", 1) > 1:
        ref = rplan.plan_sweep(128, **kw)
        assert (ref.backend, ref.swap_ab) == (got.backend, got.swap_ab)


@pytest.mark.parametrize("kw", [
    dict(l_a=300, backend="rowstream"),                   # a self-join
    dict(l_a=300, l_b=3, backend="rowstream", k=4),       # k > short side
    dict(l_a=300, l_b=200, backend="rowstream", normalize=False),
])
def test_rowstream_guard_rails_raise_like_reference(kw):
    with pytest.raises(ValueError):
        rplan.plan_sweep(16, **kw)
    with pytest.raises(ValueError):
        tplan.plan_sweep(16, device="cpu", **kw)


def test_rowstream_reseed_rows_are_exact_dots():
    """The reseed rows replace the carry with centered-window dots: with a
    period of 1 every row is an exact dot, and the profile agrees with the
    dense f64 oracle to f32 rounding."""
    a, b = walk(200, seed=30), walk(150, seed=31)
    m = 16
    cross = tz.compute_cross_stats_host(a, b, m, device="cpu")
    pa, pb = tmp.ab_join_rowstream(cross, 0, 1)
    dense = dense_corr(a, b, m)
    np.testing.assert_allclose(pa.corr.double().numpy(), dense.max(axis=1),
                               rtol=0, atol=2e-6)
    np.testing.assert_allclose(pb.corr.double().numpy(), dense.max(axis=0),
                               rtol=0, atol=2e-6)


@pytest.mark.parametrize("precision", ["bf16", "f64"])
def test_rowstream_precision_matches_reference(precision):
    """16-bit streams and f64 accumulation on rowstream: the streams are
    upcast to the accumulator dtype at load, as in the reference."""
    import jax

    a, b = walk(400, seed=50), walk(150, seed=51)
    m = 16
    with jax.enable_x64(precision == "f64"):
        ref = ref_ab_join(a, b, m, return_b=True, precision=precision)
        rp, ri = np.asarray(ref.p, np.float64), np.asarray(ref.i)
        rbp, rbi = np.asarray(ref.b_p, np.float64), np.asarray(ref.b_i)
    assert ref.backend == "rowstream"
    res = ab_join(a, b, m, return_b=True, backend="rowstream",
                  precision=precision, device="cpu")
    want = torch.float64 if precision == "f64" else torch.float32
    assert res.p.dtype == want
    dense = dense_corr(a, b, m)
    for p, i, pp, pi, d in ((rp, ri, res.p, res.i, dense),
                            (rbp, rbi, res.b_p, res.b_i, dense.T)):
        # the port's values against the reference's: the streams (bf16
        # included) are the same bits, so only the sweeps' order differs
        np.testing.assert_allclose(corr_of(pp, m), corr_of(p, m), rtol=0,
                                   atol=1e-4 if precision == "bf16"
                                   else 1e-10)
        if precision == "f64":
            assert_topk(corr_of(p, m)[:, None], i[:, None],
                        corr_of(pp, m)[:, None], pi[:, None], d)
