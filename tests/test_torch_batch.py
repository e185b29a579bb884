"""Batched plans in the port (`batch_profile`, `batch_ab_join`, `batch=`),
on the CPU.

The contract is the reference's own: a batched plan equals the sequential
calls of its unbatched plan on each series, bit for bit, inside the port
(`tests/test_ab_join.py:152`, `:173`; `tests/test_fused_twoside.py:209`),
with every field stacked (B, l[, k]). Across packages the batched results
hold to `tests/test_torch_topk.py`'s standard against `repro`'s vmapped
ones, on identical streams where the payload is carried over.
"""

import jax
import numpy as np
import pytest
import torch

from repro.core import batch_ab_join as ref_batch_ab_join
from repro.core import batch_profile as ref_batch_profile
from repro.core import plan as rplan
from repro.core import zstats as rz
from repro_torch.core import batch_ab_join, batch_profile
from repro_torch.core import plan as tplan
from repro_torch.core import zstats as tz
from test_torch_topk import FIELDS, assert_topk, corr_of, dense_corr

_SEQ_FIELDS = ("dist", "index", "dist_b", "index_b", "left_dist",
               "left_index", "right_dist", "right_index", "topk_dist",
               "topk_index", "topk_dist_b", "topk_index_b")
_RESULT_OF = {"dist": "p", "index": "i", "dist_b": "b_p", "index_b": "b_i",
              "left_dist": "left_p", "left_index": "left_i",
              "right_dist": "right_p", "right_index": "right_i",
              "topk_dist": "topk_p", "topk_index": "topk_i",
              "topk_dist_b": "b_topk_p", "topk_index_b": "b_topk_i"}


def _stack(kinds, n, seed0):
    rng = np.random.default_rng(seed0)
    out = []
    for r, kind in enumerate(kinds):
        if kind == "walk":
            out.append(np.cumsum(rng.normal(size=n)))
        elif kind == "noise":
            out.append(rng.normal(size=n))
        elif kind == "sine":
            out.append(np.sin(np.arange(n) / 4.8) + 0.05 * rng.normal(size=n))
        else:                             # flat stretch: zero-variance windows
            t = rng.normal(size=n)
            t[n // 3:n // 3 + n // 4] = 2.5
            out.append(t)
    return np.stack(out).astype(np.float32)


def _assert_equals_sequential(batched, plan, payloads):
    """Every stacked field of a batched result equals the unbatched plan
    executed on each series, bit for bit (lazy sides resolved)."""
    one = tplan.plan_sweep(plan.window, plan.l_a, plan.l_b,
                           exclusion=plan.exclusion, harvest="both",
                           k=plan.harvest.k, backend=plan.backend,
                           band=plan.band, reseed_every=plan.reseed_every,
                           device="cpu")
    seq = [tplan.execute(one, p) for p in payloads]
    checked = 0
    for f in _SEQ_FIELDS:
        if getattr(seq[0], f) is None:
            continue
        got = getattr(batched, _RESULT_OF[f])
        assert got is not None, f
        want = torch.stack([getattr(s, f) for s in seq])
        assert got.shape == want.shape and got.dtype == want.dtype, f
        assert torch.equal(got, want), f
        checked += 1
    return checked


@pytest.mark.parametrize("k,harvest", [(1, "merged"), (1, "both"),
                                       (3, "merged")])
def test_batch_profile_equals_sequential(k, harvest):
    """tests/test_ab_join.py:152 / test_fused_twoside.py:209, in the port
    bit for bit."""
    stack = _stack(["walk", "noise", "sine", "flat"], 260, seed0=5)
    m = 14
    res = batch_profile(stack, m, k=k, harvest=harvest, device="cpu")
    assert res.backend == "engine" and res.p.shape == (4, 260 - m + 1)
    payloads = [tz.compute_stats_host(s, m, device="cpu") for s in stack]
    plan = tplan.plan_sweep(m, 260 - m + 1, k=k, batch=4, device="cpu")
    assert _assert_equals_sequential(res, plan, payloads) >= (
        6 if k == 1 else 8)
    ref = ref_batch_profile(stack, m, k=k)
    for r in range(4):
        dense = dense_corr(stack[r], stack[r], m, plan.exclusion)
        assert_topk(corr_of(np.asarray(ref.p[r]), m)[:, None],
                    np.asarray(ref.i[r])[:, None],
                    corr_of(res.p[r], m)[:, None], res.i[r][:, None], dense)


@pytest.mark.parametrize("backend,k,return_b", [
    (None, 1, False), (None, 1, True), ("rowstream", 1, True),
    (None, 3, True), ("rowstream", 3, False)])
def test_batch_ab_join_equals_sequential(backend, k, return_b):
    """tests/test_ab_join.py:173 in the port, on the engine (the batched
    default) and on rowstream, bit for bit."""
    a = _stack(["walk"] * 3, 200, seed0=1)
    b = _stack(["sine"] * 3, 90, seed0=11)
    m = 12
    res = batch_ab_join(a, b, m, return_b=return_b, k=k, backend=backend,
                        device="cpu")
    plan = tplan.plan_sweep(m, 189, 79, k=k, batch=3, backend=backend,
                            device="cpu")
    assert res.backend == plan.backend == (backend or "engine")
    assert res.p.shape == (3, 189)
    payloads = [tplan.cross_stats_for(plan, x, y) for x, y in zip(a, b)]
    assert _assert_equals_sequential(res, plan, payloads) >= 4
    ref = ref_batch_ab_join(a, b, m, return_b=True, k=k)
    for r in range(3):
        dense = dense_corr(a[r], b[r], m)
        assert_topk(corr_of(np.asarray(ref.p[r]), m)[:, None],
                    np.asarray(ref.i[r])[:, None],
                    corr_of(res.p[r], m)[:, None], res.i[r][:, None], dense)
        assert_topk(corr_of(np.asarray(ref.b_p[r]), m)[:, None],
                    np.asarray(ref.b_i[r])[:, None],
                    corr_of(res.b_p[r], m)[:, None], res.b_i[r][:, None],
                    dense.T)


def test_batch_topk_stacks_against_reference():
    """tests/test_result.py:191."""
    stack = _stack(["walk"] * 3, 220, seed0=20)
    m, excl, k = 14, 3, 3
    res = batch_profile(stack, m, exclusion=excl, k=k, device="cpu")
    ref = ref_batch_profile(stack, m, exclusion=excl, k=k)
    assert res.topk_p.shape == (3, 220 - m + 1, k)
    for r in range(3):
        dense = dense_corr(stack[r], stack[r], m, excl)
        assert_topk(corr_of(np.asarray(ref.topk_p[r]), m),
                    np.asarray(ref.topk_i[r]), corr_of(res.topk_p[r], m),
                    res.topk_i[r], dense)


def test_batch_split_lazy_equals_eager_no_recompute():
    """tests/test_lazy_result.py:117."""
    stack = _stack(["walk"] * 3, 200, seed0=10)
    lazy = batch_profile(stack, 14, exclusion=3, device="cpu")
    eager = batch_profile(stack, 14, exclusion=3, harvest="both",
                          device="cpu")
    assert object.__getattribute__(lazy, "_left_p") is None
    assert lazy.left_p.shape == (3, 200 - 14 + 1)
    for f in ("left_p", "left_i", "right_p", "right_i"):
        assert torch.equal(getattr(lazy, f), getattr(eager, f)), f
    assert object.__getattribute__(lazy, "_lazy").recomputes == 0


def test_batch_engine_b_side_recomputes_bitwise():
    """A minimal batched engine AB plan skips B's column state; lazy access
    re-executes the same batched plan two-sided."""
    a = _stack(["walk"] * 2, 200, seed0=30)
    b = _stack(["noise"] * 2, 120, seed0=31)
    lazy = batch_ab_join(a, b, 12, device="cpu")
    eager = batch_ab_join(a, b, 12, return_b=True, device="cpu")
    assert torch.equal(lazy.b_p, eager.b_p)
    assert torch.equal(lazy.b_i, eager.b_i)
    assert object.__getattribute__(lazy, "_lazy").recomputes == 1


def test_batched_carry_over_executes_like_the_reference():
    """A batched reference payload, carried over bit for bit, executes as
    one batched plan in the port and agrees with the reference's vmap."""
    stack = _stack(["walk", "noise", "sine"], 260, seed0=40)
    m, excl, k = 14, 3, 2
    parts = [rz.compute_stats_host(s, m) for s in stack]
    st = jax.tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs]),
                      *parts)
    port_stack = tz.stats_from_arrays({f: getattr(st, f) for f in FIELDS}, m,
                                      device="cpu")
    rp = rplan.plan_sweep(m, 260 - m + 1, exclusion=excl, batch=3, k=k)
    tp = tplan.plan_sweep(m, 260 - m + 1, exclusion=excl, batch=3, k=k,
                          device="cpu")
    ref = rplan.execute(rp, jax.tree.map(jax.numpy.asarray, st))
    got = tplan.execute(tp, port_stack)
    for r in range(3):
        dense = dense_corr(stack[r], stack[r], m, excl)
        assert_topk(corr_of(np.asarray(ref.topk_dist[r]), m),
                    np.asarray(ref.topk_index[r]),
                    corr_of(got.topk_dist[r], m), got.topk_index[r], dense)
    with pytest.raises(ValueError, match="stacks 2"):
        tplan.execute(tp, tz.stack_stats(tz.unstack_stats(port_stack)[:2]))


def test_batched_cross_carry_over_executes_like_the_reference():
    """`cross_stats_from_arrays` takes a batched reference `CrossStats`
    stack bit for bit; a batched rowstream AB plan on it agrees with the
    reference's vmap."""
    a = _stack(["walk"] * 3, 150, seed0=50)
    b = _stack(["sine"] * 3, 200, seed0=51)
    m, k = 12, 2
    parts = [rz.compute_cross_stats_host(x, y, m) for x, y in zip(a, b)]
    st = jax.tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs]),
                      *parts)
    fields = {s: {f: getattr(getattr(st, s), f) for f in FIELDS}
              for s in ("a", "b")} | {"cov0s": st.cov0s}
    port = tz.cross_stats_from_arrays(fields, m, device="cpu")
    assert port.cov0s.shape == (3, 139 + 189 - 1)
    np.testing.assert_array_equal(port.a.df.numpy(), st.a.df)
    kw = dict(batch=3, k=k, backend="rowstream", harvest="both")
    rp = rplan.plan_sweep(m, 139, 189, **kw)
    tp = tplan.plan_sweep(m, 139, 189, device="cpu", **kw)
    assert not rp.swap_ab and not tp.swap_ab   # A is the swept row side
    ref = rplan.execute(rp, jax.tree.map(jax.numpy.asarray, st))
    got = tplan.execute(tp, port)
    for r in range(3):
        dense = dense_corr(a[r], b[r], m)
        assert_topk(corr_of(np.asarray(ref.topk_dist[r]), m),
                    np.asarray(ref.topk_index[r]),
                    corr_of(got.topk_dist[r], m), got.topk_index[r], dense)
        assert_topk(corr_of(np.asarray(ref.topk_dist_b[r]), m),
                    np.asarray(ref.topk_index_b[r]),
                    corr_of(got.topk_dist_b[r], m), got.topk_index_b[r],
                    dense.T)


@pytest.mark.parametrize("kw", [
    dict(batch=3, backend="kernel"),
    dict(batch=3, normalize=False),
])
def test_batch_guard_rails_raise_like_reference(kw):
    with pytest.raises(ValueError):
        rplan.plan_sweep(16, 300, 200, **kw)
    with pytest.raises(ValueError):
        tplan.plan_sweep(16, 300, 200, device="cpu", **kw)


def test_batch_entries_reject_bad_stacks():
    with pytest.raises(ValueError, match="batch, n"):
        batch_profile(np.zeros(64), 8, device="cpu")
    with pytest.raises(ValueError, match="matching"):
        batch_ab_join(np.zeros((2, 64)), np.zeros((3, 64)), 8, device="cpu")


def test_batched_topk_ab_plans_the_engine():
    """The batched AB default is the engine even where an unbatched top-k
    join takes rowstream (the reference's rule, tests/test_plan.py:222)."""
    ref = rplan.plan_sweep(64, 961, 449, batch=8, k=2)
    got = tplan.plan_sweep(64, 961, 449, batch=8, k=2, device="cpu")
    assert ref.backend == got.backend == "engine"
    assert tplan.plan_sweep(64, 961, 449, k=2,
                            device="cpu").backend == "rowstream"
