"""Exact top-k (k > 1) in the port against the reference, on the CPU.

The band engine's top-k sweeps (`profile_topk_from_stats`,
`ab_join_topk_from_stats`), the `TopKState` union and the planner's top-k
rules, held against `repro` on identical streams (carried over bit for bit)
and against a dense f64 correlation oracle. Standard, in correlation space:
values within 1e-4; where an index differs, the two picks' exact f64
correlations are within 1e-4 of each other (a near-tie); each picked index
realizes its value within 1e-4; a row's picks are distinct and best-first.
Inside the port, top-k slot 0 equals the k = 1 profile of the same backend
bit for bit. Geometries mirror the reference's `tests/test_result.py`,
`tests/test_missing_data.py` and `tests/test_lazy_result.py`.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ab_join as ref_ab_join
from repro.core import matrix_profile as ref_matrix_profile
from repro.core import plan as rplan
from repro.core import zstats as rz
from repro_torch.core import TopKState, ab_join, matrix_profile
from repro_torch.core import plan as tplan
from repro_torch.core import zstats as tz
from repro_torch.kernels import ops as tops

rmp = importlib.import_module("repro.core.matrix_profile")
tmp = importlib.import_module("repro_torch.core.matrix_profile")

TOL = 1e-4
NEG = -2.0
FIELDS = ("ts", "mu", "invn", "df", "dg", "cov0")


# -- shared helpers (imported by test_torch_rowstream / test_torch_batch) ----


def walk(n, seed):
    return np.cumsum(np.random.default_rng(seed).normal(size=n))


def port_stats(ref_stats, m):
    return tz.stats_from_arrays(
        {f: np.asarray(getattr(ref_stats, f)) for f in FIELDS}, m,
        device="cpu")


def port_cross(ref_cross, m):
    return tz.cross_stats_from_arrays(
        {s: {f: np.asarray(getattr(getattr(ref_cross, s), f))
             for f in FIELDS} for s in ("a", "b")}
        | {"cov0s": np.asarray(ref_cross.cov0s)}, m, device="cpu")


def dense_corr(a, b, m, excl=0):
    """(l_a, l_b) f64 z-normalized correlations by direct window dots: a
    flat window correlates 0 with everything, a window touching a
    non-finite sample and the exclusion band |j - i| < excl are -inf."""
    def windows(t):
        t = np.asarray(t, np.float64)
        w = np.lib.stride_tricks.sliding_window_view(t, m)
        bad = ~np.isfinite(w).all(axis=1)
        w = np.where(bad[:, None], 0.0, w)
        w = w - w.mean(axis=1, keepdims=True)
        n = np.linalg.norm(w, axis=1)
        return w, n, bad

    wa, na, bada = windows(a)
    wb, nb, badb = windows(b)
    live = (na[:, None] > 0) & (nb[None, :] > 0)
    c = np.where(live, wa @ wb.T / np.maximum(na[:, None] * nb[None, :],
                                              1e-300), 0.0)
    c[bada, :] = -np.inf
    c[:, badb] = -np.inf
    if excl > 0:
        i = np.arange(c.shape[0])[:, None]
        j = np.arange(c.shape[1])[None, :]
        c[np.abs(i - j) < excl] = -np.inf
    return c


def corr_of(dist, m):
    """Distances (inf = no neighbour) -> correlations (NEG)."""
    d = (dist.double().numpy() if isinstance(dist, torch.Tensor)
         else np.asarray(dist, np.float64))
    return np.where(np.isfinite(d), 1.0 - d * d / (2.0 * m), NEG)


def assert_topk(ref_c, ref_i, port_c, port_i, dense, tol=TOL):
    """The module's standard for one side's (l, k) sets (see above)."""
    ref_c, ref_i = np.asarray(ref_c, np.float64), np.asarray(ref_i)
    if isinstance(port_c, torch.Tensor):
        port_c = port_c.double().numpy()
    assert port_i.dtype == torch.int32
    port_i = port_i.numpy()
    assert port_c.shape == ref_c.shape == port_i.shape == ref_i.shape
    np.testing.assert_array_equal(port_i >= 0, ref_i >= 0)
    np.testing.assert_allclose(port_c, ref_c, rtol=0, atol=tol)
    rows = np.arange(port_i.shape[0])[:, None].repeat(port_i.shape[1], 1)
    live = port_i >= 0
    got = dense[rows[live], port_i[live]]
    assert np.abs(got - port_c[live]).max(initial=0) < tol
    diff = live & (port_i != ref_i)
    gap = dense[rows[diff], port_i[diff]] - dense[rows[diff], ref_i[diff]]
    assert np.abs(gap).max(initial=0) < tol, "index mismatch off a near-tie"
    assert (np.diff(port_c, axis=1) <= 0).all()          # best-first
    for r in range(port_i.shape[0]):
        picked = port_i[r][port_i[r] >= 0]
        assert len(set(picked.tolist())) == picked.size
    assert (port_c[~live] == NEG).all()


def assert_result_topk(ref, port, dense, m, side=""):
    assert_topk(corr_of(getattr(ref, side + "topk_p"), m),
                getattr(ref, side + "topk_i"),
                corr_of(getattr(port, side + "topk_p"), m),
                getattr(port, side + "topk_i"), dense)


# -- the stable top-k and the union -------------------------------------------


def _tie_tile(shape, seed):
    """Values on a coarse grid, so most columns hold exact ties, with NEG
    fill as a sweep's masked cells leave it."""
    rng = np.random.default_rng(seed)
    t = rng.integers(-3, 4, size=shape).astype(np.float32) / 4
    t[rng.random(shape) < 0.2] = NEG
    return t


@pytest.mark.parametrize("shape,k", [((16, 40), 4), ((8, 33), 8),
                                     ((64, 5), 3), ((37, 1), 5)])
def test_topk_rows_is_stable_lax_top_k(shape, k):
    tile = _tie_tile(shape, seed=shape[0] + k)
    vals, d = tmp._topk_rows(torch.from_numpy(tile.copy()), k)
    ref_v, ref_d = rmp._topk_rows(jnp.asarray(tile), k)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(ref_v))
    np.testing.assert_array_equal(d.numpy(), np.asarray(ref_d))
    sv, sd = torch.sort(torch.from_numpy(tile.T.copy()), dim=-1,
                        descending=True, stable=True)
    np.testing.assert_array_equal(vals.numpy(), sv[:, :k].numpy())
    np.testing.assert_array_equal(d.numpy(), sd[:, :k].numpy())


@pytest.mark.parametrize("k", [2, 4])
def test_topk_union_resolves_ties_to_the_accumulator(k):
    rng = np.random.default_rng(k)
    c1 = -np.sort(-_tie_tile((50, k), seed=10 + k), axis=1)
    c2 = -np.sort(-_tie_tile((50, k), seed=20 + k), axis=1)
    i1 = rng.integers(0, 100, size=(50, k)).astype(np.int32)
    i2 = rng.integers(100, 200, size=(50, k)).astype(np.int32)
    got = tmp._topk_union(*(torch.from_numpy(x) for x in (c1, i1, c2, i2)),
                          k)
    ref = rmp._topk_union(*(jnp.asarray(x) for x in (c1, i1, c2, i2)), k)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.gpu
def test_stable_topk_and_union_on_card():
    """On the card, at the shapes of a band tile and a column-state union,
    with exact ties everywhere: the same values and indices as on the CPU
    (CUDA's `torch.topk` is not stable, the port's top-k and union are)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    tile = torch.from_numpy(_tie_tile((256, 50000), seed=1))
    for k in (1, 4, 8):
        cpu = tmp._topk_rows(tile.clone(), k)
        card = tmp._topk_rows(tile.cuda(), k)
        for x, y in zip(cpu, card):
            assert torch.equal(x, y.cpu())
    c = torch.from_numpy(-np.sort(-_tie_tile((300000, 8), seed=2), axis=1))
    i = torch.arange(c.numel(), dtype=torch.int32).reshape(c.shape)
    cpu = tmp._topk_union(c[:, :4], i[:, :4], c[:, 4:], i[:, 4:], 4)
    card = tmp._topk_union(*(x.cuda() for x in (c[:, :4], i[:, :4],
                                                c[:, 4:], i[:, 4:])), 4)
    for x, y in zip(cpu, card):
        assert torch.equal(x, y.cpu())


def test_topk_state_carry_over_and_window_merge():
    ts = walk(260, seed=3).astype(np.float32)
    rs = rz.compute_stats_host(ts, 16)
    merged, _, _ = rmp.profile_topk_from_stats(rs, 4, 64, 512, 3)
    st = TopKState.from_arrays(np.asarray(merged.corr),
                               np.asarray(merged.index), device="cpu")
    assert st.k == 3 and st.index.dtype == torch.int32
    np.testing.assert_array_equal(st.corr.numpy(), np.asarray(merged.corr))
    np.testing.assert_array_equal(st.index.numpy(), np.asarray(merged.index))
    # the conversion itself rounds its own way (XLA fuses the sqrt)
    np.testing.assert_allclose(st.to_distance(16).numpy(),
                               np.asarray(merged.to_distance(16)), rtol=1e-6)
    torch.testing.assert_close(st.best.corr, st.corr[:, 0], rtol=0, atol=0)
    # a window past the end is moved back inside, as dynamic_slice does
    acc = TopKState.empty(10, 2, device="cpu")
    win = torch.tensor([[0.5, 0.1], [0.4, NEG], [0.3, 0.2]])
    acc.merge_window(win, torch.tensor([[1, 2], [3, -1], [4, 5]],
                                       dtype=torch.int32), 9)
    np.testing.assert_array_equal(acc.index[7:].numpy(),
                                  [[1, 2], [3, -1], [4, 5]])


# -- the band engine's top-k sweeps (identical streams) ----------------------


@pytest.mark.parametrize("k,band", [(2, 256), (4, 64), (8, 32)])
def test_profile_topk_from_stats_matches_reference(k, band):
    ts, m, excl = walk(300, seed=7).astype(np.float32), 16, 4
    rs = rz.compute_stats_host(ts, m)
    ref = rmp.profile_topk_from_stats(rs, excl, band, 512, k)
    port = tmp.profile_topk_from_stats(port_stats(rs, m), excl, band, 512, k)
    dense = dense_corr(ts, ts, m, excl)
    for r, p in zip(ref, port):            # merged, right, left
        assert_topk(r.corr, r.index, p.corr, p.index, dense)


@pytest.mark.parametrize("na,nb,m,excl,two_sided", [
    (260, 120, 12, 0, True),
    (120, 260, 12, 0, True),
    (300, 300, 16, 9, True),       # self-as-AB: two spans around the band
    (260, 120, 12, 0, False),
])
def test_ab_join_topk_from_stats_matches_reference(na, nb, m, excl,
                                                   two_sided):
    a, b = walk(na, seed=na).astype(np.float32), walk(nb, seed=nb + 1)
    if na == nb:
        b = a
    rc = rz.compute_cross_stats_host(a, b, m)
    ra, rb = rmp.ab_join_topk_from_stats(rc, excl, 64, 512, two_sided, 3)
    pa, pb = tmp.ab_join_topk_from_stats(port_cross(rc, m), excl, 64, 512,
                                         two_sided, 3)
    dense = dense_corr(a, b, m, excl)
    assert_topk(ra.corr, ra.index, pa.corr, pa.index, dense)
    if two_sided:
        assert_topk(rb.corr, rb.index, pb.corr, pb.index, dense.T)
    else:
        assert rb is None and pb is None


# -- entry points --------------------------------------------------------------


@pytest.mark.parametrize("k", [2, 4, 8])
def test_topk_self_join_matches_reference_and_oracle(k):
    """tests/test_result.py:107 in the port: n=300, m=16, exclusion 4."""
    ts, m, excl = walk(300, seed=7).astype(np.float32), 16, 4
    port = matrix_profile(ts, m, excl, k=k, device="cpu")
    ref = ref_matrix_profile(ts, m, excl, k=k)
    assert port.backend == "engine" and port.topk_p.shape == (285, k)
    assert_result_topk(ref, port, dense_corr(ts, ts, m, excl), m)


def test_topk_slot0_equals_k1_engine_profile_bitwise():
    ts, m, excl = walk(300, seed=9).astype(np.float32), 16, 4
    rk = matrix_profile(ts, m, excl, k=4, device="cpu")
    plan = tplan.plan_sweep(m, 285, exclusion=excl, backend="engine",
                            device="cpu")
    r1 = tplan.execute(plan, tz.compute_stats_host(ts, m, device="cpu"))
    torch.testing.assert_close(rk.topk_p[:, 0], r1.dist, rtol=0, atol=0)
    torch.testing.assert_close(rk.p, r1.dist, rtol=0, atol=0)


def test_topk_slot0_against_the_kernel_path_at_near_ties():
    """k = 1 runs on the kernel, k > 1 on the engine: across the two the
    contract is the near-tie rule, not bit equality."""
    ts, m = walk(400, seed=11).astype(np.float32), 16
    rk = matrix_profile(ts, m, k=3, device="cpu")
    r1 = matrix_profile(ts, m, device="cpu")
    assert (rk.backend, r1.backend) == ("engine", "kernel")
    dense = dense_corr(ts, ts, m, 4)
    ck, c1 = corr_of(rk.topk_p[:, 0], m), corr_of(r1.p, m)
    assert np.abs(ck - c1).max() < TOL
    ik, i1 = rk.topk_i[:, 0].numpy(), r1.i.numpy()
    rows = np.nonzero(ik != i1)[0]
    assert np.abs(dense[rows, ik[rows]] - dense[rows, i1[rows]]).max(
        initial=0) < TOL


def test_topk_starved_rows_self_as_ab():
    """tests/test_result.py:163: a huge exclusion leaves middle rows fewer
    than k neighbours; unfilled slots are inf / -1, and self-as-AB top-k
    equals the self-join's."""
    ts, m, excl, k = walk(120, seed=15).astype(np.float32), 16, 51, 6
    port = ab_join(ts, ts, m, exclusion=excl, return_b=True, k=k,
                   device="cpu")
    ref = ref_ab_join(ts, ts, m, exclusion=excl, return_b=True, k=k)
    dense = dense_corr(ts, ts, m, excl)
    assert_result_topk(ref, port, dense, m)
    assert_result_topk(ref, port, dense.T, m, side="b_")
    starved = ~np.isfinite(port.topk_p.numpy())
    assert starved.any()
    assert (port.topk_i.numpy()[starved] == -1).all()
    self_res = matrix_profile(ts, m, excl, k=k, device="cpu")
    np.testing.assert_allclose(corr_of(port.topk_p, m),
                               corr_of(self_res.topk_p, m), rtol=0, atol=TOL)
    np.testing.assert_array_equal(np.isfinite(port.topk_p.numpy()),
                                  np.isfinite(self_res.topk_p.numpy()))


def test_topk_ab_engine_both_sides():
    """tests/test_result.py:148 on the engine backend."""
    a, b = walk(260, seed=13), np.sin(np.arange(120) / 4.8) + 0.05 * walk(
        120, seed=14)
    m, k = 12, 3
    la, lb = 260 - m + 1, 120 - m + 1
    port_plan = tplan.plan_sweep(m, la, lb, backend="engine", k=k,
                                 harvest="both", device="cpu")
    ref_plan = rplan.plan_sweep(m, la, lb, backend="engine", k=k,
                                harvest="both")
    port = tplan.execute(port_plan, tplan.cross_stats_for(port_plan, a, b))
    ref = rplan.execute(ref_plan, rplan.cross_stats_for(ref_plan, a, b))
    dense = dense_corr(a, b, m)
    assert_topk(corr_of(ref.topk_dist, m), ref.topk_index,
                corr_of(port.topk_dist, m), port.topk_index, dense)
    assert_topk(corr_of(ref.topk_dist_b, m), ref.topk_index_b,
                corr_of(port.topk_dist_b, m), port.topk_index_b, dense.T)


def test_topk_excludes_masked_windows():
    """tests/test_missing_data.py:123."""
    t = walk(300, seed=3)
    t[60] = np.nan
    port = matrix_profile(t, 16, k=3, device="cpu")
    ref = ref_matrix_profile(t, 16, k=3)
    dense = dense_corr(t, t, 16, 4)
    assert_result_topk(ref, port, dense, 16)
    bad = np.isneginf(dense).all(axis=1)
    assert bad.any() and np.isinf(port.topk_p.numpy()[bad]).all()
    live = port.topk_i.numpy()[port.topk_i.numpy() >= 0]
    assert not bad[live].any()


def test_topk_split_lazy_equals_eager_no_recompute():
    """tests/test_lazy_result.py:70: top-k arrives materialized, the split
    finishes lazily from the retained sides without a second sweep."""
    ts = walk(360, seed=2).astype(np.float32)
    res = matrix_profile(ts, 16, 4, k=4, device="cpu")
    assert object.__getattribute__(res, "_topk_p") is not None
    assert object.__getattribute__(res, "_left_p") is None
    torch.testing.assert_close(res.topk_p[..., 0], res.p, rtol=0, atol=0)
    eager = matrix_profile(ts, 16, 4, k=4, harvest="both", device="cpu")
    for f in ("left_p", "left_i", "right_p", "right_i", "topk_i"):
        torch.testing.assert_close(getattr(res, f), getattr(eager, f),
                                   rtol=0, atol=0)
    assert object.__getattribute__(res, "_lazy").recomputes == 0
    assert res.has_topk() and res.k == 4
    torch.testing.assert_close(torch.minimum(res.left_p, res.right_p), res.p,
                               rtol=0, atol=0)


def test_kernel_entry_with_k_plans_the_engine():
    ts = walk(300, seed=5)
    res = tops.natsa_matrix_profile(ts, 16, k=2, device="cpu")
    ref = rplan.plan_sweep(16, 285, backend="kernel", k=2)
    assert (res.backend, ref.backend) == ("engine", "engine")
    plan = tplan.plan_sweep(16, 285, backend="kernel", k=2, col_tile=512,
                            device="cpu")
    assert (plan.backend, plan.col_tile) == ("engine", None)


# -- top_discords / top_motif ---------------------------------------------------


def test_top_discords_and_motif_match_reference():
    ts, m = walk(500, seed=21).astype(np.float32), 16
    ref = ref_matrix_profile(ts, m)
    p, i = np.array(ref.p), np.array(ref.i)
    p[[40, 41, 300]] = np.inf                    # masked entries are skipped
    for k, excl in ((3, 4), (5, 16)):
        got = tmp.top_discords(torch.from_numpy(p), torch.from_numpy(i), k,
                               excl)
        want = rmp.top_discords(jnp.asarray(p), jnp.asarray(i), k, excl)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    gi, gj = tmp.top_motif(torch.from_numpy(p), torch.from_numpy(i))
    ri, rj = rmp.top_motif(jnp.asarray(p), jnp.asarray(i))
    assert (int(gi), int(gj)) == (int(ri), int(rj))


# -- the planner, field by field -------------------------------------------------


_PLAN_FIELDS = ("kind", "l_a", "l_b", "window", "exclusion", "normalize",
                "swap_ab", "band", "clamp_rows", "col_tile",
                "n_bands", "it", "dt", "reseed_every", "backend", "batch")
_GEOMETRY = {"self": [(300, None)], "ab": [(3969, 385), (385, 3969),
                                          (8000, 6000)]}


def _port_refusal_is_documented(ref_plan, exc) -> bool:
    """A plan the reference makes and the port refuses must be one of the
    refusals the port documents: the band engine's options on the kernel,
    or on a k = 1 distributed plan, whose chunks run the kernel (nonnorm
    and tile plans are ported since slice 6, distributed plans since slice
    9, so the grid compares them field by field)."""
    msg = str(exc)
    if ref_plan.backend == "distributed":
        return ref_plan.harvest.k == 1 and "ROADMAP.md §C (15)" in msg
    return ref_plan.backend == "kernel" and "band engine's band" in msg


@pytest.mark.parametrize("backend", [None, "engine", "rowstream", "kernel",
                                     "distributed"])
@pytest.mark.parametrize("kind", ["self", "ab"])
def test_plan_fields_match_reference(kind, backend):
    """Over a grid of (k, batch, band, exclusion, precision, normalize) the
    port's planner resolves the reference's fields (`interpret` <->
    `device` aside; k = 1 unbatched `backend=None` z-normalized plans keep
    the port's own rule, ROADMAP §C (1)), raises ValueError where it
    raises, and refuses only what it documents as not ported."""
    import itertools

    seen = {"equal": 0, "value_error": 0, "not_ported": 0}
    grid = itertools.product(_GEOMETRY[kind], (1, 2, 4), (None, 3),
                             (256, 2), (None, 0, 3), (None, "bf16", "f64"),
                             (True, False))
    for (la, lb), k, batch, band, excl, prec, norm in grid:
        kw = dict(exclusion=excl, k=k, backend=backend, batch=batch,
                  band=band, precision=prec, normalize=norm)
        try:
            ref = rplan.plan_sweep(16, la, lb, **kw)
        except ValueError:
            with pytest.raises(ValueError):
                tplan.plan_sweep(16, la, lb, device="cpu", **kw)
            seen["value_error"] += 1
            continue
        try:
            port = tplan.plan_sweep(16, la, lb, device="cpu", **kw)
        except NotImplementedError as exc:
            assert _port_refusal_is_documented(ref, exc), (kw, exc)
            seen["not_ported"] += 1
            continue
        # ROADMAP §C (1): the kernel, or the engine for an engine-only ask
        own_rule = backend is None and k == 1 and batch is None and norm
        for f in _PLAN_FIELDS:
            if own_rule and f in ("backend", "swap_ab", "col_tile"):
                continue
            assert getattr(port, f) == getattr(ref, f), (kw, f)
        assert (port.harvest.sides, port.harvest.k) == (ref.harvest.sides,
                                                        ref.harvest.k)
        p, r = port.precision, ref.precision
        assert (p.stream, p.accum, p.seed_dot) == (r.stream, r.accum,
                                                   r.seed_dot)
        seen["equal"] += 1
    assert seen["value_error"] > 0, seen
    if (kind, backend) != ("self", "rowstream"):
        assert seen["equal"] > 0, seen


def test_compute_stats_is_exported_and_f64_close():
    """`repro_torch.core.compute_stats` is the in-graph twin that
    `repro.core.__all__` exports."""
    from repro_torch.core import compute_stats

    ts = walk(200, seed=1)
    with jax.enable_x64(True):
        ref = rz.compute_stats(jnp.asarray(ts, jnp.float64), 16)
        ref_cov0 = np.asarray(ref.cov0)
    got = compute_stats(ts, 16, device="cpu").cov0.numpy()
    np.testing.assert_allclose(got, ref_cov0, rtol=0,
                               atol=1e-12 * np.abs(ref_cov0).max())


def test_topk_f64_accumulation_matches_reference():
    ts, m = walk(320, seed=60), 16
    with jax.enable_x64(True):
        ref = ref_matrix_profile(ts, m, k=3, precision="f64")
        rp, ri = np.asarray(ref.topk_p, np.float64), np.asarray(ref.topk_i)
    port = matrix_profile(ts, m, k=3, precision="f64", device="cpu")
    assert port.backend == "engine" and port.topk_p.dtype == torch.float64
    assert_topk(corr_of(rp, m), ri, corr_of(port.topk_p, m), port.topk_i,
                dense_corr(ts, ts, m, 4), tol=1e-10)
