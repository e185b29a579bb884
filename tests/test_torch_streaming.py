"""The port's `StreamingProfile` and resident corpus cache
(`repro_torch.core.streaming`, `core.resident`, `plan.resident_stats`)
against the reference and the f64 oracle, on the CPU — the twins of
`tests/test_flash_and_streaming.py:76-303`.

The reference's block appends run under `repro.core.zstats.x64_scope`,
which needs `jax.experimental.enable_x64` (missing from jax 0.9.0); the
`ref_x64` fixture swaps it for `jax.enable_x64(True)` for these tests only.
Tolerances: both packages append in f64, so snapshots agree within 1e-9
(with equal indices on these series); a snapshot against the batch profile and
a query against `ab_join` keep the reference's 3e-3 (the batch sweeps are
f32); against the f64 oracle, 1e-9.
"""

import jax
import numpy as np
import pytest
import torch

from repro.core import zstats as rz
from repro.core.streaming import StreamingProfile as RefStreamingProfile
from repro_torch.core import ab_join, analytics, matrix_profile, ref
from repro_torch.core import plan as tplan
from repro_torch.core.resident import ReferenceCache, build_side
from repro_torch.core.streaming import StreamingProfile

F64_TOL = 1e-9


@pytest.fixture
def ref_x64(monkeypatch):
    monkeypatch.setattr(rz, "x64_scope", lambda: jax.enable_x64(True))


def _sp(m, excl=None, normalize=True):
    return StreamingProfile(m, excl, normalize=normalize, device="cpu")


def _d(sp):
    return sp.snapshot().p.numpy()


def _oracle(ts, m, excl, normalize):
    rows = np.arange(len(ts) - m + 1)
    d, _ = ref.profile_rows(ts, ts, m, rows, exclusion=excl,
                            normalize=normalize)
    return d.numpy()


@pytest.mark.parametrize("normalize", [True, False])
def test_streaming_matches_batch_and_oracle(normalize):
    """:76 — mixed batch sizes; the batch profile at 3e-3, the f64 oracle
    at 1e-9."""
    ts = np.cumsum(np.random.default_rng(2).normal(size=260))
    m, excl = 16, 4
    sp = _sp(m, excl, normalize)
    sp.append(ts[:100])
    sp.append(ts[100:])
    batch = matrix_profile(ts, m, excl, normalize=normalize, device="cpu")
    np.testing.assert_allclose(_d(sp), batch.p.numpy(), rtol=3e-3,
                               atol=3e-3)
    np.testing.assert_allclose(_d(sp), _oracle(ts, m, excl, normalize),
                               rtol=0, atol=F64_TOL)


@pytest.mark.parametrize("normalize", [True, False])
def test_streaming_matches_reference(ref_x64, normalize):
    ts = np.cumsum(np.random.default_rng(3).normal(size=300))
    ts[150] = np.nan                       # a missing sample
    m, excl = 12, 3
    rsp, sp = RefStreamingProfile(m, excl, normalize=normalize), _sp(
        m, excl, normalize)
    for lo, hi in ((0, 40), (40, 41), (41, 200), (200, 300)):
        rsp.append(ts[lo:hi])
        sp.append(ts[lo:hi])
    r, p = rsp.snapshot(), sp.snapshot()
    for fp, fi in (("p", "i"), ("left_p", "left_i"), ("right_p", "right_i")):
        rp, pp = np.asarray(getattr(r, fp)), getattr(p, fp).numpy()
        np.testing.assert_array_equal(np.isfinite(pp), np.isfinite(rp))
        fin = np.isfinite(rp)
        np.testing.assert_allclose(pp[fin], rp[fin], rtol=0, atol=F64_TOL)
        # f64 on both sides: no pick differs on this series
        np.testing.assert_array_equal(getattr(p, fi).numpy(),
                                      np.asarray(getattr(r, fi)))
    masked = np.arange(150 - m + 1, 151)
    assert np.isinf(p.p.numpy()[masked]).all()
    assert not np.isin(p.i.numpy(), masked).any()


def test_streaming_monotone_and_incremental():
    """:90."""
    rng = np.random.default_rng(5)
    sp = _sp(8, 2, normalize=False)
    sp.append(rng.normal(size=60))
    d1 = _d(sp).copy()
    sp.append(rng.normal(size=20))
    d2 = _d(sp)
    assert (d2[: d1.size] <= d1 + 1e-12).all(), "appends may only improve"
    assert d2.size > d1.size


def test_streaming_discord_detection():
    """:103 through the port's analytics."""
    rng = np.random.default_rng(1)
    base = 2.0 + 0.02 * rng.normal(size=300)
    base[200:216] += np.linspace(0, 1.0, 16)
    sp = _sp(16, 4, normalize=False)
    sp.append(base)
    top = analytics.top_discord(sp.snapshot(), exclusion=1)
    assert top is not None
    assert 185 <= top.position <= 216, (top.position, top.score)


@pytest.mark.parametrize("normalize", [True, False])
def test_streaming_query_matches_ab_oracle_and_reference(ref_x64, normalize):
    """:117 — the query is an AB join against the corpus: the oracle and
    the reference's query at 2e-3, `ab_join` bit for bit."""
    rng = np.random.default_rng(8)
    corpus = np.cumsum(rng.normal(size=240))
    q = np.cumsum(rng.normal(size=70))
    m = 12
    sp = _sp(m, 3, normalize)
    sp.append(corpus)
    got = sp.query(q)
    assert got.kind == "ab" and got.p.dtype == torch.float64
    d, idx = ref.ab_join_bruteforce(np.float32(q), np.float32(corpus), m,
                                    normalize=normalize)
    np.testing.assert_allclose(got.p.numpy(), d.numpy(), rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_array_equal(got.i.numpy(), idx.numpy())
    rsp = RefStreamingProfile(m, 3, normalize=normalize)
    rsp.append(corpus)
    np.testing.assert_allclose(got.p.numpy(), rsp.query(q).p, rtol=2e-3,
                               atol=2e-3)
    direct = ab_join(q, corpus, m, normalize=normalize, device="cpu")
    assert got.backend == direct.backend
    torch.testing.assert_close(got.p, direct.p.double(), rtol=0, atol=0)
    torch.testing.assert_close(got.i, direct.i.long(), rtol=0, atol=0)


def test_streaming_query_does_not_mutate_state():
    rng = np.random.default_rng(4)
    sp = _sp(8, 2)
    sp.append(rng.normal(size=80))
    before_d, before_n = _d(sp).copy(), sp.n_subsequences
    sp.query(rng.normal(size=30))
    assert sp.n_subsequences == before_n
    np.testing.assert_array_equal(_d(sp), before_d)


def test_streaming_query_validation():
    sp = _sp(16, 4)
    with pytest.raises(ValueError):
        sp.query(np.zeros(20))          # corpus has no complete window yet
    sp.append(np.random.default_rng(0).normal(size=40))
    with pytest.raises(ValueError):
        sp.query(np.zeros(10))          # query shorter than one window
    with pytest.raises(ValueError):
        sp.append(np.zeros((2, 2)))
    capped = StreamingProfile(8, max_points=20, device="cpu")
    capped.append(np.zeros(15))
    with pytest.raises(ValueError, match="max_points"):
        capped.append(np.zeros(6))


def test_streaming_query_improves_as_corpus_grows():
    rng = np.random.default_rng(6)
    sp = _sp(10, 2)
    sp.append(rng.normal(size=60))
    q = rng.normal(size=40)
    d1 = sp.query(q).p
    sp.append(rng.normal(size=60))
    d2 = sp.query(q).p
    # f32 sweeps re-center the grown corpus: prefix distances wobble at f32
    assert bool((d2 <= d1 + 2e-3).all())


@pytest.mark.parametrize("seed", [0, 17, 421, 999])
def test_streaming_valid_pairs(seed):
    """:172 over fixed seeds: each pick honours the exclusion and realizes
    its distance."""
    ts = np.random.default_rng(seed).normal(size=120)
    sp = _sp(8, 2, normalize=False)
    sp.append(ts)
    d, idx = _d(sp), sp.snapshot().i.numpy()
    for i in np.nonzero(np.isfinite(d))[0]:
        j = int(idx[i])
        assert abs(i - j) >= 2
        assert abs(np.linalg.norm(ts[i:i + 8] - ts[j:j + 8]) - d[i]) < 1e-9


@pytest.mark.parametrize("normalize", [True, False])
def test_streaming_snapshot_profile_result(normalize):
    """:194 — merged, split and metadata off the incremental state; left
    entries are final; an earlier snapshot stays frozen."""
    rng = np.random.default_rng(9)
    sp = _sp(8, 2, normalize)
    sp.append(rng.normal(size=90))
    res = sp.snapshot()
    assert res.kind == "self" and res.backend == "streaming"
    assert (res.window, res.exclusion, res.normalize) == (8, 2, normalize)
    torch.testing.assert_close(torch.minimum(res.left_p, res.right_p),
                               res.p, rtol=0, atol=0)
    p0 = res.p.clone()
    sp.append(rng.normal(size=40))
    res2 = sp.result
    n = res.left_p.numel()
    torch.testing.assert_close(res2.left_p[:n], res.left_p, rtol=0, atol=0)
    torch.testing.assert_close(res2.left_i[:n], res.left_i, rtol=0, atol=0)
    torch.testing.assert_close(res.p, p0, rtol=0, atol=0)
    assert res.p.numel() < res2.p.numel()


def test_streaming_has_no_raw_accessors():
    """:221 — snapshot()/analytics is the only surface."""
    sp = _sp(4, 1)
    sp.append(np.sin(np.arange(20.0)))
    for name in ("distances", "indices", "top_discord"):
        assert not hasattr(sp, name), name


def test_streaming_top_discord_via_analytics():
    rng = np.random.default_rng(12)
    sp = _sp(8, 2, normalize=False)
    sp.append(rng.normal(size=100))
    top = analytics.top_discord(sp.snapshot(), exclusion=1)
    d = _d(sp)
    assert top is not None and np.isfinite(top.score)
    assert top.score == np.max(np.where(np.isfinite(d), d, -np.inf))


@pytest.mark.parametrize("normalize", [True, False])
def test_streaming_point_by_point_and_chunks_are_bitwise(normalize):
    """The block kernels' fixed-order sums: appending one point at a time,
    and evaluating a block in small row chunks, give the bulk append's
    bits."""
    ts = np.cumsum(np.random.default_rng(10).normal(size=150))
    bulk = _sp(10, 3, normalize)
    bulk.append(ts)
    single = _sp(10, 3, normalize)
    single.append(ts[:100])
    for v in ts[100:]:
        single.append(v)
    chunked = _sp(10, 3, normalize)
    chunked.BLOCK_ELEMENTS = 10 * 141 * 3       # three rows per chunk
    chunked.append(ts)
    a = bulk.snapshot()
    for other in (single.snapshot(), chunked.snapshot()):
        for f in ("p", "i", "left_p", "left_i", "right_p", "right_i"):
            torch.testing.assert_close(getattr(other, f), getattr(a, f),
                                       rtol=0, atol=0)


def test_streaming_ref_cache_keyed_by_generation():
    """:235 — the corpus side is keyed by the append generation, not the
    length: a same-length content change never serves stale streams."""
    rng = np.random.default_rng(3)
    m = 8
    a, b, q = rng.normal(size=60), rng.normal(size=60), rng.normal(size=30)
    sp = _sp(m, 2)
    sp.append(a)
    d_a = sp.query(q).p.clone()
    assert len(sp._refs._sides) == 1
    sp._ts = torch.as_tensor(b, dtype=torch.float64)
    sp._gen += 1
    d_b = sp.query(q).p
    fresh = _sp(m, 2)
    fresh.append(b)
    torch.testing.assert_close(d_b, fresh.query(q).p, rtol=0, atol=0)
    assert not torch.equal(d_a, d_b), "stale cached streams served"
    side = sp._ref_side()
    assert sp._ref_side() is side
    # a mode flip builds the other mode's side, keyed apart
    sp.normalize = False
    assert sp._ref_side() is not side and not sp._ref_side().normalize


def test_reference_cache_staleness_and_lru_bounds():
    """:266 — same generation hits, a bumped one rebuilds; plans are keyed
    by geometry; both LRUs stay within their bounds."""
    rng = np.random.default_rng(7)
    m = 8
    a, b = rng.normal(size=60), rng.normal(size=60)
    cache = ReferenceCache(m, side_max=2, plan_max=2, device="cpu")
    built = []

    def builder(ts):
        def build():
            built.append(1)
            return build_side(ts, m, device="cpu")
        return build

    s0 = cache.side((0, True), builder(a))
    assert cache.side((0, True), builder(a)) is s0 and len(built) == 1
    s1 = cache.side((1, True), builder(b))
    assert s1 is not s0 and len(built) == 2
    assert not torch.equal(s0.stats.mu, s1.stats.mu)
    p = cache.plan_for(s1, 23)
    assert cache.plan_for(s1, 23) is p and cache.plan_for(s0, 23) is p
    assert cache.plan_for(s1, 17) is not p
    cache.plan_for(s1, 11)
    assert len(cache._plans) == 2
    cache.side((2, True), builder(a))
    assert len(cache._sides) == 2 and (0, True) not in cache._sides
    with pytest.raises(ValueError, match="window"):
        cache.side((3, True), lambda: build_side(a, m + 1, device="cpu"))


@pytest.mark.parametrize("nq", [40, 200])
def test_resident_stats_bitwise_fresh(nq):
    """A resident payload equals building both sides fresh, bit for bit,
    in either orientation (a query longer than the corpus swaps onto the
    kernel's rows)."""
    rng = np.random.default_rng(nq)
    corpus, q = np.cumsum(rng.normal(size=120)), np.cumsum(
        rng.normal(size=nq))
    m = 10
    side = build_side(corpus, m, device="cpu")
    plan = ReferenceCache(m, device="cpu").plan_for(side, nq - m + 1)
    assert plan.swap_ab == (nq > 120)
    got = tplan.resident_stats(plan, q, side)
    want = tplan.cross_stats_for(plan, q, corpus)
    for part in ("a", "b"):
        for f in ("ts", "mu", "invn", "df", "dg", "cov0"):
            assert torch.equal(getattr(getattr(got, part), f),
                               getattr(getattr(want, part), f)), (part, f)
    assert torch.equal(got.cov0s, want.cov0s)


def test_resident_stats_refusals():
    m = 8
    side = build_side(np.random.default_rng(0).normal(size=50), m,
                      device="cpu")
    q = np.zeros(20)
    with pytest.raises(ValueError, match="AB plans"):
        tplan.resident_stats(tplan.plan_sweep(m, 43, device="cpu"), q, side)
    with pytest.raises(ValueError, match="default-precision"):
        tplan.resident_stats(tplan.plan_sweep(m, 13, 43, precision="bf16",
                                              device="cpu"), q, side)
    with pytest.raises(ValueError, match="normalize"):
        tplan.resident_stats(tplan.plan_sweep(m, 13, 43, normalize=False,
                                              device="cpu"), q, side)
    with pytest.raises(ValueError, match="1-D"):
        build_side(np.zeros(5), m, device="cpu")
