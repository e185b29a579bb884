"""The port's profile service (`repro_torch.serve`) on the CPU — the twins
of `tests/test_serve.py`, held to the port's own contracts and to
`repro.serve` (JAX on the CPU) on the same seeded numpy inputs.

The port's contracts are BITWISE: every (query, series) pair runs the plan
`ab_join` runs for it — at k = 1 the unbatched k = 1 AB plan (the NATSA
kernel on the card, its plain version here), at k > 1 rowstream — so the
served profile equals the port's per-pair `ab_join` loop reduced on the
host, to the bit: an elementwise min at k = 1, a stable top-k union at
k > 1; the sharded union equals the unsharded one. Against the reference (a vmapped
rowstream sweep in another accumulation order) the profiles agree within
TOL_CORR in correlation, and the winning (series, position) is equal
except at near-ties: where it differs, the f64 correlations of the two
picks are within TOL_CORR. Fault, deadline and backpressure outcomes and
`QueueStats` equal the reference's under the same schedules.
"""

import dataclasses
import re
import time

import numpy as np
import pytest
import torch

from repro.core import faults as rfaults
from repro.core.resident import ReferenceCache as RefReferenceCache
from repro.core.resident import build_side as ref_build_side
from repro.launch import serve as rlaunch
from repro.serve import ProfileService as RefService
from repro.serve import QueryRejected as RefRejected
from repro.serve import ShardedCorpus as RefCorpus
from repro_torch.core import ab_join
from repro_torch.core import faults as tfaults
from repro_torch.core.resident import ReferenceCache, build_side
from repro_torch.core.zstats import compute_cross_stats_host
from repro_torch.launch import serve as tlaunch
from repro_torch.serve import (AdmissionQueue, ProfileService, QueryRejected,
                               RoundLoop, ShardedCorpus)

WINDOW = 16
TOL_CORR = 1e-4      # the reference's own kernel standard, in correlation
NO_SLEEP = dict(sleep=lambda _t: None)


def _corpus_series(rng, n_series=5, n=220):
    return [rng.normal(size=n) for _ in range(n_series)]


def _corpus(series, device="cpu", **kw):
    return ShardedCorpus(series, WINDOW, devices=[device], **kw)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _pair_union(q, series, m=WINDOW, sids=None, device="cpu"):
    """The port's per-pair loop: `ab_join` of q against each series (in
    ascending sid), reduced on the host by an elementwise min."""
    lq = q.shape[0] - m + 1
    best_d = np.full(lq, np.inf, np.float32)
    best_s = np.full(lq, -1, np.int64)
    best_i = np.full(lq, -1, np.int64)
    for sid in (range(len(series)) if sids is None else sids):
        r = ab_join(q, series[sid], m, device=device)
        d, i = _np(r.p), _np(r.i)
        take = d < best_d
        best_d = np.where(take, d, best_d)
        best_s = np.where(take, sid, best_s)
        best_i = np.where(take, i, best_i)
    return best_d, best_s, best_i


def _topk_union(q, series, k, m=WINDOW, device="cpu"):
    """Unsharded top-k: a stable sort over every series' per-pair top-k
    candidates, series in ascending order."""
    lq = q.shape[0] - m + 1
    cand_d, cand_i, cand_s = [], [], []
    for sid, s in enumerate(series):
        r = ab_join(q, s, m, k=k, device=device)
        assert r.backend == "rowstream"
        cand_d.append(_np(r.topk_p))
        cand_i.append(_np(r.topk_i))
        cand_s.append(np.full((lq, k), sid))
    D = np.concatenate(cand_d, axis=1)
    order = np.argsort(D, axis=1, kind="stable")[:, :k]
    return tuple(np.take_along_axis(np.concatenate(c, axis=1), order, 1)
                 for c in ((D,), cand_i, cand_s))


def _assert_bitwise(a, d, s, i):
    np.testing.assert_array_equal(_np(a.result.p), d)
    np.testing.assert_array_equal(a.series, s)
    np.testing.assert_array_equal(_np(a.result.i), i)


def _unit_windows(ts, m=WINDOW):
    w = np.lib.stride_tricks.sliding_window_view(np.asarray(ts, float), m)
    w = w - w.mean(axis=1, keepdims=True)
    return w / np.linalg.norm(w, axis=1, keepdims=True)


def _corr(dist, m=WINDOW):
    return 1.0 - np.asarray(dist, np.float64) ** 2 / (2 * m)


def _assert_near_reference(q, series, got_d, got_s, got_i, want_d, want_s,
                           want_i, m=WINDOW):
    """Within TOL_CORR in correlation; picks equal but at near-ties, where
    the f64 correlations of both picks are within TOL_CORR."""
    np.testing.assert_allclose(_corr(got_d), _corr(want_d), rtol=0,
                               atol=TOL_CORR)
    uq = _unit_windows(q, m)
    us = [_unit_windows(s, m) for s in series]
    rows = np.argwhere((got_s != want_s) | (got_i != want_i))
    for at in map(tuple, rows):
        r = at[0]
        exact_got = uq[r] @ us[got_s[at]][got_i[at]]
        exact_want = uq[r] @ us[want_s[at]][want_i[at]]
        assert abs(exact_got - exact_want) < TOL_CORR, (at, exact_got,
                                                        exact_want)


def _counters(stats):
    """`QueueStats` as a dict: the two packages' classes never compare
    equal as objects."""
    return dataclasses.asdict(stats)


def _answer_fields(a):
    return (a.status, a.coverage, a.failed_shards, a.result.fraction_done)


def test_batched_service_matches_sequential_engine_bitwise():
    """The headline equality: a batch of concurrent queries answered by the
    service is BITWISE-equal (distances, winning series, positions) to
    looping the port's per-(query, series) `ab_join` and reducing on the
    host."""
    rng = np.random.default_rng(0)
    series = _corpus_series(rng)
    svc = ProfileService(_corpus(series, n_shards=2))
    queries = [rng.normal(size=150) for _ in range(4)]

    answers = svc.serve(queries)
    assert [a.status for a in answers] == ["ok"] * 4
    for q, a in zip(queries, answers):
        _assert_bitwise(a, *_pair_union(q, series))
        assert a.result.kind == "ab" and a.result.fraction_done == 1.0
        assert a.result.p.dtype == torch.float32
        assert a.result.i.dtype == torch.int32


@pytest.mark.parametrize("n_shards", [1, 2])
def test_service_matches_default_ab_join_values(n_shards):
    """Against the reference's service on the same inputs: within TOL_CORR
    in correlation, winners equal but at near-ties. A query longer than
    the corpus series is swept swapped by the port's kernel plan and by
    the reference's engine: the answers still agree."""
    rng = np.random.default_rng(1)
    series = _corpus_series(rng, n_series=3)
    queries = [rng.normal(size=140), rng.normal(size=140)]
    longq = [rng.normal(size=260)]
    for qs in (queries, longq):
        got = ProfileService(_corpus(series, n_shards=n_shards)).serve(qs)
        want = RefService(RefCorpus(series, WINDOW,
                                    n_shards=n_shards)).serve(qs)
        for q, a, b in zip(qs, got, want):
            assert _answer_fields(a) == _answer_fields(b)
            _assert_near_reference(q, series, _np(a.result.p), a.series,
                                   _np(a.result.i), np.asarray(b.result.p),
                                   np.asarray(b.series),
                                   np.asarray(b.result.i))


def test_sharded_topk_union_equals_unsharded():
    """k > 1: the per-shard union must equal the top-k over ALL series'
    candidate sets at once — shard boundaries cannot change the answer —
    bit for bit; and the reference's within TOL_CORR slot by slot."""
    rng = np.random.default_rng(2)
    series = _corpus_series(rng, n_series=6)
    k = 3
    q = rng.normal(size=130)
    d_ref, i_ref, s_ref = _topk_union(q, series, k)

    for n_shards in (1, 2, 3):
        [a] = ProfileService(_corpus(series, n_shards=n_shards)).serve(
            [q], k=k)
        np.testing.assert_array_equal(_np(a.result.topk_p), d_ref)
        np.testing.assert_array_equal(_np(a.result.topk_i), i_ref)
        np.testing.assert_array_equal(a.series, s_ref)
        np.testing.assert_array_equal(_np(a.result.p), d_ref[:, 0])
    [b] = RefService(RefCorpus(series, WINDOW, n_shards=2)).serve([q], k=k)
    _assert_near_reference(q, series, d_ref, s_ref, i_ref,
                           np.asarray(b.result.topk_p), np.asarray(b.series),
                           np.asarray(b.result.topk_i))


def test_mixed_geometry_batches_split_and_all_answer():
    """Queries of different lengths can't share a batch — the batcher
    buckets them, and every query still gets a full answer."""
    rng = np.random.default_rng(3)
    series = _corpus_series(rng, n_series=3)
    svc = ProfileService(_corpus(series))
    queries = [rng.normal(size=n) for n in (100, 150, 100, 150, 100)]
    answers = svc.serve(queries)
    assert svc.stats.batches >= 2            # at least one per geometry
    for q, a in zip(queries, answers):
        _assert_bitwise(a, *_pair_union(q, series))


def test_shard_failure_degrades_answer_with_partial_coverage():
    """A crashed shard drops ITS series from the union; the answer is still
    a valid ProfileResult over the survivors, tagged with the coverage it
    got and the failed shard id — as the reference tags it."""
    rng = np.random.default_rng(4)
    series = _corpus_series(rng, n_series=4)
    corpus = _corpus(series, n_shards=2)
    # shard 0 crashes on the first group dispatch (tick 0)
    svc = ProfileService(corpus,
                         injector=tfaults.FaultInjector(
                             worker_crashes={0: (0,)}),
                         policy=tfaults.FaultPolicy(**NO_SLEEP))
    q = rng.normal(size=150)
    [a] = svc.serve([q])

    assert a.status == "degraded" and a.failed_shards == (0,)
    survivors = [sid for sid in range(len(series))
                 if corpus.shard_of(sid) != 0]
    assert a.coverage == pytest.approx(len(survivors) / len(series))
    assert a.result.fraction_done == a.coverage
    _assert_bitwise(a, *_pair_union(q, series, sids=survivors))
    assert all(corpus.shard_of(int(sid)) == 1 for sid in a.series)
    assert svc.stats.degraded == 1

    ref = RefService(RefCorpus(series, WINDOW, n_shards=2),
                     injector=rfaults.FaultInjector(worker_crashes={0: (0,)}),
                     policy=rfaults.FaultPolicy(**NO_SLEEP))
    [b] = ref.serve([q])
    assert _answer_fields(a) == _answer_fields(b)
    assert _counters(svc.stats) == _counters(ref.stats)


def test_transient_failures_retry_then_succeed_or_degrade():
    """Transient round failures within the FaultPolicy retry budget are
    invisible; beyond it the shard degrades the batch — the reference's
    outcomes and backoff delays."""
    rng = np.random.default_rng(5)
    series = _corpus_series(rng, n_series=2)
    q1, q2 = rng.normal(size=120), rng.normal(size=120)
    corpus = _corpus(series, n_shards=2)
    ref_corpus = RefCorpus(series, WINDOW, n_shards=2)

    for fails, q, status, coverage in ((2, q1, "ok", 1.0),
                                       (5, q2, "degraded", 0.5)):
        slept = {"port": [], "ref": []}
        svc = ProfileService(
            corpus, injector=tfaults.FaultInjector(round_failures={0: fails}),
            policy=tfaults.FaultPolicy(max_retries=3,
                                       sleep=slept["port"].append))
        ref = RefService(
            ref_corpus,
            injector=rfaults.FaultInjector(round_failures={0: fails}),
            policy=rfaults.FaultPolicy(max_retries=3,
                                       sleep=slept["ref"].append))
        [a], [b] = svc.serve([q]), ref.serve([q])
        assert a.status == status and a.coverage == coverage
        assert _answer_fields(a) == _answer_fields(b)
        assert slept["port"] == slept["ref"] and slept["port"]
        if status == "ok":
            _assert_bitwise(a, *_pair_union(q, series))
        else:
            assert a.failed_shards == (0,)


def test_all_shards_failed_still_answers_with_zero_coverage():
    rng = np.random.default_rng(6)
    series = _corpus_series(rng, n_series=2)
    q = rng.normal(size=100)
    crashes = {0: (0,), 1: (1,)}
    svc = ProfileService(_corpus(series, n_shards=2),
                         injector=tfaults.FaultInjector(worker_crashes=crashes),
                         policy=tfaults.FaultPolicy(**NO_SLEEP))
    [a] = svc.serve([q])
    assert a.status == "degraded" and a.coverage == 0.0
    assert a.failed_shards == (0, 1)
    assert torch.isinf(a.result.p).all()
    assert bool((a.result.i == -1).all()) and (a.series == -1).all()

    ref = RefService(RefCorpus(series, WINDOW, n_shards=2),
                     injector=rfaults.FaultInjector(worker_crashes=crashes),
                     policy=rfaults.FaultPolicy(**NO_SLEEP))
    [b] = ref.serve([q])
    assert _answer_fields(a) == _answer_fields(b)
    assert _counters(svc.stats) == _counters(ref.stats)


def test_deadline_expired_query_answers_degraded_not_lost():
    """A query whose deadline lapses in the queue is answered immediately:
    a VALID coverage-0 ProfileResult tagged expired, never silently
    dropped, and it frees its queue slot — the reference's counters."""
    rng = np.random.default_rng(7)
    series = _corpus_series(rng, n_series=2)
    q_dead, q_live = rng.normal(size=100), rng.normal(size=100)
    stats = []
    for svc in (ProfileService(_corpus(series)),
                RefService(RefCorpus(series, WINDOW))):
        qid = svc.submit(q_dead, deadline=0.0)
        live = svc.submit(q_live)
        time.sleep(0.005)
        by_qid = {a.qid: a for a in svc.step() + svc.drain()}
        a = by_qid[qid]
        assert a.status == "expired" and a.coverage == 0.0
        assert a.result.fraction_done == 0.0
        assert np.all(np.isinf(_np(a.result.p)))
        assert by_qid[live].status == "ok"
        assert svc.stats.expired == 1 and svc.stats.pending == 0
        stats.append(_counters(svc.stats))
    assert stats[0] == stats[1]


def test_backpressure_rejects_instead_of_growing():
    rng = np.random.default_rng(8)
    series = _corpus_series(rng, n_series=2)
    qs = [rng.normal(size=100) for _ in range(5)]
    stats = []
    for svc in (ProfileService(_corpus(series), max_pending=3),
                RefService(RefCorpus(series, WINDOW), max_pending=3)):
        for q in qs[:3]:
            svc.submit(q)
        with pytest.raises(QueryRejected if isinstance(svc, ProfileService)
                           else RefRejected, match="queue full"):
            svc.submit(qs[3])
        assert svc.stats.rejected == 1 and svc.stats.pending == 3
        while len(svc.queue):
            svc.step()
        assert len(svc.drain()) == 3
        svc.submit(qs[4])                    # slot freed after completion
        stats.append(_counters(svc.stats))
    assert stats[0] == stats[1]


def test_admission_queue_buckets_by_geometry_oldest_first():
    from repro.serve import AdmissionQueue as RefQueue

    for cls in (AdmissionQueue, RefQueue):
        q = cls(WINDOW, max_pending=8, max_batch=8)
        a = q.submit(np.zeros(100))
        b = q.submit(np.zeros(150))
        c = q.submit(np.zeros(100))
        d = q.submit(np.zeros(100), k=3)     # same l_q, different k
        batch = q.take_batch()
        assert [p.qid for p in batch] == [a.qid, c.qid]
        assert [p.qid for p in q.take_batch()] == [b.qid]
        assert [p.qid for p in q.take_batch()] == [d.qid]
        with pytest.raises(ValueError):
            q.submit(np.zeros(4))            # shorter than the window
        assert q.stats.batches == 3 and q.stats.accepted == 4


def test_corpus_reload_bumps_generation_and_serves_fresh_stats():
    """The shared ReferenceCache generation contract holds through the
    corpus — a same-length reload must change answers."""
    rng = np.random.default_rng(9)
    series = [rng.normal(size=160), rng.normal(size=160)]
    corpus = _corpus(series)
    svc = ProfileService(corpus)
    q = rng.normal(size=100)
    [before] = svc.serve([q])

    fresh = rng.normal(size=160)
    corpus.reload(1, fresh)
    [after] = svc.serve([q])
    _assert_bitwise(after, *_pair_union(q, [series[0], fresh]))
    assert not np.array_equal(_np(before.result.p), _np(after.result.p))


def test_corpus_rejects_nonnorm_and_bad_series():
    rng = np.random.default_rng(10)
    for cls, kw in ((ShardedCorpus, {"devices": ["cpu"]}), (RefCorpus, {})):
        with pytest.raises(ValueError, match="z-normalized"):
            cls([rng.normal(size=100)], WINDOW, normalize=False, **kw)
        with pytest.raises(ValueError, match="at least one"):
            cls([], WINDOW, **kw)
        with pytest.raises(ValueError, match="1-D"):
            cls([np.zeros((4, 4))], WINDOW, **kw)
        with pytest.raises(ValueError, match="n_shards"):
            cls([rng.normal(size=100)], WINDOW, n_shards=0, **kw)


def test_round_loop_bounds_inflight_and_preserves_order():
    delivered = []
    loop = RoundLoop(depth=2, deliver=lambda m, _p: delivered.append(m))
    for n in range(5):
        loop.dispatch({"d": torch.zeros(4) + n}, meta=n)
        assert len(loop) <= 2
    loop.drain()
    assert delivered == [0, 1, 2, 3, 4]
    assert loop.dispatched == loop.delivered == 5
    with pytest.raises(RuntimeError):
        loop.deliver_next()
    with pytest.raises(ValueError):
        RoundLoop(depth=0)


# -- beyond the reference's tests: plans, streams, faults, the CLI ------------


@pytest.mark.parametrize("l_q,k,batch", [
    (85, 1, None), (85, 3, None), (85, 1, 6), (85, 3, 6), (300, 3, 6),
    (205, 4, 4), (206, 1, 8), (5000, 2, 4)])
def test_batched_plan_matches_reference(l_q, k, batch):
    """The plan each pair of a served batch runs: `ReferenceCache.plan_for(
    side, l_q, k=)` is field by field the reference's unbatched plan at
    k > 1, and the kernel at k = 1 (§C (1)). Against the reference's
    batched plan of the same batch (one vmapped sweep of `batch` lanes,
    §C (14)) it sweeps the same geometry, and where the reference's lanes
    run rowstream the port's pairs do too, in the same orientation."""
    ts = np.random.default_rng(11).normal(size=220)
    m = WINDOW
    got = ReferenceCache(m, device="cpu").plan_for(
        build_side(ts, m, device="cpu"), l_q, k=k)
    cache = RefReferenceCache(m)
    want = cache.plan_for(ref_build_side(ts, m), l_q, k=k)
    geometry = ("kind", "l_a", "l_b", "window", "exclusion", "normalize")
    if k == 1:
        assert got.backend == "kernel"
    else:
        assert (dataclasses.asdict(got.harvest)
                == dataclasses.asdict(want.harvest))
        for field in geometry + ("swap_ab", "band", "clamp_rows", "col_tile",
                                 "backend", "batch"):
            assert getattr(got, field) == getattr(want, field), field
    if batch is None:
        return
    lanes = cache.plan_for(ref_build_side(ts, m), l_q, k=k, batch=batch)
    assert lanes.batch == batch and got.batch is None
    for field in geometry:
        assert getattr(got, field) == getattr(lanes, field), field
    if k > 1 and lanes.backend == "rowstream":
        assert got.backend == "rowstream"
        assert got.swap_ab == lanes.swap_ab


def test_pair_streams_bitwise_compute_cross_stats_and_reference():
    """Every pair payload of a group is bitwise a fresh
    `compute_cross_stats_host` of the same two series, in the plan's swept
    orientation (a query longer than the series is swept swapped), and
    bitwise the reference's stacked lane of the same pair (its pad lanes
    aside)."""
    rng = np.random.default_rng(12)
    series = _corpus_series(rng, n_series=3, n=150)
    queries = [rng.normal(size=100), rng.normal(size=100)]
    corpus = _corpus(series, n_shards=1)
    ref_corpus = RefCorpus(series, WINDOW)
    [group], [ref_group] = corpus.groups(), ref_corpus.groups()
    from repro.core.zstats import compute_stats_host as ref_stats
    from repro_torch.core.zstats import compute_stats_host

    def parts_of(qs):
        return [compute_stats_host(q, WINDOW, min_subsequences=1,
                                   return_centered_windows=True, device="cpu")
                for q in qs]

    def assert_fresh(pair, a, b):
        fresh = compute_cross_stats_host(a, b, WINDOW, device="cpu")
        assert torch.equal(pair.cov0s, fresh.cov0s)
        for side in ("a", "b"):
            for f in ("ts", "mu", "invn", "df", "dg", "cov0"):
                assert torch.equal(getattr(getattr(pair, side), f),
                                   getattr(getattr(fresh, side), f))

    parts = parts_of(queries)
    lq = 100 - WINDOW + 1
    kplan = corpus.plan_for(group, lq)
    assert kplan.backend == "kernel" and not kplan.swap_ab
    pairs = list(corpus.assemble_pairs(group, parts, kplan))
    assert len(pairs) == len(queries) * len(group.sids)
    for n, pair in enumerate(pairs):
        assert_fresh(pair, queries[n // 3], series[group.sids[n % 3]])

    plan = corpus.plan_for(group, lq, k=3)
    assert plan.backend == "rowstream" and not plan.swap_ab
    pairs = list(corpus.assemble_pairs(group, parts, plan))
    ref_parts = [ref_stats(q, WINDOW, min_subsequences=1,
                           return_centered_windows=True) for q in queries]
    ref_plan = ref_corpus.plan_for(ref_group, lq, k=3, batch=8)
    ref_stack = ref_corpus.assemble_batch(ref_group, ref_parts, ref_plan)
    for n, pair in enumerate(pairs):
        np.testing.assert_array_equal(pair.cov0s.numpy(),
                                      np.asarray(ref_stack.cov0s)[n])
        for side in ("a", "b"):
            for f in ("mu", "invn", "df", "dg", "cov0"):
                np.testing.assert_array_equal(
                    getattr(getattr(pair, side), f).numpy(),
                    np.asarray(getattr(getattr(ref_stack, side), f))[n])

    longq = [rng.normal(size=200)]
    for k in (1, 3):
        plan = corpus.plan_for(group, 200 - WINDOW + 1, k=k)
        assert plan.swap_ab
        for n, pair in enumerate(corpus.assemble_pairs(group,
                                                       parts_of(longq), plan)):
            assert_fresh(pair, series[group.sids[n]], longq[0])


def test_shards_over_several_devices_keep_the_answers():
    """`devices` places shards round-robin; answers do not depend on it."""
    rng = np.random.default_rng(13)
    series = _corpus_series(rng, n_series=4, n=150)
    q = rng.normal(size=90)
    one = ShardedCorpus(series, WINDOW, devices=["cpu"], n_shards=2)
    two = ShardedCorpus(series, WINDOW, devices=["cpu", "cpu"])
    assert two.n_shards == 2 and [g.shard for g in two.groups()] == [0, 1]
    [a], [b] = (ProfileService(c).serve([q]) for c in (one, two))
    _assert_bitwise(b, _np(a.result.p), a.series, _np(a.result.i))


@pytest.mark.parametrize("seed", [0, 3, 7, 123])
def test_fault_policy_and_round_hooks_match_reference(seed):
    """`FaultPolicy`'s fields, defaults and backoff, `RoundFailure`, and the
    round hooks of a seeded schedule equal the reference's. The service
    reads the retry knobs; the other four are the supervised scheduler's."""
    def fields(cls):
        return {f.name: f.default for f in dataclasses.fields(cls)
                if f.name != "sleep"}

    got_fields, want_fields = (fields(tfaults.FaultPolicy),
                               fields(rfaults.FaultPolicy))
    assert {n: got_fields[n] for n in ("max_retries", "backoff_base",
                                       "backoff_max")} == {
        "max_retries": 3, "backoff_base": 0.05, "backoff_max": 2.0}
    assert got_fields == want_fields
    base = 0.01 * (1 + seed % 5)
    for kw in ({}, {"backoff_base": base, "backoff_max": 8 * base}):
        got, want = tfaults.FaultPolicy(**kw), rfaults.FaultPolicy(**kw)
        assert [got.backoff(a) for a in range(8)] == [
            want.backoff(a) for a in range(8)]
    assert issubclass(tfaults.RoundFailure, RuntimeError)
    kw = dict(n_rounds=30, n_workers=4, p_worker_crash=0.2,
              p_round_failure=0.4, max_round_failures=3)
    got = tfaults.FaultInjector.seeded(seed, **kw)
    want = rfaults.FaultInjector.seeded(seed, **kw)
    for tick in range(32):
        assert got.crashed_workers(tick) == want.crashed_workers(tick)
        for attempt in range(4):
            assert (got.round_should_fail(tick, attempt)
                    == want.round_should_fail(tick, attempt))


def test_seeded_injector_service_outcomes_match_reference():
    """A seeded schedule over several batches: every answer's status,
    coverage and failed shards, the retries' sleeps and the counters equal
    the reference's; every non-degraded answer is the per-pair union."""
    rng = np.random.default_rng(14)
    series = _corpus_series(rng, n_series=4, n=150)
    queries = [rng.normal(size=n) for n in (90, 90, 70, 90, 70)]
    kw = dict(n_rounds=16, n_workers=2, p_worker_crash=0.3,
              p_round_failure=0.4, max_round_failures=4)
    runs = []
    for svc_cls, corpus, faults in (
            (ProfileService, _corpus(series, n_shards=2), tfaults),
            (RefService, RefCorpus(series, WINDOW, n_shards=2), rfaults)):
        sleeps = []
        svc = svc_cls(corpus, max_batch=2,
                      injector=faults.FaultInjector.seeded(5, **kw),
                      policy=faults.FaultPolicy(max_retries=2,
                                                sleep=sleeps.append))
        runs.append((svc.serve(queries), sleeps, svc.stats))
    (answers, sleeps, stats), (ref_answers, ref_sleeps, ref_stats) = runs
    outcomes = [_answer_fields(a) for a in answers]
    assert outcomes == [_answer_fields(b) for b in ref_answers]
    assert sleeps == ref_sleeps
    assert _counters(stats) == _counters(ref_stats)
    assert {"ok", "degraded"} <= {o[0] for o in outcomes}
    for q, a in zip(queries, answers):
        if a.status == "ok":
            _assert_bitwise(a, *_pair_union(q, series))


def _masked(line: str) -> str:
    """A report line with its host times and rates masked."""
    line = re.sub(r"in \d+\.\d+s", "in <t>s", line)
    line = re.sub(r"-> \d+\.\d+ queries/s", "-> <r> queries/s", line)
    return re.sub(r"best d=\d+\.\d+", "best d=<d>", line)


def test_run_service_report_and_lines_match_reference(capsys):
    argv = ["--series", "3", "--n", "200", "--window", "16", "--queries",
            "3", "--query-n", "90"]
    got = tlaunch.main(argv + ["--device", "cpu"])
    got_lines = capsys.readouterr().out.splitlines()
    want = rlaunch.main(argv)
    want_lines = capsys.readouterr().out.splitlines()
    assert set(got) == set(want)
    assert len(got_lines) == len(want_lines) == 4
    assert [_masked(x) for x in got_lines] == [_masked(x) for x in want_lines]
    best = [float(re.search(r"best d=(\d+\.\d+)", x[2]).group(1))
            for x in (got_lines, want_lines)]
    assert abs(best[0] - best[1]) <= 1e-3
    assert (got["mesh_devices"], got["shards"]) == (1, 1)
    assert _counters(got["stats"]) == _counters(want["stats"])
    assert len(got["answers"]) == 3 and all(a.ok for a in got["answers"])


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 4])
def test_service_equals_per_pair_ab_join_on_card(k):
    """On the card: k = 1 through one NATSA launch per pair, bit for bit
    the per-pair `ab_join` loop; k = 4 (rowstream) bit for bit the
    per-pair top-k union; one event wait per delivered group."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (and nvcc) to run the NATSA kernel")
    from repro_torch.kernels import natsa_mp

    rng = np.random.default_rng(15)
    series = [np.cumsum(rng.normal(size=2048)) for _ in range(5)]
    queries = [np.cumsum(rng.normal(size=512)) for _ in range(3)]
    svc = ProfileService(ShardedCorpus(series, 64, n_shards=2))
    before = natsa_mp.LAUNCHES
    answers = svc.serve(queries, k=k)
    launches = natsa_mp.LAUNCHES - before
    assert launches == (len(queries) * len(series) if k == 1 else 0)
    for q, a in zip(queries, answers):
        assert a.status == "ok"
        if k == 1:
            _assert_bitwise(a, *_pair_union(q, series, m=64, device="cuda"))
        else:
            d, i, s = _topk_union(q, series, k, m=64, device="cuda")
            np.testing.assert_array_equal(_np(a.result.topk_p), d)
            np.testing.assert_array_equal(_np(a.result.topk_i), i)
            np.testing.assert_array_equal(a.series, s)
    loop = RoundLoop(depth=1)
    loop.dispatch({"d": torch.ones(4, device="cuda")})
    assert loop._inflight[0][2] is not None
    loop.drain()
