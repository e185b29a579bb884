"""The twin of `tests/test_distributed_mp.py` with one gloo rank per worker:
the port's `AnytimeScheduler` over a 1-D `workers` mesh of 4 ranks
(`tests/_torch_mesh_worker.py suite_anytime`, run once for the file) at
the reference test's sizes (n = 600 and 250, m = 20, band 16, 4 chunks a
worker), against

  * the one-process scheduler over `["cpu"] * 4` with the same plan, run
    here: every round, the failure and resume chains (shrink to 3, to 2,
    grow to 4), supervised runs under a seeded schedule and rounds with
    idle ranks, BIT FOR BIT, self and AB, k = 1 and 4;
  * the f64 brute force: the final profiles and exact top-4 sets;
  * the reference's scheduler on 4 forced host devices
    (`reference_anytime`): every round within 1e-4 in correlation, indices
    differing only at near-ties (ROADMAP.md §C (15): the port's k = 1
    chunks are NATSA, the reference's its band engine), and the group's
    checkpoint resumed there.

A planted fault, the index all-reduce replaced by each rank's own index,
must fail the bit-for-bit check.
"""

import json
import zlib

import numpy as np
import pytest

from _torch_mesh_run import run_reference, run_suite
from _torch_mesh_worker import (ANY_CASES, ANY_CHAIN_CASES, ANY_IDLE,
                                ANY_IDLE_CASES, ANY_M,
                                ANY_SUPERVISED_CASES, any_array, any_chain,
                                any_dump, any_idle, any_make, any_series,
                                any_states, any_supervised, any_tie_states)
from repro_torch.core.distributed import allreduce_topk, pmax_profile
from repro_torch.core.scheduler import AnytimeScheduler

TOL_CORR = 1e-4      # the reference's own kernel standard, in correlation
SUITE_TIMEOUT = 240  # seconds a rank may take; the suite reads ~6 s
WORKERS = ["cpu"] * 4


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    return tmp_path_factory.mktemp("anytime_group")


@pytest.fixture(scope="module")
def group(tmp):
    return run_suite("anytime", tmp, world=4, timeout=SUITE_TIMEOUT)


@pytest.fixture(scope="module")
def reference(tmp, group):
    # after the group: it resumes the group's first chain checkpoint
    return run_reference(tmp, "anytime", timeout=SUITE_TIMEOUT)


@pytest.fixture(scope="module")
def one(tmp):
    """The same work on the one-process scheduler over four CPU workers."""
    def mk(case):
        return any_make(AnytimeScheduler, WORKERS, case)

    out = {"rounds": {}, "chain": {}, "supervised": {}, "idle": {}}
    for case in ANY_CASES:
        sch = mk(case)
        out["rounds"][case] = [any_dump(sch.step_round())
                               for _ in range(sch.plan.n_rounds)]
    for case in ANY_CHAIN_CASES:
        d = tmp / "one" / case
        d.mkdir(parents=True)
        out["chain"][case] = any_chain(lambda: mk(case), str(d))
    for case in ANY_SUPERVISED_CASES:
        out["supervised"][case] = any_supervised(
            lambda: mk(case), str(tmp / "one" / f"sup_{case}.npz"))
    for case in ANY_IDLE_CASES:
        out["idle"][case] = any_idle(mk(case))
    return out


def _corr(case):
    """f64 correlations of every (row, column) pair of the case's
    rectangle: A against itself, or A against B."""
    ts, ts_b = any_series()

    def unit(x):
        w = np.lib.stride_tricks.sliding_window_view(
            x.astype(np.float64), ANY_M)
        w = w - w.mean(axis=1, keepdims=True)
        return w / np.linalg.norm(w, axis=1, keepdims=True)

    ua = unit(ts)
    return ua @ (unit(ts_b) if ANY_CASES[case][0] else ua).T


def _sides(dump):
    """[(corr, index), ...] of a dumped state's sides, as arrays."""
    return [None if s is None else (any_array(s[0]), any_array(s[1]))
            for s in dump]


def _same(got, want) -> bool:
    """Two dumped scheduler states (or lists of them) bit for bit."""
    return json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)


def _assert_near(got, want, corr, ctx):
    """One side, (l,) or (l, k): correlations within TOL_CORR, indices
    equal but at near-ties (both picks' f64 correlations within it)."""
    (gc, gi), (wc, wi) = got, want
    assert gc.shape == wc.shape, ctx
    np.testing.assert_allclose(gc, wc, rtol=0, atol=TOL_CORR, err_msg=ctx)
    for at in map(tuple, np.argwhere(gi != wi)):
        assert gi[at] >= 0 and wi[at] >= 0, (ctx, at, gi[at], wi[at])
        r = at[0]
        assert abs(corr[r, gi[at]] - corr[r, wi[at]]) < TOL_CORR, (ctx, at)


def _oracle_sides(case):
    """The exact answer of each side: (corr matrix, the allowed mask)."""
    c = _corr(case)
    if ANY_CASES[case][0]:
        return [(c, np.ones_like(c, bool)), (c.T, np.ones_like(c.T, bool))]
    i = np.arange(c.shape[0])
    return [(c, np.abs(i[:, None] - i[None, :]) >= 5), None]


@pytest.mark.parametrize("case", list(ANY_CASES))
def test_rounds_bit_for_bit_the_one_process_path(group, one, case):
    got, want = group["rounds"][case], one["rounds"][case]
    assert len(got) == len(want) == 4
    for r, (g, w) in enumerate(zip(got, want)):
        assert _same(g, w), f"{case} round {r}"


@pytest.mark.parametrize("case", list(ANY_CASES))
def test_every_rank_ends_with_the_same_state(group, one, case):
    crc = zlib.crc32(json.dumps(one["rounds"][case][-1]).encode())
    assert group["final_crc"][case] == [crc] * 4


@pytest.mark.parametrize("case", list(ANY_CASES))
def test_rounds_monotone_and_exact_against_bruteforce(group, case):
    """Every round improves every side; the last is the exact answer (the
    f64 brute force's best correlations, or top-4 sets, within TOL_CORR,
    each pick's own correlation within it, no neighbour twice)."""
    rounds = [_sides(r["sides"]) for r in group["rounds"][case]]
    for prev, cur in zip(rounds, rounds[1:]):
        for p, c in zip(prev, cur):
            if p is not None:
                assert (c[0] >= p[0]).all(), case
    assert group["rounds"][case][-1]["frac"] == 1.0
    for side, oracle in zip(rounds[-1], _oracle_sides(case)):
        if oracle is None:
            assert side is None
            continue
        c, ok = oracle
        cc, ci = side
        k = ANY_CASES[case][1]
        cc, ci = cc.reshape(len(cc), -1), ci.reshape(len(ci), -1)
        masked = np.where(ok, c, -np.inf)
        want = -np.sort(-masked, axis=1)[:, :k]
        np.testing.assert_allclose(cc, want, rtol=0, atol=TOL_CORR)
        picked = np.take_along_axis(c, ci, axis=1)
        np.testing.assert_allclose(picked, cc, rtol=0, atol=TOL_CORR)
        assert np.take_along_axis(ok, ci, axis=1).all()
        assert all(len(set(row)) == k for row in ci.tolist())


@pytest.mark.parametrize("case", ANY_CHAIN_CASES)
def test_failure_and_resume_chain_bit_for_bit(group, one, case):
    """Failures in three consecutive rounds, a checkpoint, a resume onto 3
    workers (rank 3 idle), another failure, onto 2, then back onto 4:
    every state the one-process chain's, and the end the clean run's."""
    got, want = group["chain"][case], one["chain"][case]
    assert len(got) == len(want)
    for n, (g, w) in enumerate(zip(got, want)):
        assert _same(g, w), f"{case} chain step {n}"
    assert 0.0 < got[3]["frac"] < 1.0
    assert _same(got[-1]["sides"], group["rounds"][case][-1]["sides"])


def test_group_checkpoint_restores_in_one_process_and_reference(
        tmp, group, one, reference):
    """Rank 0's checkpoint is format 2 with the one-process writer's
    arrays and meta; the one-process scheduler resumes it to the clean
    run's bits, the reference's to within TOL_CORR / near-ties."""
    path = tmp / "anytime_ckpt" / "self_k1" / "chain1.npz"
    with np.load(path) as g, np.load(tmp / "one" / "self_k1" /
                                     "chain1.npz") as w:
        assert sorted(g.files) == sorted(w.files)
        for name in g.files:
            assert np.array_equal(g[name], w[name]), name
    sch = any_make(AnytimeScheduler, WORKERS, "self_k1")
    sch.resume(str(path))
    clean = group["rounds"]["self_k1"][-1]
    assert _same(any_dump(sch.run())["sides"], clean["sides"])
    res = reference["resumed"]
    assert res["frac"] == 1.0 and any_array(res["done"]).all()
    _assert_near(_sides(res["sides"])[0], _sides(clean["sides"])[0],
                 _corr("self_k1"), "reference resumed")


@pytest.mark.parametrize("case", ANY_SUPERVISED_CASES)
def test_supervised_run_bit_for_bit_with_its_report(group, one, case):
    """The seeded schedule (crashed workers, failed rounds, killed and
    corrupted checkpoints) under supervision: the one-process run's report
    and bits, and the clean run's answer."""
    got, want = group["supervised"][case], one["supervised"][case]
    assert got["report"] == want["report"]
    rep = got["report"]
    assert (rep["retries"] > 0 and rep["worker_failures"]
            and rep["checkpoint_failures"] > 0
            and rep["checkpoints_corrupted"] > 0), rep
    assert not rep["degraded"] and rep["fraction_done"] == 1.0
    assert _same(got["state"], want["state"])
    assert _same(got["state"]["sides"],
                 group["rounds"][case][-1]["sides"])


@pytest.mark.parametrize("case", ANY_IDLE_CASES)
def test_idle_ranks_give_the_one_process_bits(group, one, case):
    """A round with idle ranks merges their empty states, as the
    reference's idle workers do; the one-process loop skips them. Both
    give the same bits, all ranks idle included."""
    got, want = group["idle"][case], one["idle"][case]
    assert len(got) == len(want) == len(ANY_IDLE)
    for live, g, w in zip(ANY_IDLE, got, want):
        assert _same(g, w), (case, live)
    # the patterns are distinct rounds: idle workers leave their chunk out
    assert not _same(got[0], got[1])
    assert _same(got[2], one["rounds"][case][0]["sides"])


def test_collective_merges_keep_the_reference_tie_rules(group):
    """Correlations that tie across the ranks: the k = 1 all-reduces pick
    the highest index, the all-gather's union is slot-major, rank-minor
    and stable — the list forms' bits over the ranks' states in rank
    order."""
    states = [any_tie_states(r) for r in range(4)]
    want = any_states((pmax_profile([s[0] for s in states]),
                       allreduce_topk([s[1] for s in states])))
    assert _same(group["ties"], want)
    assert any_array(group["ties"][1][1]).tolist() == [[0, 1, 2],
                                                      [30, 31, 32]]


@pytest.mark.parametrize("case", list(ANY_CASES))
def test_rounds_within_the_reference(group, reference, case):
    got, want = group["rounds"][case], reference["rounds"][case]
    assert len(got) == len(want)
    oracle = _oracle_sides(case)
    for r, (g, w) in enumerate(zip(got, want)):
        assert g["frac"] == w["frac"]
        assert np.array_equal(any_array(g["done"]), any_array(w["done"]))
        for side, (gs, ws) in enumerate(zip(_sides(g["sides"]),
                                            _sides(w["sides"]))):
            if gs is None:
                assert ws is None
                continue
            _assert_near(gs, ws, oracle[side][0], f"{case} round {r}")


def test_mismatched_series_or_plan_raises_on_every_rank(group):
    for what, rank in (("series", 2), ("band", 1)):
        msgs = group["guard"][what]
        assert len(msgs) == 4
        assert all(m is not None and f"ranks [{rank}]" in m for m in msgs), \
            msgs


def test_resume_onto_more_workers_than_ranks_raises(tmp, group):
    """A plan for more workers than the group has ranks (or the list
    has devices) cannot run: `resume` raises on every rank."""
    msgs = group["too_many_workers"]
    assert all(m is not None and "n_workers=5" in m for m in msgs), msgs
    sch = any_make(AnytimeScheduler, WORKERS, "self_k1")
    with pytest.raises(ValueError, match="4 worker slots"):
        sch.resume(str(tmp / "anytime_ckpt" / "self_k1" / "chain1.npz"),
                   n_workers=5)


def test_device_list_under_a_group_raises(group):
    for where, msg in group["device_list"].items():
        assert msg is not None and "DeviceMesh" in msg, where


def test_planted_index_fault_fails_the_bitwise_check(group, one):
    """Each rank keeping its own index after the correlations' all-reduce
    leaves the correlations right and the indices wrong: the bit-for-bit
    check must see it."""
    got, want = group["planted"], one["rounds"]["self_k1"]
    assert not all(_same(g, w) for g, w in zip(got, want))
    for g, w in zip(got, want):
        assert g["sides"][0][0] == w["sides"][0][0]

