"""The port's anytime partitioning (`repro_torch.core.partition`) — the twin
of `tests/test_partition.py`, plus equality with `repro.core.partition`:
over the same grids every function gives the reference's ranges, plans,
replans, work and badness, exactly (both are host-side numpy; nothing here
has a tolerance). Chunk boundaries are Python ints, so a plan's chunks
serialize with `json.dumps` as the scheduler's checkpoint meta needs.
"""

import dataclasses
import itertools
import json

import numpy as np
import pytest

from repro.core import partition as rpart
from repro_torch.core import partition


def _plan(p):
    return dataclasses.astuple(p)


def _covered(ranges, k_min, k_max):
    cov = np.zeros(k_max - k_min, int)
    for k0, k1 in ranges:
        for k in range(max(k0, k_min), min(k1, k_max)):
            cov[k - k_min] += 1
    return cov


@pytest.mark.parametrize("band", [1, 8, 16, 64])
def test_ranges_cover_exactly_and_equal_reference(band):
    for l, excl, parts in itertools.product((100, 777, 5000), (1, 9, 32),
                                            (1, 5, 16)):
        excl = min(excl, l // 4 + 1)
        ranges = partition.balanced_ranges(l, excl, parts, band=band)
        assert ranges == rpart.balanced_ranges(l, excl, parts, band=band)
        assert len(ranges) == parts
        cov = _covered(ranges, 0, l)
        assert (cov[excl:] == 1).all(), "every diagonal covered exactly once"
        assert (cov[:excl] == 0).all(), "exclusion zone untouched"


@pytest.mark.parametrize("l", [2000, 9001, 20000])
def test_work_balance(l):
    """NATSA's claim: equal WORK per unit (within one diagonal), never
    worse than the naive equal-count split."""
    excl = 8
    for parts in (2, 7, 64):
        ranges = partition.balanced_ranges(l, excl, parts, band=1)
        w = np.array([partition.range_work(l, r) for r in ranges], float)
        assert list(w) == [rpart.range_work(l, r) for r in ranges]
        assert w.max() <= w.sum() / parts + (l + 1)
        naive = np.array_split(np.arange(excl, l), parts)
        nw = np.array([partition.diag_work(l, ks).sum() for ks in naive])
        assert w.max() <= nw.max() + (l + 1)


@pytest.mark.parametrize("workers", [1, 3, 8])
def test_interleaved_plan_rounds_equal_reference(workers):
    for l, cpw in itertools.product((500, 2222, 5000), (1, 4, 6)):
        plan = partition.interleaved_chunks(l, 8, workers,
                                            chunks_per_worker=cpw, band=16)
        assert _plan(plan) == _plan(rpart.interleaved_chunks(
            l, 8, workers, chunks_per_worker=cpw, band=16))
        seen = [c for r in plan.rounds for c in r if c >= 0]
        assert all(len(r) == workers for r in plan.rounds)
        assert len(seen) == len(set(seen)), "chunk scheduled twice"
        nonempty = {c for c in range(len(plan.chunks))
                    if partition.range_work(l, plan.chunks[c]) > 0}
        assert nonempty <= set(seen)
        assert np.array_equal(plan.chunk_work(),
                              rpart.interleaved_chunks(
                                  l, 8, workers, chunks_per_worker=cpw,
                                  band=16).chunk_work())


@pytest.mark.parametrize("w_after", [1, 2, 5, 8])
def test_replan_covers_remaining_equal_reference(w_after):
    for l, w_before in itertools.product((500, 4000), (2, 8)):
        plan = partition.interleaved_chunks(l, 4, w_before,
                                            chunks_per_worker=4)
        rplan = rpart.interleaved_chunks(l, 4, w_before, chunks_per_worker=4)
        done = np.zeros(len(plan.chunks), bool)
        done[::2] = True
        new = partition.replan_remaining(plan, done, w_after)
        assert _plan(new) == _plan(rpart.replan_remaining(rplan, done,
                                                          w_after))
        scheduled = {c for r in new.rounds for c in r if c >= 0}
        assert scheduled == {c for c in range(len(plan.chunks))
                             if not done[c]}
        assert new.n_workers == w_after
    with pytest.raises(ValueError):
        partition.replan_remaining(plan, done, 0)


def test_anytime_round_spreads_coverage():
    """Each round touches the whole diagonal span (anytime uniformity)."""
    l, excl = 10000, 16
    plan = partition.interleaved_chunks(l, excl, 8, chunks_per_worker=8)
    for r in plan.rounds:
        ks = [plan.chunks[c][0] for c in r if c >= 0]
        assert max(ks) - min(ks) > (l - excl) * 0.5


def test_balance_badness_metric_equals_reference():
    for ranges in ([(8, 500), (500, 1000)], [(0, 0)], [(3, 3), (10, 900)]):
        assert (partition.balance_badness(1000, ranges)
                == rpart.balance_badness(1000, ranges))
    assert partition.balance_badness(1000, [(8, 500), (500, 1000)]) > 1.0
    ranges = partition.balanced_ranges(100000, 8, 16, band=1)
    assert partition.balance_badness(100000, ranges) < 1.05
    ab = partition.balanced_ranges_ab(3000, 700, 9, band=16)
    for band in (1, 16):
        assert (partition.balance_badness_ab(3000, 700, ab, band=band)
                == rpart.balance_badness_ab(3000, 700, ab, band=band))


def test_parts_must_be_positive():
    for fn, args in ((partition.balanced_ranges, (100, 4, 0)),
                     (partition.balanced_ranges_ab, (100, 50, 0))):
        with pytest.raises(ValueError, match="parts must be positive"):
            fn(*args)


# -- rectangular (AB) diagonal space ------------------------------------------


@pytest.mark.parametrize("band", [1, 8, 64])
@pytest.mark.parametrize("excl", [0, 3])
def test_ab_ranges_cover_exactly_and_equal_reference(band, excl):
    for l_a, l_b, parts in itertools.product((50, 611, 2000), (50, 1400),
                                             (1, 6, 16)):
        e = min(excl, min(l_a, l_b) // 4)
        ranges = partition.balanced_ranges_ab(l_a, l_b, parts, band=band,
                                              excl=e)
        assert ranges == rpart.balanced_ranges_ab(l_a, l_b, parts,
                                                  band=band, excl=e)
        cov = _covered(ranges, -(l_a - 1), l_b)
        inside = np.abs(np.arange(-(l_a - 1), l_b)) >= e
        assert (cov[inside] == 1).all(), "every diagonal exactly once"
        assert (cov[~inside] == 0).all(), "exclusion band untouched"
        for r in ranges:
            assert (partition.range_work_ab(l_a, l_b, r, band=band)
                    == rpart.range_work_ab(l_a, l_b, r, band=band))
        ks = np.arange(-(l_a - 1), l_b)
        assert np.array_equal(partition.diag_work_ab(l_a, l_b, ks, band),
                              rpart.diag_work_ab(l_a, l_b, ks, band))


@pytest.mark.parametrize("parts", [2, 9, 64])
def test_ab_work_balance(parts):
    """Equal WORK per range, within one diagonal (band=1)."""
    for l_a, l_b in ((1000, 500), (20000, 20000), (3000, 17000)):
        ranges = partition.balanced_ranges_ab(l_a, l_b, parts, band=1)
        w = np.array([partition.range_work_ab(l_a, l_b, r) for r in ranges],
                     float)
        assert w.sum() == float(l_a) * l_b
        assert w.max() <= w.sum() / parts + min(l_a, l_b) + 1


@pytest.mark.parametrize("workers", [1, 4, 8])
def test_ab_interleaved_plan_equals_reference(workers):
    for (l_a, l_b), cpw, excl in itertools.product(
            ((300, 3000), (2500, 900)), (1, 4, 6), (0, 5)):
        plan = partition.interleaved_chunks_ab(
            l_a, l_b, workers, chunks_per_worker=cpw, band=16, excl=excl)
        assert _plan(plan) == _plan(rpart.interleaved_chunks_ab(
            l_a, l_b, workers, chunks_per_worker=cpw, band=16, excl=excl))
        assert plan.l_b == l_b
        seen = [c for r in plan.rounds for c in r if c >= 0]
        assert all(len(r) == workers for r in plan.rounds)
        assert len(seen) == len(set(seen))
        nonempty = {c for c in range(len(plan.chunks))
                    if partition.range_work_ab(l_a, l_b, plan.chunks[c]) > 0}
        assert nonempty <= set(seen)
        assert plan.chunk_work().sum() == l_a * l_b - (
            0 if excl == 0 else sum(
                partition.diag_work_ab(l_a, l_b, np.arange(-excl + 1, excl))))


def test_ab_gap_never_straddled():
    l_a, l_b, excl = 700, 400, 5
    for parts in (3, 7, 16):
        for k0, k1 in partition.balanced_ranges_ab(l_a, l_b, parts, band=8,
                                                   excl=excl):
            if k1 > k0:
                assert k1 <= -excl + 1 or k0 >= excl, (k0, k1)


def test_ab_replan_preserves_l_b_and_equals_reference():
    plan = partition.interleaved_chunks_ab(900, 500, 4, chunks_per_worker=4)
    rplan = rpart.interleaved_chunks_ab(900, 500, 4, chunks_per_worker=4)
    done = np.zeros(len(plan.chunks), bool)
    done[1::2] = True
    new = partition.replan_remaining(plan, done, 2)
    assert _plan(new) == _plan(rpart.replan_remaining(rplan, done, 2))
    assert new.l_b == plan.l_b
    scheduled = {c for r in new.rounds for c in r if c >= 0}
    assert scheduled == {c for c in range(len(plan.chunks)) if not done[c]}


def test_chunks_are_python_ints_for_checkpoint_meta():
    for plan in (partition.interleaved_chunks(3000, 12, 3),
                 partition.interleaved_chunks_ab(900, 500, 4, excl=3),
                 partition.interleaved_chunks(40, 39, 8)):
        assert all(type(k) is int for c in plan.chunks for k in c)
        assert json.loads(json.dumps(list(plan.chunks))) == [
            list(c) for c in plan.chunks]
