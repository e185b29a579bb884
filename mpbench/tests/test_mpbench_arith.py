"""The harness's own cell count and roofline arithmetic."""

import pytest

import mpbench_small  # noqa: F401
from mpbench import arith


def brute_cells(l, e):
    return sum(1 for i in range(l) for j in range(i + e, l))


@pytest.mark.parametrize("l,e", [(1, 0), (5, 1), (37, 4), (100, 25),
                                 (64, 64), (64, 70)])
def test_selfjoin_cells_brute_force(l, e):
    assert arith.selfjoin_cells(l, e) == brute_cells(l, e)


@pytest.mark.parametrize("l,e,cuts", [(100, 7, [7, 20, 50, 99, 100]),
                                      (61, 3, [3, 4, 61])])
def test_diagonal_cells_partition(l, e, cuts):
    parts = sum(arith.diagonal_cells(l, a, b) for a, b in zip(cuts, cuts[1:]))
    assert parts == arith.selfjoin_cells(l, e)
    assert arith.diagonal_cells(l, 5, 5) == 0


def test_paper_counts():
    assert arith.selfjoin_cells(262144 - 512 + 1, 128) == 261505 * 261506 // 2 == 34192563265
    assert round(arith.selfjoin_cells(524288 - 1024 + 1, 256) / 1e11, 2) \
        == 1.37


def test_bound_is_the_larger_term():
    kind = "NVIDIA H100 80GB HBM3"
    cells, nbytes = 10 ** 9, 10 ** 6
    t = arith.bound_s(cells, nbytes, kind)
    assert t == pytest.approx(9e9 / 67e12)
    assert arith.bound_s(1, 3.35e12, kind) == pytest.approx(1.0)
    assert arith.bound_s(cells, nbytes, kind, chips=4) == pytest.approx(t / 4)
    assert arith.bound_s(cells, nbytes, "a card the table lacks") is None
    assert arith.sweep_bytes(10, 4) == 3 * 4 * 10 + 4 * 4 + 8 * 10
