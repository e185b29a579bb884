"""The plain reference against a brute-force float64 profile, and its
independence from the program."""

import subprocess
import sys

import numpy as np
import pytest
import torch

import mpbench_small
from mpbench import series
from mpbench.references import exact_selfjoin as ref


def brute(ts, m, e):
    t = np.asarray(ts, np.float64)
    l = len(t) - m + 1
    w = np.array([t[i:i + m] - t[i:i + m].mean() for i in range(l)])
    w /= np.linalg.norm(w, axis=1)[:, None]
    c = w @ w.T
    i = np.arange(l)
    c[np.abs(i[:, None] - i[None, :]) < e] = -np.inf
    return c


@pytest.mark.parametrize("n,m,e", [(300, 16, 4), (257, 32, 8)])
def test_reference_is_the_brute_force_profile(n, m, e):
    ts, pair = series.make(n, m, 2 ** 31 + 11)
    c = brute(ts, m, e)
    rows = series.sample_rows(n - m + 1, 40, 5, pair)
    best, arg = ref.best_rows(ts, m, e, rows, block=50)
    np.testing.assert_allclose(best, c[rows].max(axis=1), atol=1e-12)
    np.testing.assert_allclose(c[rows, arg], best, atol=1e-12)
    idx = c.argmax(axis=1)
    np.testing.assert_allclose(ref.pair_corr(ts, m, idx, block=64),
                               c.max(axis=1), atol=1e-12)
    bad = idx.copy()
    bad[3] = -1
    assert np.isnan(ref.pair_corr(ts, m, bad)[3])
    d, i = ref.profile(ts, m, e, dtype=torch.float64, block=64)
    np.testing.assert_allclose(1 - d.astype(np.float64) ** 2 / (2 * m),
                               c.max(axis=1), atol=1e-5)
    assert np.all(np.abs(i - np.arange(len(i))) >= e)


def test_planted_pair_is_found():
    n, m = 2048, 64
    ts, (a, b) = series.make(n, m, 123)
    best, arg = ref.best_rows(ts, m, 16, [a, b])
    assert list(arg) == [b, a] and np.all(best > 1 - 1e-6)


def test_series_repeat_by_seed():
    a, pa = series.make(1000, 32, 2 ** 33 + 1)
    b, pb = series.make(1000, 32, 2 ** 33 + 1)
    c, _ = series.make(1000, 32, 7)
    assert a.dtype == np.float32 and np.array_equal(a, b) and pa == pb
    assert not np.array_equal(a, c)


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path[:0] = [sys.argv[1]]; "
            "import mpbench.references.exact_selfjoin, mpbench.check, "
            "mpbench.series, mpbench.kinds.self_join; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code,
                          str(mpbench_small.ROOT)], capture_output=True,
                         text=True, check=True).stdout
    loaded = set(eval(out))
    assert not loaded & {"repro_torch", "repro", "jax", "jaxlib", "flax"}
