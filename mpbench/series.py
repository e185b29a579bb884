"""The benchmark's inputs, made from `--seed`: a float32 random walk with
one planted exact motif pair, and the rows whose exact profile the check
recomputes. The same seed gives the same series, pair and rows; every seed
gives a series of the configuration's length."""

from __future__ import annotations

import numpy as np


def _rng(seed: int, stream: int = 0) -> np.random.Generator:
    return np.random.default_rng([int(seed) % 2 ** 64, stream])


def walk(rng: np.random.Generator, n: int) -> np.ndarray:
    return np.cumsum(rng.standard_normal(n))


def plant(ts: np.ndarray, src: int, dst: int, m: int) -> np.ndarray:
    """Copy the window at `src` to `dst`, shifted to continue the series:
    a z-normalized exact match."""
    ts[dst:dst + m] = ts[src:src + m] - ts[src] + ts[dst - 1]
    return ts


def make(n: int, m: int, seed: int) -> tuple[np.ndarray, tuple[int, int]]:
    """(float32 series of n samples, the planted pair (src, dst))."""
    rng = _rng(seed)
    ts = walk(rng, n)
    src = int(rng.integers(m, n // 2 - m))
    dst = int(rng.integers(n // 2 + m, n - m))
    return plant(ts, src, dst, m).astype(np.float32), (src, dst)


def sample_rows(l: int, count: int, seed: int, pair) -> np.ndarray:
    """`count` distinct rows of l drawn from the seed, and the planted pair."""
    rows = _rng(seed, 1).choice(l, size=min(count, l), replace=False)
    return np.unique(np.concatenate([rows, np.asarray(pair)]))
