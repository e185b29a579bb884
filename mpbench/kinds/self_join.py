"""self_join: an exact z-normalized self-join of one series.

The input: a float32 random walk with one planted exact motif pair
(`series.make`), and the rows whose exact profile the check recomputes,
drawn from the seed with the pair. Numbers compared (each with its own
limit):

  * `bad_rows`: rows whose neighbour is no subsequence, lies inside the
    exclusion zone, or whose distance is not finite (exact: 0);
  * `value_gap`: over EVERY row, the gap between the correlation the
    program reports and the float64 correlation of the pair it names;
  * `best_gap`: over the sampled rows (and the planted pair), the gap
    between the reported correlation and the float64 exact best.

Correlations come from the delivered distances, c = 1 - d^2 / (2m).
"""

from __future__ import annotations

import types

import numpy as np
import torch

from mpbench import series

EXACT = ("bad_rows",)


def inputs(cfg: dict, seed: int) -> types.SimpleNamespace:
    """The series, its planted pair and the rows the check samples."""
    m = int(cfg["window"])
    ts, pair = series.make(int(cfg["n"]), m, seed)
    rows = series.sample_rows(len(ts) - m + 1, int(cfg["sample_rows"]),
                              seed, pair)
    return types.SimpleNamespace(ts=ts, pair=pair, rows=rows)


def corr_of(dist: np.ndarray, m: int) -> np.ndarray:
    d = np.asarray(dist, np.float64)
    return 1.0 - d * d / (2.0 * m)


def readings(data, cfg: dict, answer, ref, device) -> dict:
    """The numbers that compare one delivered (distance, index) answer
    with the reference; with no answer, the gaps are infinite."""
    if answer is None:
        return {"bad_rows": 0, "value_gap": float("inf"),
                "best_gap": float("inf")}
    m, excl = int(cfg["window"]), int(cfg["exclusion"])
    dist = np.asarray(answer[0])
    index = np.asarray(answer[1], np.int64)
    l = dist.shape[0]
    i = np.arange(l)
    bad = ((index < 0) | (index >= l) | (np.abs(index - i) < excl)
           | ~np.isfinite(dist))
    c = corr_of(dist, m)
    pair = ref.pair_corr(data.ts, m, index, device=device)
    gap = np.abs(c - pair)[~bad]
    best, _ = ref.best_rows(data.ts, m, excl, data.rows, device=device)
    best_gap = np.abs(c[data.rows] - best)
    return {"bad_rows": int(bad.sum()),
            "value_gap": float(gap.max()) if gap.size else float("inf"),
            "best_gap": (float(best_gap.max())
                         if np.isfinite(best_gap).all() else float("inf"))}


def control(data, cfg: dict, ref, device):
    """The reference in the program's place, computed from bfloat16
    windows: the answer the limits have to refuse."""
    return ref.profile(data.ts, int(cfg["window"]), int(cfg["exclusion"]),
                       dtype=torch.bfloat16, device=device)
