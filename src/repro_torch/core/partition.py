"""NATSA's balanced anytime workload partitioning, host-side — port of
`repro.core.partition`, copied (numpy only, no tensors), so that both
packages cut the same chunks and schedule the same rounds.

The iteration space is the upper triangle of an l x l matrix restricted to
diagonals k in [excl, l): diagonal k holds (l - k) cells, and each cell
streamed yields BOTH its row- and column-profile update, so covering these
diagonals once is the whole job. Splitting diagonals *evenly by count*
gives the first worker ~2x the cells of the last; NATSA's scheme splits by
*cumulative cell count* so every processing unit streams the same number
of updates.

Two layers, both deterministic:

  balanced_ranges(l, excl, parts)    — contiguous diag ranges w/ equal work
  interleaved_chunks(l, excl, P, C)  — over-decomposition into C equal-work
        chunks + a stride-interleaved round order that preserves the ANYTIME
        property: after r rounds every region of the diagonal space has been
        visited ~uniformly.

Chunk boundaries are aligned to `band` so the band engine never straddles a
chunk edge. Every boundary is a Python int, so a plan's chunks serialize
with `json.dumps` (the scheduler's checkpoint meta).
"""

from __future__ import annotations

import dataclasses

import numpy as np


def diag_work(l: int, k: np.ndarray) -> np.ndarray:
    """Cells on diagonal k. One streamed cell = one unit of work; each cell
    produces both its row and its column profile update, so this is the
    TOTAL work of the diagonal (the old reversed pass that doubled it is
    gone)."""
    return l - k


def balanced_ranges(l: int, excl: int, parts: int, band: int = 1) -> list[tuple[int, int]]:
    """Split diagonals [excl, l) into `parts` contiguous ranges of ~equal work.

    Boundaries are multiples of `band` (offset from excl). Returns a list of
    (k_start, k_end) half-open ranges covering the space exactly.
    """
    if parts <= 0:
        raise ValueError("parts must be positive")
    ks = np.arange(excl, l)
    if ks.size == 0:
        return [(excl, excl)] * parts
    w = diag_work(l, ks).astype(np.float64)
    cum = np.cumsum(w)
    total = cum[-1]
    targets = total * (np.arange(1, parts) / parts)
    cuts = np.searchsorted(cum, targets, side="left") + 1  # index into ks
    # align cuts to band multiples (relative to excl)
    cuts = np.clip(((cuts + band // 2) // band) * band, 0, ks.size)
    bounds = [0, *sorted(set(int(c) for c in cuts)), ks.size]
    # if alignment collapsed cuts, re-pad with empty ranges at the end
    ranges = [(excl + bounds[i], excl + bounds[i + 1]) for i in range(len(bounds) - 1)]
    while len(ranges) < parts:
        ranges.append((l, l))
    return ranges[:parts]


def range_work(l: int, r: tuple[int, int]) -> int:
    k0, k1 = r
    k0, k1 = max(k0, 0), min(k1, l)
    if k1 <= k0:
        return 0
    ks = np.arange(k0, k1)
    return int(diag_work(l, ks).sum())


# -- rectangular (AB-join) diagonal space ------------------------------------
#
# An AB join's iteration space is the full (l_a, l_b) rectangle; diagonals
# carry a SIGNED offset k = j - i in [-(l_a-1), l_b). Diagonal lengths ramp
# up from 1 at both corners to min(l_a, l_b) in the middle, so the naive
# equal-count split is unbalanced in BOTH directions — the same cumulative
# equal-work scheme covers it.


def diag_work_ab(l_a: int, l_b: int, k: np.ndarray,
                 band: int = 1) -> np.ndarray:
    """Engine cost of signed diagonal k of the (l_a, l_b) rectangle.

    With band == 1 this is the exact cell count inside the rectangle. With
    band > 1 it models the ROW-CLAMPED band engine (`ab_row_tile`): a
    `band`-wide tile starting at k computes the union row range
    [max(0, -(k+band-1)), min(l_a, l_b - k)) whatever the per-diagonal
    overlap is, so each diagonal is charged that clamped height — the count
    the balancer must equalize for the anytime scheduler's rounds to finish
    together (charging true cells would under-weight corner diagonals whose
    band still streams the clamp slack)."""
    k = np.asarray(k)
    return np.maximum(0, np.minimum(l_a, l_b - k)
                      - np.maximum(0, -(k + band - 1)))


def balanced_ranges_ab(l_a: int, l_b: int, parts: int, band: int = 1,
                       excl: int = 0) -> list[tuple[int, int]]:
    """Split the rectangle's signed diagonals into ~equal-work ranges.

    `band` both aligns the cut points and selects the clamped-cell cost
    model (`diag_work_ab(..., band)`) so the split balances what the
    row-clamped engine actually computes. With excl == 0 (the true-AB
    default) returns exactly `parts` half-open (k0, k1) ranges covering
    [-(l_a-1), l_b) (padded with empty ranges if alignment collapses cuts).
    With excl > 0 the band |k| < excl is removed and a cut is FORCED at the
    gap so no range straddles it — the result may then hold parts+1 ranges.
    Empty sentinel ranges are (l_b, l_b).
    """
    if parts <= 0:
        raise ValueError("parts must be positive")
    segs = []
    if excl == 0:
        segs.append(np.arange(-(l_a - 1), l_b))
    else:
        if l_a - excl > 0:
            segs.append(np.arange(-(l_a - 1), -excl + 1))
        if l_b - excl > 0:
            segs.append(np.arange(excl, l_b))
    ks = np.concatenate(segs) if segs else np.array([], np.int64)
    if ks.size == 0:
        return [(l_b, l_b)] * parts
    w = diag_work_ab(l_a, l_b, ks, band=band).astype(np.float64)
    cum = np.cumsum(w)
    total = cum[-1]
    targets = total * (np.arange(1, parts) / parts)
    cuts = np.searchsorted(cum, targets, side="left") + 1
    cuts = np.clip(((cuts + band // 2) // band) * band, 0, ks.size)
    forced = {segs[0].size} if len(segs) == 2 else set()
    bounds = sorted({0, ks.size} | {int(c) for c in cuts} | forced)
    ranges = [(int(ks[b0]), int(ks[b1 - 1]) + 1)
              for b0, b1 in zip(bounds[:-1], bounds[1:]) if b1 > b0]
    while len(ranges) < parts:
        ranges.append((l_b, l_b))
    return ranges


def range_work_ab(l_a: int, l_b: int, r: tuple[int, int],
                  band: int = 1) -> int:
    """Work of one signed range under the band-clamped cost model
    (band == 1: exact cells — the coverage/progress semantics)."""
    k0, k1 = r
    k0, k1 = max(k0, -(l_a - 1)), min(k1, l_b)
    if k1 <= k0:
        return 0
    return int(diag_work_ab(l_a, l_b, np.arange(k0, k1), band=band).sum())


@dataclasses.dataclass(frozen=True)
class AnytimePlan:
    """Deterministic chunked execution plan for P workers.

    rounds[r][p] = chunk id processed by worker p in round r (or -1 = idle).
    chunks[c] = (k_start, k_end). Self-join plans have l_b None and
    non-negative diagonals; AB plans carry l_b and SIGNED diagonal ranges
    over the (l, l_b) rectangle.
    """

    l: int
    exclusion: int
    n_workers: int
    chunks: tuple[tuple[int, int], ...]
    rounds: tuple[tuple[int, ...], ...]
    l_b: int | None = None

    @property
    def n_rounds(self) -> int:
        return len(self.rounds)

    def chunk_work(self) -> np.ndarray:
        if self.l_b is None:
            return np.array([range_work(self.l, c) for c in self.chunks])
        return np.array([range_work_ab(self.l, self.l_b, c)
                         for c in self.chunks])


def interleaved_chunks(l: int, excl: int, n_workers: int,
                       chunks_per_worker: int = 8, band: int = 64) -> AnytimePlan:
    """Over-decompose into C = n_workers * chunks_per_worker equal-work chunks
    and order them so round r covers chunks {r, r+R, r+2R, ...} (R = #rounds):
    every round touches the full diagonal span, preserving anytime convergence.
    """
    C = n_workers * chunks_per_worker
    chunks = balanced_ranges(l, excl, C, band=band)
    R = chunks_per_worker
    rounds = []
    for r in range(R):
        ids = list(range(r, C, R))[:n_workers]
        while len(ids) < n_workers:
            ids.append(-1)
        rounds.append(tuple(ids))
    return AnytimePlan(l=l, exclusion=excl, n_workers=n_workers,
                       chunks=tuple(chunks), rounds=tuple(rounds))


def interleaved_chunks_ab(l_a: int, l_b: int, n_workers: int,
                          chunks_per_worker: int = 8, band: int = 64,
                          excl: int = 0) -> AnytimePlan:
    """AB-join analogue of `interleaved_chunks`: over-decompose the signed
    diagonal space into equal-work chunks and stride-interleave the rounds so
    every round sweeps the whole rectangle (anytime uniformity)."""
    C = n_workers * chunks_per_worker
    chunks = balanced_ranges_ab(l_a, l_b, C, band=band, excl=excl)
    n = len(chunks)                 # may be C+1 when an exclusion gap forced a cut
    R = -(-n // n_workers)
    rounds = []
    for r in range(R):
        ids = list(range(r, n, R))[:n_workers]
        while len(ids) < n_workers:
            ids.append(-1)
        rounds.append(tuple(ids))
    return AnytimePlan(l=l_a, exclusion=excl, n_workers=n_workers,
                       chunks=tuple(chunks), rounds=tuple(rounds), l_b=l_b)


def replan_remaining(plan: AnytimePlan, done: np.ndarray,
                     n_workers: int) -> AnytimePlan:
    """ELASTIC RESCALE / FAILURE RECOVERY: rebuild a round schedule over the
    not-yet-done chunks for a (possibly different) worker count. Chunk
    boundaries are kept (their partial profiles are already merged), only the
    assignment changes, so no work is lost and no cell is recomputed.
    """
    remaining = [c for c in range(len(plan.chunks)) if not done[c]]
    if n_workers <= 0:
        raise ValueError("n_workers must be positive")
    R = max(1, -(-len(remaining) // n_workers))
    rounds = []
    for r in range(R):
        ids = remaining[r::R][:n_workers]
        while len(ids) < n_workers:
            ids.append(-1)
        rounds.append(tuple(ids))
    return AnytimePlan(l=plan.l, exclusion=plan.exclusion, n_workers=n_workers,
                       chunks=plan.chunks, rounds=tuple(rounds), l_b=plan.l_b)


def balance_badness(l: int, ranges: list[tuple[int, int]]) -> float:
    """max/mean work ratio — 1.0 is perfect balance (straggler metric)."""
    w = np.array([range_work(l, r) for r in ranges], dtype=np.float64)
    w = w[w > 0]
    if w.size == 0:
        return 1.0
    return float(w.max() / w.mean())


def balance_badness_ab(l_a: int, l_b: int,
                       ranges: list[tuple[int, int]],
                       band: int = 1) -> float:
    """Straggler metric over signed AB ranges (see `balance_badness`).
    `band` > 1 scores under the row-clamped engine cost model."""
    w = np.array([range_work_ab(l_a, l_b, r, band=band) for r in ranges],
                 dtype=np.float64)
    w = w[w > 0]
    if w.size == 0:
        return 1.0
    return float(w.max() / w.mean())
