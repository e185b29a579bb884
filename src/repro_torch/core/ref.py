"""Brute-force matrix-profile oracles in torch float64 (O(l^2 m)).

Port of `repro.core.ref`: the full z-normalized (or, with
`normalize=False`, raw Euclidean) distance matrix from the windowed
subsequences directly — no recurrence — computed on whatever device the
input tensor lies on. `profile_rows` is the row-sampled form for series
too long for a full matrix: the exact profile of a few chosen rows of A
against all of B.
"""

from __future__ import annotations

import torch

from repro_torch.core.zstats import corr_to_dist


def _as_f64(ts, device=None) -> torch.Tensor:
    if isinstance(ts, torch.Tensor):
        return ts.to(device=device or ts.device, dtype=torch.float64)
    return torch.as_tensor(ts, dtype=torch.float64, device=device)


def _centered_windows(ts: torch.Tensor, m: int):
    w = ts.unfold(0, m, 1)                          # (l, m) view
    wc = w - w.mean(dim=1, keepdim=True)
    return wc, torch.sqrt((wc * wc).sum(dim=1))


def _corr(wa, na, wb, nb) -> torch.Tensor:
    dots = wa @ wb.T
    denom = na[:, None] * nb[None, :]
    corr = torch.where(denom > 0, dots / torch.clamp(denom, min=1e-30),
                       torch.zeros((), dtype=dots.dtype, device=dots.device))
    return torch.clamp(corr, -1.0, 1.0)


def distance_matrix(ts, window: int) -> torch.Tensor:
    """Full (l, l) z-normalized Euclidean distance matrix."""
    m = int(window)
    wc, norm = _centered_windows(_as_f64(ts), m)
    return corr_to_dist(_corr(wc, norm, wc, norm), m)


def matrix_profile_bruteforce(ts, window: int, exclusion: int | None = None):
    """(profile, index) with trivial exclusion-zone handling."""
    m = int(window)
    excl = max(1, m // 4) if exclusion is None else int(exclusion)
    d = distance_matrix(ts, m)
    i = torch.arange(d.shape[0], device=d.device)
    banned = (i[:, None] - i[None, :]).abs() < excl
    d = torch.where(banned, torch.inf, d)
    return d.min(dim=1).values, d.argmin(dim=1)


def _raw_dist(wa: torch.Tensor, wb: torch.Tensor) -> torch.Tensor:
    """(p, q) Euclidean distances between raw windows, one row of A at a
    time: memory O(q·m), not O(p·q·m)."""
    return torch.stack([torch.sqrt(((wb - w) ** 2).sum(dim=1)) for w in wa])


def cross_distance_matrix(ts_a, ts_b, window: int,
                          normalize: bool = True) -> torch.Tensor:
    """Full (l_a, l_b) rectangle of distances between A and B
    subsequences: z-normalized, or raw Euclidean with `normalize=False`."""
    m = int(window)
    a = _as_f64(ts_a)
    b = _as_f64(ts_b, a.device)
    if not normalize:
        return _raw_dist(a.unfold(0, m, 1), b.unfold(0, m, 1))
    wa, na = _centered_windows(a, m)
    wb, nb = _centered_windows(b, m)
    return corr_to_dist(_corr(wa, na, wb, nb), m)


def ab_join_bruteforce(ts_a, ts_b, window: int, exclusion: int = 0,
                       normalize: bool = True):
    """(profile (l_a,), index) of A vs B — the AB ground truth."""
    d = cross_distance_matrix(ts_a, ts_b, window, normalize=normalize)
    if exclusion > 0:
        la, lb = d.shape
        i = torch.arange(la, device=d.device)
        j = torch.arange(lb, device=d.device)
        d = torch.where((i[:, None] - j[None, :]).abs() < int(exclusion),
                        torch.inf, d)
    return d.min(dim=1).values, d.argmin(dim=1)


def _rows_dist(ts_a, ts_b, m: int, rows, exclusion: int,
               normalize: bool) -> torch.Tensor:
    """(len(rows), l_b) exact distances of the chosen rows of A against
    every subsequence of B, banned pairs inf."""
    a = _as_f64(ts_a)
    b = _as_f64(ts_b, a.device)
    rows = torch.as_tensor(rows, dtype=torch.long, device=a.device)
    if normalize:
        wa, na = _centered_windows(a, m)
        wb, nb = _centered_windows(b, m)
        d = corr_to_dist(_corr(wa[rows], na[rows], wb, nb), m)
    else:
        d = _raw_dist(a.unfold(0, m, 1)[rows], b.unfold(0, m, 1))
    if exclusion > 0:
        j = torch.arange(d.shape[1], device=a.device)
        d = torch.where((rows[:, None] - j[None, :]).abs() < int(exclusion),
                        torch.inf, d)
    return d


def profile_rows(ts_a, ts_b, window: int, rows, exclusion: int = 0,
                 normalize: bool = True):
    """Exact (dist, index) of the chosen subsequences `rows` of A against
    every subsequence of B, with |i - j| < exclusion banned (a self-join is
    ts_b = ts_a with the self-join's exclusion); z-normalized, or raw with
    `normalize=False`. Memory is O(l_b·m) for B's windows plus
    O(len(rows)·l_b)."""
    d = _rows_dist(ts_a, ts_b, int(window), rows, exclusion, normalize)
    return d.min(dim=1).values, d.argmin(dim=1)


def profile_rows_topk(ts_a, ts_b, window: int, rows, k: int,
                      exclusion: int = 0):
    """`profile_rows` widened to the exact top-k: ((len(rows), k) distances
    best-first, indices) of the chosen rows of A against every subsequence
    of B, banned pairs excluded (an exhausted row pads with inf). Among
    equal distances the order is `torch.topk`'s, so compare picks by their
    distances, not their indices."""
    d = _rows_dist(ts_a, ts_b, int(window), rows, exclusion, True)
    return torch.topk(d, int(k), dim=1, largest=False)
