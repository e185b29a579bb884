"""Plain reference of an exact z-normalized self-join, in float64.

Straight from the definition: each subsequence is centred by its own mean,
the correlation of two is their dot over the product of their norms, and a
row's nearest neighbour is the largest correlation over every other
subsequence at least `exclusion` away. No recurrence, no streams and
nothing of the program: the series the harness hands to both sides is all
it reads. It runs on any device, in blocks, so that it fits beside nothing.

`profile` is the same reference at a lower precision, put in the program's
place: the control that the comparison has to refuse.
"""

from __future__ import annotations

import numpy as np
import torch

BLOCK = 1 << 16        # subsequences per block of centred windows


def _windows(ts: np.ndarray, m: int, device) -> torch.Tensor:
    """(l, m) float64 view of the series' windows on `device`."""
    t = torch.as_tensor(np.asarray(ts, np.float64), device=device)
    return t.unfold(0, int(m), 1)


def _centred(w: torch.Tensor):
    wc = w - w.mean(dim=1, keepdim=True)
    return wc, torch.sqrt((wc * wc).sum(dim=1))


def best_rows(ts, m: int, exclusion: int, rows, device="cpu",
              block: int = BLOCK) -> tuple[np.ndarray, np.ndarray]:
    """Exact float64 profile of `rows`: (best correlation, its neighbour)
    over every subsequence j with |i - j| >= exclusion."""
    w = _windows(ts, m, device)
    l = w.shape[0]
    r = torch.as_tensor(np.asarray(rows, np.int64), device=device)
    q, qn = _centred(w[r])
    best = torch.full((r.shape[0],), -np.inf, dtype=torch.float64,
                      device=device)
    arg = torch.full((r.shape[0],), -1, dtype=torch.int64, device=device)
    for j0 in range(0, l, block):
        wc, wn = _centred(w[j0:j0 + block])
        corr = (q @ wc.T) / (qn[:, None] * wn[None, :])
        j = torch.arange(j0, j0 + wc.shape[0], device=device)
        corr = corr.masked_fill((j[None, :] - r[:, None]).abs() < exclusion,
                                -np.inf)
        v, a = corr.max(dim=1)
        take = v > best
        best = torch.where(take, v, best)
        arg = torch.where(take, a + j0, arg)
    return best.cpu().numpy(), arg.cpu().numpy()


def pair_corr(ts, m: int, index, device="cpu",
              block: int = BLOCK) -> np.ndarray:
    """Float64 correlation of every row i with the neighbour `index[i]`;
    NaN where the index is not a subsequence."""
    w = _windows(ts, m, device)
    l = w.shape[0]
    idx = torch.as_tensor(np.asarray(index, np.int64), device=device)
    ok = (idx >= 0) & (idx < l)
    idx = torch.where(ok, idx, 0)
    out = torch.empty(l, dtype=torch.float64, device=device)
    for i0 in range(0, l, block):
        a, an = _centred(w[i0:i0 + block])
        b, bn = _centred(w[idx[i0:i0 + block]])
        out[i0:i0 + a.shape[0]] = (a * b).sum(dim=1) / (an * bn)
    out = torch.where(ok, out, torch.full_like(out, float("nan")))
    return out.cpu().numpy()


def profile(ts, m: int, exclusion: int, dtype=torch.bfloat16, device="cpu",
            block: int = 4096) -> tuple[np.ndarray, np.ndarray]:
    """The whole profile as (distance float32, index int32), the program's
    output form, from z-normalized windows rounded to `dtype` and their
    products computed in it."""
    w = _windows(ts, m, device)
    l = w.shape[0]
    wc, wn = _centred(w)
    z = (wc / wn[:, None]).to(dtype)
    del wc
    best = torch.full((l,), -np.inf, dtype=torch.float64, device=device)
    arg = torch.full((l,), -1, dtype=torch.int64, device=device)
    for i0 in range(0, l, block):
        i1 = min(i0 + block, l)
        i = torch.arange(i0, i1, device=device)
        for j0 in range(0, l, BLOCK):
            j1 = min(j0 + BLOCK, l)
            j = torch.arange(j0, j1, device=device)
            corr = z[i0:i1] @ z[j0:j1].T
            corr = corr.masked_fill((j[None, :] - i[:, None]).abs()
                                    < exclusion, -np.inf)
            v, a = corr.max(dim=1)
            v = v.double()
            take = v > best[i0:i1]
            best[i0:i1] = torch.where(take, v, best[i0:i1])
            arg[i0:i1] = torch.where(take, a + j0, arg[i0:i1])
    dist = torch.sqrt(torch.clamp(2 * m * (1 - best), min=0))
    return (dist.float().cpu().numpy(), arg.to(torch.int32).cpu().numpy())
