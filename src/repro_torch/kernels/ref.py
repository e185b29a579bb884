"""Plain-tensor oracles for the NATSA kernel — port of `repro.kernels.ref`.

`rowmax_profile_ref` computes what `natsa_mp.rowmax_profile` computes —
both profile sides over diagonals [excl, excl + len(cov0)) from the same
padded streams — in one shot: the covariance of every diagonal as one
cumsum, the column side through the band engine's anti-offset harvest.
`rowmax_profile_ab_ref` is one un-reseeded whole-span evaluation of the AB
band recurrence. The tests hold the kernel's plain version against both.
"""

from __future__ import annotations

import torch

NEG = -2.0


def rowmax_profile_ref(df, dg, invn, cov0, *, excl: int, l: int):
    """(corr (l,), idx, col_corr (l,), col_idx) over diagonals
    k in [excl, excl + len(cov0)). Row ties go to the smallest diagonal
    (argmax), as in the reference."""
    from repro_torch.core.matrix_profile import _col_window

    dev = df.device
    n_diags = cov0.shape[0]
    ks = excl + torch.arange(n_diags, device=dev)            # (D,)
    i = torch.arange(l, device=dev)
    j = i[None, :] + ks[:, None]                             # (D, l)
    jc = torch.clamp(j, max=df.shape[0] - 1)
    dfj, dgj, invnj = df[jc], dg[jc], invn[jc]
    delta = df[None, :l] * dgj + dfj * dg[None, :l]
    delta[:, 0] = 0.0
    cov = cov0[:, None] + torch.cumsum(delta, dim=1)
    corr = cov * invn[None, :l] * invnj
    # the kernel's masks: geometry and the invn < 0 missing-data sentinel
    corr = torch.where((j < l) & (invn[None, :l] >= 0) & (invnj >= 0),
                       corr, NEG)
    best = torch.argmax(corr, dim=0)
    corr_best = corr.gather(0, best[None, :])[0]
    idx = torch.where(corr_best > NEG, i + excl + best, -1).to(torch.int32)
    # the whole span is one "band": window entry t is column excl + t
    win, win_i = _col_window(corr, NEG)
    k = l - excl
    col_corr = torch.full((l,), NEG, dtype=corr.dtype, device=dev)
    col_idx = torch.full((l,), -1, dtype=torch.int32, device=dev)
    col_corr[excl:] = win[:k]
    col_idx[excl:] = win_i[:k]
    return corr_best, idx, col_corr, col_idx


def rowmax_profile_ab_ref(cross, k_lo: int, k_hi: int):
    """(row_win, row_idx, col_win, col_win_i, i0) over signed AB diagonals
    [k_lo, k_hi): one un-reseeded whole-span band (row-clamped windows at
    offset i0, see `matrix_profile.band_rowmax_ab`) — what
    `natsa_mp.rowmax_profile_ab` computes for that span, both sides."""
    from repro_torch.core.matrix_profile import band_rowmax_ab

    return band_rowmax_ab(cross, int(k_lo), int(k_hi - k_lo), k_hi=k_hi,
                          reseed_every=None)
