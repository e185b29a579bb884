"""Exact z-normalized join: the band engine and the public entry points —
port of `repro.core.matrix_profile` (the k = 1 engine and the entry layer).

`matrix_profile(ts, m)` is the self-join and `ab_join(a, b, m)` the AB
join. Each validates its series, plans a sweep (`core.plan.plan_sweep`),
builds the f64 host streams, executes the plan and wraps a
`ProfileResult`. The planner sends a sweep to the CUDA NATSA kernel
(`kernels/csrc/natsa_mp.cu`) unless the call asks for what only the band
engine below does: a non-default `band`, `clamp_rows=False`, a reseed
period, or f64 accumulation.

The band engine is NATSA's diagonal recurrence re-associated into a
cumulative sum along each diagonal,

    cov_k(i) = cov0[k] + sum_{t<=i} delta_k(t)
    delta_k(t) = df[t]*dg[t+k] + df[t+k]*dg[t]        (delta_k(0) = 0)

evaluated `band` adjacent diagonals at a time in plain tensor ops, so it
runs on any device. Every (D, rows) band tile yields both profile sides:
the row side is a max over the band axis, the column side the same max
after the anti-offset skew (`_col_window`), so one sweep of the upper
triangle is the whole self-join profile. `reseed_every=R` recomputes the
covariance exactly every R rows to bound f32 drift. The reference's
`lax.scan` over bands is a Python loop over Python-int diagonal offsets,
and its functional window merges are in-place slice updates here.
The rowstream, top-k, non-normalized, batched and reduced-precision tile
sweeps are not ported yet (the planner raises for them).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core.zstats import CrossStats, ZStats, corr_to_dist
from repro_torch.kernels.natsa_mp import row_harvest

NEG = -2.0  # corr lives in [-1, 1]; NEG marks "not yet computed"

DEFAULT_RESEED = 512
# diagonals per band tile; the answer does not depend on it (tested)
DEFAULT_BAND = 256


def default_exclusion(window: int) -> int:
    return max(1, -(-int(window) // 4))


def profile_distance(corr: torch.Tensor, window: int) -> torch.Tensor:
    """A correlation profile as distances; entries never filled (NEG) are
    inf."""
    d = corr_to_dist(torch.clamp(corr, -1.0, 1.0), window)
    return torch.where(corr <= NEG + 1e-6,
                       torch.full((), torch.inf, dtype=d.dtype,
                                  device=d.device), d)


# -- running states -----------------------------------------------------------


@dataclasses.dataclass
class ProfileState:
    """Running profile in correlation space (max corr == min dist)."""

    corr: torch.Tensor    # (l,) running max correlation (accum dtype)
    index: torch.Tensor   # (l,) int32 argmax position j (or -1)

    @classmethod
    def empty(cls, l: int, fill: float = NEG, dtype=torch.float32,
              device=None) -> "ProfileState":
        return cls(corr=torch.full((l,), fill, dtype=dtype, device=device),
                   index=torch.full((l,), -1, dtype=torch.int32,
                                    device=device))

    def merge(self, other: "ProfileState") -> "ProfileState":
        take = other.corr > self.corr
        return ProfileState(corr=torch.where(take, other.corr, self.corr),
                            index=torch.where(take, other.index, self.index))

    def to_distance(self, window: int) -> torch.Tensor:
        return profile_distance(self.corr, window)


@dataclasses.dataclass
class SplitProfile:
    """A self-join sweep's harvest with the sides kept separate: `right` is
    the row harvest (neighbour j > t), `left` the column harvest (j < t),
    `merged` = `right.merge(left)`."""

    merged: ProfileState
    right: ProfileState
    left: ProfileState


def centered_windows(stats: ZStats) -> torch.Tensor:
    """(l, m) matrix of centered subsequences, in the streams' dtype — used
    only for reseeding."""
    return stats.ts.unfold(0, stats.window, 1) - stats.mu[:, None]


def _col_window(corr: torch.Tensor, fill: float):
    """Column-side harvest of one band tile — the anti-offset gather.

    `corr[d, i]` is cell (i, j = i + k0 + d); the best value ENDING at
    column j = k0 + t is max_d corr[d, t - d]. Padding each row by D + 1,
    flattening and re-wrapping one element shorter gives skew[d, t] =
    corr[d, t - d]. Returns (win (li + D,), win_i): entry t belongs to
    column k0 + t, with its winning row t - d (or -1)."""
    D, li = corr.shape
    W = li + D
    p = F.pad(corr, (0, D + 1), value=fill)
    skew = p.reshape(-1)[:-D].reshape(D, W)
    win, d_win = row_harvest(skew)
    win_i = (torch.arange(W, device=corr.device) - d_win).to(torch.int32)
    return win, torch.where(win > fill, win_i, -1).to(torch.int32)


def _clamp_start(start: int, n: int, w: int) -> int:
    """The start a `w`-wide slice of an `n`-long axis is moved to when it
    would run outside — JAX's `dynamic_slice` rule, kept so the engine
    merges exactly where the reference's does. It only moves windows of
    bands wholly outside the diagonal space, which are all fill."""
    return min(max(int(start), 0), n - w)


@dataclasses.dataclass
class ColState:
    """Running column-side profile over a PADDED index space: real column
    j lives at j + pad_left, and the pads absorb band windows that start
    before column 0 (negative AB diagonals) or run past the last column.
    `merge_window` updates the state in place."""

    corr: torch.Tensor    # (pad_left + l_out + pad_right,)
    index: torch.Tensor

    @classmethod
    def empty(cls, pad_left: int, l_out: int, pad_right: int,
              fill: float = NEG, dtype=torch.float32,
              device=None) -> "ColState":
        n = pad_left + l_out + pad_right
        return cls(corr=torch.full((n,), fill, dtype=dtype, device=device),
                   index=torch.full((n,), -1, dtype=torch.int32,
                                    device=device))

    def merge_window(self, win, win_i, start: int) -> "ColState":
        w = win.shape[0]
        s = _clamp_start(start, self.corr.shape[0], w)
        seg_c, seg_i = self.corr[s:s + w], self.index[s:s + w]
        take = win > seg_c
        seg_i.copy_(torch.where(take, win_i, seg_i))
        seg_c.copy_(torch.where(take, win, seg_c))
        return self

    def to_profile(self, pad_left: int, l_out: int) -> ProfileState:
        return ProfileState(corr=self.corr[pad_left:pad_left + l_out],
                            index=self.index[pad_left:pad_left + l_out])


@dataclasses.dataclass
class BankedColState:
    """`ColState` split into overlapping banks — the engine twin of the TPU
    kernel's banked column accumulator, kept so `col_tile` plans give the
    reference's answer. Banks cover the flat space at stride `width -
    w_max`, so a window starting at s lies wholly in bank s // stride;
    `to_flat` max-merges the overlaps back. Updated in place."""

    corr: torch.Tensor    # (n_banks, width)
    index: torch.Tensor
    stride: int

    @classmethod
    def empty(cls, flat_len: int, width: int, w_max: int, fill: float = NEG,
              dtype=torch.float32, device=None) -> "BankedColState":
        if width <= w_max:
            raise ValueError(f"bank width {width} must exceed the merge "
                             f"window bound {w_max}")
        stride = width - w_max
        n_banks = max(1, max(flat_len - w_max, 0) // stride + 1)
        return cls(corr=torch.full((n_banks, width), fill, dtype=dtype,
                                   device=device),
                   index=torch.full((n_banks, width), -1, dtype=torch.int32,
                                    device=device),
                   stride=stride)

    def merge_window(self, win, win_i, start: int) -> "BankedColState":
        w = win.shape[0]
        n_banks, width = self.corr.shape
        bank = int(start) // self.stride
        local = int(start) - bank * self.stride
        bank = _clamp_start(bank, n_banks, 1)
        local = _clamp_start(local, width, w)
        seg_c = self.corr[bank, local:local + w]
        seg_i = self.index[bank, local:local + w]
        take = win > seg_c
        seg_i.copy_(torch.where(take, win_i, seg_i))
        seg_c.copy_(torch.where(take, win, seg_c))
        return self

    def to_flat(self, flat_len: int, fill: float = NEG):
        n_banks, width = self.corr.shape
        dev = self.corr.device
        flat_c = torch.full((flat_len,), fill, dtype=self.corr.dtype,
                            device=dev)
        flat_i = torch.full((flat_len,), -1, dtype=torch.int32, device=dev)
        for b in range(n_banks):
            s = b * self.stride
            e = min(s + width, flat_len)
            if e <= s:
                break
            bc, bi = self.corr[b, :e - s], self.index[b, :e - s]
            take = bc > flat_c[s:e]
            flat_i[s:e] = torch.where(take, bi, flat_i[s:e])
            flat_c[s:e] = torch.where(take, bc, flat_c[s:e])
        return flat_c, flat_i

    def to_profile(self, pad_left: int, l_out: int,
                   fill: float = NEG) -> ProfileState:
        flat_c, flat_i = self.to_flat(pad_left + l_out, fill)
        return ProfileState(corr=flat_c[pad_left:], index=flat_i[pad_left:])


# -- self-join engine ---------------------------------------------------------


def _exact_seeds(w_r: torch.Tensor, w_j: torch.Tensor) -> torch.Tensor:
    """(D, S) exact covariances <w_r[s], w_j[d, s]>: an elementwise product
    and a sum, so no matmul precision mode (TF32) can touch them."""
    return (w_r[None, :, :] * w_j).sum(dim=-1)


def _band_corr(stats: ZStats, k0: int, band: int,
               reseed_every: int | None = None,
               windows_c: torch.Tensor | None = None,
               accum_dtype=torch.float32) -> torch.Tensor:
    """The (D, l) correlation tile of diagonals [k0, k0 + band); cells with
    j >= l and pairs touching a masked window (invn < 0) hold NEG.
    `reseed_every=R` recomputes the covariance exactly (a centered-window
    dot) every R rows and corrects the running sum per segment."""
    l = stats.n_subsequences
    dev = stats.df.device
    acc = accum_dtype
    ks = k0 + torch.arange(band, device=dev)               # (D,)
    i = torch.arange(l, device=dev)                        # (l,)
    j = i[None, :] + ks[:, None]                           # (D, l)
    jc = torch.clamp(j, max=l - 1)
    valid = j < l

    dfa, dga, invna = (x.to(acc) for x in (stats.df, stats.dg, stats.invn))
    dfj, dgj, invnj = dfa[jc], dga[jc], invna[jc]
    cov0b = stats.cov0.to(acc)[torch.clamp(ks, max=l - 1)]

    delta = dfa[None, :] * dgj + dfj * dga[None, :]
    delta = torch.where(valid & (i[None, :] >= 1), delta, 0.0)
    cov = cov0b[:, None] + torch.cumsum(delta, dim=1)

    if reseed_every is not None:
        if windows_c is None:
            windows_c = centered_windows(stats).to(acc)
        R = int(reseed_every)
        n_seg = -(-l // R)
        rows = torch.clamp(torch.arange(n_seg, device=dev) * R, max=l - 1)
        jr = torch.clamp(rows[None, :] + ks[:, None], max=l - 1)   # (D, S)
        seeds = _exact_seeds(windows_c[rows], windows_c[jr])
        drift = seeds - cov[:, rows]
        seg = torch.clamp(i // R, max=n_seg - 1)
        cov = cov + drift[:, seg]

    corr = cov * invna[None, :] * invnj
    # the missing-data mask applies to the harvest only: the recurrence must
    # still run through masked cells to reach the valid ones after them
    keep = valid & (invna >= 0)[None, :] & (invnj >= 0)
    return torch.where(keep, corr, NEG)


def band_rowmax(stats: ZStats, k0: int, band: int, *,
                reseed_every: int | None = None,
                windows_c: torch.Tensor | None = None,
                accum_dtype=torch.float32):
    """Two-sided harvest of diagonals [k0, k0 + band): (row_corr (l,),
    row_idx, win (l + band,), win_i) — the best correlation starting at row
    i with its column j, and the column window whose entry t is column
    k0 + t with its row."""
    l = stats.n_subsequences
    corr = _band_corr(stats, k0, band, reseed_every, windows_c, accum_dtype)
    i = torch.arange(l, device=corr.device)
    best, d_win = row_harvest(corr)
    idx = torch.where(best > NEG, i + k0 + d_win, -1).to(torch.int32)
    win, win_i = _col_window(corr, NEG)
    return best, idx, win, win_i


def chunk_rowmax_split(stats: ZStats, k0: int, k1_static: int, band: int,
                       reseed_every: int | None = DEFAULT_RESEED,
                       accum_dtype=torch.float32):
    """Both sides over diagonals [k0, k0 + k1_static), kept separate:
    (row state = right profile, column profile = left profile)."""
    l = stats.n_subsequences
    dev = stats.df.device
    wc = (centered_windows(stats).to(accum_dtype)
          if reseed_every is not None else None)
    state = ProfileState.empty(l, dtype=accum_dtype, device=dev)
    # self-join diagonals are >= 0: no left pad; the right pad takes the
    # last window and overshooting all-fill bands
    col = ColState.empty(0, l, l + band, dtype=accum_dtype, device=dev)
    for b in range(-(-k1_static // band)):
        start = k0 + b * band
        rc, ri, win, wi = band_rowmax(stats, start, band,
                                      reseed_every=reseed_every,
                                      windows_c=wc, accum_dtype=accum_dtype)
        state = state.merge(ProfileState(rc, ri))
        col.merge_window(win, wi, start)
    return state, col.to_profile(0, l)


def chunk_rowmax(stats: ZStats, k0: int, k1_static: int, band: int,
                 reseed_every: int | None = DEFAULT_RESEED,
                 accum_dtype=torch.float32) -> ProfileState:
    """Merged two-sided profile over diagonals [k0, k0 + k1_static)."""
    rows, col = chunk_rowmax_split(stats, k0, k1_static, band, reseed_every,
                                   accum_dtype)
    return rows.merge(col)


def profile_from_stats(stats: ZStats, exclusion: int,
                       band: int = DEFAULT_BAND,
                       reseed_every: int | None = DEFAULT_RESEED, *,
                       accum_dtype: str = "float32") -> SplitProfile:
    """The exact self-join: ONE sweep of diagonals k in [excl, l); every
    cell updates both its row (right) and its column (left) side."""
    from repro_torch.core.precision import torch_dtype

    l = stats.n_subsequences
    rows, col = chunk_rowmax_split(stats, int(exclusion), l - int(exclusion),
                                   band, reseed_every,
                                   torch_dtype(accum_dtype))
    return SplitProfile(merged=rows.merge(col), right=rows, left=col)


# -- AB engine: the signed diagonal space of the rectangle --------------------
#
# Diagonal k = j - i in [-(l_a-1), l_b) starts at cell (max(0,-k), max(0,k))
# with seed CrossStats.cov0s; deltas before the start are masked to zero, so
# the cumsum holds the seed until the diagonal enters the rectangle. Each band
# tile's rows are clamped to those inside the rectangle (`ab_row_tile` rows
# from i0), so a skewed join sweeps ~l_a*l_b cells, not l_a^2.


def ab_row_tile(l_a: int, l_b: int, band: int) -> int:
    """Height of a row-clamped AB band tile: a band touches at most
    min(l_a, l_b + band - 1) rows, wherever it lies."""
    return int(min(l_a, l_b + band - 1))


def _unskew(w: torch.Tensor, rows: int, li: int) -> torch.Tensor:
    """Diagonal strip loads: out[d, t] = w[t + d] for d < rows, t < li — a
    strided view of the contiguous window `w` (li + rows long)."""
    return w.as_strided((rows, li), (1, 1), w.storage_offset())


def _ab_padded_streams(cross: CrossStats, band: int, li: int,
                       clamp_rows: bool = True):
    """Zero-pad both sides' streams so every row slice and every j-side
    window a chunk can visit is in bounds. Returns (pad_left, dfa, dga,
    invna, dfb, dgb, invnb). With the row clamp i0 + k0 >= 1 - band; the
    unclamped sweep pins i0 = 0, so its windows start as low as
    -(l_a - 1)."""
    pad_left = band if clamp_rows else band + cross.l_a - 1
    sa, sb = cross.a, cross.b
    return (pad_left,
            *(F.pad(x, (0, li)) for x in (sa.df, sa.dg, sa.invn)),
            *(F.pad(x, (pad_left, li + 2 * band))
              for x in (sb.df, sb.dg, sb.invn)))


def ab_reseed(l_a: int, l_b: int, reseed_every: int | None) -> int | None:
    """No reseed where no AB diagonal is longer than one reseed segment:
    the seeds already give the same drift bound."""
    if reseed_every is not None and min(l_a, l_b) <= int(reseed_every):
        return None
    return reseed_every


def _band_corr_ab(cross: CrossStats, k0: int, band: int, *, k_hi=None,
                  reseed_every: int | None = None, wa=None, wb=None,
                  clamp_rows: bool = True, padded=None,
                  accum_dtype=torch.float32):
    """The (D, li) correlation tile of signed diagonals [k0, k0 + band),
    row-clamped. Returns (corr, i (li,) absolute rows of A, i0). Streams
    are upcast to the accum dtype right after their loads."""
    acc = accum_dtype
    la, lb = cross.l_a, cross.l_b
    dev = cross.cov0s.device
    li = ab_row_tile(la, lb, band) if clamp_rows else la
    i0 = max(0, -(k0 + band - 1)) if clamp_rows else 0
    if padded is None:
        padded = _ab_padded_streams(cross, band, li, clamp_rows)
    pad_left, dfa_p, dga_p, invna_p, dfb_p, dgb_p, invnb_p = padded

    ks = k0 + torch.arange(band, device=dev)               # (D,) signed
    i = i0 + torch.arange(li, device=dev)                  # (li,)
    j = i[None, :] + ks[:, None]                           # (D, li)
    valid = (j >= 0) & (j < lb) & (i < la)[None, :]
    if k_hi is not None:
        valid = valid & (ks < k_hi)[:, None]

    r0 = _clamp_start(i0, dfa_p.shape[0], li)
    dfi, dgi, invni = (x[r0:r0 + li].to(acc)
                       for x in (dfa_p, dga_p, invna_p))
    W = li + band
    off = _clamp_start(i0 + k0 + pad_left, dfb_p.shape[0], W)
    dfj, dgj, invnj = (_unskew(x[off:off + W], band, li).to(acc)
                       for x in (dfb_p, dgb_p, invnb_p))
    cov0b = cross.cov0s.to(acc)[torch.clamp(ks + la - 1, 0, la + lb - 2)]

    delta = dfi[None, :] * dgj + dfj * dgi[None, :]
    # the predecessor cell (i-1, j-1) must exist; before a negative
    # diagonal's start the masked cumsum carries the seed forward
    delta = torch.where(valid & (i[None, :] >= 1) & (j >= 1), delta, 0.0)
    cov = cov0b[:, None] + torch.cumsum(delta, dim=1)

    if reseed_every is not None:
        if wa is None:
            wa = centered_windows(cross.a)
        if wb is None:
            wb = centered_windows(cross.b)
        R = int(reseed_every)
        n_seg = -(-li // R)
        rows_rel = torch.clamp(torch.arange(n_seg, device=dev) * R,
                               max=li - 1)
        rows_abs = i0 + rows_rel
        rows_c = torch.clamp(rows_abs, max=la - 1)
        jrow = rows_abs[None, :] + ks[:, None]             # (D, S)
        jr = torch.clamp(jrow, 0, lb - 1)
        seeds = _exact_seeds(wa[rows_c].to(acc), wb[jr].to(acc))
        drift = seeds - cov[:, rows_rel]
        # segments starting outside the rectangle keep the raw cumsum
        drift = torch.where((jrow >= 0) & (jrow < lb)
                            & (rows_abs < la)[None, :], drift, 0.0)
        seg = torch.clamp(torch.arange(li, device=dev) // R, max=n_seg - 1)
        cov = cov + drift[:, seg]

    corr = cov * invni[None, :] * invnj
    keep = valid & (invni >= 0)[None, :] & (invnj >= 0)
    return torch.where(keep, corr, NEG), i, i0


def band_rowmax_ab(cross: CrossStats, k0: int, band: int, *, k_hi=None,
                   reseed_every: int | None = None, wa=None, wb=None,
                   harvest_cols: bool = True, clamp_rows: bool = True,
                   padded=None, accum_dtype=torch.float32):
    """Two-sided harvest of A vs B over signed diagonals [k0, k0 + band):
    (row_win (li,), row_idx, win (li + band,), win_i, i0). Row entry t is
    row i0 + t of A with its column in B; column entry t is B's column
    i0 + k0 + t with its row in A. `harvest_cols=False` skips the column
    window (None)."""
    corr, i, i0 = _band_corr_ab(cross, k0, band, k_hi=k_hi,
                                reseed_every=reseed_every, wa=wa, wb=wb,
                                clamp_rows=clamp_rows, padded=padded,
                                accum_dtype=accum_dtype)
    best, d_win = row_harvest(corr)
    idx = torch.where(best > NEG, i + k0 + d_win, -1).to(torch.int32)
    win = win_i = None
    if harvest_cols:
        win, win_i = _col_window(corr, NEG)
        win_i = torch.where(win > NEG, win_i + i0, -1).to(torch.int32)
    return best, idx, win, win_i, i0


def chunk_rowmax_ab(cross: CrossStats, k0: int, width_static: int, band: int,
                    reseed_every: int | None = DEFAULT_RESEED, k_hi=None,
                    two_sided: bool = True, clamp_rows: bool = True,
                    col_tile: int | None = None, accum_dtype=torch.float32):
    """(state_a (l_a,), state_b (l_b,) or None) over signed diagonals
    [k0, k0 + width_static): A's row harvest and B's column harvest, both
    merged as bounded windows into padded states. `col_tile` accumulates
    B's side in a `BankedColState` of that bank width."""
    acc = accum_dtype
    la, lb = cross.l_a, cross.l_b
    dev = cross.cov0s.device
    reseed_every = ab_reseed(la, lb, reseed_every)
    wa = centered_windows(cross.a) if reseed_every is not None else None
    wb = centered_windows(cross.b) if reseed_every is not None else None
    li = ab_row_tile(la, lb, band) if clamp_rows else la
    padded = _ab_padded_streams(cross, band, li, clamp_rows)
    pad_l = la - 1                 # most negative valid diagonal start
    rows = ColState.empty(0, la, li, dtype=acc, device=dev)
    col = None
    if two_sided:
        col = (BankedColState.empty(pad_l + lb + li + band, col_tile,
                                    li + band, dtype=acc, device=dev)
               if col_tile is not None
               else ColState.empty(pad_l, lb, li + 2 * band, dtype=acc,
                                   device=dev))
    for b in range(-(-width_static // band)):
        start = k0 + b * band
        ra, ia, win, wi, i0 = band_rowmax_ab(
            cross, start, band, k_hi=k_hi, reseed_every=reseed_every,
            wa=wa, wb=wb, harvest_cols=two_sided, clamp_rows=clamp_rows,
            padded=padded, accum_dtype=acc)
        rows.merge_window(ra, ia, i0)
        if two_sided:
            col.merge_window(win, wi, start + i0 + pad_l)
    return (rows.to_profile(0, la),
            col.to_profile(pad_l, lb) if two_sided else None)


def ab_join_from_stats(cross: CrossStats, exclusion: int = 0,
                       band: int = DEFAULT_BAND,
                       reseed_every: int | None = DEFAULT_RESEED,
                       two_sided: bool = True, clamp_rows: bool = True,
                       col_tile: int | None = None, *,
                       accum_dtype: str = "float32"):
    """Both profiles of the rectangle from one sweep: (state_a, state_b).

    `exclusion` > 0 removes the band |j - i| < exclusion (meaningful when A
    is B, where the join then equals the self-join); with 0 the signed space
    is one span. `two_sided=False` skips B's side (state_b None);
    `clamp_rows=False` sweeps every row of A for every band."""
    from repro_torch.core.precision import torch_dtype

    acc = torch_dtype(accum_dtype)
    la, lb = cross.l_a, cross.l_b
    dev = cross.cov0s.device
    excl = int(exclusion)
    state_a = ProfileState.empty(la, dtype=acc, device=dev)
    state_b = ProfileState.empty(lb, dtype=acc, device=dev) \
        if two_sided else None
    kw = dict(two_sided=two_sided, clamp_rows=clamp_rows, col_tile=col_tile,
              accum_dtype=acc)
    if excl == 0:
        spans = [(-(la - 1), la - 1 + lb, lb)]
    else:
        spans = []
        if la - excl > 0:          # diagonals [-(l_a-1), -excl]
            spans.append((-(la - 1), la - excl, -excl + 1))
        if lb - excl > 0:          # diagonals [excl, l_b)
            spans.append((excl, lb - excl, lb))
    for k0, width, k_hi in spans:
        sa, sb = chunk_rowmax_ab(cross, k0, width, band, reseed_every,
                                 k_hi=k_hi, **kw)
        state_a = state_a.merge(sa)
        if two_sided:
            state_b = state_b.merge(sb)
    return state_a, state_b


# -- entry points -------------------------------------------------------------


def matrix_profile(ts, window: int, exclusion: int | None = None,
                   band: int = DEFAULT_BAND,
                   reseed_every: int | None = DEFAULT_RESEED, *,
                   k: int = 1, harvest: str = "merged",
                   normalize: bool = True, precision=None,
                   device=None) -> "ProfileResult":
    """Full exact matrix profile -> `ProfileResult` on `device` (default
    the CUDA card; `device="cpu"` runs the kernel's plain version or the
    band engine on the host).

    `result.p` / `result.i` are the merged profile; the LEFT/RIGHT split
    (`result.left_p` / `result.right_p`, the sweep's column and row halves)
    finishes lazily from the retained halves, or eagerly with
    `harvest="both"`. `precision` (None, a preset name or a
    `PrecisionSpec`) sets the stream and accumulator dtypes. A non-default
    `band`, a `reseed_every` other than its default or None, or f64
    accumulation plans the band engine; otherwise the CUDA kernel sweeps.
    """
    from repro_torch.core import plan as plan_mod
    from repro_torch.core.result import build_result
    from repro_torch.core.validate import validate_series
    from repro_torch.core.zstats import compute_stats_host

    m = int(window)
    arr = validate_series(ts, m, require_finite=not normalize)
    plan = plan_mod.plan_sweep(m, arr.shape[0] - m + 1, exclusion=exclusion,
                               normalize=normalize, band=band,
                               reseed_every=reseed_every, k=k,
                               harvest=harvest, precision=precision,
                               device=device)
    stats = compute_stats_host(arr, m, device=plan.device,
                               **plan_mod.stats_dtypes_for(plan))
    res = plan_mod.execute(plan, stats)
    return build_result(plan, res, stats)


def ab_join(ts_a, ts_b, window: int, *, exclusion: int | None = None,
            band: int = DEFAULT_BAND,
            reseed_every: int | None = DEFAULT_RESEED,
            normalize: bool = True, return_b: bool = False,
            k: int = 1, precision=None, device=None) -> "ProfileResult":
    """AB join: for every subsequence of A, its nearest neighbour in B.

    `result.p[i]` is the distance and `result.i[i]` the matching start in
    B. With `return_b=True` B's profile against A (`result.b_p/b_i`) comes
    eagerly from the same sweep; otherwise it finishes lazily. No exclusion
    zone by default; with one, ab_join(ts, ts, m, exclusion=e) equals
    matrix_profile(ts, m, exclusion=e). The kernel sweeps the rectangle
    with its short side on rows (`swap_ab`); callers never see the
    orientation.
    """
    from repro_torch.core import plan as plan_mod
    from repro_torch.core.result import build_result
    from repro_torch.core.validate import validate_series

    m = int(window)
    a = validate_series(ts_a, m, name="ts_a", require_finite=not normalize)
    b = validate_series(ts_b, m, name="ts_b", require_finite=not normalize)
    plan = plan_mod.plan_sweep(m, a.shape[0] - m + 1, b.shape[0] - m + 1,
                               exclusion=exclusion, normalize=normalize,
                               harvest="both" if return_b else "merged",
                               band=band, reseed_every=reseed_every, k=k,
                               precision=precision, device=device)
    stats = plan_mod.cross_stats_for(plan, a, b)
    res = plan_mod.execute(plan, stats)
    return build_result(plan, res, stats)
