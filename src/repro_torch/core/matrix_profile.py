"""Exact z-normalized join: the band engine and the public entry points —
port of `repro.core.matrix_profile` (the z-normalized sweeps and the
entry layer).

`matrix_profile(ts, m)` is the self-join and `ab_join(a, b, m)` the AB
join. Each validates its series, plans a sweep (`core.plan.plan_sweep`),
builds the f64 host streams, executes the plan and wraps a
`ProfileResult`. The planner sends a k = 1 sweep to the CUDA NATSA kernel
(`kernels/csrc/natsa_mp.cu`) unless the call asks for what only the band
engine below does: a non-default `band`, `clamp_rows=False`, a reseed
period, or f64 accumulation. Top-k (k > 1) and batched sweeps run the band
engine, or rowstream for a short AB side, as the reference plans them.

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
`TopKState` widens every harvest to exact top-k sets (k > 1) off the same
tiles, with stable unions so that equal values resolve as the reference's
`lax.top_k` resolves them. The rowstream AB sweep walks A's rows instead
of diagonals; batched entry points sweep each series of a stack. The
non-normalized sweeps run the same band tiles on the raw squared-distance
recurrence, and 16-bit self-join streams on the engine take the tile
sweep: products of window tiles, no recurrence.
"""

from __future__ import annotations

import contextlib
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


@dataclasses.dataclass
class TopKState:
    """Running exact top-k profile: `(L, k)` best-first correlations and
    neighbours — the k > 1 analogue of `ProfileState` and `ColState` in one
    class. `merge` is the union of two best-first sets (exact: every sweep
    evaluates each cell once, so no neighbour is offered twice) and
    `merge_window` the same union over a window of a padded index space, in
    place. Unfilled slots are (NEG, -1); ties resolve to the accumulator
    side, so all-NEG windows merge as no-ops."""

    corr: torch.Tensor    # (L, k) accum dtype, best-first along the last axis
    index: torch.Tensor   # (L, k) int32 neighbour (or -1)

    @classmethod
    def empty(cls, l: int, k: int, fill: float = NEG, dtype=torch.float32,
              device=None) -> "TopKState":
        return cls(corr=torch.full((l, k), fill, dtype=dtype, device=device),
                   index=torch.full((l, k), -1, dtype=torch.int32,
                                    device=device))

    @classmethod
    def from_arrays(cls, corr, index, device=None) -> "TopKState":
        """Carry-over: a reference `TopKState` read out as numpy arrays,
        bits unchanged (leading batch axes allowed)."""
        from repro_torch.core.zstats import _tensor
        from repro_torch.utils.device import resolve_device

        dev = resolve_device(device)
        return cls(corr=_tensor(corr, dev), index=_tensor(index, dev))

    @property
    def k(self) -> int:
        return self.corr.shape[-1]

    def merge(self, other: "TopKState") -> "TopKState":
        return TopKState(*_topk_union(self.corr, self.index, other.corr,
                                      other.index, self.k))

    def merge_window(self, win, win_i, start: int) -> "TopKState":
        w = win.shape[0]
        s = _clamp_start(start, self.corr.shape[0], w)
        c, i = _topk_union(self.corr[s:s + w], self.index[s:s + w], win,
                           win_i, self.k)
        self.corr[s:s + w] = c
        self.index[s:s + w] = i
        return self

    def to_state(self, pad_left: int, l_out: int) -> "TopKState":
        return TopKState(corr=self.corr[pad_left:pad_left + l_out],
                         index=self.index[pad_left:pad_left + l_out])

    @property
    def best(self) -> ProfileState:
        """Slot 0: the same VALUES as the k = 1 profile (max == top-1)."""
        return ProfileState(corr=self.corr[..., 0], index=self.index[..., 0])

    def to_distance(self, window: int) -> torch.Tensor:
        return profile_distance(self.corr, window)


def _topk_union(c1, i1, c2, i2, k: int):
    """Exact best-first union of two neighbour sets along the last axis.
    A STABLE descending sort, as `lax.top_k` is stable: at equal values
    the first set (the accumulator) and then the lower slot win, on every
    device (`torch.topk` promises no order among ties)."""
    c = torch.cat([c1, c2], dim=-1)
    i = torch.cat([i1, i2], dim=-1)
    vals, pos = torch.sort(c, dim=-1, descending=True, stable=True)
    return vals[..., :k], torch.gather(i, -1, pos[..., :k])


def _topk_rows(tile: torch.Tensor, k: int):
    """Top-k of a (D, L) tile over its first axis: (L, k) best-first values
    and the offsets d attaining them (int32), equal values in ascending d —
    what the stable `lax.top_k` gives. k rounds of a max, the first d that
    attains it, and a knock-out of that cell, so the tile is OVERWRITTEN:
    callers hand over a tile they are done with. Needs k <= D (the planner
    enforces k <= band, and k <= min(l_a, l_b) for rowstream)."""
    D, L = tile.shape
    dd = torch.arange(D, dtype=torch.int32, device=tile.device)[:, None]
    vals = tile.new_empty((L, k))
    ds = torch.empty((L, k), dtype=torch.int32, device=tile.device)
    for s in range(k):
        best = tile.max(dim=0).values
        d = torch.where(tile == best, dd, D).min(dim=0).values
        vals[:, s] = best
        ds[:, s] = d
        if s + 1 < k:
            # clamped: a NaN cell matches nothing and must not index past D
            tile.scatter_(0, d.clamp(max=D - 1).long()[None, :], -torch.inf)
    return vals, ds


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
    W = corr.shape[1] + corr.shape[0]
    win, d_win = row_harvest(_skew(corr, fill))
    win_i = (torch.arange(W, device=corr.device) - d_win).to(torch.int32)
    return win, torch.where(win > fill, win_i, -1).to(torch.int32)


def _skew(corr: torch.Tensor, fill: float) -> torch.Tensor:
    """(D, li + D) skew[d, t] = corr[d, t - d] (`fill` outside), in memory
    of its own: each row padded by D + 1, flattened and re-wrapped one
    element shorter."""
    D, li = corr.shape
    p = F.pad(corr, (0, D + 1), value=fill)
    return p.reshape(-1)[:-D].reshape(D, li + D)


def _topk_col_window(corr: torch.Tensor, k: int, fill: float = NEG):
    """Top-k column-side harvest of one band tile: `_col_window`'s skew,
    then a top-k instead of a max. Returns ((li + D, k) win, win_i): entry
    t is the best-k set ENDING at column k0 + t with its rows t - d (or
    -1). `corr` is left as it was."""
    W = corr.shape[1] + corr.shape[0]
    win, d_win = _topk_rows(_skew(corr, fill), k)
    win_i = torch.arange(W, device=corr.device)[:, None] - d_win
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


def band_topk(stats: ZStats, k0: int, band: int, k: int, *,
              reseed_every: int | None = None,
              windows_c: torch.Tensor | None = None,
              accum_dtype=torch.float32):
    """`band_rowmax` widened to exact top-k: (row (l, k), row_idx, win
    (l + band, k), win_i) off the same correlation tile. Within one tile a
    position's candidates lie on distinct diagonals, so the per-tile top-k
    is exact and the union across bands stays exact."""
    l = stats.n_subsequences
    corr = _band_corr(stats, k0, band, reseed_every, windows_c, accum_dtype)
    win, win_i = _topk_col_window(corr, k)
    vals, d = _topk_rows(corr, k)                  # consumes the tile
    i = torch.arange(l, device=corr.device)
    idx = torch.where(vals > NEG, i[:, None] + k0 + d, -1).to(torch.int32)
    return vals, idx, win, win_i


def chunk_topk(stats: ZStats, k0: int, k1_static: int, band: int, k: int,
               reseed_every: int | None = DEFAULT_RESEED,
               accum_dtype=torch.float32):
    """Top-k analogue of `chunk_rowmax_split`: (right (l, k), left (l, k))
    exact best-first neighbour sets over diagonals [k0, k0 + k1_static)."""
    l = stats.n_subsequences
    dev = stats.df.device
    wc = (centered_windows(stats).to(accum_dtype)
          if reseed_every is not None else None)
    rows = TopKState.empty(l, k, dtype=accum_dtype, device=dev)
    col = TopKState.empty(2 * l + band, k, dtype=accum_dtype, device=dev)
    for b in range(-(-k1_static // band)):
        start = k0 + b * band
        rc, ri, win, wi = band_topk(stats, start, band, k,
                                    reseed_every=reseed_every, windows_c=wc,
                                    accum_dtype=accum_dtype)
        rows = rows.merge(TopKState(rc, ri))
        col.merge_window(win, wi, start)
    return rows, col.to_state(0, l)


def profile_topk_from_stats(stats: ZStats, exclusion: int,
                            band: int = DEFAULT_BAND,
                            reseed_every: int | None = DEFAULT_RESEED,
                            k: int = 4, *, accum_dtype: str = "float32"):
    """Exact top-k self-join -> (merged, right, left) `(l, k)` best-first
    sets from one sweep. Slot 0 of `merged` holds the k = 1 profile's
    values; with exclusion >= 1 (the planner refuses 0 for top-k) the row
    and column candidates are disjoint (j > i against j < i), so the union
    is exact."""
    from repro_torch.core.precision import torch_dtype

    l = stats.n_subsequences
    rows, col = chunk_topk(stats, int(exclusion), l - int(exclusion), band,
                           k, reseed_every, torch_dtype(accum_dtype))
    return rows.merge(col), rows, col


# -- reduced-precision self-join: the tile sweep --------------------------------

# Tile edge of the reduced-precision sweep: rows of A per product (any
# positive edge gives the same answer).
TILE_EDGE = 512


@contextlib.contextmanager
def _ieee_f32_matmul():
    """f32 matmuls in full f32 (no TF32) inside the block; the caller's
    setting, through either of torch's two switches, is restored after."""
    try:
        prev = torch.get_float32_matmul_precision()
    except RuntimeError:        # the caller used the per-backend switch
        mm = torch.backends.cuda.matmul
        prev_backend = mm.fp32_precision
        mm.fp32_precision = "ieee"
        try:
            yield
        finally:
            mm.fp32_precision = prev_backend
        return
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def tile_profile_from_stats(stats: ZStats, exclusion: int, *,
                            tile: int = TILE_EDGE,
                            stream_dtype: str = "bfloat16",
                            accum_dtype: str = "float32") -> SplitProfile:
    """Reduced-precision self-join sweep: QT by products of window tiles,
    no recurrence.

    The windows are centered at the stats' precision (f32), rounded ONCE to
    the 16-bit stream dtype, then upcast exactly to the accum dtype: every
    cell is one m-term dot of exact 16-bit products summed in the accum
    dtype, with TF32 off for the product (`_ieee_f32_matmul`). Its error is
    the closed-form `precision.corr_tolerance`, with no drift along a
    diagonal and no reseed (`reseed_every` does not apply).

    One `(tile, m) x (m, lp - r*tile)` product per tile row r covers the
    reference's tile pairs (r, c >= r). Its tie rule is kept bit for bit:
    inside a tile a max takes the LARGEST index; across tiles a strict `>`
    keeps the earlier tile (the row side takes the first tile attaining
    its max; the column side merges tile rows r = 0, 1, ... in order). The
    row max is the RIGHT profile, the column max the LEFT. Padding rows
    carry the invn = -1 sentinel, so they are never selected; missing-data
    and flat-window conventions are the streams'."""
    from repro_torch.core.precision import torch_dtype

    acc = torch_dtype(accum_dtype)
    sdt = torch_dtype(stream_dtype)
    m = stats.window
    l = stats.n_subsequences
    excl = int(exclusion)
    dev = stats.invn.device

    nt = -(-l // tile)
    lp = nt * tile
    wcp = torch.zeros((lp, m), dtype=acc, device=dev)
    wcp[:l] = centered_windows(stats).to(sdt)       # rounded once, upcast
    invp = torch.full((lp,), -1.0, dtype=acc, device=dev)
    invp[:l] = stats.invn.to(acc)
    rc = torch.full((lp,), NEG, dtype=acc, device=dev)
    ri = torch.full((lp,), -1, dtype=torch.int32, device=dev)
    cc, ci = rc.clone(), ri.clone()
    lt = torch.arange(tile, dtype=torch.int32, device=dev)
    with _ieee_f32_matmul():
        for r in range(nt):
            i0 = r * tile
            n_c = nt - r
            ia, ib = invp[i0:i0 + tile], invp[i0:]
            corr = wcp[i0:i0 + tile] @ wcp[i0:].T        # (tile, n_c*tile)
            corr.mul_(ia[:, None]).mul_(ib[None, :])
            corr.masked_fill_((ia < 0)[:, None] | (ib < 0)[None, :], NEG)
            # j - i < excl only in the leading columns of this tile row
            e = min(corr.shape[1], max(tile + excl - 1, 0))
            je = torch.arange(e, dtype=torch.int32, device=dev)
            corr[:, :e].masked_fill_(je[None, :] - lt[:, None] < excl, NEG)

            # row side: per-tile max, its largest in-tile index, then the
            # first tile attaining the row's max
            c3 = corr.view(tile, n_c, tile)
            tmax = c3.amax(dim=2)                             # (tile, n_c)
            targ = torch.where(c3 == tmax[..., None], lt, -1).amax(dim=2)
            best = tmax.amax(dim=1)
            first = torch.where(tmax == best[:, None],
                                torch.arange(n_c, device=dev),
                                n_c).amin(dim=1)
            j = (i0 + first * tile
                 + targ.gather(1, first[:, None]).squeeze(1))
            rc[i0:i0 + tile] = best
            ri[i0:i0 + tile] = torch.where(best > NEG, j, -1).to(torch.int32)

            # column side: max over the tile's rows, the largest row
            # attaining it, merged after the earlier tile rows
            cbest = corr.amax(dim=0)
            carg = torch.where(corr == cbest[None, :], i0 + lt[:, None],
                               -1).amax(dim=0)
            carg = torch.where(cbest > NEG, carg, -1).to(torch.int32)
            seg_c, seg_i = cc[i0:], ci[i0:]
            take = cbest > seg_c
            seg_i.copy_(torch.where(take, carg, seg_i))
            seg_c.copy_(torch.where(take, cbest, seg_c))
    rows = ProfileState(rc[:l], ri[:l])
    col = ProfileState(cc[:l], ci[:l])
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
    from repro_torch.kernels.ops import ab_spans

    acc = torch_dtype(accum_dtype)
    la, lb = cross.l_a, cross.l_b
    dev = cross.cov0s.device
    excl = int(exclusion)
    state_a = ProfileState.empty(la, dtype=acc, device=dev)
    state_b = ProfileState.empty(lb, dtype=acc, device=dev) \
        if two_sided else None
    kw = dict(two_sided=two_sided, clamp_rows=clamp_rows, col_tile=col_tile,
              accum_dtype=acc)
    for k0, k_hi in ab_spans(la, lb, excl):
        sa, sb = chunk_rowmax_ab(cross, k0, k_hi - k0, band, reseed_every,
                                 k_hi=k_hi, **kw)
        state_a = state_a.merge(sa)
        if two_sided:
            state_b = state_b.merge(sb)
    return state_a, state_b


def band_topk_ab(cross: CrossStats, k0: int, band: int, k: int, *,
                 k_hi=None, reseed_every: int | None = None, wa=None,
                 wb=None, harvest_cols: bool = True, clamp_rows: bool = True,
                 padded=None, accum_dtype=torch.float32):
    """`band_rowmax_ab` widened to exact top-k: ((li, k) row window,
    row_idx, (li + band, k) column window, win_i, i0) off the same tile."""
    corr, i, i0 = _band_corr_ab(cross, k0, band, k_hi=k_hi,
                                reseed_every=reseed_every, wa=wa, wb=wb,
                                clamp_rows=clamp_rows, padded=padded,
                                accum_dtype=accum_dtype)
    win = win_i = None
    if harvest_cols:
        win, win_i = _topk_col_window(corr, k)
        win_i = torch.where(win > NEG, win_i + i0, -1).to(torch.int32)
    vals, d = _topk_rows(corr, k)                  # consumes the tile
    idx = torch.where(vals > NEG, i[:, None] + k0 + d, -1).to(torch.int32)
    return vals, idx, win, win_i, i0


def chunk_topk_ab(cross: CrossStats, k0: int, width_static: int, band: int,
                  k: int, reseed_every: int | None = DEFAULT_RESEED,
                  k_hi=None, two_sided: bool = True,
                  accum_dtype=torch.float32):
    """Top-k analogue of `chunk_rowmax_ab`: (state_a (l_a, k), state_b
    (l_b, k) or None) over signed diagonals [k0, k0 + width_static), with
    row-clamped tiles. Both sides merge as bounded `(w, k)` windows into
    padded `TopKState`s; there is no banked top-k accumulator, so top-k
    plans accumulate flat."""
    acc = accum_dtype
    la, lb = cross.l_a, cross.l_b
    dev = cross.cov0s.device
    reseed_every = ab_reseed(la, lb, reseed_every)
    wa = centered_windows(cross.a) if reseed_every is not None else None
    wb = centered_windows(cross.b) if reseed_every is not None else None
    li = ab_row_tile(la, lb, band)
    padded = _ab_padded_streams(cross, band, li)
    pad_l = la - 1                 # most negative valid diagonal start
    rows = TopKState.empty(la + li, k, dtype=acc, device=dev)
    col = (TopKState.empty(pad_l + lb + li + 2 * band, k, dtype=acc,
                           device=dev) if two_sided else None)
    for b in range(-(-width_static // band)):
        start = k0 + b * band
        ra, ia, win, wi, i0 = band_topk_ab(
            cross, start, band, k, k_hi=k_hi, reseed_every=reseed_every,
            wa=wa, wb=wb, harvest_cols=two_sided, padded=padded,
            accum_dtype=acc)
        rows.merge_window(ra, ia, i0)
        if two_sided:
            col.merge_window(win, wi, start + i0 + pad_l)
    return (rows.to_state(0, la),
            col.to_state(pad_l, lb) if two_sided else None)


def ab_join_topk_from_stats(cross: CrossStats, exclusion: int = 0,
                            band: int = DEFAULT_BAND,
                            reseed_every: int | None = DEFAULT_RESEED,
                            two_sided: bool = True, k: int = 4, *,
                            accum_dtype: str = "float32"):
    """Exact top-k AB join: `(l_a, k)` (and `(l_b, k)` with `two_sided`)
    best-first sets from one signed-diagonal sweep, span by span
    (`ops.ab_spans`), as `ab_join_from_stats`."""
    from repro_torch.core.precision import torch_dtype
    from repro_torch.kernels.ops import ab_spans

    acc = torch_dtype(accum_dtype)
    la, lb = cross.l_a, cross.l_b
    dev = cross.cov0s.device
    state_a = TopKState.empty(la, k, dtype=acc, device=dev)
    state_b = (TopKState.empty(lb, k, dtype=acc, device=dev)
               if two_sided else None)
    for k0, k_hi in ab_spans(la, lb, int(exclusion)):
        sa, sb = chunk_topk_ab(cross, k0, k_hi - k0, band, k, reseed_every,
                               k_hi=k_hi, two_sided=two_sided,
                               accum_dtype=acc)
        state_a = state_a.merge(sa)
        if two_sided:
            state_b = state_b.merge(sb)
    return state_a, state_b


# -- rowstream AB sweep ---------------------------------------------------------
#
# The rectangle's other natural tiling: one pass over A's rows, each step a
# vectorized O(l_b) update of the carried covariance row
#     QT(i, j) = QT(i-1, j-1) + df_a[i] dg_b[j] + df_b[j] dg_a[i],
# with the j = 0 cell seeded exactly from `cov0s` (it starts diagonal -i).
# The reference's `lax.scan` is a Python loop over Python-int rows here: no
# step reads a value back to the host, so the card runs the steps as they
# are queued. The planner sends short sides (<= AB_ROWSTREAM_MAX_ROWS rows)
# here only where the CUDA kernel cannot go (k > 1, batches) or when asked.

# rows of the short side up to which the reference's planner prefers the
# row-streamed sweep
AB_ROWSTREAM_MAX_ROWS = 4096


def _rowstream_rows(cross: CrossStats, exclusion: int,
                    reseed_every: int | None, acc):
    """Yield (i, corr_i) for every row i of A: the (l_b,) correlation row,
    NEG where masked (a missing window, or |j - i| < exclusion). Rows at
    multiples of the reseed period replace the carry with exact centered
    dots, a product and a sum as in `_exact_seeds`, so no TF32 mode touches
    them; `ab_reseed` drops the period where no diagonal outruns it."""
    sa, sb = cross.a, cross.b
    la, lb = cross.l_a, cross.l_b
    excl = int(exclusion)
    R = ab_reseed(la, lb, reseed_every)
    dfa, dga, invna = (x.to(acc) for x in (sa.df, sa.dg, sa.invn))
    dfb, dgb, invnb = (x.to(acc) for x in (sb.df, sb.dg, sb.invn))
    cov0s = cross.cov0s.to(acc)
    seeds_neg = cov0s[:la].flip(0)                     # cov(i, 0)
    if R is None:
        exact = [cov0s[la - 1:]]                       # cov(0, j)
    else:
        wa = centered_windows(sa).to(acc)
        wb = centered_windows(sb).to(acc)
        exact = [(wb * wa[r]).sum(dim=-1) for r in range(0, la, int(R))]
        del wa, wb
    keep_b = invnb >= 0
    qt = None
    for i in range(la):
        if (R is None and i == 0) or (R is not None and i % R == 0):
            qt = exact[0 if R is None else i // R]
        else:
            delta = dfa[i] * dgb + dfb * dga[i]
            qt = torch.cat([seeds_neg[i:i + 1], qt[:-1] + delta[1:]])
        corr = qt * invnb * invna[i]
        # missing-data sentinel (invn < 0): masked pairs lose unconditionally
        corr = torch.where(keep_b & (invna[i] >= 0), corr, NEG)
        if excl > 0:
            corr[max(0, i - excl + 1):min(lb, i + excl)] = NEG
        yield i, corr


def ab_join_rowstream(cross: CrossStats, exclusion: int = 0,
                      reseed_every: int | None = DEFAULT_RESEED, *,
                      accum_dtype: str = "float32"):
    """Row-streamed AB join -> (state_a (l_a,), state_b (l_b,)): each row's
    max is A's profile (plain max, then the largest column attaining it),
    the running elementwise max over rows is B's (an earlier row keeps a
    tie)."""
    from repro_torch.core.precision import torch_dtype

    acc = torch_dtype(accum_dtype)
    la, lb = cross.l_a, cross.l_b
    dev = cross.cov0s.device
    jj = torch.arange(lb, device=dev)
    pa = torch.empty(la, dtype=acc, device=dev)
    ja = torch.empty(la, dtype=torch.int64, device=dev)
    pb = torch.full((lb,), NEG, dtype=acc, device=dev)
    ib = torch.full((lb,), -1, dtype=torch.int32, device=dev)
    for i, corr in _rowstream_rows(cross, exclusion, reseed_every, acc):
        take = corr > pb
        pb = torch.where(take, corr, pb)
        ib = torch.where(take, i, ib)
        mx = corr.max()
        pa[i] = mx
        ja[i] = torch.where(corr >= mx, jj, -1).max()
    ja = torch.where(pa > NEG, ja, -1).to(torch.int32)
    return ProfileState(pa, ja), ProfileState(pb, ib)


def ab_join_rowstream_topk(cross: CrossStats, exclusion: int = 0,
                           reseed_every: int | None = DEFAULT_RESEED,
                           k: int = 4, *, accum_dtype: str = "float32"):
    """Row-streamed AB join with exact top-k on both sides -> (TopKState
    (l_a, k), TopKState (l_b, k)): the same rows as `ab_join_rowstream`;
    each row keeps its k best columns (every candidate of the row is
    present) and B runs the `(l_b, k)` union with one new candidate per
    column per row."""
    from repro_torch.core.precision import torch_dtype

    acc = torch_dtype(accum_dtype)
    la, lb = cross.l_a, cross.l_b
    dev = cross.cov0s.device
    pa = torch.empty((la, k), dtype=acc, device=dev)
    ja = torch.empty((la, k), dtype=torch.int32, device=dev)
    tb = TopKState.empty(lb, k, dtype=acc, device=dev)
    for i, corr in _rowstream_rows(cross, exclusion, reseed_every, acc):
        cand_i = torch.where(corr > NEG, i, -1).to(torch.int32)
        tb = tb.merge(TopKState(corr[:, None], cand_i[:, None]))
        vals, pos = _topk_rows(corr[:, None], k)    # consumes the row
        pa[i] = vals[0]
        ja[i] = torch.where(vals[0] > NEG, pos[0], -1)
    return TopKState(pa, ja), tb


# -- non-normalized sweeps ----------------------------------------------------
#
# The same diagonal streaming with the raw squared-distance recurrence
#     D2(i+1, j+1) = D2(i, j) + (T[i+m] - T[j+m])^2 - (T[i] - T[j])^2.
# Level shifts are NOT normalized away: this is the telemetry monitor's
# distance (a z-normalized profile is blind to amplitude anomalies). States
# hold the NEGATED squared distance with -inf for "no cell yet", so every
# max-merge of the z-normalized engine applies unchanged. Raw squared
# distances have no [-1, 1] bound: the recurrence's rounding grows with the
# series' level squared, as in the reference.


def _window_sumsq(ts: torch.Tensor, m: int) -> torch.Tensor:
    """(l,) sums of squares of the length-m windows, from a cumsum."""
    csq = torch.cat([ts.new_zeros(1), torch.cumsum(ts * ts, 0)])
    return csq[m:] - csq[:-m]


def _nonnorm_self_parts(ts: torch.Tensor, m: int, band: int):
    """What every band of a nonnorm self-join shares: the windows' sums of
    squares, the first row's dots, and the series padded so every strip is
    one slice (`tsp[x] = ts[x - 1]`; pad reads are masked)."""
    from repro_torch.core.zstats import sliding_dot

    l = ts.shape[0] - m + 1
    return (_window_sumsq(ts, m), sliding_dot(ts[:m], ts),
            F.pad(ts, (1, l + band)))


def band_rowmin_nonnorm(ts: torch.Tensor, window: int, k0: int, band: int,
                        *, parts=None):
    """Nonnorm two-sided harvest of self-join diagonals [k0, k0 + band):
    (neg_d2 (l,), idx, win (l + band,), win_i) — negated so max-merges
    apply; (win, win_i) is the tile's column window (`_col_window`).
    `parts` are `_nonnorm_self_parts`, computed here when not given."""
    m = int(window)
    l = ts.shape[0] - m + 1
    dev = ts.device
    ssq, qt0, tsp = parts if parts is not None else _nonnorm_self_parts(
        ts, m, band)
    ks = k0 + torch.arange(band, device=dev)               # (D,)
    i = torch.arange(l, device=dev)
    j = i[None, :] + ks[:, None]                           # (D, l)
    valid = j < l
    kc = torch.clamp(ks, max=l - 1)
    d20 = ssq[0] + ssq[kc] - 2 * qt0[kc]                   # D2(0, k)

    W = l + band
    tim = tsp[m:m + l][None, :]                            # T[i+m-1]
    tip = tsp[:l][None, :]                                 # T[i-1]
    tjm = _unskew(tsp[k0 + m:k0 + m + W], band, l)         # T[j+m-1]
    tjp = _unskew(tsp[k0:k0 + W], band, l)                 # T[j-1]
    delta = (tim - tjm).square() - (tip - tjp).square()
    delta = torch.where(valid & (i >= 1)[None, :], delta, 0.0)
    d2 = d20[:, None] + torch.cumsum(delta, dim=1)
    neg = torch.where(valid, -torch.clamp(d2, min=0.0), -torch.inf)

    neg_best, d_win = row_harvest(neg)
    idx = torch.where(torch.isfinite(neg_best), i + k0 + d_win,
                      -1).to(torch.int32)
    win, win_i = _col_window(neg, -torch.inf)
    return neg_best, idx, win, win_i


def nonnorm_to_distance(state: ProfileState) -> torch.Tensor:
    """Finish a nonnorm state (corr = negated squared distance) to the
    Euclidean distance; inf where the side never saw a cell."""
    dist = torch.sqrt(torch.clamp(-state.corr, min=0.0))
    return torch.where(torch.isfinite(state.corr), dist, torch.inf)


def nonnorm_profile_from_ts(ts: torch.Tensor, window: int, exclusion: int,
                            band: int = DEFAULT_BAND, *,
                            accum_dtype: str = "float32") -> SplitProfile:
    """The nonnorm self-join: one two-sided sweep of diagonals k in
    [excl, l), the whole computation in `accum_dtype`. Returns states in
    negated squared distance; finish each with `nonnorm_to_distance`."""
    from repro_torch.core.precision import torch_dtype

    m = int(window)
    excl = int(exclusion)
    acc = torch_dtype(accum_dtype)
    ts = ts.to(acc)
    dev = ts.device
    l = ts.shape[0] - m + 1
    parts = _nonnorm_self_parts(ts, m, band)
    rows = ProfileState.empty(l, -torch.inf, dtype=acc, device=dev)
    col = ColState.empty(0, l, l + band, -torch.inf, dtype=acc, device=dev)
    for b in range(-(-(l - excl) // band)):
        start = excl + b * band
        rneg, ridx, win, wi = band_rowmin_nonnorm(ts, m, start, band,
                                                  parts=parts)
        rows = rows.merge(ProfileState(rneg, ridx))
        col.merge_window(win, wi, start)
    left = col.to_profile(0, l)
    return SplitProfile(merged=rows.merge(left), right=rows, left=left)


def _nonnorm_padded_series(ts_a, ts_b, band: int, li: int,
                           clamp_rows: bool = True):
    """Pad raw series so every row slice (at i0 - 1) and every strip (at
    i0 + k0 - 1 .. + m - 1 + li + band) of a band is in bounds; pad reads
    are masked before any harvest. Returns (pad_left, A padded, B padded);
    the unclamped sweep needs l_a - 1 more left slack."""
    la = ts_a.shape[0]            # >= l_a, a safe left-slack bound
    pad_left = band if clamp_rows else band + la - 1
    return (pad_left, F.pad(ts_a, (1, li + 1)),
            F.pad(ts_b, (pad_left + 1, li + 2 * band + 1)))


def band_rowmin_nonnorm_ab(ts_a: torch.Tensor, ts_b: torch.Tensor,
                           d20s: torch.Tensor, window: int, k0: int,
                           band: int, k_hi=None, harvest_cols: bool = True,
                           clamp_rows: bool = True, padded=None):
    """Nonnorm AB harvest over signed diagonals [k0, k0 + band). `d20s`
    are the seed squared distances at each diagonal's first cell (index
    k + l_a - 1). Returns (neg_d2 (li,), idx, win (li + band,), win_i, i0):
    A's row window over rows [i0, i0 + li) and B's column window of the
    same row-clamped tile (None with `harvest_cols=False`)."""
    m = int(window)
    la, lb = ts_a.shape[0] - m + 1, ts_b.shape[0] - m + 1
    dev = ts_a.device
    li = ab_row_tile(la, lb, band) if clamp_rows else la
    i0 = max(0, -(k0 + band - 1)) if clamp_rows else 0
    if padded is None:
        padded = _nonnorm_padded_series(ts_a, ts_b, band, li, clamp_rows)
    pad_left, tsa_p, tsb_p = padded

    ks = k0 + torch.arange(band, device=dev)               # (D,) signed
    i = i0 + torch.arange(li, device=dev)                  # (li,)
    j = i[None, :] + ks[:, None]                           # (D, li)
    valid = (j >= 0) & (j < lb) & (i < la)[None, :]
    if k_hi is not None:
        valid = valid & (ks < k_hi)[:, None]
    d20 = d20s[torch.clamp(ks + la - 1, 0, la + lb - 2)]

    def arow(offset):                                      # (li,) of A
        s = _clamp_start(i0 + 1 + offset, tsa_p.shape[0], li)
        return tsa_p[s:s + li]

    W = li + band

    def bstrips(offset):                                   # (D, li) of B
        s = _clamp_start(i0 + k0 + pad_left + 1 + offset, tsb_p.shape[0], W)
        return _unskew(tsb_p[s:s + W], band, li)

    tim, tip = arow(m - 1)[None, :], arow(-1)[None, :]     # A[i+m-1], A[i-1]
    tjm, tjp = bstrips(m - 1), bstrips(-1)                 # B[j+m-1], B[j-1]
    delta = (tim - tjm).square() - (tip - tjp).square()
    delta = torch.where(valid & (i >= 1)[None, :] & (j >= 1), delta, 0.0)
    d2 = d20[:, None] + torch.cumsum(delta, dim=1)
    neg = torch.where(valid, -torch.clamp(d2, min=0.0), -torch.inf)

    neg_best, d_win = row_harvest(neg)
    idx = torch.where(torch.isfinite(neg_best), i + k0 + d_win,
                      -1).to(torch.int32)
    win = win_i = None
    if harvest_cols:
        win, win_i = _col_window(neg, -torch.inf)
        win_i = torch.where(torch.isfinite(win), win_i + i0,
                            -1).to(torch.int32)
    return neg_best.float(), idx, win, win_i, i0


def ab_join_nonnorm(ts_a: torch.Tensor, ts_b: torch.Tensor, window: int,
                    exclusion: int = 0, band: int = DEFAULT_BAND, *,
                    two_sided: bool = True, clamp_rows: bool = True):
    """Exact nonnorm AB join -> (dist_a (l_a,), idx_a, dist_b (l_b,),
    idx_b), both sides from one signed-diagonal sweep in f32 (dist_b /
    idx_b None with `two_sided=False`, which skips the column harvest).
    The row clamp is the z-normalized engine's (`clamp_rows=False` sweeps
    every row of A); with exclusion 0 the signed space is one span."""
    from repro_torch.core.zstats import sliding_dot
    from repro_torch.kernels.ops import ab_spans

    m = int(window)
    ts_a = torch.as_tensor(ts_a, dtype=torch.float32)
    ts_b = torch.as_tensor(ts_b, dtype=torch.float32, device=ts_a.device)
    dev = ts_a.device
    # distances are invariant under a COMMON shift of both series; removing
    # the shared level keeps the f32 seeds (ssq + ssq - 2 qt) conditioned on
    # offset-heavy data (a shift per series would change the answer)
    c = 0.5 * (ts_a.mean() + ts_b.mean())
    ts_a = ts_a - c
    ts_b = ts_b - c
    la, lb = ts_a.shape[0] - m + 1, ts_b.shape[0] - m + 1
    ssq_a, ssq_b = _window_sumsq(ts_a, m), _window_sumsq(ts_b, m)
    qt_pos = sliding_dot(ts_a[:m], ts_b)                   # <A_0, B_k>
    qt_neg = sliding_dot(ts_b[:m], ts_a)                   # <A_i, B_0>
    d20_pos = ssq_a[0] + ssq_b - 2.0 * qt_pos              # k >= 0 seeds
    d20_neg = ssq_a[1:] + ssq_b[0] - 2.0 * qt_neg[1:]      # k = -1 .. -(la-1)
    d20s = torch.cat([d20_neg.flip(0), d20_pos])

    pad_l = la - 1
    li = ab_row_tile(la, lb, band) if clamp_rows else la
    padded = _nonnorm_padded_series(ts_a, ts_b, band, li, clamp_rows)
    merged_a = ProfileState.empty(la, -torch.inf, device=dev)
    merged_b = (ProfileState.empty(lb, -torch.inf, device=dev)
                if two_sided else None)
    for k_lo, k_hi in ab_spans(la, lb, int(exclusion)):
        rows = ColState.empty(0, la, li, -torch.inf, device=dev)
        col = (ColState.empty(pad_l, lb, li + 2 * band, -torch.inf,
                              device=dev) if two_sided else None)
        for b in range(-(-(k_hi - k_lo) // band)):
            start = k_lo + b * band
            ra, ia, win, wi, i0 = band_rowmin_nonnorm_ab(
                ts_a, ts_b, d20s, m, start, band, k_hi=k_hi,
                harvest_cols=two_sided, clamp_rows=clamp_rows, padded=padded)
            rows.merge_window(ra, ia, i0)
            if two_sided:
                col.merge_window(win, wi, start + i0 + pad_l)
        merged_a = merged_a.merge(rows.to_profile(0, la))
        if two_sided:
            merged_b = merged_b.merge(col.to_profile(pad_l, lb))

    da = nonnorm_to_distance(merged_a)
    if not two_sided:
        return da, merged_a.index, None, None
    return da, merged_a.index, nonnorm_to_distance(merged_b), merged_b.index


# -- entry points -------------------------------------------------------------


def matrix_profile(ts, window: int, exclusion: int | None = None,
                   band: int = DEFAULT_BAND,
                   reseed_every: int | None = DEFAULT_RESEED, *,
                   k: int = 1, harvest: str = "merged",
                   normalize: bool = True, precision=None,
                   backend: str | None = None,
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
    `k > 1` adds exact `(l, k)` top-k sets (`result.topk_p/topk_i`) from
    the band engine, whatever the other options. `backend` forces a sweep
    ("kernel" or "engine"); 16-bit streams on the engine take the tile
    sweep (`tile_profile_from_stats`).

    `normalize=False` gives raw Euclidean distances from the nonnorm band
    engine: finite samples only, k = 1, `reseed_every` ignored (its
    recurrence has no reseed).
    """
    from repro_torch.core import plan as plan_mod
    from repro_torch.core.result import build_result
    from repro_torch.core.validate import validate_series
    from repro_torch.core.zstats import compute_stats_host

    m = int(window)
    if not normalize and k != 1:
        raise ValueError(f"normalize=False supports only k=1, got k={k}")
    arr = validate_series(ts, m, require_finite=not normalize)
    # the nonnorm recurrence has no reseed: its plan keeps the default
    plan = plan_mod.plan_sweep(m, arr.shape[0] - m + 1, exclusion=exclusion,
                               normalize=normalize, band=band,
                               reseed_every=(reseed_every if normalize
                                             else DEFAULT_RESEED),
                               k=k, harvest=harvest, backend=backend,
                               precision=precision, device=device)
    if normalize:
        stats = compute_stats_host(arr, m, device=plan.device,
                                   **plan_mod.stats_dtypes_for(plan))
    else:
        stats = plan_mod.raw_series(plan, arr)
    res = plan_mod.execute(plan, stats)
    return build_result(plan, res, stats)


def ab_join(ts_a, ts_b, window: int, *, exclusion: int | None = None,
            band: int = DEFAULT_BAND,
            reseed_every: int | None = DEFAULT_RESEED,
            normalize: bool = True, return_b: bool = False,
            k: int = 1, backend: str | None = None, precision=None,
            device=None) -> "ProfileResult":
    """AB join: for every subsequence of A, its nearest neighbour in B.

    `result.p[i]` is the distance and `result.i[i]` the matching start in
    B. With `return_b=True` B's profile against A (`result.b_p/b_i`) comes
    eagerly from the same sweep; otherwise it finishes lazily. No exclusion
    zone by default; with one, ab_join(ts, ts, m, exclusion=e) equals
    matrix_profile(ts, m, exclusion=e). The kernel sweeps the rectangle
    with its short side on rows (`swap_ab`); callers never see the
    orientation. `k > 1` adds exact top-k sets (`result.topk_p`, and
    `result.b_topk_p` with `return_b`), swept by rowstream when the short
    side has at most AB_ROWSTREAM_MAX_ROWS rows, else by the band engine.
    `backend` forces a sweep ("kernel", "engine" or "rowstream").
    `normalize=False` runs the nonnorm AB engine on the raw series (finite
    samples only, f32).
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
                               backend=backend, precision=precision,
                               device=device)
    stats = (plan_mod.cross_stats_for(plan, a, b) if normalize
             else (plan_mod.raw_series(plan, a), plan_mod.raw_series(plan, b)))
    res = plan_mod.execute(plan, stats)
    return build_result(plan, res, stats)


def batch_profile(series, window: int, *, exclusion: int | None = None,
                  band: int = DEFAULT_BAND,
                  reseed_every: int | None = DEFAULT_RESEED,
                  k: int = 1, harvest: str = "merged", precision=None,
                  device=None) -> "ProfileResult":
    """Self-join profiles of a (B, n) stack -> one `ProfileResult` whose
    every field is stacked (B, l[, k]). The planner runs the band engine;
    each series is swept as its unbatched plan would be (the reference
    vmaps one program), so row r equals that plan on series r bit for
    bit."""
    import numpy as np

    from repro_torch.core import plan as plan_mod
    from repro_torch.core.result import build_result
    from repro_torch.core.validate import validate_series
    from repro_torch.core.zstats import compute_stats_host, stack_stats

    arr = np.asarray(series)
    if arr.ndim != 2 or arr.shape[0] == 0:
        raise ValueError(f"expected a non-empty (batch, n) stack, got "
                         f"shape {arr.shape}")
    m = int(window)
    # rows share dtype and length, so validating one validates the stack
    validate_series(arr[0], m, name="series[0]")
    plan = plan_mod.plan_sweep(m, arr.shape[1] - m + 1, exclusion=exclusion,
                               band=band, reseed_every=reseed_every,
                               batch=arr.shape[0], k=k, harvest=harvest,
                               precision=precision, device=device)
    dt_kw = plan_mod.stats_dtypes_for(plan)
    stack = stack_stats([compute_stats_host(s, m, device=plan.device,
                                            **dt_kw) for s in arr])
    res = plan_mod.execute(plan, stack)
    return build_result(plan, res, stack)


def batch_ab_join(stack_a, stack_b, window: int, *,
                  exclusion: int | None = None, band: int = DEFAULT_BAND,
                  reseed_every: int | None = DEFAULT_RESEED,
                  return_b: bool = False, k: int = 1,
                  backend: str | None = None, precision=None,
                  device=None) -> "ProfileResult":
    """AB joins of row r of (B, n_a) against row r of (B, n_b) -> a stacked
    `ProfileResult` (with `return_b`, the (B, l_b) B sides ride along).
    The planner runs the band engine unless `backend="rowstream"`; each
    pair is swept as its unbatched plan would be."""
    import numpy as np

    from repro_torch.core import plan as plan_mod
    from repro_torch.core.result import build_result
    from repro_torch.core.validate import validate_series
    from repro_torch.core.zstats import stack_stats

    a, b = np.asarray(stack_a), np.asarray(stack_b)
    if (a.ndim != 2 or b.ndim != 2 or a.shape[0] != b.shape[0]
            or a.shape[0] == 0):
        raise ValueError(f"expected matching non-empty (batch, n) stacks, "
                         f"got {a.shape} vs {b.shape}")
    m = int(window)
    validate_series(a[0], m, name="stack_a[0]")
    validate_series(b[0], m, name="stack_b[0]")
    plan = plan_mod.plan_sweep(m, a.shape[1] - m + 1, b.shape[1] - m + 1,
                               exclusion=exclusion, band=band,
                               reseed_every=reseed_every,
                               harvest="both" if return_b else "merged",
                               batch=a.shape[0], k=k, backend=backend,
                               precision=precision, device=device)
    stack = stack_stats([plan_mod.cross_stats_for(plan, ra, rb)
                         for ra, rb in zip(a, b)])
    res = plan_mod.execute(plan, stack)
    return build_result(plan, res, stack)


def top_discords(profile: torch.Tensor, index: torch.Tensor, k: int,
                 exclusion: int) -> torch.Tensor:
    """Indices of the k largest profile entries, greedily non-overlapping
    (each pick masks `exclusion` positions on either side)."""
    del index
    p = torch.where(torch.isfinite(profile), profile, -torch.inf)
    pos = torch.arange(p.shape[0], device=p.device)
    picks = []
    for _ in range(k):
        i = torch.argmax(p)                  # the first largest
        picks.append(i)
        lo = torch.clamp(i - exclusion, min=0)
        p = torch.where((pos >= lo) & (pos < lo + 2 * exclusion + 1),
                        -torch.inf, p)
    return torch.stack(picks)


def top_motif(profile: torch.Tensor, index: torch.Tensor):
    """(i, j) of the best-matching pair: the profile's global minimum (the
    first one) and its neighbour."""
    i = torch.argmin(profile)
    return i, index[i]
