"""Incremental (streaming) exact matrix profile — port of
`repro.core.streaming` (STAMPI-style appends).

A batch sweep costs O(n^2); a telemetry monitor wants O(n·m) per appended
point. Each new subsequence adds one ROW of the implicit distance matrix,
which (a) sets the new subsequence's own entry and (b) can only LOWER
existing entries.

`append(values)` evaluates all p new rows as ONE (p, l) block through the
shared f64 block kernels (`zstats.centered_block`, `sqdist_*_from_parts`),
the op sequence the fleet will share: a product and a fixed-order sum, no
matmul, so every output element's bits depend only on its own pair of
windows, whatever the block's shape. The block is evaluated in row chunks
under `BLOCK_ELEMENTS` (a bulk append would otherwise materialize a
(p, l, m) product); chunking, and appending point by point, change no
bit.

State lives on the profile's device, in f64: the series, the squared
distances and the indices, and the left/right split kept incrementally.
Both z-normalized and raw distances stream, so the monitor can run either
mode. `query` scores a query against the series so far through the sweep
planner, with the corpus side cached (`core.resident.ReferenceCache`).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.utils.device import resolve_device


def _host_f64(values) -> np.ndarray:
    """Values (scalar, sequence, array or tensor on any device) as a 1-D
    host f64 array."""
    if isinstance(values, torch.Tensor):
        values = values.detach().to("cpu", torch.float64).numpy()
    return np.atleast_1d(np.asarray(values, np.float64))


class StreamingProfile:
    """Append-only exact matrix profile over a growing series."""

    # LRU bounds of query()'s resident-corpus cache: how many corpus
    # contents/modes stay resident, and how many query-shape plans.
    REF_CACHE_MAX = 4
    PLAN_CACHE_MAX = 8
    # elements of the (rows, l, m) f64 product one block chunk may hold
    # (512 MiB)
    BLOCK_ELEMENTS = 1 << 26

    def __init__(self, window: int, exclusion: int | None = None,
                 normalize: bool = True, max_points: int | None = None, *,
                 device=None):
        from repro_torch.core.resident import ReferenceCache

        if int(window) < 2:
            raise ValueError(f"window must be >= 2, got {window}")
        self.m = int(window)
        self.excl = max(1, self.m // 4) if exclusion is None else int(exclusion)
        self.normalize = normalize
        self.max_points = max_points
        self.device = resolve_device(device)
        f64 = dict(dtype=torch.float64, device=self.device)
        i64 = dict(dtype=torch.int64, device=self.device)
        self._ts = torch.zeros(0, **f64)
        self._profile = torch.zeros(0, **f64)          # squared distance
        self._index = torch.zeros(0, **i64)
        # the split, kept incrementally: a new subsequence's row-min over
        # earlier columns IS its left entry (final); column-min improvements
        # are right-side by construction
        self._left_profile = torch.zeros(0, **f64)
        self._left_index = torch.zeros(0, **i64)
        self._right_profile = torch.zeros(0, **f64)
        self._right_index = torch.zeros(0, **i64)
        # bumped on EVERY series mutation, so a cached corpus side can never
        # outlive a content change that keeps the length (see _ref_side)
        self._gen = 0
        self._refs = ReferenceCache(self.m, side_max=self.REF_CACHE_MAX,
                                    plan_max=self.PLAN_CACHE_MAX,
                                    device=self.device)

    # -- internals -----------------------------------------------------------

    def _windows(self) -> torch.Tensor:
        """(l, m) view of the series' windows."""
        return self._ts.unfold(0, self.m, 1)

    def _sqdist_rows(self, wa: torch.Tensor, wb: torch.Tensor) -> torch.Tensor:
        """Squared distances between window matrices, (p, m) x (q, m) ->
        (p, q), through the shared block kernels, in row chunks of at most
        `BLOCK_ELEMENTS` product elements."""
        from repro_torch.core import zstats

        p, q = wa.shape[0], wb.shape[0]
        out = torch.empty((p, q), dtype=torch.float64, device=wa.device)
        if p == 0 or q == 0:
            return out
        rows = max(1, self.BLOCK_ELEMENTS // (q * self.m))
        if self.normalize:
            ac, an = zstats.centered_block(wa)
            bc, bn = zstats.centered_block(wb)
            for s in range(0, p, rows):
                out[s:s + rows] = zstats.sqdist_znorm_from_parts(
                    ac[s:s + rows], an[s:s + rows], bc, bn, window=self.m)
        else:
            sa, sb = zstats.window_sumsq(wa), zstats.window_sumsq(wb)
            for s in range(0, p, rows):
                out[s:s + rows] = zstats.sqdist_nonnorm_from_parts(
                    wa[s:s + rows], sa[s:s + rows], wb, sb)
        return out

    # -- public ---------------------------------------------------------------

    def append(self, values) -> None:
        """Append point(s) and update the exact profile.

        All new subsequences are one (p, l) block: new entry j takes its
        row-min over columns [0, j - excl] (earlier rows of the same batch
        included), existing entries take the block's column-min — the
        sequential per-point result, whatever the batch sizes."""
        from repro_torch.core.zstats import window_finite_mask

        vals = _host_f64(values)
        if vals.ndim != 1:
            raise ValueError(f"append expects scalar or 1-D values, got "
                             f"shape {vals.shape}")
        if vals.size == 0:
            return
        n_old = self._ts.shape[0]
        if self.max_points and n_old + vals.size > self.max_points:
            raise ValueError("max_points exceeded; start a new profile")
        l_old = self._profile.shape[0]
        self._ts = torch.cat([self._ts, torch.from_numpy(vals).to(
            self.device)])
        self._gen += 1                  # series content changed
        l_new = self._ts.shape[0] - self.m + 1
        if l_new <= max(l_old, 0):
            return                       # no new complete window yet
        p = l_new - l_old
        dev = self.device
        w = self._windows().contiguous()        # (l_new, m), built once
        d2 = self._sqdist_rows(w[l_old:], w)              # (p, l_new)
        # pair (i, j = l_old + r) is admissible iff i <= j - excl
        jj = (l_old + torch.arange(p, device=dev))[:, None]
        admissible = torch.arange(l_new, device=dev)[None, :] <= jj - self.excl
        d2 = torch.where(admissible, d2, torch.inf)
        # missing data (the streams' invn < 0 sentinel): a window touching a
        # NaN/Inf sample is masked, its entry stays inf/-1 and it is never a
        # neighbour; NaNs from the block are overwritten here
        ok = window_finite_mask(w)                        # (l_new,)
        if not bool(ok.all()):
            d2 = torch.where(ok[l_old:, None] & ok[None, :], d2, torch.inf)

        def grow(dist, idx):
            return (torch.cat([dist, torch.full((p,), torch.inf,
                                                dtype=dist.dtype, device=dev)]),
                    torch.cat([idx, torch.full((p,), -1, dtype=idx.dtype,
                                               device=dev)]))

        self._profile, self._index = grow(self._profile, self._index)
        self._left_profile, self._left_index = grow(self._left_profile,
                                                    self._left_index)
        self._right_profile, self._right_index = grow(self._right_profile,
                                                      self._right_index)
        # row mins -> the new subsequences' own entries; every admissible
        # column precedes the row, so each is the LEFT entry, and final
        row_best = torch.argmin(d2, dim=1)                # (p,), first min
        row_vals = d2.gather(1, row_best[:, None]).squeeze(1)
        has = torch.isfinite(row_vals)
        for dist, idx in ((self._profile, self._index),
                          (self._left_profile, self._left_index)):
            dist[l_old:] = torch.where(has, row_vals, dist[l_old:])
            idx[l_old:] = torch.where(has, row_best, idx[l_old:])
        # column mins -> existing entries (and earlier rows of this batch)
        # improve; the improving row always FOLLOWS the column, so these are
        # right-side updates
        col_best = torch.argmin(d2, dim=0)                # (l_new,)
        col_vals = d2.gather(0, col_best[None, :]).squeeze(0)
        for dist, idx in ((self._profile, self._index),
                          (self._right_profile, self._right_index)):
            upd = col_vals < dist[:l_new]
            dist[:l_new] = torch.where(upd, col_vals, dist[:l_new])
            idx[:l_new] = torch.where(upd, l_old + col_best, idx[:l_new])

    def _ref_side(self):
        """The corpus side, invariant between appends, from the shared
        `ReferenceCache` keyed by the append generation AND the distance
        mode (not the length: a content change that keeps the length must
        never serve stale streams; a `normalize` flip must not serve the
        other mode's side)."""
        from repro_torch.core.resident import build_side

        norm = self.normalize
        return self._refs.side(
            (self._gen, norm),
            lambda: build_side(self._ts.cpu().numpy(), self.m,
                               normalize=norm, device=self.device))

    def query(self, values):
        """Score a query series against the corpus appended so far, WITHOUT
        appending it: an AB `SweepPlan` with the streaming state as the
        resident B side, run by the plan executor (so the distances follow
        the sweeps' own conventions).

        Returns a `ProfileResult` of f64/int64 tensors on the profile's
        device: for each of the query's l_q = len(q) - m + 1 subsequences,
        `p` is its distance to the nearest corpus subsequence and `i` that
        subsequence's start. No exclusion: query and corpus are different
        series."""
        from repro_torch.core import plan as plan_mod
        from repro_torch.core.result import ProfileResult

        q = _host_f64(values)
        if q.ndim != 1 or q.shape[0] < self.m:
            raise ValueError(f"query must be 1-D with >= {self.m} points, "
                             f"got shape {q.shape}")
        if self._ts.shape[0] < self.m:
            raise ValueError("reference corpus has no complete window yet")
        lq = q.shape[0] - self.m + 1
        side = self._ref_side()
        plan = self._refs.plan_for(side, lq)
        stats = plan_mod.resident_stats(plan, q, side)
        res = plan_mod.execute(plan, stats)
        return ProfileResult(p=res.dist.to(torch.float64),
                             i=res.index.to(torch.int64),
                             kind="ab", window=self.m, exclusion=0,
                             normalize=self.normalize,
                             backend=plan.backend)

    @property
    def n_subsequences(self) -> int:
        return self._profile.shape[0]

    def snapshot(self):
        """The profile so far as a `ProfileResult`: merged AND the
        left/right split, straight off the incremental state (distances
        sqrt'd on the way out; masked entries stay inf/-1). Each call
        returns tensors of its own: later appends never change a snapshot
        already taken."""
        from repro_torch.core.result import ProfileResult
        from repro_torch.core.zstats import sqdist_to_dist as _d

        return ProfileResult(
            p=_d(self._profile), i=self._index.clone(),
            left_p=_d(self._left_profile), left_i=self._left_index.clone(),
            right_p=_d(self._right_profile),
            right_i=self._right_index.clone(),
            kind="self", window=self.m, exclusion=self.excl,
            normalize=self.normalize, backend="streaming")

    @property
    def result(self):
        """Alias for `snapshot()`."""
        return self.snapshot()
