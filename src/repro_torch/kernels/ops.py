"""Host halves of the NATSA kernel backend — port of `repro.kernels.ops`.

Pipeline (the paper's Fig. 1 dataflow):
  1. host-side f64 stream prep (`core.zstats.compute_stats_host`);
  2. pad the streams exactly as the reference does, so both packages hand
     their kernels identical arrays;
  3. ONE kernel launch per diagonal span -> both profile sides;
  4. merge the sides in correlation space (the plan converts to distance).

A span may be a whole sweep or one chunk of the anytime scheduler's
rounds (`rowmax_chunk`, `ab_rowmax_chunk`: signed diagonals [k0, k1)); an
empty chunk launches nothing.

The sweep's roofline (`hbm_bytes_per_cell`, `kernel_roofline`) keeps the
reference's byte formulas and divides by the H100's rates
(`launch.roofline`); `kernel_vmem_bytes`, the TPU VMEM model, has no
counterpart (ROADMAP.md §C (23)).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.zstats import CrossStats, ZStats
from repro_torch.kernels import DEFAULT_DT, DEFAULT_IT, natsa_mp
from repro_torch.utils import trace

NEG = natsa_mp.NEG


def _pad(x: torch.Tensor, before: int, after: int) -> torch.Tensor:
    """Zero-pad a 1-D tensor, keeping its dtype and device."""
    parts = [x]
    if before:
        parts.insert(0, x.new_zeros(before))
    if after:
        parts.append(x.new_zeros(after))
    return torch.cat(parts) if len(parts) > 1 else x.contiguous()


def _kernel_stream(x: torch.Tensor) -> torch.Tensor:
    """The kernel reads f32/bf16/f16 streams: f64 streams (a plan with
    stream="float64" and f32 accumulation) are rounded to f32 once, here,
    as the reference's kernel rounds them on load. The plain version gets
    the same f32 streams."""
    return x.float() if x.dtype == torch.float64 else x


def _pad_streams(stats: ZStats, it: int, dt: int, excl: int,
                 k_end: int | None = None):
    """Pad streams for diagonals [excl, k_end) (default: to l); returns
    (df, dg, invn, cov0p, n_rows, n_diags, l)."""
    l = stats.n_subsequences
    k_end = l if k_end is None else k_end
    n_rows = -(-l // it)
    n_diag_total = max(k_end - excl, 1)
    n_diags = -(-n_diag_total // dt)
    pad = n_rows * it + excl + n_diags * dt - l
    with trace.span("repro_torch.kernels.pad"):
        # seeds feed the f32 covariance carry directly, whatever the
        # streams' dtype
        cov0p = _pad(stats.cov0.float()[excl:k_end], 0,
                     n_diags * dt - n_diag_total)
        df, dg, invn = (_pad(_kernel_stream(x), 0, pad)
                        for x in (stats.df, stats.dg, stats.invn))
    return df, dg, invn, cov0p, n_rows, n_diags, l


# Column accumulators below this flat length fit one TPU VMEM block; kept so
# the port resolves `SweepPlan.col_tile` exactly as the reference does.
AUTO_COL_BANK_MIN = 8192


def auto_col_tile(col_len: int, it: int, dt: int,
                  col_tile: int | None) -> int | None:
    """The reference's col_tile policy: None = auto (bank long spaces into
    max(4096, 2*(it+dt)) blocks rounded up to 128), 0 = one full-length
    bank, any other int = explicit width. The CUDA kernel accumulates flat
    and never reads the result; it exists so plans compare field by field."""
    if col_tile == 0:
        return None
    if col_tile is not None:
        return int(col_tile)
    if col_len <= AUTO_COL_BANK_MIN:
        return None
    return -(-max(4096, 2 * (it + dt)) // 128) * 128


def rowmax_from_stats(stats: ZStats, *, excl: int, it: int = DEFAULT_IT,
                      dt: int = DEFAULT_DT):
    """Two-sided self-join harvest via ONE kernel launch: (corr (l,), idx,
    col_corr (l,), col_idx) — the row half (j > i) and the column half
    (j < i) of the same swept cells."""
    return rowmax_chunk(stats, excl, stats.n_subsequences, it=it, dt=dt)


def _empty_sides(l_rows: int, l_cols: int, device):
    """(NEG, -1) row and column sides: an empty chunk's harvest."""
    def side(n):
        return (torch.full((n,), NEG, dtype=torch.float32, device=device),
                torch.full((n,), -1, dtype=torch.int32, device=device))

    return (*side(l_rows), *side(l_cols))


def rowmax_chunk(stats: ZStats, k0: int, k1: int, *, it: int = DEFAULT_IT,
                 dt: int = DEFAULT_DT):
    """`rowmax_from_stats` over the self-join diagonals [k0, k1) only: one
    launch sized to the chunk, (corr (l,), idx, col_corr (l,), col_idx).
    An empty chunk (k1 <= k0) returns (NEG, -1) sides and launches
    nothing. A diagonal's cells do not depend on the span it is swept in,
    so chunks covering [excl, l) give one launch's correlations bit for
    bit."""
    l = stats.n_subsequences
    if k1 <= k0:
        return _empty_sides(l, l, stats.df.device)
    df, dg, invn, cov0p, _, _, _ = _pad_streams(stats, it, dt, k0, k1)
    corr, idx, colc, coli = natsa_mp.rowmax_profile(
        df, dg, invn, cov0p, excl=k0, l=l, it=it, k_end=k1)
    return corr[:l], idx[:l], colc[:l], coli[:l]


def _merge_corr(corr_a, idx_a, corr_b, idx_b):
    take = corr_b > corr_a
    return (torch.where(take, corr_b, corr_a),
            torch.where(take, idx_b, idx_a).to(torch.int32))


def natsa_matrix_profile(ts, window: int, *, exclusion: int | None = None,
                         device=None, k: int = 1, harvest: str = "merged",
                         precision=None):
    """Full matrix profile -> `ProfileResult`: `core.matrix_profile`
    itself, whose planner picks the kernel backend by default."""
    from repro_torch.core.matrix_profile import matrix_profile

    return matrix_profile(ts, window, exclusion, k=k, harvest=harvest,
                          precision=precision, device=device)


# -- AB join through the kernel ----------------------------------------------


def _pad_streams_ab(cross: CrossStats, it: int, dt: int, s0: int, s1: int):
    """Pad A-side row streams and zero-prepad B-side streams for the signed
    diagonal span [s0, s1). Returns the seven kernel inputs plus
    (n_rows, n_diags, jpad)."""
    la, lb = cross.l_a, cross.l_b
    n_rows = -(-la // it)
    n_total = max(s1 - s0, 1)
    n_diags = -(-n_total // dt)
    jpad = max(0, -s0)
    rows_len = n_rows * it
    # padded_j[p] = stream_b[p - jpad]: the prepad makes a negative
    # diagonal's deltas before its first cell zero
    jlen = max(rows_len + s0 + n_diags * dt + jpad, jpad + lb)
    back = max(jlen - jpad - lb, 0)
    u = np.clip(np.arange(s0, s0 + n_diags * dt) + la - 1, 0, la + lb - 2)
    cov0p = cross.cov0s.float()[torch.from_numpy(u).to(cross.cov0s.device)]
    a, b = cross.a, cross.b
    return (*(_pad(_kernel_stream(x), 0, rows_len - la)
              for x in (a.df, a.dg, a.invn)),
            *(_pad(_kernel_stream(x), jpad, back)
              for x in (b.df, b.dg, b.invn)),
            cov0p, n_rows, n_diags, jpad)


def ab_spans(la: int, lb: int, exclusion: int) -> list[tuple[int, int]]:
    """Signed diagonal spans of an AB sweep: the whole [-(la-1), lb) with
    no exclusion, else the negative and positive spans around the band."""
    excl = int(exclusion)
    if excl == 0:
        return [(-(la - 1), lb)]
    spans = []
    if la - excl > 0:
        spans.append((-(la - 1), -excl + 1))
    if lb - excl > 0:
        spans.append((excl, lb))
    return spans


def ab_rowmax_from_stats(cross: CrossStats, *, exclusion: int = 0,
                         it: int = DEFAULT_IT, dt: int = DEFAULT_DT):
    """Two-sided AB harvest: one launch per span (`ab_spans`). Returns
    (corr_a (l_a,), idx_a, corr_b (l_b,), idx_b) — A's profile over B and
    B's over A, from the same sweep."""
    la, lb = cross.l_a, cross.l_b
    corr, idx, corr_b, idx_b = _empty_sides(la, lb, cross.cov0s.device)
    for s0, s1 in ab_spans(la, lb, exclusion):
        c, ix, cc, ci = ab_rowmax_chunk(cross, s0, s1, it=it, dt=dt)
        corr, idx = _merge_corr(corr, idx, c, ix)
        corr_b, idx_b = _merge_corr(corr_b, idx_b, cc, ci)
    return corr, idx, corr_b, idx_b


def ab_rowmax_chunk(cross: CrossStats, k0: int, k1: int, *,
                    it: int = DEFAULT_IT, dt: int = DEFAULT_DT):
    """Both AB sides over the signed diagonals [k0, k1) in ONE launch, in
    the orientation `cross` is built in: (corr_a (l_a,), idx_a, corr_b
    (l_b,), idx_b). An empty chunk (k1 <= k0) returns (NEG, -1) sides and
    launches nothing."""
    la, lb = cross.l_a, cross.l_b
    if k1 <= k0:
        return _empty_sides(la, lb, cross.cov0s.device)
    (df_i, dg_i, invn_i, df_j, dg_j, invn_j, cov0p,
     _, _, jpad) = _pad_streams_ab(cross, it, dt, k0, k1)
    c, ix, cc, ci = natsa_mp.rowmax_profile_ab(
        df_i, dg_i, invn_i, df_j, dg_j, invn_j, cov0p,
        k_start=k0, k_end=k1, l_i=la, l_j=lb, jpad=jpad)
    return c[:la], ix[:la], cc[jpad:jpad + lb], ci[jpad:jpad + lb]


def natsa_ab_join(ts_a, ts_b, window: int, *, exclusion: int | None = None,
                  device=None, return_b: bool = False, k: int = 1,
                  precision=None):
    """AB join -> `ProfileResult`: `core.matrix_profile.ab_join` itself,
    whose planner picks the kernel backend by default."""
    from repro_torch.core.matrix_profile import ab_join

    return ab_join(ts_a, ts_b, window, exclusion=exclusion,
                   return_b=return_b, k=k, precision=precision,
                   device=device)


# per evaluated cell: 2 mul + 1 add (delta) + the carry add + 2 mul (corr)
# + the row max and the column max/select (the reference's count)
FLOPS_PER_CELL = 9.0


def sweep_cells(l: int, excl: int) -> int:
    """Admissible cells of a self-join of `l` rows, each visited once:
    sum(l - k for k in range(excl, l)), the reference's count."""
    n = max(l - excl, 0)
    return n * (n + 1) // 2


def _resident_bytes(l: int, it: int, dt: int, stream_bytes: int) -> int:
    """The sweep's streams and accumulators: df/dg/invn plus the row and
    column corr/idx words, over the padded length."""
    return (l + it + dt) * (3 * int(stream_bytes) + 16)


def hbm_bytes_per_cell(l: int, excl: int, it: int = DEFAULT_IT,
                       dt: int = DEFAULT_DT, *,
                       stream_bytes: int = 4) -> float:
    """Modelled HBM traffic per distance-matrix cell, the reference's two
    formulas (`repro/kernels/ops.py:265-302`) at its tile geometry
    (`it` rows by `dt` diagonals):
      * resident: every stream element crosses HBM once, plus the seeds,
        the row outputs and the column accumulators read and written once;
      * streamed: the j-side strips and the column window are re-fetched
        once per (row tile, diagonal tile), so bytes/cell ~ c·(it+dt)/(it·dt).
    The regime is the card's: "resident" when `_resident_bytes` (the
    streams and accumulators) fit in the H100's L2 (`L2_BYTES`), where
    the reference asks whether its kernel's VMEM working set fits a TPU
    core's budget (ROADMAP.md §C (23)). `stream_bytes` is the width of the
    df/dg/invn streams; seeds, outputs and accumulators stay 4-byte."""
    from repro_torch.launch.roofline import L2_BYTES

    n_rows = -(-l // it)
    n_diags = -(-(l - excl) // dt)
    cells = float(sweep_cells(l, excl))
    f32 = 4
    sb = int(stream_bytes)
    if _resident_bytes(l, it, dt, sb) <= L2_BYTES:
        total = (3 * (l + it + dt) * sb                 # streams, once
                 + n_diags * dt * f32                   # seeds
                 + n_rows * it * (f32 + 4) * 2          # row outputs rw
                 + (l + it + dt) * (f32 + 4) * 2)       # col accumulators rw
        return total / max(cells, 1.0)
    i_side = n_rows * it * 3 * sb                       # once per row tile
    j_side = n_rows * n_diags * (it + dt) * 3 * sb      # per (row, diag) tile
    outs = n_rows * n_diags * it * (f32 + 4) * 2        # rw of row corr+idx
    cols = n_rows * n_diags * (it + dt) * (f32 + 4) * 2  # rw of col window
    seeds = n_diags * dt * f32
    total = i_side + j_side + outs + cols + seeds       # single fused pass
    return total / max(cells, 1.0)


def kernel_roofline(l: int, excl: int, it: int, dt: int, *,
                    stream_bytes: int = 4) -> dict:
    """Compute and memory seconds of the whole self-join profile at (l, it,
    dt) on one card: the cells' FLOPs at the H100's f32 rate (`FP32_PEAK`;
    the sweep is f32 arithmetic on CUDA cores) and their modelled bytes
    (`hbm_bytes_per_cell`) at its HBM rate. The reference's keys, with
    `l2_bytes` (the bytes the regime rule weighs against `L2_BYTES`) in
    place of `vmem_bytes`."""
    from repro_torch.launch.roofline import FP32_PEAK, HBM_BW, L2_BYTES

    cells = float(sweep_cells(l, excl))
    bpc = hbm_bytes_per_cell(l, excl, it, dt, stream_bytes=stream_bytes)
    l2 = _resident_bytes(l, it, dt, stream_bytes)
    return {
        "cells": cells,
        "bytes_per_cell": bpc,
        "stream_bytes": int(stream_bytes),
        "t_compute_s": cells * FLOPS_PER_CELL / FP32_PEAK,
        "t_memory_s": cells * bpc / HBM_BW,
        "l2_bytes": l2,
        "resident": l2 <= L2_BYTES,
    }
