"""Host halves of the NATSA kernel backend — port of `repro.kernels.ops`.

Pipeline (the paper's Fig. 1 dataflow):
  1. host-side f64 stream prep (`core.zstats.compute_stats_host`);
  2. pad the streams exactly as the reference does, so both packages hand
     their kernels identical arrays;
  3. ONE kernel launch per diagonal span -> both profile sides;
  4. merge the sides in correlation space (the plan converts to distance).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.zstats import CrossStats, ZStats
from repro_torch.kernels import DEFAULT_DT, DEFAULT_IT, natsa_mp

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


def _pad_streams(stats: ZStats, it: int, dt: int, excl: int):
    """Pad streams; returns (df, dg, invn, cov0p, n_rows, n_diags, l)."""
    l = stats.n_subsequences
    n_rows = -(-l // it)
    n_diag_total = max(l - excl, 1)
    n_diags = -(-n_diag_total // dt)
    pad = n_rows * it + excl + n_diags * dt - l
    # seeds feed the f32 covariance carry directly, whatever the streams' dtype
    cov0p = _pad(stats.cov0.float()[excl:], 0, n_diags * dt - n_diag_total)
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
    df, dg, invn, cov0p, _, _, l = _pad_streams(stats, it, dt, excl)
    corr, idx, colc, coli = natsa_mp.rowmax_profile(
        df, dg, invn, cov0p, excl=excl, l=l, it=it)
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
    dev = cross.cov0s.device
    corr = torch.full((la,), NEG, dtype=torch.float32, device=dev)
    idx = torch.full((la,), -1, dtype=torch.int32, device=dev)
    corr_b = torch.full((lb,), NEG, dtype=torch.float32, device=dev)
    idx_b = torch.full((lb,), -1, dtype=torch.int32, device=dev)
    for s0, s1 in ab_spans(la, lb, exclusion):
        (df_i, dg_i, invn_i, df_j, dg_j, invn_j, cov0p,
         _, _, jpad) = _pad_streams_ab(cross, it, dt, s0, s1)
        c, ix, cc, ci = natsa_mp.rowmax_profile_ab(
            df_i, dg_i, invn_i, df_j, dg_j, invn_j, cov0p,
            k_start=s0, k_end=s1, l_i=la, l_j=lb, jpad=jpad)
        corr, idx = _merge_corr(corr, idx, c[:la], ix[:la])
        corr_b, idx_b = _merge_corr(corr_b, idx_b,
                                    cc[jpad:jpad + lb], ci[jpad:jpad + lb])
    return corr, idx, corr_b, idx_b


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
