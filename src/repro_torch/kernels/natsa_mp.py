"""NATSA diagonal-streaming matrix profile, two-sided — wrapper and plain
version of the CUDA kernel `csrc/natsa_mp.cu`.

Port of `repro.kernels.natsa_mp` (`rowmax_profile_ab`, `rowmax_profile`),
with the same contract: one call sweeps the signed diagonals
[k_start, k_start + len(cov0)) ∩ [k_start, k_end) of the AB rectangle and
returns BOTH profile sides of the swept cells, `(corr, idx, col_corr,
col_idx)`, in the `jpad`-shifted column layout (see `rowmax_profile_ab`).

A CUDA tensor launches the kernel or raises; a CPU tensor runs
`rowmax_profile_ab_plain`, the plain PyTorch version of the same function,
which the tests and the chip smoke hold the kernel against. The TPU
kernel's column banks (`col_tile`) do not exist here: the CUDA kernel
merges into one flat column array with atomics.
"""

from __future__ import annotations

import ctypes
import struct

import torch

from repro_torch.kernels import DEFAULT_IT
from repro_torch.kernels import _build

NEG = -2.0  # correlations live in [-1, 1]

LAUNCHES = 0  # CUDA kernel launches in this process (bumped per launch)

_STREAM_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def row_harvest(tile: torch.Tensor):
    """Max of a (D, n) tile over the band axis and the LARGEST band offset
    d attaining it."""
    best = tile.max(dim=0).values
    dd = torch.arange(tile.shape[0], device=tile.device)[:, None]
    d_win = torch.where(tile == best[None, :], dd, -1).max(dim=0).values
    return best, d_win


def _packed_init() -> int:
    """The (NEG, -1) key of the packed accumulators, as a signed int64:
    order-preserving bits of NEG high, 0xffffffff low."""
    u = struct.unpack("<I", struct.pack("<f", NEG))[0]
    o = (~u & 0xFFFFFFFF) if u & 0x80000000 else (u | 0x80000000)
    key = (o << 32) | 0xFFFFFFFF
    return key - (1 << 64) if key >= (1 << 63) else key


_PACKED_INIT = _packed_init()

_P, _I = ctypes.c_void_p, ctypes.c_int
# dtype; 6 streams + cov0; rows, n_diag, jp, k_start, k_end, l_i, l_j,
# jpad, col_len; 2 accumulators, 4 outputs, stream
_ARGTYPES = [_I] + [_P] * 7 + [_I] * 9 + [_P] * 7


def _lib():
    """The built `csrc/natsa_mp.cu` with its C entry's signature set."""
    lib = _build.load("natsa_mp")
    lib.natsa_mp_rowmax_ab.argtypes = _ARGTYPES
    lib.natsa_mp_rowmax_ab.restype = ctypes.c_int
    return lib


def _geometry(df_i, df_j, cov0, k_start: int, jpad: int, l_j: int):
    """(rows, n_diag, jp, col_len) of one call, checked."""
    rows, n_diag, jp = df_i.shape[0], cov0.shape[0], df_j.shape[0]
    col_len = max(rows + k_start + n_diag + jpad, l_j + jpad)
    if jp < col_len:
        raise ValueError(f"j streams hold {jp} entries; this span needs "
                         f"{col_len} (rows={rows}, k_start={k_start}, "
                         f"n_diag={n_diag}, jpad={jpad}, l_j={l_j})")
    if k_start + jpad < 0:
        raise ValueError(f"k_start + jpad must be >= 0, got {k_start}+{jpad}")
    return rows, n_diag, jp, col_len


def rowmax_profile_ab(df_i, dg_i, invn_i, df_j, dg_j, invn_j, cov0, *,
                      k_start: int, k_end: int, l_i: int, l_j: int,
                      jpad: int = 0):
    """Two-sided harvest over signed diagonals
    [k_start, k_start + len(cov0)) ∩ [k_start, k_end), in ONE launch.

    Inputs are the padded streams:
      df_i/dg_i/invn_i : (rows,) — A-side row streams, rows >= l_i
      df_j/dg_j/invn_j : (JP,) — B-side, zero-prepadded by `jpad`, with
          JP >= col_len = max(rows + k_start + len(cov0) + jpad, l_j + jpad)
      cov0             : (n_diag,) f32 seed covariance of each diagonal
    Streams are f32, bf16 or f16 (upcast to f32; all arithmetic is f32).
    Returns (corr (rows,), idx, col_corr (col_len,), col_idx): `idx` is the
    best j in B per row of A (-1 where no valid cell); `col_corr[j + jpad]`
    the best correlation of column j of B with `col_idx` its row i in A.

    A CPU tensor runs the plain version; any other device goes to the
    CUDA kernel, which raises for what it cannot run.
    """
    if df_i.device.type == "cpu":
        return rowmax_profile_ab_plain(
            df_i, dg_i, invn_i, df_j, dg_j, invn_j, cov0, k_start=k_start,
            k_end=k_end, l_i=l_i, l_j=l_j, jpad=jpad)
    return _rowmax_profile_ab_cuda(
        df_i, dg_i, invn_i, df_j, dg_j, invn_j, cov0, k_start=k_start,
        k_end=k_end, l_i=l_i, l_j=l_j, jpad=jpad)


def _rowmax_profile_ab_cuda(df_i, dg_i, invn_i, df_j, dg_j, invn_j, cov0, *,
                            k_start, k_end, l_i, l_j, jpad):
    global LAUNCHES
    lib = _lib()
    streams = (df_i, dg_i, invn_i, df_j, dg_j, invn_j)
    dev = df_i.device
    if dev.type != "cuda":
        raise ValueError(f"the NATSA kernel runs on CUDA tensors, got {dev}")
    dtype = df_i.dtype
    if dtype not in _STREAM_CODES:
        raise TypeError(f"streams must be float32, bfloat16 or float16, "
                        f"got {dtype}")
    for x in (*streams, cov0):
        if x.device != dev or x.dim() != 1 or not x.is_contiguous():
            raise ValueError("streams and cov0 must be contiguous 1-D "
                             f"tensors on {dev}")
    if any(x.dtype != dtype for x in streams):
        raise TypeError("all six streams must share one dtype")
    if cov0.dtype != torch.float32:
        raise TypeError(f"cov0 must be float32, got {cov0.dtype}")
    if dg_i.shape != df_i.shape or invn_i.shape != df_i.shape \
            or dg_j.shape != df_j.shape or invn_j.shape != df_j.shape:
        raise ValueError("df/dg/invn of one side must have equal lengths")
    rows, n_diag, jp, col_len = _geometry(df_i, df_j, cov0, k_start, jpad,
                                          l_j)
    if l_i > rows:
        raise ValueError(f"l_i={l_i} exceeds the {rows} row entries")
    if col_len >= 2 ** 31:
        raise ValueError(f"column space {col_len} exceeds int32 indexing")

    row_acc = torch.full((rows,), _PACKED_INIT, dtype=torch.int64,
                         device=dev)
    col_acc = torch.full((col_len,), _PACKED_INIT, dtype=torch.int64,
                         device=dev)
    corr = torch.empty((rows,), dtype=torch.float32, device=dev)
    idx = torch.empty((rows,), dtype=torch.int32, device=dev)
    col_corr = torch.empty((col_len,), dtype=torch.float32, device=dev)
    col_idx = torch.empty((col_len,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.natsa_mp_rowmax_ab(
            _STREAM_CODES[dtype], *(x.data_ptr() for x in streams),
            cov0.data_ptr(), rows, n_diag, jp, int(k_start), int(k_end),
            int(l_i), int(l_j), int(jpad), col_len, row_acc.data_ptr(),
            col_acc.data_ptr(), corr.data_ptr(), idx.data_ptr(),
            col_corr.data_ptr(), col_idx.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"natsa_mp kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return corr, idx, col_corr, col_idx


# elements per intermediate (diagonals x rows) block of the plain version
PLAIN_BLOCK_ELEMS = 1 << 24


def rowmax_profile_ab_plain(df_i, dg_i, invn_i, df_j, dg_j, invn_j, cov0, *,
                            k_start: int, k_end: int, l_i: int, l_j: int,
                            jpad: int = 0, block_elems: int = PLAIN_BLOCK_ELEMS):
    """The kernel's function in plain PyTorch, on any device.

    Sweeps blocks of C diagonals: each block's (C, rows) deltas come from
    strided views of the j streams, `torch.cumsum` along the rows carries
    the covariance from the seed, and the same masks give the correlations.
    The row side is a max + argmax over the block's diagonals; the column
    side is the reference engine's anti-offset skew (`_col_window`: pad
    each diagonal by C+1, flatten, re-wrap one shorter, so entry t of the
    window is column k0 + t) followed by the same max + argmax. Blocks merge
    with strict `>` (the earlier block keeps ties; within a block the
    largest diagonal wins). Rows are clamped per block to those inside the
    rectangle — rows before add only zero deltas from the prepad. Memory is
    O(block_elems).
    """
    dev = df_i.device
    rows, n_diag, _, col_len = _geometry(df_i, df_j, cov0, k_start, jpad, l_j)
    f32 = torch.float32
    corr = torch.full((rows,), NEG, dtype=f32, device=dev)
    idx = torch.full((rows,), -1, dtype=torch.int32, device=dev)
    col_corr = torch.full((col_len,), NEG, dtype=f32, device=dev)
    col_idx = torch.full((col_len,), -1, dtype=torch.int32, device=dev)
    xj = [x.to(f32).contiguous() for x in (df_j, dg_j, invn_j)]
    xi = [x.to(f32) for x in (df_i, dg_i, invn_i)]
    seeds = cov0.to(f32)
    C = max(1, min(n_diag, block_elems // max(rows, 1)))
    for d0 in range(0, n_diag, C):
        c = min(C, n_diag - d0)
        k0 = k_start + d0
        lo = max(0, -(k0 + c - 1))
        hi = min(rows, l_i, l_j - k0)
        if hi <= lo:
            continue
        R = hi - lo
        base = lo + k0 + jpad          # flat j of cell (lo, k0)
        dfj, dgj, invj = (x.as_strided((c, R), (1, 1),
                                       x.storage_offset() + base)
                          for x in xj)
        dfi, dgi, invi = (x[lo:hi] for x in xi)
        delta = dfi[None, :] * dgj + dfj * dgi[None, :]
        cov = seeds[d0:d0 + c, None] + torch.cumsum(delta, dim=1)
        val = cov * invi[None, :] * invj
        dd = torch.arange(c, device=dev)[:, None]
        ii = torch.arange(lo, hi, device=dev)[None, :]
        jj = ii + k0 + dd
        valid = ((jj >= 0) & (jj < l_j) & (ii < l_i) & (k0 + dd < k_end)
                 & (invi[None, :] >= 0) & (invj >= 0))
        val = torch.where(valid, val, torch.full((), NEG, dtype=f32,
                                                 device=dev))
        # row side
        best, d_win = row_harvest(val)
        take = best > corr[lo:hi]
        j_best = (ii[0] + k0 + d_win).to(torch.int32)
        corr[lo:hi] = torch.where(take, best, corr[lo:hi])
        idx[lo:hi] = torch.where(take, j_best, idx[lo:hi])
        # column side: skew[d, t] = val[d, t - d]
        W = R + c
        skew = torch.nn.functional.pad(val, (0, c + 1), value=NEG)
        skew = skew.reshape(-1)[:-c].reshape(c, W)
        wbest, wd = row_harvest(skew)
        i_best = (lo + torch.arange(W, device=dev) - wd).to(torch.int32)
        seg_c, seg_i = col_corr[base:base + W], col_idx[base:base + W]
        take = wbest > seg_c
        col_corr[base:base + W] = torch.where(take, wbest, seg_c)
        col_idx[base:base + W] = torch.where(take, i_best, seg_i)
    # an all-NEG window never beats the NEG/-1 fill, so untouched entries
    # keep index -1
    return corr, idx, col_corr, col_idx


def rowmax_profile(df, dg, invn, cov0, *, excl: int, l: int,
                   it: int = DEFAULT_IT):
    """Self-join entry: diagonals k in [excl, l) of one series, whose
    column side is the lower triangle — merged with the row side it is the
    complete profile. `df/dg/invn` (LP,), LP >= rows + excl + len(cov0)
    with rows = l rounded up to `it`; `cov0` (n_diag,) f32 = cov(0, excl+d).
    """
    rows = -(-l // it) * it
    return rowmax_profile_ab(
        df[:rows], dg[:rows], invn[:rows], df, dg, invn, cov0,
        k_start=excl, k_end=l, l_i=l, l_j=l, jpad=0)
