"""Sliding-window z-normalization streams, built on the host in float64.

Port of `repro.core.zstats` (the stream-prep half). Streams (SCAMP
formulation, Zhu et al. ICDM'18):

    mu[i]    = mean(T[i:i+m])
    invn[i]  = 1 / ||T[i:i+m] - mu[i]||           (inverse centered norm)
    df[0]=dg[0]=0
    df[i]    = (T[i+m-1] - T[i-1]) / 2
    dg[i]    = (T[i+m-1] - mu[i]) + (T[i-1] - mu[i-1])
    cov0[k]  = <T[0:m]-mu[0], T[k:k+m]-mu[k]>

    cov(i, j) = cov(i-1, j-1) + df[i]*dg[j] + df[j]*dg[i]
    corr(i,j) = cov(i, j) * invn[i] * invn[j]
    dist(i,j) = sqrt(2 m (1 - corr(i, j)))

Degenerate windows are carried in `invn`: 0 for a flat window (corr 0),
-1 for a window touching a NaN/Inf sample (masked by every sweep).

The arithmetic is the reference's f64 numpy, line for line, and each
stream is rounded ONCE to its dtype in numpy before it becomes a tensor —
so the port's streams are bitwise equal to the reference's. Two rounding
facts shape `_emit`: numpy's f64->f16 cast rounds once, while torch's goes
through f32 (they differ near f16 midpoints); numpy has no bfloat16, and
the reference's f64->bf16 goes through f32, so bf16 is f64->f32 in numpy
then f32->bf16 in torch.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.precision import torch_dtype
from repro_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ZStats:
    """Precomputed streams for a series of length n with window m."""

    ts: torch.Tensor      # (n,)  the centered raw series
    mu: torch.Tensor      # (l,)
    invn: torch.Tensor    # (l,)
    df: torch.Tensor      # (l,)
    dg: torch.Tensor      # (l,)
    cov0: torch.Tensor    # (l,)  cov of subsequence 0 against every k
    window: int

    @property
    def n_subsequences(self) -> int:
        return self.mu.shape[0]

    def to(self, device) -> "ZStats":
        """The same streams on another device."""
        return dataclasses.replace(
            self, **{f: getattr(self, f).to(device) for f in _ZFIELDS})


_ZFIELDS = ("ts", "mu", "invn", "df", "dg", "cov0")


@dataclasses.dataclass(frozen=True)
class CrossStats:
    """Streams for an AB join of series A against series B.

    Diagonals of the (l_a, l_b) rectangle are indexed by a SIGNED offset
    k = j - i in [-(l_a-1), l_b); `cov0s[k + l_a - 1]` is the covariance at
    the first cell of diagonal k — (0, k) for k >= 0, (-k, 0) for k < 0.
    """

    a: ZStats
    b: ZStats
    cov0s: torch.Tensor   # (l_a + l_b - 1,)

    @property
    def l_a(self) -> int:
        return self.a.n_subsequences

    @property
    def l_b(self) -> int:
        return self.b.n_subsequences

    @property
    def k_min(self) -> int:
        return -(self.l_a - 1)

    @property
    def k_max(self) -> int:
        return self.l_b

    @property
    def window(self) -> int:
        return self.a.window

    def to(self, device) -> "CrossStats":
        return CrossStats(a=self.a.to(device), b=self.b.to(device),
                          cov0s=self.cov0s.to(device))


def _emit(x, dtype, device: torch.device) -> torch.Tensor:
    """Round f64 `x` ONCE to `dtype` (see the module docstring for why in
    numpy) and move it to `device`."""
    x = np.asarray(x, np.float64)
    dt = torch_dtype(dtype)
    if dt == torch.bfloat16:
        return torch.from_numpy(x.astype(np.float32)).to(device).to(dt)
    np_dt = torch.empty((), dtype=dt).numpy().dtype
    return torch.from_numpy(np.ascontiguousarray(x.astype(np_dt))).to(device)


def _tensor(arr, device) -> torch.Tensor:
    """A numpy array (any float dtype, including an ml_dtypes bfloat16 the
    reference hands out) -> a tensor with the same bits, in memory of its
    own (the reference's buffers are read-only)."""
    arr = np.array(arr, copy=True, order="C")
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def self_cross(stats: ZStats) -> CrossStats:
    """View a self-join's streams as the AB rectangle A == B (cov is
    symmetric: the negative seeds are the mirrored first row)."""
    cov0s = torch.cat([stats.cov0[1:].flip(0), stats.cov0])
    return CrossStats(a=stats, b=stats, cov0s=cov0s)


def cross_stats_from_parts(stats_a: ZStats, wa, stats_b: ZStats, wb,
                           out_dtype=None, seed_dtype=None) -> CrossStats:
    """Assemble a `CrossStats` from per-series `(stats, centered windows)`
    parts. The seeds are exact f64 centered-window dots, rounded once to
    `seed_dtype` (default `out_dtype`), on the device of `stats_a`."""
    wa = np.asarray(wa, np.float64)
    wb = np.asarray(wb, np.float64)
    neg = wa[1:] @ wb[0]            # k = -1 .. -(l_a-1), start cells (-k, 0)
    pos = wb @ wa[0]                # k = 0 .. l_b-1,     start cells (0, k)
    if seed_dtype is None:
        seed_dtype = out_dtype
    cov0s = _emit(np.concatenate([neg[::-1], pos]), seed_dtype,
                  stats_a.mu.device)
    return CrossStats(a=stats_a, b=stats_b, cov0s=cov0s)


def compute_cross_stats_host(ts_a, ts_b, window: int, out_dtype=None,
                             seed_dtype=None, *, device=None) -> CrossStats:
    """AB-join streams built host-side in f64; each side's centered-window
    matrix is built once and reused for the seed dots. Either side may be
    as short as one window."""
    m = int(window)
    dev = resolve_device(device)
    sa, wa = compute_stats_host(ts_a, m, out_dtype=out_dtype,
                                seed_dtype=seed_dtype, min_subsequences=1,
                                return_centered_windows=True, device=dev)
    sb, wb = compute_stats_host(ts_b, m, out_dtype=out_dtype,
                                seed_dtype=seed_dtype, min_subsequences=1,
                                return_centered_windows=True, device=dev)
    return cross_stats_from_parts(sa, wa, sb, wb, out_dtype=out_dtype,
                                  seed_dtype=seed_dtype)


def compute_stats_host(ts, window: int, out_dtype=None, seed_dtype=None,
                       min_subsequences: int | None = None, *,
                       return_centered_windows: bool = False, device=None):
    """Build the NATSA streams in float64 on the host and emit `out_dtype`
    tensors (default f32) on `device` (default the CUDA card).

    `seed_dtype` overrides the dtype of `cov0` only. `min_subsequences`
    relaxes the self-join check n >= 2m to n >= m + min_subsequences - 1.
    `return_centered_windows=True` returns `(stats, w)` with `w` the f64
    (l, m) centered-window matrix. NaN/Inf samples mask every window that
    touches them with the `invn = -1` sentinel; other windows keep
    bit-identical statistics.
    """
    dev = resolve_device(device)
    t = np.asarray(ts, np.float64)
    if t.ndim != 1:
        raise ValueError(f"time series must be 1-D, got shape {t.shape}")
    m = int(window)
    n = t.shape[0]
    min_n = 2 * m if min_subsequences is None else m + int(min_subsequences) - 1
    if n < min_n:
        raise ValueError(f"series too short: n={n} < {min_n} "
                         f"(window={m}, min_subsequences={min_subsequences})")
    finite = np.isfinite(t)
    masked = None
    if not finite.all():
        # gaps are filled with the finite mean so every cumsum/dot stays
        # finite; windows touching a gap get the invn = -1 sentinel below
        fill = t[finite].mean() if finite.any() else 0.0
        t = np.where(finite, t, fill)
        nbad = np.concatenate([[0], np.cumsum(~finite)])
        masked = (nbad[m:] - nbad[:-m]) > 0
    t = t - t.mean()
    l = n - m + 1
    csum = np.concatenate([[0.0], np.cumsum(t)])
    mu = (csum[m:] - csum[:-m]) / m
    view = np.lib.stride_tricks.sliding_window_view(t, m)
    w = view - mu[:, None]                # exact two-pass centering
    norm = np.sqrt(np.einsum("lm,lm->l", w, w))
    # RELATIVE flat-window guard: cumsum roundoff leaves ~1e-15-relative
    # residues in constant windows; scale^2 = norm^2 + m*mu^2
    scale2 = norm * norm + m * mu * mu
    flat = norm * norm <= 1e-16 * np.maximum(scale2, 1e-300)
    invn = np.where(~flat & (norm > 0), 1.0 / np.maximum(norm, 1e-300), 0.0)
    if masked is not None:
        invn = np.where(masked, -1.0, invn)   # missing-data sentinel
    tail, head = t[m:], t[: l - 1]
    df = np.concatenate([[0.0], (tail[: l - 1] - head) / 2.0])
    dg = np.concatenate([[0.0], (tail[: l - 1] - mu[1:]) + (head - mu[:-1])])
    cov0 = w @ w[0]
    sdt = out_dtype if seed_dtype is None else seed_dtype
    stats = ZStats(ts=_emit(t, out_dtype, dev), mu=_emit(mu, out_dtype, dev),
                   invn=_emit(invn, out_dtype, dev),
                   df=_emit(df, out_dtype, dev), dg=_emit(dg, out_dtype, dev),
                   cov0=_emit(cov0, sdt, dev), window=m)
    if return_centered_windows:
        return stats, w
    return stats


def stats_from_arrays(fields: dict, window: int, device=None) -> ZStats:
    """Carry-over: build the port's `ZStats` from a reference `ZStats` read
    out as numpy arrays by field name (`ts`, `mu`, `invn`, `df`, `dg`,
    `cov0`), bits unchanged, so both packages sweep identical streams. A
    batched reference stack (every field with a leading `(B,)` axis) gives
    the stacked `ZStats` a batched plan executes."""
    dev = resolve_device(device)
    return ZStats(window=int(window),
                  **{f: _tensor(fields[f], dev) for f in _ZFIELDS})


def cross_stats_from_arrays(fields: dict, window: int,
                            device=None) -> CrossStats:
    """`stats_from_arrays` for a `CrossStats`: `fields` holds `a` and `b`
    (each a field dict as above) and `cov0s`, single or stacked."""
    dev = resolve_device(device)
    return CrossStats(a=stats_from_arrays(fields["a"], window, dev),
                      b=stats_from_arrays(fields["b"], window, dev),
                      cov0s=_tensor(fields["cov0s"], dev))


def stack_stats(parts: list):
    """Per-series `ZStats` or `CrossStats` of one shape -> one stacked
    payload, every field with a leading `(B,)` axis (what a batched plan
    executes; the reference stacks with `jax.tree.map(jnp.stack, ...)`)."""
    first = parts[0]
    if isinstance(first, CrossStats):
        return CrossStats(a=stack_stats([p.a for p in parts]),
                          b=stack_stats([p.b for p in parts]),
                          cov0s=torch.stack([p.cov0s for p in parts]))
    return dataclasses.replace(first, **{
        f: torch.stack([getattr(p, f) for p in parts]) for f in _ZFIELDS})


def unstack_stats(stack) -> list:
    """`stack_stats` undone: a stacked payload -> its per-series views."""
    if isinstance(stack, CrossStats):
        return [CrossStats(a=a, b=b, cov0s=c) for a, b, c in zip(
            unstack_stats(stack.a), unstack_stats(stack.b), stack.cov0s)]
    return [dataclasses.replace(stack, **{f: getattr(stack, f)[r]
                                          for f in _ZFIELDS})
            for r in range(stack.mu.shape[0])]


# -- in-graph stats ------------------------------------------------------------
#
# Torch twins of the reference's in-graph stream prep, on the device of
# their input and in its dtype. They cancel catastrophically in f32 on
# series with a level (E[x^2] - E[x]^2, qt0 - m mu0 muk), which is why the
# entry points use `compute_stats_host`; the dot products are a product and
# a sum, never a matmul, so no TF32 mode touches them on the card.


def moving_mean_var(ts: torch.Tensor, m: int):
    """Sliding mean and population variance over windows of length `m`,
    from cumulative sums; the variance is clamped at 0 against
    cancellation."""
    zero = ts.new_zeros(1)
    csum = torch.cat([zero, torch.cumsum(ts, 0)])
    csq = torch.cat([zero, torch.cumsum(ts * ts, 0)])
    mu = (csum[m:] - csum[:-m]) / m
    var = torch.clamp((csq[m:] - csq[:-m]) / m - mu * mu, min=0.0)
    return mu, var


def sliding_dot(query: torch.Tensor, ts: torch.Tensor) -> torch.Tensor:
    """dot(query, ts[k:k+m]) for every k: O(n m), vectorized."""
    return (ts.unfold(0, query.shape[0], 1) * query).sum(dim=-1)


def compute_stats(ts, window: int, *, device=None) -> ZStats:
    """All NATSA streams of a 1-D FINITE series, computed in its own dtype
    on `device` (default the CUDA card; a float tensor's dtype is kept, a
    numpy array's too). Use `compute_stats_host` for series with NaN/Inf
    gaps or a level: it masks the gaps and computes in f64."""
    dev = resolve_device(device)
    ts = torch.as_tensor(ts, device=dev)
    if not ts.is_floating_point():
        ts = ts.float()
    if ts.ndim != 1:
        raise ValueError(f"time series must be 1-D, got shape "
                         f"{tuple(ts.shape)}")
    m = int(window)
    n = ts.shape[0]
    if n < 2 * m:
        raise ValueError(f"series too short: n={n} < 2*window={2 * m}")
    mu, var = moving_mean_var(ts, m)
    # flat windows (norm 0) get invn 0: corr 0 against everything
    norm = torch.sqrt(var * m)
    invn = torch.where(norm > 0, 1.0 / torch.clamp(norm, min=1e-30), 0.0)
    l = n - m + 1
    tail, head = ts[m:], ts[:l - 1]
    zero = ts.new_zeros(1)
    df = torch.cat([zero, (tail[:l - 1] - head) / 2.0])
    dg = torch.cat([zero, (tail[:l - 1] - mu[1:]) + (head - mu[:-1])])
    cov0 = sliding_dot(ts[:m], ts) - m * mu[0] * mu
    return ZStats(ts=ts, mu=mu, invn=invn, df=df, dg=dg, cov0=cov0, window=m)


def compute_stats_jit(ts, window: int, *, device=None) -> ZStats:
    """`compute_stats` under the reference's jitted name (torch has no
    trace-and-compile step to add)."""
    return compute_stats(ts, window, device=device)


def cov_row(stats: ZStats, row: int) -> torch.Tensor:
    """cov(row, row + k) for all k in [0, l - row), evaluated directly — an
    independent check of the diagonal recurrence."""
    m = stats.window
    q = stats.ts[row:row + m]
    return sliding_dot(q, stats.ts[row:]) - m * stats.mu[row] * stats.mu[row:]


def corr_to_dist(corr: torch.Tensor, window: int) -> torch.Tensor:
    """Pearson correlation -> z-normalized Euclidean distance."""
    return torch.sqrt(torch.clamp(2.0 * window * (1.0 - corr), min=0.0))


def dist_to_corr(dist: torch.Tensor, window: int) -> torch.Tensor:
    return 1.0 - dist * dist / (2.0 * window)


# -- shared streaming block distances ------------------------------------------
#
# The incremental surfaces (`core.streaming.StreamingProfile`, and the fleet
# that will share them) evaluate squared-distance BLOCKS between raw f64
# window matrices instead of running the f32 diagonal recurrence: appends
# are exact and drift-free. A fleet tenant must equal a per-series replay
# bit for bit, which holds only if both run the same arithmetic, so the
# block evaluator lives here as ONE op sequence:
#
#   * every dot product is an elementwise product and a sum over the window
#     axis, never a matmul (GEMM tilings round differently per shape, and
#     a TF32 mode could touch a matmul on the card);
#   * every sum is `_tree_sum`: pairwise halving adds in a fixed order.
#     `torch.sum` on the card picks its reduction order from the block's
#     shape, so a one-row block would not equal the same row of a bulk
#     block; elementwise adds round each output on its own, whatever the
#     shape or the device;
#   * f64 throughout: the callers hand f64 tensors in, and torch has no
#     global dtype switch to set around them.
#
# Degenerate windows: a flat window correlates with nothing (corr 0); a
# window touching a NaN/Inf sample is masked by the CALLER with
# `window_finite_mask`, after the block, so NaNs flowing through it are
# overwritten and never compared.


def sqdist_to_dist(d2: torch.Tensor) -> torch.Tensor:
    """Squared distances -> distances (negatives clamped to 0), with a
    correctly rounded f64 sqrt on every device: CUDA's is, torch's CPU
    kernel is not (an ulp off for ~0.7% of values on an AVX-512 build), so
    the host goes through numpy's, as the reference's snapshots do."""
    d2 = torch.clamp(d2, min=0.0)
    if d2.device.type == "cpu":
        return torch.from_numpy(np.sqrt(d2.numpy()))
    return torch.sqrt(d2)


def _tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in a fixed order: halves added pairwise, an
    odd length's last element carried to the next level."""
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        s = x[..., :h] + x[..., h:2 * h]
        x = torch.cat([s, x[..., 2 * h:]], dim=-1) if x.shape[-1] % 2 else s
    return x[..., 0]


def centered_block(w: torch.Tensor):
    """(..., q, m) raw windows -> (centered windows, centered norms). The
    mean is a sum, then a division."""
    s = _tree_sum(w)[..., None]
    mu = s / w.shape[-1]
    c = w - mu
    sq = c * c
    ss = _tree_sum(sq)
    return c, torch.sqrt(ss)


def window_finite_mask(w: torch.Tensor) -> torch.Tensor:
    """(..., q, m) -> (..., q) bool: True where the window touches only
    finite samples (the block path's `invn = -1` sentinel)."""
    return torch.isfinite(w).all(dim=-1)


def sqdist_znorm_from_parts(ac, an, bc, bn, *, window: int) -> torch.Tensor:
    """Z-normalized squared distances from centered parts: `ac` (..., p, m)
    / `an` (..., p) against `bc` (..., q, m) / `bn` (..., q) -> (..., p,
    q). Split out so a caller can keep one side's parts resident."""
    prod = ac[..., :, None, :] * bc[..., None, :, :]
    cross = _tree_sum(prod)
    nn = an[..., :, None] * bn[..., None, :]
    denom = torch.clamp(nn, min=1e-300)
    ratio = cross / denom
    corr = torch.where((an[..., :, None] > 0) & (bn[..., None, :] > 0),
                       ratio, 0.0)
    om = 1.0 - torch.clamp(corr, -1.0, 1.0)
    return (2.0 * int(window)) * om


def window_sumsq(w: torch.Tensor) -> torch.Tensor:
    """(..., q, m) raw windows -> (..., q) sums of squares."""
    sq = w * w
    return _tree_sum(sq)


def sqdist_nonnorm_from_parts(wa, sa, wb, sb) -> torch.Tensor:
    """Raw squared distances ||a - b||^2 by expansion, from the windows and
    their sums of squares (`sa = sum(wa^2)`, `sb = sum(wb^2)`)."""
    prod = wa[..., :, None, :] * wb[..., None, :, :]
    cross = _tree_sum(prod)
    ssum = sa[..., :, None] + sb[..., None, :]
    c2 = 2.0 * cross
    return ssum - c2


def sqdist_block(wa: torch.Tensor, wb: torch.Tensor, *, window: int,
                 normalize: bool = True) -> torch.Tensor:
    """Squared distances between window matrices, (..., p, m) x (..., q, m)
    -> (..., p, q): the one block evaluator of the incremental surfaces."""
    if normalize:
        ac, an = centered_block(wa)
        bc, bn = centered_block(wb)
        return sqdist_znorm_from_parts(ac, an, bc, bn, window=window)
    return sqdist_nonnorm_from_parts(wa, window_sumsq(wa), wb,
                                     window_sumsq(wb))


def sqdist_block_jit(wa, wb, *, window: int, normalize: bool = True):
    """`sqdist_block` under the reference's jitted name: torch runs it op by
    op, so there is no compiled twin to keep bitwise equal to it."""
    return sqdist_block(wa, wb, window=window, normalize=normalize)
