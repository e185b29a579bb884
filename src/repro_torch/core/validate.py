"""Shared entry-point input validation.

Every public entry (`matrix_profile`, `ab_join`, their nonnorm/batch
variants, `StreamingProfile`) funnels its series arguments through
`validate_series` so malformed inputs fail at the API boundary with ONE
consistent message instead of surfacing as shape errors deep inside the
planner or stats pass. The checks here are purely structural (dimensionality,
dtype class, window sanity); length-vs-window requirements that depend on the
join kind (self-join needs n >= 2m, an AB side only n >= m) stay with
`zstats.compute_stats_host`, which already raises a precise message.

Non-finite samples are NOT rejected: `compute_stats_host` masks every
subsequence touching a NaN/Inf sample (missing-data tolerance). Paths that
cannot mask — the non-normalized distance entries — pass
`require_finite=True`.
"""

from __future__ import annotations

import numpy as np


def validate_series(ts, window: int, *, name: str = "ts",
                    require_finite: bool = False) -> np.ndarray:
    """Validate one series argument; returns it as a numpy array.

    Raises ValueError for 0-d/multi-d input, complex or non-numeric dtypes,
    `window < 2`, an empty series, or `window > len(ts)` — the structural
    failures every entry point shares.
    """
    arr = np.asarray(ts)
    if arr.ndim != 1:
        raise ValueError(f"{name} must be a 1-D series, got shape "
                         f"{arr.shape} (ndim={arr.ndim})")
    if np.issubdtype(arr.dtype, np.complexfloating):
        raise ValueError(f"{name} must be real-valued, got complex dtype "
                         f"{arr.dtype}")
    if not (np.issubdtype(arr.dtype, np.floating)
            or np.issubdtype(arr.dtype, np.integer)
            or np.issubdtype(arr.dtype, np.bool_)):
        raise ValueError(f"{name} must be numeric, got dtype {arr.dtype}")
    m = int(window)
    if m < 2:
        raise ValueError(f"window must be >= 2, got {window}")
    if arr.shape[0] == 0:
        raise ValueError(f"{name} is empty (window={m} needs at least {m} "
                         f"points)")
    if arr.shape[0] < m:
        raise ValueError(f"window ({m}) exceeds len({name}) "
                         f"({arr.shape[0]}): no complete subsequence exists")
    if require_finite and not np.isfinite(arr.astype(np.float64)).all():
        raise ValueError(f"{name} contains non-finite values; this entry "
                         f"point does not support missing-data masking "
                         f"(use the z-normalized profile instead)")
    return arr
