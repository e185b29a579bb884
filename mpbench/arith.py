"""The yardstick's arithmetic: the cells an exact self-join sweeps, its
operations and bytes, the card's peaks and the least time they allow.

9 FLOP a cell (two multiplies and an add for the covariance's delta, the
carry's add, two multiplies for the correlation, the row max and the column
max and select). Bytes are what the sweep's shapes need: each input stream
read once and each output written once, whatever a kernel reads again.
"""

from __future__ import annotations

import json
import pathlib

FLOP_PER_CELL = 9
STREAMS = 3            # df, dg, invn: the per-cell streams a sweep reads
STREAM_BYTES = 4       # float32
OUT_BYTES = 8          # a float32 profile entry and its int32 index

PEAKS = json.loads((pathlib.Path(__file__).resolve().parent
                    / "peaks.json").read_text())


def diagonal_cells(l: int, k0: int, k1: int) -> int:
    """Cells of the self-join diagonals k in [k0, k1) of an l-row profile:
    sum(l - k), the upper triangle's cells on those diagonals."""
    k0, k1 = max(int(k0), 0), min(int(k1), int(l))
    if k1 <= k0:
        return 0
    # sum_{k=k0}^{k1-1} (l - k) = count * (2l - k0 - k1 + 1) / 2
    count = k1 - k0
    return count * (2 * int(l) - k0 - k1 + 1) // 2


def selfjoin_cells(l: int, exclusion: int) -> int:
    """Cells of an exact self-join at exclusion e: (l - e)(l - e + 1) / 2."""
    n = max(int(l) - int(exclusion), 0)
    return n * (n + 1) // 2


def sweep_bytes(l: int, n_diagonals: int) -> int:
    """One launch over n diagonals of an l-row profile: the three streams
    and the diagonals' seeds read once, the profile and its indices
    written once."""
    return (STREAMS * STREAM_BYTES * int(l) + STREAM_BYTES * int(n_diagonals)
            + OUT_BYTES * int(l))


def peaks(kind: str) -> dict | None:
    """The card's published peaks by `torch.cuda.get_device_name()`."""
    p = PEAKS.get(kind)
    return p if isinstance(p, dict) else None


def bound_s(cells: int, nbytes: int, kind: str, chips: int = 1) -> float | None:
    """The least time `chips` cards of `kind` could take: the larger of the
    cells' FLOP at the FP32 peak and the bytes at the HBM rate; None for a
    card the table lacks."""
    p = peaks(kind)
    if p is None:
        return None
    return max(FLOP_PER_CELL * cells / (chips * p["fp32_flop_per_s"]),
               nbytes / (chips * p["hbm_bytes_per_s"]))
