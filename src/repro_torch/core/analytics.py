"""Analytics over `ProfileResult`: motifs, discords, regimes — port of
`repro.core.analytics`.

One profile opens a family of mining tasks; this module is its first tier,
consuming the `ProfileResult` every entry point returns, with no re-sweep:

  * `top_motifs` — the best-matching pairs, each grown into a motif group
    from the result's top-k neighbour sets when it carries them;
  * `discords` — the positions most unlike everything else, greedily
    non-overlapping (anomaly detection);
  * `regimes` — FLUSS-style segmentation: the corrected arc curve over the
    1-NN pointers (Gharghabi et al., ICDM'17), whose valleys are regime
    boundaries.

All three read the merged profile, skip inf entries (positions whose
exclusion zone covered the whole series) and run in f64 on the device the
result lives on; the picks are Python ints.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.result import ProfileResult


@dataclasses.dataclass(frozen=True)
class Motif:
    """One repeated pattern: the pair (a, b) at distance `d`, and the
    motif's wider neighbour group (start positions, best-first, from the
    top-k sets when the result carries them)."""

    a: int
    b: int
    d: float
    neighbors: tuple[int, ...] = ()


@dataclasses.dataclass(frozen=True)
class Discord:
    """One anomaly: the subsequence at `position` whose nearest neighbour
    (`neighbor`, -1 if none) is `score` away."""

    position: int
    score: float
    neighbor: int


@dataclasses.dataclass(frozen=True)
class Regimes:
    """Segmentation: `boundaries` (regime changes, best-first) and the
    corrected arc curve `cac` (f64; low = likely boundary; the edges are
    pinned to 1)."""

    boundaries: tuple[int, ...]
    cac: torch.Tensor


def _check_self_1d(result: ProfileResult, what: str) -> torch.Tensor:
    p = torch.as_tensor(result.p).to(torch.float64)
    if p.ndim != 1:
        raise ValueError(f"{what} expects a single-series result; got a "
                         f"stacked profile of shape {tuple(p.shape)}; index "
                         f"one batch row first")
    return p


def _default_exclusion(result: ProfileResult) -> int:
    # the profile's own trivial-match zone is the natural non-overlap
    # radius; the window where the result carries exclusion 0 (AB geometry)
    return int(result.exclusion) if result.exclusion > 0 \
        else max(1, int(result.window))


def top_motifs(result: ProfileResult, max_motifs: int = 3,
               exclusion: int | None = None,
               radius: float = 2.0) -> list[Motif]:
    """The `max_motifs` best-matching subsequence pairs, non-overlapping.

    Each pick takes the first global profile minimum (a, b = i[a]), then
    suppresses the exclusion zone around every occurrence before the next
    pick. Where the result carries top-k sets, a's further neighbours
    within `radius` times the pair distance join `neighbors`."""
    p = _check_self_1d(result, "top_motifs").clone()
    idx = torch.as_tensor(result.i).to(p.device)
    excl = _default_exclusion(result) if exclusion is None else int(exclusion)
    pos = torch.arange(p.shape[0], device=p.device)
    out: list[Motif] = []
    for _ in range(int(max_motifs)):
        fin = torch.isfinite(p)
        if not bool(fin.any()):
            break
        a = int(torch.argmin(torch.where(fin, p, torch.inf)))
        b = int(idx[a])
        if b < 0:
            break
        d = float(result.p[a])
        neighbors: tuple[int, ...] = ()
        if result.has_topk():
            tk_p = result.topk_p[a].to(torch.float64).tolist()
            tk_i = result.topk_i[a].tolist()
            cut = radius * max(d, torch.finfo(torch.float64).tiny)
            neighbors = tuple(
                int(j) for j, dj in zip(tk_i, tk_p)
                if j >= 0 and j != b and math.isfinite(dj) and dj <= cut)
        out.append(Motif(a=a, b=b, d=d, neighbors=neighbors))
        # b and the neighbours index B of an AB join: another series
        occ = (a, b, *neighbors) if result.kind == "self" else (a,)
        for c in occ:
            p[(pos - c).abs() < excl] = torch.inf
    return out


def discords(result: ProfileResult, n: int = 3,
             exclusion: int | None = None) -> list[Discord]:
    """The `n` most isolated subsequences (largest profile entries),
    greedily non-overlapping. Positions with no admissible neighbour (inf
    entries) are geometry, not anomalies, and are skipped."""
    p = _check_self_1d(result, "discords").clone()
    idx = torch.as_tensor(result.i).to(p.device)
    excl = _default_exclusion(result) if exclusion is None else int(exclusion)
    pos = torch.arange(p.shape[0], device=p.device)
    p[~torch.isfinite(p)] = -torch.inf
    out: list[Discord] = []
    for _ in range(int(n)):
        if not bool(torch.isfinite(p).any()):
            break
        a = int(torch.argmax(p))
        out.append(Discord(position=a, score=float(p[a]),
                           neighbor=int(idx[a])))
        p[(pos - a).abs() < excl] = -torch.inf
    return out


def top_discord(result: ProfileResult,
                exclusion: int | None = None) -> Discord | None:
    """The single most isolated subsequence, or None when no position has
    an admissible neighbour."""
    got = discords(result, n=1, exclusion=exclusion)
    return got[0] if got else None


def corrected_arc_curve(result: ProfileResult) -> torch.Tensor:
    """FLUSS corrected arc curve from the result's 1-NN pointers.

    Every position t contributes one arc to its neighbour i[t]; `ac[t]`
    counts the arcs crossing t. Arcs stay inside a regime, so few cross a
    boundary. Divided by the curve of uniformly random pointers (the
    parabola `2 t (l - t) / l`) and clipped to [0, 1], valleys mark
    boundaries. The first and last `window` positions are pinned to 1."""
    p = _check_self_1d(result, "corrected_arc_curve")
    if result.kind != "self":
        raise ValueError("arc-curve segmentation needs a SELF-join result: "
                         "AB pointers cross into the other series, so arcs "
                         "over one axis are undefined")
    l = p.shape[0]
    dev = p.device
    idx = torch.as_tensor(result.i).to(device=dev, dtype=torch.int64)
    pos = torch.arange(l, device=dev)
    ok = (idx >= 0) & (idx < l)
    lo = torch.minimum(pos[ok], idx[ok])
    hi = torch.maximum(pos[ok], idx[ok])
    # +1 where an arc opens, -1 where it closes (integer-valued, so exact)
    mark = torch.zeros(l + 1, dtype=torch.float64, device=dev)
    mark.index_add_(0, lo, torch.ones_like(lo, dtype=torch.float64))
    mark.index_add_(0, hi, torch.full_like(hi, -1.0, dtype=torch.float64))
    ac = torch.cumsum(mark, 0)[:l]
    t = pos.to(torch.float64)
    iac = 2.0 * t * (l - t) / max(l, 1)
    inner = iac > 0
    cac = torch.ones(l, dtype=torch.float64, device=dev)
    cac[inner] = torch.clamp(ac[inner] / iac[inner], max=1.0)
    edge = min(max(1, int(result.window)), l)
    cac[:edge] = 1.0
    cac[l - edge:] = 1.0
    return cac


def regimes(result: ProfileResult, n_regimes: int = 2,
            exclusion: int | None = None) -> Regimes:
    """The `n_regimes - 1` best regime boundaries: valleys of the corrected
    arc curve, greedily non-overlapping within `exclusion` (default 5
    windows, the FLUSS rule that keeps boundaries off one transition)."""
    cac = corrected_arc_curve(result)
    excl = (5 * max(1, int(result.window)) if exclusion is None
            else int(exclusion))
    work = cac.clone()
    pos = torch.arange(work.shape[0], device=work.device)
    bounds: list[int] = []
    for _ in range(max(0, int(n_regimes) - 1)):
        t = int(torch.argmin(work))
        if float(work[t]) >= 1.0:
            break                   # no valley left: fewer regimes exist
        bounds.append(t)
        work[(pos - t).abs() < excl] = 1.0
    return Regimes(boundaries=tuple(bounds), cac=cac)
