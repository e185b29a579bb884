"""The result object every entry point returns — port of `repro.core.result`.

`ProfileResult` carries the merged profile `p`/`i` eagerly and the other
sides (`left_p/right_p` of a self-join, `b_p/b_i` of an AB join, top-k
sets) as LAZY attributes:

  * when the sweep already harvested the side (the kernel's row and column
    halves ARE the split and the B side), the executor installs a `raw`
    closure over the retained tensors and first access finishes from it —
    an O(l) conversion, no new sweep;
  * otherwise first access re-executes the SAME plan with `sides="both"`
    (the recompute path), so the late arrays equal an eager request;
  * a side the plan can never produce stays None.

Iterating, indexing or `len()` on a `ProfileResult` raises `TypeError`, as
in the reference: use `result.p` / `result.i`.
"""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass(frozen=True)
class HarvestSpec:
    """What a sweep should harvest: `sides` "merged" (minimal, default) |
    "row" (A side only) | "both" (eager two-sided); `k` neighbors kept per
    position."""

    sides: str = "merged"
    k: int = 1

    def __post_init__(self):
        if self.sides not in ("merged", "row", "both"):
            raise ValueError(f"harvest sides must be 'merged', 'row' or "
                             f"'both', got {self.sides!r}")
        if int(self.k) < 1:
            raise ValueError(f"harvest k must be >= 1, got {self.k}")


# lazy field -> the group one resolution fills
_LAZY_GROUPS = {
    "left_p": "split", "left_i": "split",
    "right_p": "split", "right_i": "split",
    "b_p": "b", "b_i": "b",
    "topk_p": "topk", "topk_i": "topk",
    "b_topk_p": "b_topk", "b_topk_i": "b_topk",
}

# SweepResult field for each public lazy name (recompute path)
_SWEEP_FIELDS = {
    "left_p": "left_dist", "left_i": "left_index",
    "right_p": "right_dist", "right_i": "right_index",
    "b_p": "dist_b", "b_i": "index_b",
    "topk_p": "topk_dist", "topk_i": "topk_index",
    "b_topk_p": "topk_dist_b", "b_topk_i": "topk_index_b",
}


class _LazyHarvest:
    """Deferred-harvest provider attached to a `ProfileResult`: `raw` maps
    a group to a zero-sweep closure the executor installed; groups without
    one recompute through the retained (plan, stats). `recomputes` counts
    those follow-up sweeps."""

    __slots__ = ("plan", "stats", "raw", "recomputes")

    def __init__(self, plan, stats=None, raw=None):
        self.plan = plan
        self.stats = stats
        self.raw = dict(raw) if raw else {}
        self.recomputes = 0

    def _producible(self, result: "ProfileResult", group: str) -> bool:
        if group == "split":
            return result.kind == "self"
        if group == "b":
            return result.kind == "ab"
        if group == "topk":
            return result.k > 1
        return result.kind == "ab" and result.k > 1       # b_topk

    def resolve(self, result: "ProfileResult", name: str) -> None:
        group = _LAZY_GROUPS[name]
        if not self._producible(result, group):
            return
        fn = self.raw.get(group)
        fields = fn() if fn is not None else self._recompute()
        for key, val in fields.items():
            if object.__getattribute__(result, "_" + key) is None:
                object.__setattr__(result, "_" + key, val)

    def _recompute(self) -> dict:
        if self.stats is None:
            return {}
        from repro_torch.core import plan as plan_mod

        full = dataclasses.replace(
            self.plan, harvest=dataclasses.replace(self.plan.harvest,
                                                   sides="both"))
        res = plan_mod.execute(full, self.stats)
        self.recomputes += 1
        return {pub: getattr(res, fld) for pub, fld in _SWEEP_FIELDS.items()
                if getattr(res, fld) is not None}


def _lazy_property(name: str):
    slot = "_" + name

    def get(self: "ProfileResult"):
        val = object.__getattribute__(self, slot)
        if val is None:
            lazy = object.__getattribute__(self, "_lazy")
            if lazy is not None:
                lazy.resolve(self, name)
                val = object.__getattribute__(self, slot)
        return val

    get.__name__ = name
    get.__doc__ = f"Lazy `{name}` (see the module docstring)."
    return property(get)


class ProfileResult:
    """Everything one executed sweep learned, in the caller's orientation.

    `p[t]` is the distance from subsequence t to its nearest admissible
    neighbor and `i[t]` that neighbor's start (-1 where none exists), as
    float32 / int32 tensors on the plan's device. Self-joins also carry
    `left_p/left_i` (neighbor j < t) and `right_p/right_i` (j > t); AB
    joins carry B's profile against A (`b_p/b_i`). Frozen.
    `fraction_done` is the anytime coverage of the answer (1.0 here).
    """

    _META = ("kind", "window", "exclusion", "normalize", "k", "backend",
             "fraction_done")
    LAZY_FIELDS = tuple(_LAZY_GROUPS)

    def __init__(self, p: Any, i: Any, *, left_p: Any = None,
                 left_i: Any = None, right_p: Any = None, right_i: Any = None,
                 b_p: Any = None, b_i: Any = None, topk_p: Any = None,
                 topk_i: Any = None, b_topk_p: Any = None,
                 b_topk_i: Any = None, kind: str = "self", window: int = 0,
                 exclusion: int = 0, normalize: bool = True, k: int = 1,
                 backend: str = "kernel", fraction_done: float = 1.0,
                 lazy: _LazyHarvest | None = None):
        sa = object.__setattr__
        sa(self, "p", p)
        sa(self, "i", i)
        for name, val in (("left_p", left_p), ("left_i", left_i),
                          ("right_p", right_p), ("right_i", right_i),
                          ("b_p", b_p), ("b_i", b_i), ("topk_p", topk_p),
                          ("topk_i", topk_i), ("b_topk_p", b_topk_p),
                          ("b_topk_i", b_topk_i)):
            sa(self, "_" + name, val)
        sa(self, "kind", kind)
        sa(self, "window", int(window))
        sa(self, "exclusion", int(exclusion))
        sa(self, "normalize", bool(normalize))
        sa(self, "k", int(k))
        sa(self, "backend", backend)
        sa(self, "fraction_done", float(fraction_done))
        sa(self, "_lazy", lazy)

    def __setattr__(self, name, value):
        raise dataclasses.FrozenInstanceError(
            f"cannot assign to field {name!r}")

    def __delattr__(self, name):
        raise dataclasses.FrozenInstanceError(
            f"cannot delete field {name!r}")

    left_p = _lazy_property("left_p")
    left_i = _lazy_property("left_i")
    right_p = _lazy_property("right_p")
    right_i = _lazy_property("right_i")
    b_p = _lazy_property("b_p")
    b_i = _lazy_property("b_i")
    topk_p = _lazy_property("topk_p")
    topk_i = _lazy_property("topk_i")
    b_topk_p = _lazy_property("b_topk_p")
    b_topk_i = _lazy_property("b_topk_i")

    @property
    def n_subsequences(self) -> int:
        return self.p.shape[-1]

    def has_split(self) -> bool:
        """Whether the left/right split is available — materialized or
        lazily producible. Does NOT trigger resolution."""
        if object.__getattribute__(self, "_left_p") is not None:
            return True
        lazy = object.__getattribute__(self, "_lazy")
        return lazy is not None and lazy._producible(self, "split")

    def has_topk(self) -> bool:
        """Whether (l, k) top-k sets are available (see `has_split`)."""
        if object.__getattribute__(self, "_topk_p") is not None:
            return True
        lazy = object.__getattribute__(self, "_lazy")
        return lazy is not None and lazy._producible(self, "topk")

    def __repr__(self) -> str:
        sides = [f for f in self.LAZY_FIELDS
                 if object.__getattribute__(self, "_" + f) is not None]
        meta = ", ".join(f"{f}={getattr(self, f)!r}" for f in self._META)
        return (f"ProfileResult(l={self.p.shape[-1]}, {meta}, "
                f"materialized={sides!r})")


def build_result(plan, res, stats=None) -> ProfileResult:
    """Wrap an executed plan's `SweepResult` into the public `ProfileResult`
    (`stats` retained for the recompute path; None disables it)."""
    lazy = _LazyHarvest(plan, stats, raw=res.raw)
    return ProfileResult(
        p=res.dist, i=res.index,
        left_p=res.left_dist, left_i=res.left_index,
        right_p=res.right_dist, right_i=res.right_index,
        b_p=res.dist_b, b_i=res.index_b,
        topk_p=res.topk_dist, topk_i=res.topk_index,
        b_topk_p=res.topk_dist_b, b_topk_i=res.topk_index_b,
        kind=plan.kind, window=plan.window, exclusion=plan.exclusion,
        normalize=plan.normalize, k=plan.harvest.k, backend=plan.backend,
        lazy=lazy)
