"""Telemetry discord monitors — port of `repro.core.monitor`.

Matrix-profile discord discovery over telemetry traces (loss, grad-norm,
step-time) flags anomalies that threshold alarms miss: a discord is a
*subsequence unlike every other subsequence*, so slow drifts and periodic
patterns don't false-positive, while loss spikes, silent data corruption
and straggler onset (step-time shape changes) do.

`TelemetryMonitor.scan` runs the raw (`normalize=False`) profile through
the port's nonnorm band engine; `motif` runs the z-normalized self-join,
which the planner sends to the NATSA kernel on the card. `FleetMonitor`
applies `scan`'s z-score gate per tenant of a `StreamingFleet`. Both run on
their `device` (the CUDA card unless `"cpu"`); the fleet monitor on the
fleet's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import analytics
from repro_torch.core.matrix_profile import matrix_profile

__all__ = ["Discord", "TelemetryMonitor", "FleetAlert", "FleetMonitor"]


@dataclasses.dataclass
class Discord:
    position: int
    score: float          # profile value (distance to nearest neighbor)
    zscore: float         # score vs profile distribution


def _finite_stats(p: torch.Tensor) -> tuple[int, float, float]:
    """(count, mean, population std + 1e-12) of a profile's finite
    entries, in the profile's dtype."""
    finite = p[torch.isfinite(p)]
    if finite.numel() == 0:
        return 0, 0.0, 0.0
    return (finite.numel(), float(finite.mean()),
            float(finite.std(correction=0) + 1e-12))


@dataclasses.dataclass
class TelemetryMonitor:
    """Sliding matrix-profile monitor over a scalar telemetry stream.

    Uses the NON-normalized profile by default: telemetry anomalies are
    usually amplitude/level changes, which z-normalization factors out
    (z-norm mode remains available for pure shape anomalies)."""

    window: int = 32
    min_history: int = 256
    max_history: int = 8192
    zscore_alarm: float = 4.0
    normalize: bool = False
    device: object = None
    _trace: list = dataclasses.field(default_factory=list)

    def push(self, value: float) -> None:
        self._trace.append(float(value))
        if len(self._trace) > self.max_history:
            self._trace = self._trace[-self.max_history:]

    def extend(self, values) -> None:
        for v in values:
            self.push(v)

    @property
    def ready(self) -> bool:
        return len(self._trace) >= max(self.min_history, 2 * self.window)

    def _series(self) -> np.ndarray:
        return np.asarray(self._trace, np.float32)

    def scan(self, top_k: int = 3) -> list[Discord]:
        """Full-profile scan of current history; returns alarmed discords."""
        if not self.ready:
            return []
        result = matrix_profile(self._series(), self.window,
                                normalize=self.normalize, device=self.device)
        count, mean, std = _finite_stats(result.p)
        if count < 8:
            return []
        excl = max(1, self.window // 4)
        out = []
        for d in analytics.discords(result, n=top_k, exclusion=excl):
            z = (d.score - mean) / std
            if z >= self.zscore_alarm:
                out.append(Discord(position=d.position, score=d.score,
                                   zscore=z))
        return out

    def motif(self) -> tuple[int, int] | None:
        """Most repeated pattern (for e.g. periodic-straggler diagnosis)."""
        if not self.ready:
            return None
        result = matrix_profile(self._series(), self.window,
                                device=self.device)
        motifs = analytics.top_motifs(result, max_motifs=1)
        return (motifs[0].a, motifs[0].b) if motifs else None


@dataclasses.dataclass
class FleetAlert:
    """One alarmed discord in one fleet tenant (epoch-local `position`)."""

    tenant: int
    position: int
    score: float          # profile value (distance to nearest neighbor)
    zscore: float         # score vs that tenant's profile distribution
    neighbor: int         # nearest neighbor's start position (-1 if none)


@dataclasses.dataclass
class FleetMonitor:
    """Per-tenant discord alerting over a `StreamingFleet` — the
    `TelemetryMonitor.scan` gate (z-score of the discord's profile value
    against that tenant's own profile distribution, via
    `analytics.discords`) applied fleet-wide, with an optional `on_alert`
    callback fired per alert as it is found.

    One `fleet.snapshot(t)` per scanned tenant (its rows only); tenants
    whose current epoch has fewer than `min_windows` finite profile entries
    are skipped (a fresh or mostly-masked tenant has no distribution to
    gate against)."""

    fleet: object                       # StreamingFleet (duck-typed)
    zscore_alarm: float = 4.0
    top_k: int = 3
    min_windows: int = 8
    on_alert: object | None = None      # callable(FleetAlert) -> None

    def scan(self, tenants=None) -> list[FleetAlert]:
        """Scan every tenant (or just `tenants`); returns alarmed discords
        ordered by tenant then severity, invoking `on_alert` for each."""
        which = range(self.fleet.n) if tenants is None \
            else [int(t) for t in tenants]
        out: list[FleetAlert] = []
        for t in which:
            result = self.fleet.snapshot(t)
            count, mean, std = _finite_stats(result.p)
            if count < self.min_windows:
                continue
            for d in analytics.discords(result, n=self.top_k):
                z = (d.score - mean) / std
                if z >= self.zscore_alarm:
                    alert = FleetAlert(tenant=t, position=d.position,
                                       score=d.score, zscore=z,
                                       neighbor=d.neighbor)
                    out.append(alert)
                    if self.on_alert is not None:
                        self.on_alert(alert)
        return out
