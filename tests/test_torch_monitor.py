"""The port's monitors (`repro_torch.core.monitor`) against the
reference's (`repro.core.monitor`) on the same data, on the CPU — twins of
`tests/test_substrate.py:153-168` and `tests/test_fleet.py:188`.

Tolerances: alert positions, tenants, neighbours and motif pairs are
EQUAL. `FleetMonitor` reads f64 fleet profiles in both packages: scores
and z-scores within 1e-9 relative. `TelemetryMonitor.scan` reads the f32
raw (`normalize=False`) sweep, where the two packages round differently
(ROADMAP.md §C). On the spike trace below (seed 0) the scores differ by
3.1e-6 relative and the z-scores by 4.6e-5; over seeds 0..23 of the same
trace the most is 5.2e-6 and 6.5e-5. A z-score divides by the profile's
spread, which takes the rounding of every small distance, hence the
larger figure. Scores are held within 2e-5 relative, z-scores within
1e-4.
"""

import jax
import numpy as np
import pytest
import torch

from repro.core import zstats as rz
from repro.core.fleet import StreamingFleet as RefFleet
from repro.core.monitor import FleetMonitor as RefFleetMonitor
from repro.core.monitor import TelemetryMonitor as RefTelemetryMonitor
from repro_torch.core.fleet import StreamingFleet
from repro_torch.core.monitor import (Discord, FleetAlert, FleetMonitor,
                                      TelemetryMonitor)

F32_SCORE_RTOL = 2e-5
F32_ZSCORE_RTOL = 1e-4
F64_RTOL = 1e-9


@pytest.fixture
def ref_x64(monkeypatch):
    monkeypatch.setattr(rz, "x64_scope", lambda: jax.enable_x64(True))


def _spike_trace():
    rng = np.random.default_rng(0)
    trace = 2.0 + 0.9 ** np.arange(300) + 0.01 * rng.normal(size=300)
    trace[200:216] += np.linspace(0, 2.0, 16)       # loss spike
    return trace


def _monitors(trace, **kw):
    port = TelemetryMonitor(device="cpu", **kw)
    ref = RefTelemetryMonitor(**kw)
    port.extend(trace)
    ref.extend(trace)
    return port, ref


def test_monitor_flags_planted_anomaly_as_the_reference_does():
    port, ref = _monitors(_spike_trace(), window=16, min_history=128,
                          zscore_alarm=3.0)
    hits, want = port.scan(top_k=2), ref.scan(top_k=2)
    assert hits and min(abs(h.position - 200) for h in hits) < 24
    assert all(isinstance(h, Discord) for h in hits)
    assert [h.position for h in hits] == [w.position for w in want]
    for h, w in zip(hits, want):
        assert h.score == pytest.approx(w.score, rel=F32_SCORE_RTOL)
        assert h.zscore == pytest.approx(w.zscore, rel=F32_ZSCORE_RTOL)


def test_monitor_quiet_on_clean_trace():
    rng = np.random.default_rng(1)
    port, ref = _monitors(2.0 + 0.01 * rng.normal(size=300), window=16,
                          min_history=128, zscore_alarm=4.0)
    assert port.scan(top_k=1) == [] == ref.scan(top_k=1)


def test_motif_names_the_planted_pair_as_the_reference_does():
    """The z-normalized self-join (on the card, the NATSA kernel)."""
    rng = np.random.default_rng(2)
    trace = 2.0 + 0.1 * rng.normal(size=600)
    trace[400:416] = trace[100:116] - trace[100] + trace[399]
    port, ref = _monitors(trace, window=16, min_history=128)
    got = port.motif()
    assert set(got) == {100, 400}
    assert got == ref.motif()


def test_history_bound_readiness_and_device_rule(monkeypatch):
    mon = TelemetryMonitor(window=8, min_history=20, max_history=50,
                           device="cpu")
    assert mon.scan() == [] and mon.motif() is None      # not ready yet
    mon.extend(np.arange(60.0))
    assert mon.ready and len(mon._trace) == 50 and mon._trace[0] == 10.0
    card = TelemetryMonitor(window=8, min_history=20)   # device=None
    card.extend(np.sin(np.arange(60.0)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        card.scan()


def _fleet_data(n, length):
    rng = np.random.RandomState(0)
    base = np.sin(np.arange(length) / 3.0) + 0.01 * rng.randn(length)
    for tenant in range(n):
        vals = base.copy()
        if tenant == 1:
            vals[200:208] += 3.0        # level anomaly, tenant 1 only
        yield tenant, vals


def test_fleet_monitor_alerts_and_callback(ref_x64):
    """:188 — a planted per-tenant anomaly alarms that tenant only; the
    callback sees every alert in order; the same alerts as the reference's
    monitor over the reference's fleet."""
    n, m, cap, length = 3, 8, 512, 320
    fleet = StreamingFleet(n, window=m, capacity=cap, normalize=False,
                           device="cpu")
    ref = RefFleet(n, window=m, capacity=cap, normalize=False)
    for tenant, vals in _fleet_data(n, length):
        fleet.ingest(np.full(length, tenant), vals)
        ref.ingest(np.full(length, tenant), vals)
    seen = []
    mon = FleetMonitor(fleet, zscore_alarm=3.5, top_k=2, on_alert=seen.append)
    alerts = mon.scan()
    assert alerts and alerts == seen
    assert {a.tenant for a in alerts} == {1}
    assert all(isinstance(a, FleetAlert) for a in alerts)
    assert min(abs(a.position - 200) for a in alerts) <= m
    assert mon.scan(tenants=[0, 2]) == []
    want = RefFleetMonitor(ref, zscore_alarm=3.5, top_k=2).scan()
    assert ([(a.tenant, a.position, a.neighbor) for a in alerts]
            == [(a.tenant, a.position, a.neighbor) for a in want])
    for a, w in zip(alerts, want):
        assert a.score == pytest.approx(w.score, rel=F64_RTOL)
        assert a.zscore == pytest.approx(w.zscore, rel=F64_RTOL)


def test_fleet_monitor_skips_tenants_without_a_distribution():
    fleet = StreamingFleet(3, window=8, capacity=64, normalize=False,
                           device="cpu")
    fleet.ingest(np.zeros(20, int), np.sin(np.arange(20.0)))   # 13 windows
    fleet.ingest(np.ones(10, int), np.sin(np.arange(10.0)))    # 3 windows
    calls = []
    mon = FleetMonitor(fleet, zscore_alarm=-np.inf, top_k=1,
                       min_windows=8, on_alert=calls.append)
    assert [a.tenant for a in mon.scan()] == [0] == [a.tenant for a in calls]
