"""The paper's engine as a training-telemetry monitor on the PyTorch/CUDA
port: detect a silent loss anomaly with matrix-profile discord discovery
(threshold alarms miss it because the trace also drifts and oscillates) —
`examples/anomaly_monitor.py`'s scenario through `repro_torch`.

The non-normalized profile comes back as a `ProfileResult` and
`analytics.discords` ranks the anomalies straight off it — the
`TelemetryMonitor` convenience wrapper (same machinery + z-score alarm
gating) is shown alongside; its `motif` is a z-normalized self-join, one
NATSA kernel launch on the card.

    PYTHONPATH=src python examples/anomaly_monitor_torch.py               # the card
    PYTHONPATH=src python examples/anomaly_monitor_torch.py --device cpu  # the host
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np

from repro_torch.core import analytics
from repro_torch.core.matrix_profile import matrix_profile
from repro_torch.core.monitor import TelemetryMonitor

WINDOW = 24


def loss_trace() -> np.ndarray:
    """The reference example's trace, made by the same numpy calls: mild
    decay, an LR-schedule oscillation and noise, with a small shape/level
    anomaly at steps 400..423."""
    rng = np.random.default_rng(0)
    steps = 600
    # realistic post-warmup loss telemetry: mild decay + LR-schedule
    # oscillation + noise (monitors attach after the steep warmup phase)
    t = np.arange(steps)
    loss = (2.2 * 0.9995 ** t + 0.05 * np.sin(t / 7.0)
            + 0.02 * rng.normal(size=steps))
    # silent data corruption: a small shape/level anomaly
    loss[400:424] += 0.12 * np.sin(t[400:424] * 2.1)
    return loss


def main(device=None) -> dict:
    """Run the scenario on `device` (None: the card); returns what it
    found: the raw profile's top-3 discords (position, neighbour), the
    monitor's alarms (position, z-score) and its motif pair, and the raw
    profile."""
    loss = loss_trace()
    window = WINDOW
    # telemetry anomalies are amplitude/level changes -> NON-normalized
    # profile (z-norm factors exactly those out)
    result = matrix_profile(loss.astype(np.float32), window, normalize=False,
                            device=device)
    hits = analytics.discords(result, n=3)
    print(f"scanned {len(loss)} steps of loss telemetry "
          f"(analytics.discords over a {result.kind}-join ProfileResult)")
    for h in hits:
        print(f"  DISCORD at step {h.position} (dist={h.score:.3f}, "
              f"nearest neighbour at step {h.neighbor})")
    assert hits and min(abs(h.position - 400) for h in hits) < 30, hits
    print("OK — corruption window (planted at step 400) flagged.")

    # the TelemetryMonitor wrapper adds z-score alarm gating on top of the
    # same analytics.discords call
    mon = TelemetryMonitor(window=window, min_history=128, zscore_alarm=3.0,
                           device=device)
    mon.extend(loss)
    alarms = mon.scan(top_k=3)
    print(f"[TelemetryMonitor] alarmed: "
          f"{[(h.position, round(h.zscore, 1)) for h in alarms]}")
    assert alarms and min(abs(h.position - 400) for h in alarms) < 30

    mot = mon.motif()
    print(f"most-repeated telemetry pattern at steps {mot} "
          f"(the LR oscillation period)")
    return {"discords": [(h.position, h.neighbor) for h in hits],
            "alarms": [(h.position, h.zscore) for h in alarms],
            "motif": mot, "profile": result.p.cpu()}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    main(ap.parse_args().device)
