"""Quickstart on the PyTorch/CUDA port: exact matrix profile on a synthetic
ECG-like series — `examples/quickstart.py`'s scenario through `repro_torch`.

`matrix_profile` returns a rich `ProfileResult` — merged profile
(`.p`/`.i`), LEFT/RIGHT split profiles, and (with `k > 1`) exact top-k
neighbor sets — and the `analytics` layer turns it into motifs and
discords without re-sweeping. `k = 4` runs on the band engine; the plain
k = 1 call below sweeps with the NATSA CUDA kernel on the card (its plain
PyTorch version on the host) and returns the same object.

    PYTHONPATH=src python examples/quickstart_torch.py               # the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu  # the host
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch.core import analytics
from repro_torch.core.matrix_profile import matrix_profile
from repro_torch.kernels import ops
from repro_torch.utils.device import resolve_device

N, M = 6000, 120


def series() -> np.ndarray:
    """The reference example's series, made by the same numpy calls: a
    low-pass random walk, a chirp repeated at 800 and 4200, a noise
    window at 2600."""
    n, m = N, M
    # smooth aperiodic background (low-pass random walk)
    rng = np.random.default_rng(5)
    walk = np.cumsum(rng.normal(size=n + 40))
    ts = np.convolve(walk, np.ones(41) / 41, mode="valid")[:n].astype(np.float32)
    # motif: an exactly repeated chirp burst at 800 and 4200
    t = np.linspace(0, 1, m)
    pattern = (np.sin(2 * np.pi * (2 * t + 6 * t * t)) * 3
               + 0.05 * np.random.default_rng(3).normal(size=m)).astype(np.float32)
    ts[800:800 + m] = pattern
    ts[4200:4200 + m] = pattern
    # discord: a shape anomaly (signal replaced by noise for one window)
    ts[2600:2600 + m] = ts[2600] + 0.5 * np.random.default_rng(9).normal(
        size=m).astype(np.float32)
    return ts


def main(device=None) -> dict:
    """Run the scenario on `device` (None: the card); returns what it
    found: the engine's motif pair and top-3 discords, the k = 1 kernel
    path's motif pair and its max |Δ| against the engine, and both
    profiles."""
    n, m = N, M
    ts = series()
    dev = resolve_device(device)
    print(f"series n={n}, window m={m}")

    result = matrix_profile(ts, m, k=4, device=dev)
    motifs = analytics.top_motifs(result, max_motifs=1)
    i, j = motifs[0].a, motifs[0].b
    print(f"[engine] top motif pair: ({i}, {j})  (planted at 800 / 4200)")
    discords = analytics.discords(result, n=3, exclusion=m)
    print(f"[engine] top-3 discords: {[d.position for d in discords]}  "
          f"(noise window planted at ~2600)")
    # the same sweep also harvested the split profiles and top-k sets
    assert bool((torch.minimum(result.left_p, result.right_p)
                 == result.p).all())
    print(f"[engine] left/right split: e.g. position {i} has left neighbor "
          f"{int(result.left_i[i])} and right neighbor "
          f"{int(result.right_i[i])}; top-{result.k} neighbors of {i}: "
          f"{result.topk_i[i].tolist()}")

    kres = ops.natsa_matrix_profile(ts, m, device=dev)
    label = ("NATSA CUDA kernel" if dev.type == "cuda"
             else "NATSA kernel's plain version, CPU")
    err = (kres.p - result.p).abs()
    err = float(err[torch.isfinite(err)].max())
    print(f"[{label}] max |Δ| vs engine: {err:.2e}")

    kmot = analytics.top_motifs(kres, max_motifs=1)[0]
    print(f"[{label}] top motif pair: ({kmot.a}, {kmot.b})")
    pair = sorted((i, j))
    assert abs(pair[0] - 800) < 40 and abs(pair[1] - 4200) < 40, pair
    assert any(abs(d.position - 2600) < m for d in discords), discords
    print("OK — motif and discord recovered.")
    return {"motif": (i, j), "discords": [d.position for d in discords],
            "kernel_motif": (kmot.a, kmot.b), "kernel_vs_engine": err,
            "profile": result.p.cpu(), "kernel_profile": kres.p.cpu()}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    main(ap.parse_args().device)
