"""The always-on profile service on the PyTorch/CUDA port: a resident corpus
answering batched AB-join queries — `examples/serve_profiles.py`'s scenario
through `repro_torch.serve`.

A fleet of reference series is loaded ONCE into a `ShardedCorpus` (per-
series z-stats and centered windows stay resident on the card; queries
never recompute corpus-side state), then concurrent queries are pushed
through the `ProfileService` front-end: every compatible batch is swept
against each shard, one NATSA kernel launch per (query, series) pair at
k = 1 (ROADMAP.md §C (14): the reference sweeps a shard group as one
vmapped engine batch), the per-shard sets union-merge into one
`ProfileResult` per query, and every answer names the WINNING SERIES per
position, not just the position. Deadline and backpressure semantics are
shown at the end: a lapsed query comes back as a valid coverage-0 answer,
and a full queue rejects instead of growing without bound.

    PYTHONPATH=src python examples/serve_profiles_torch.py               # the card
    PYTHONPATH=src python examples/serve_profiles_torch.py --device cpu  # the host
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch.serve import ProfileService, QueryRejected, ShardedCorpus


def main(device=None) -> dict:
    """Run the scenario on `device` (None: the card); returns what it
    found: the probe's best (series, position), the expired answer's
    coverage and status, and whether the ninth pending query was
    rejected."""
    rng = np.random.default_rng(7)
    window = 32

    # a small fleet of reference series; series 2 gets a planted pattern
    series = [rng.normal(size=600) for _ in range(6)]
    pattern = np.sin(np.linspace(0, 4 * np.pi, 64))
    series[2][300:364] += 3.0 * pattern

    corpus = ShardedCorpus(series, window, n_shards=3, devices=[device])
    svc = ProfileService(corpus, max_pending=8, max_batch=8)

    # queries: random probes plus one containing the planted pattern
    queries = [rng.normal(size=200) for _ in range(3)]
    probe = rng.normal(size=200) * 0.1
    probe[60:124] += 3.0 * pattern
    queries.append(probe)

    answers = svc.serve(queries)
    print(f"served {len(answers)} queries against {corpus.n_series} series "
          f"in {corpus.n_shards} shards")
    for a in answers:
        best = int(torch.argmin(a.result.p))
        print(f"  q{a.qid}: status={a.status} coverage={a.coverage:.2f} "
              f"best match d={float(a.result.p[best]):.3f} -> series "
              f"{int(a.series[best])} @ {int(a.result.i[best])}")
    hit = answers[-1]
    best = int(torch.argmin(hit.result.p))
    found = (int(hit.series[best]), int(hit.result.i[best]))
    assert found[0] == 2, "probe should match the planted series"
    assert abs(found[1] - 300) < 16
    print("OK — probe matched the planted pattern in series 2.")

    # deadline: a query admitted with an already-lapsed budget is answered
    # as a VALID coverage-0 result instead of holding a batch slot
    svc.submit(rng.normal(size=200), deadline=0.0)
    time.sleep(0.01)
    expired = [a for a in svc.step() if a.status == "expired"]
    assert expired and expired[0].coverage == 0.0
    print(f"deadline: expired answer delivered (coverage="
          f"{expired[0].coverage}, all-inf profile)")

    # backpressure: the bounded queue rejects the 9th pending query
    for _ in range(8):
        svc.submit(rng.normal(size=200))
    try:
        svc.submit(rng.normal(size=200))
        raise AssertionError("expected QueryRejected")
    except QueryRejected:
        rejected = svc.stats.rejected
        print(f"backpressure: query 9 rejected "
              f"(stats: {rejected} rejected, {svc.stats.pending} pending)")
    while len(svc.queue):
        svc.step()
    svc.drain()
    return {"probe": found, "expired": [expired[0].status,
                                         expired[0].coverage,
                                         bool(torch.isinf(
                                             expired[0].result.p).all())],
            "rejected": rejected}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    main(ap.parse_args().device)
