"""Always-on matrix-profile serving tier — port of `repro.serve`.

NATSA's thesis is keeping time-series data resident next to the compute and
streaming queries past it. This package is that tier for the port:

  * `corpus`   — `ShardedCorpus`: N series loaded ONCE, per-series z-stats +
    centered windows computed host-side in f64 and kept resident (streams
    on each shard's device), so a query never recomputes corpus-side state;
  * `frontend` — `ProfileService`: accepts concurrent AB-join queries,
    sweeps each compatible batch against every shard, one `ab_join` plan
    per (query, series) pair (k = 1: one NATSA kernel launch on the card;
    k > 1: rowstream or the band engine), union-merges per-shard top-k
    sets into one `ProfileResult` per query;
  * `queue`    — admission control: bounded queue, per-query deadlines,
    geometry-bucketing batcher, rejection/backpressure accounting;
  * `rounds`   — the async round loop: bounded in-flight dispatch, host
    assembly of group k+1 overlapping the card's sweeps of group k, a CUDA
    event wait only at result delivery.
"""

from repro_torch.serve.corpus import ShardedCorpus
from repro_torch.serve.frontend import ProfileService, ServeAnswer
from repro_torch.serve.queue import AdmissionQueue, QueryRejected, QueueStats
from repro_torch.serve.rounds import RoundLoop

__all__ = [
    "AdmissionQueue",
    "ProfileService",
    "QueryRejected",
    "QueueStats",
    "RoundLoop",
    "ServeAnswer",
    "ShardedCorpus",
]
