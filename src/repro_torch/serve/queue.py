"""Admission control and job orchestration for the profile service — port
of `repro.serve.queue` (host-side, numpy only; the same FIFO order,
geometry buckets, expiry and backpressure).

The front-end's contract is bounded memory and bounded staleness: a full
queue REJECTS new queries at submit time (backpressure the caller can see
and retry, instead of an unbounded pending list exhausting the host), and
every query may carry a deadline — a query still queued past its deadline
is delivered as an EXPIRED degraded answer (coverage 0) rather than holding
a batch slot forever.

The batcher is geometry-bucketing: compatible queries — same subsequence
count and k — form one batch, and the bucket containing the OLDEST pending
query is served first (no starvation: age, not bucket size, picks the next
batch). `QueueStats` counts every admission decision so
rejection/backpressure behavior is observable, not inferred.
"""

from __future__ import annotations

import dataclasses
import itertools
import time

import numpy as np


class QueryRejected(RuntimeError):
    """Raised at submit time when the queue is full (backpressure)."""


@dataclasses.dataclass
class QueueStats:
    """Admission counters — every submitted query ends in exactly one of
    completed/rejected/expired (degraded completions count in BOTH
    `completed` and `degraded`)."""

    submitted: int = 0
    accepted: int = 0
    rejected: int = 0
    expired: int = 0
    completed: int = 0
    degraded: int = 0
    batches: int = 0

    @property
    def pending(self) -> int:
        return self.accepted - self.completed - self.expired


@dataclasses.dataclass
class PendingQuery:
    """One admitted query: the raw values plus its admission metadata."""

    qid: int
    values: np.ndarray             # (n_q,) f64
    l_q: int                       # subsequence count — the geometry key
    k: int
    deadline: float | None         # absolute monotonic time, or None
    submitted_at: float

    def expired(self, now: float) -> bool:
        return self.deadline is not None and now > self.deadline


class AdmissionQueue:
    """Bounded FIFO of admitted queries with geometry-bucketed batching."""

    def __init__(self, window: int, max_pending: int = 64,
                 max_batch: int = 32):
        if max_pending < 1 or max_batch < 1:
            raise ValueError("max_pending and max_batch must be >= 1")
        self.window = int(window)
        self.max_pending = int(max_pending)
        self.max_batch = int(max_batch)
        self.stats = QueueStats()
        self._pending: list[PendingQuery] = []      # FIFO, oldest first
        self._qids = itertools.count()

    def __len__(self) -> int:
        return len(self._pending)

    def submit(self, values, *, k: int = 1, deadline: float | None = None,
               now: float | None = None) -> PendingQuery:
        """Admit one query or raise `QueryRejected` (queue full). `deadline`
        is a RELATIVE budget in seconds from submission."""
        self.stats.submitted += 1
        if len(self._pending) >= self.max_pending:
            self.stats.rejected += 1
            raise QueryRejected(
                f"queue full ({self.max_pending} pending); retry later")
        v = np.atleast_1d(np.asarray(values, np.float64))
        if v.ndim != 1 or v.shape[0] < self.window:
            self.stats.submitted -= 1      # malformed, not a load decision
            raise ValueError(f"query must be 1-D with >= {self.window} "
                             f"points, got shape {v.shape}")
        now = time.monotonic() if now is None else now
        q = PendingQuery(
            qid=next(self._qids), values=v,
            l_q=v.shape[0] - self.window + 1, k=int(k),
            deadline=None if deadline is None else now + float(deadline),
            submitted_at=now)
        self._pending.append(q)
        self.stats.accepted += 1
        return q

    def take_expired(self, now: float | None = None) -> list[PendingQuery]:
        """Remove and return every query whose deadline has passed while it
        sat in the queue — the front-end turns these into coverage-0
        degraded answers."""
        now = time.monotonic() if now is None else now
        out = [q for q in self._pending if q.expired(now)]
        if out:
            self._pending = [q for q in self._pending if not q.expired(now)]
            self.stats.expired += len(out)
        return out

    def take_batch(self, now: float | None = None) -> list[PendingQuery]:
        """Remove and return the next geometry-compatible batch: every
        pending query sharing the OLDEST query's (l_q, k), oldest-first,
        up to `max_batch`. Empty list when nothing is pending."""
        if not self._pending:
            return []
        now = time.monotonic() if now is None else now
        head = self._pending[0]
        key = (head.l_q, head.k)
        batch = [q for q in self._pending
                 if (q.l_q, q.k) == key][:self.max_batch]
        taken = set(id(q) for q in batch)
        self._pending = [q for q in self._pending if id(q) not in taken]
        self.stats.batches += 1
        return batch

    def mark_completed(self, n: int = 1, *, degraded: int = 0) -> None:
        self.stats.completed += n
        self.stats.degraded += degraded
