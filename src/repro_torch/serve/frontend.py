"""The profile service: grouped query execution + per-shard union merge;
port of `repro.serve.frontend`.

`ProfileService` turns admitted queries into answers in three moves:

  1. the admission queue's batcher hands it a geometry-compatible batch
     (same subsequence count and k) — the service computes each query's
     z-stats + centered windows ONCE and reuses them against every shard;
  2. per corpus group (shard x reference length) it sweeps the Q x S
     (query, series) pairs and dispatches the group through the async
     `RoundLoop` — host assembly of the next group overlaps the card's
     sweeps of the previous one, and the card is waited on only at
     delivery. Every pair runs the unbatched AB plan `ab_join` would run
     for it: at k = 1 that is one NATSA kernel launch on the card, at k > 1
     the rowstream or the band engine (ROADMAP.md §C (14));
  3. at delivery it union-merges the per-shard neighbor sets with
     `TopKState.merge` (a stable best-first union, with indices packed as
     `sid * stride + position`) — exact for the union because shards hold
     DISJOINT series — into one `ProfileResult` per query.

Faults degrade, they don't fail: a shard that crashes (or exhausts its
`FaultPolicy.max_retries` transient retries) is dropped from the batch and
every affected answer is tagged with the coverage it actually got
(`ProfileResult.fraction_done` = fraction of corpus series consulted). A
query whose deadline lapses in the queue is answered immediately with
coverage 0 instead of holding a batch slot.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.serve.queue import AdmissionQueue, PendingQuery
from repro_torch.serve.rounds import RoundLoop


@dataclasses.dataclass
class ServeAnswer:
    """One query's answer. `result` is a standard `ProfileResult` (AB kind,
    `fraction_done` = corpus coverage; f32 / int32 tensors on the host);
    `series` maps each profile position to the WINNING corpus series id
    (`(l_q,)`, or `(l_q, k)` aligned with `result.topk_i` when k > 1), since
    a multi-series join needs (series, position) to name a neighbor, not
    position alone."""

    qid: int
    result: object                  # ProfileResult
    series: np.ndarray
    coverage: float                 # fraction of corpus series consulted
    status: str                     # "ok" | "degraded" | "expired"
    elapsed: float                  # submit -> answer, seconds
    failed_shards: tuple[int, ...] = ()

    @property
    def ok(self) -> bool:
        return self.status == "ok"


class ProfileService:
    """Always-on front-end over a `ShardedCorpus`."""

    def __init__(self, corpus, *, max_pending: int = 64, max_batch: int = 32,
                 depth: int = 2, policy=None, injector=None):
        """`policy` is a `core.faults.FaultPolicy` (retry budget + backoff
        clock for transient shard failures); `injector` a `FaultInjector`
        driving chaos tests — each group dispatch consumes one injector
        tick, `crashed_workers(tick)` naming shards that fail it outright
        and `round_should_fail(tick, attempt)` transient attempts."""
        from repro_torch.core.faults import FaultPolicy

        self.corpus = corpus
        self.queue = AdmissionQueue(corpus.window, max_pending=max_pending,
                                    max_batch=max_batch)
        self.policy = policy if policy is not None else FaultPolicy()
        self.injector = injector
        self._loop = RoundLoop(depth=depth, deliver=self._on_delivered)
        self._ready: list[ServeAnswer] = []
        self._tick = 0
        # packed-neighbor stride: one id space over (series, position)
        self._stride = max(g.l_ref for g in corpus.groups())

    # -- submission --------------------------------------------------------

    def submit(self, values, *, k: int = 1,
               deadline: float | None = None) -> int:
        """Admit one query (raises `QueryRejected` under backpressure);
        returns its qid. `deadline` is a relative budget in seconds."""
        return self.queue.submit(values, k=k, deadline=deadline).qid

    @property
    def stats(self):
        return self.queue.stats

    # -- execution ---------------------------------------------------------

    def step(self, now: float | None = None) -> list[ServeAnswer]:
        """One service step: expire lapsed queries, dispatch the next
        geometry batch across every corpus group, and return whatever
        answers became ready (expirations immediately; batch answers as
        the in-flight window rolls them out — call `drain()` to flush)."""
        now = time.monotonic() if now is None else now
        answers = [self._expired_answer(q, now)
                   for q in self.queue.take_expired(now)]
        batch = self.queue.take_batch(now)
        if batch:
            self._dispatch_batch(batch)
        answers.extend(self._ready)
        self._ready = []
        return answers

    def drain(self) -> list[ServeAnswer]:
        """Deliver every in-flight round and return the finished answers."""
        self._loop.drain()
        out = self._ready
        self._ready = []
        return out

    def serve(self, queries, *, k: int = 1) -> list[ServeAnswer]:
        """Convenience synchronous path: submit `queries`, run the loop to
        completion, return answers in submission order."""
        qids = [self.submit(q, k=k) for q in queries]
        answers = []
        while len(self.queue):
            answers.extend(self.step())
        answers.extend(self.drain())
        order = {qid: n for n, qid in enumerate(qids)}
        return sorted((a for a in answers if a.qid in order),
                      key=lambda a: order[a.qid])

    # -- internals ---------------------------------------------------------

    def _dispatch_batch(self, batch: list[PendingQuery]) -> None:
        from repro_torch.core.zstats import compute_stats_host

        m = self.corpus.window
        lq, k = batch[0].l_q, batch[0].k
        dev = self.corpus.device_of(0)
        parts = [compute_stats_host(q.values, m, min_subsequences=1,
                                    return_centered_windows=True, device=dev)
                 for q in batch]
        rec = {"batch": batch, "lq": lq, "k": k, "expected": 0,
               "collected": [], "failed_shards": []}
        for group in self.corpus.groups():
            tick = self._tick
            self._tick += 1
            if not self._group_survives(tick, group.shard):
                if group.shard not in rec["failed_shards"]:
                    rec["failed_shards"].append(group.shard)
                continue
            payload = self._sweep_group(group, parts, lq, k)  # async launch
            rec["expected"] += 1
            self._loop.dispatch(payload, meta=(rec, group))
        if rec["expected"] == 0:
            self._finalize(rec)                       # every shard failed

    def _sweep_group(self, group, parts: list, lq: int, k: int) -> dict:
        """Launch one group's sweeps, one per (query, series) pair; returns
        `{"d", "i"}`, pair-major `(Q * S, lq)` (k = 1) or `(Q * S, lq, k)`
        distances and positions."""
        from repro_torch.core import plan as plan_mod

        plan = self.corpus.plan_for(group, lq, k=k)
        outs = [plan_mod.execute(plan, pair)
                for pair in self.corpus.assemble_pairs(group, parts, plan)]
        if k == 1:
            return {"d": torch.stack([o.dist for o in outs]),
                    "i": torch.stack([o.index for o in outs])}
        return {"d": torch.stack([o.topk_dist for o in outs]),
                "i": torch.stack([o.topk_index for o in outs])}

    def _group_survives(self, tick: int, shard: int) -> bool:
        inj = self.injector
        if inj is None:
            return True
        if shard in inj.crashed_workers(tick):
            return False
        attempt = 0
        while inj.round_should_fail(tick, attempt):
            attempt += 1
            if attempt > self.policy.max_retries:
                return False
            self.policy.sleep(self.policy.backoff(attempt))
        return True

    def _on_delivered(self, meta, payload) -> None:
        rec, group = meta
        rec["collected"].append((group, payload))
        if len(rec["collected"]) == rec["expected"]:
            self._finalize(rec)

    def _finalize(self, rec: dict) -> None:
        """Union-merge every delivered group into one answer per query."""
        from repro_torch.core.matrix_profile import TopKState

        batch, lq, k = rec["batch"], rec["lq"], rec["k"]
        nq, stride = len(batch), self._stride
        dev = self.corpus.device_of(0)
        state = TopKState(
            corr=torch.full((nq, lq, k), -torch.inf, dtype=torch.float32,
                            device=dev),
            index=torch.full((nq, lq, k), -1, dtype=torch.int32, device=dev))
        covered = 0
        for group, payload in rec["collected"]:
            ns = len(group.sids)
            covered += ns
            d, i = payload["d"].to(dev), payload["i"].to(dev)
            if k == 1:
                d, i = d[..., None], i[..., None]
            # rows are query-major: (q * S + s) -> (Q, lq, S, k); pack the
            # neighbor as a single id so the union is one best-first merge
            d = d.reshape(nq, ns, lq, k).transpose(1, 2)
            i = i.reshape(nq, ns, lq, k).transpose(1, 2)
            sid = torch.tensor(group.sids, dtype=torch.int32,
                               device=dev)[None, None, :, None]
            packed = torch.where(i >= 0, sid * stride + i, -1)
            cand = TopKState(corr=(-d).reshape(nq, lq, ns * k),
                             index=packed.reshape(nq, lq, ns * k))
            # exact union: shards hold disjoint series, so no neighbor is
            # offered twice
            state = state.merge(cand)
        dist = (-state.corr).cpu()
        packed = state.index.cpu()
        pos = torch.where(packed >= 0, packed % stride, -1).to(torch.int32)
        sid = torch.where(packed >= 0, packed // stride, -1).to(torch.int32)
        coverage = covered / self.corpus.n_series
        degraded = coverage < 1.0
        now = time.monotonic()
        for n, q in enumerate(batch):
            self._ready.append(self._make_answer(
                q, dist[n], pos[n], sid[n], k, coverage,
                "degraded" if degraded else "ok",
                now, tuple(rec["failed_shards"])))
        self.queue.mark_completed(len(batch),
                                  degraded=len(batch) if degraded else 0)

    def _make_answer(self, q: PendingQuery, dist, pos, sid, k: int,
                     coverage: float, status: str, now: float,
                     failed: tuple) -> ServeAnswer:
        from repro_torch.core.result import ProfileResult

        kwargs = {}
        if k > 1:
            kwargs = {"topk_p": dist, "topk_i": pos}
        result = ProfileResult(
            dist[..., 0], pos[..., 0], kind="ab", window=self.corpus.window,
            exclusion=0, normalize=True, k=k, backend="serve",
            fraction_done=coverage, **kwargs)
        series = (sid[..., 0] if k == 1 else sid).numpy()
        return ServeAnswer(qid=q.qid, result=result, series=series,
                           coverage=coverage, status=status,
                           elapsed=now - q.submitted_at,
                           failed_shards=failed)

    def _expired_answer(self, q: PendingQuery, now: float) -> ServeAnswer:
        """A lapsed-deadline query still gets a VALID `ProfileResult` — the
        coverage-0 anytime answer (all-inf, no neighbors), tagged expired."""
        dist = torch.full((q.l_q, q.k), torch.inf, dtype=torch.float32)
        idx = torch.full((q.l_q, q.k), -1, dtype=torch.int32)
        return self._make_answer(q, dist, idx, idx.clone(), q.k, 0.0,
                                 "expired", now, ())
