"""Async round loop: bounded in-flight dispatch, sync only at delivery —
port of `repro.serve.rounds`.

A loop that launches round k, synchronizes, THEN assembles round k+1
leaves the card idle through every host-side assembly and the host idle
through every sweep. CUDA launches are asynchronous — a kernel call returns
once it is queued on the stream — so the fix is structural: keep up to
`depth` dispatched rounds in flight, assemble round k+1 on the host while
round k runs, and wait on the card ONLY when a result is delivered.

`dispatch(payload, meta)` takes a round whose launches the caller already
queued and records a `torch.cuda.Event` on the current stream of the
payload's card right after them; it returns at once unless the window is
full — then the OLDEST round is delivered first (bounded memory: at most
`depth` rounds of results live at once). `deliver_next` waits on that
round's event, the loop's own only sync (the reference's
`jax.block_until_ready`). The caller's launches may wait too: the profile
service uploads each pair's seeds from pageable host memory, a copy that
waits for the stream. A payload of CPU tensors is ready when dispatched:
there is nothing to wait for. `drain()` delivers the rest in dispatch
order.
"""

from __future__ import annotations

from collections import deque

import torch


def _cuda_device(payload):
    """The CUDA device of the first CUDA tensor in a (nested dict / list /
    tuple) payload, or None."""
    if isinstance(payload, torch.Tensor):
        return payload.device if payload.is_cuda else None
    if isinstance(payload, dict):
        payload = list(payload.values())
    if isinstance(payload, (list, tuple)):
        for leaf in payload:
            dev = _cuda_device(leaf)
            if dev is not None:
                return dev
    return None


class RoundLoop:
    """Bounded in-flight window over asynchronously dispatched rounds."""

    def __init__(self, depth: int = 2, deliver=None):
        """`depth` — max rounds in flight (2 = classic double buffering:
        one executing, one assembling). `deliver(meta, payload)` — the
        result sink, called once the payload's launches have finished."""
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self.depth = int(depth)
        self._deliver = deliver
        self._inflight: deque = deque()
        self.dispatched = 0
        self.delivered = 0

    def __len__(self) -> int:
        return len(self._inflight)

    def dispatch(self, payload, meta=None) -> None:
        """Track one dispatched round. `payload` is any nest of tensors the
        caller's sweep already launched. If the window is full, the oldest
        round is delivered (waiting on ITS event — by then usually already
        passed) before this one is admitted, so dispatch order == delivery
        order and memory stays bounded."""
        while len(self._inflight) >= self.depth:
            self.deliver_next()
        dev = _cuda_device(payload)
        event = None
        if dev is not None:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(dev))
        self._inflight.append((meta, payload, event))
        self.dispatched += 1

    def deliver_next(self):
        """Wait until the OLDEST in-flight round is done and deliver it.
        This is the only place the loop synchronizes with the card."""
        if not self._inflight:
            raise RuntimeError("no rounds in flight")
        meta, payload, event = self._inflight.popleft()
        if event is not None:
            event.synchronize()
        self.delivered += 1
        if self._deliver is not None:
            self._deliver(meta, payload)
        return meta, payload

    def drain(self) -> list:
        """Deliver every remaining in-flight round, dispatch order."""
        out = []
        while self._inflight:
            out.append(self.deliver_next())
        return out
