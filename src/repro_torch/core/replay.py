"""`EpochReplay` — one tenant's arrivals replayed through `StreamingProfile`
with `StreamingFleet`'s epoch-restart eviction.

The fleet's contract is that a tenant is bit for bit this replay: when
the tenant's buffer already holds `capacity` samples, the next arrival
first restarts the profile from the trailing m-1 samples. The fleet's
tests and the chip smoke check hold the fleet against it; nothing else in
the package uses it.
"""

from __future__ import annotations

from repro_torch.core.streaming import StreamingProfile


class EpochReplay:
    """`push` one arrival at a time; `sp` is the current epoch's profile,
    `hist` its samples and `epochs` the number of restarts so far."""

    def __init__(self, window: int, capacity: int,
                 exclusion: int | None = None, normalize: bool = True, *,
                 device=None):
        self.m, self.cap = int(window), int(capacity)
        self.excl, self.normalize, self.device = exclusion, normalize, device
        self.sp = self._fresh()
        self.hist: list = []
        self.epochs = 0

    def _fresh(self) -> StreamingProfile:
        return StreamingProfile(self.m, self.excl, normalize=self.normalize,
                                device=self.device)

    def push(self, v) -> None:
        if len(self.hist) == self.cap:
            self.hist = self.hist[-(self.m - 1):]
            self.sp = self._fresh()
            self.sp.append(self.hist)
            self.epochs += 1
        self.sp.append(v)
        self.hist.append(v)
