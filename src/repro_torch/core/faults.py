"""Fault primitives — port of `repro.core.faults` (numpy only).

The pieces here are host-side and deterministic, and the same seed gives
the same schedule and the same flipped bytes as the reference:

  * `FaultPolicy` — the knobs of a supervised loop: per-round retry count
    and exponential backoff (the profile service retries a shard group's
    dispatch under them), and the supervised scheduler's own
    (`core.scheduler.AnytimeScheduler.run_supervised`): when a repeatedly
    crashing worker is excluded and the remaining chunks replanned over
    the survivors, how often to checkpoint, and whether exhausted retries
    degrade gracefully (return the current anytime answer tagged with its
    `fraction_done`) or raise;
  * `FaultInjector` — a SEEDED, fully deterministic schedule of faults
    (worker crashes per round, transient round failures, kill-mid-checkpoint
    writes, post-write checkpoint bit-flips). The supervised scheduler and
    the profile service consult the round hooks `crashed_workers` and
    `round_should_fail` once per tick; the checkpoint writers consult
    `on_checkpoint_write` and `after_checkpoint_write`;
  * `SupervisedReport` — what one `run_supervised` call did: rounds,
    retries, excluded workers, replans, checkpoints written/failed,
    degradation;
  * `flip_bits` — the model of silent disk corruption.

Exceptions: `RoundFailure` is the retryable dispatch failure;
`CheckpointWriteError` marks an interrupted checkpoint write (the previous
on-disk checkpoint is still intact — atomic rename commit);
`CheckpointCorruptionError` is raised when a checkpoint fails
checksum/truncation verification (a restore then falls back to the
previous good file if one exists).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np


class RoundFailure(RuntimeError):
    """A round dispatch failed (injected or real). Retryable: the running
    profile state is untouched — the round simply was not committed."""


class CheckpointWriteError(RuntimeError):
    """A checkpoint write was interrupted before its atomic commit. The
    previously committed checkpoint (if any) is intact."""


class CheckpointCorruptionError(ValueError):
    """A checkpoint failed verification on load: truncated archive, missing
    arrays, checksum mismatch, or an unreadable meta record."""


@dataclasses.dataclass(frozen=True)
class FaultPolicy:
    """Supervision knobs, with the reference's fields and defaults.

    max_retries              retries per round before giving up on it
    backoff_base/backoff_max exponential backoff (seconds) between retries:
                             delay = min(base * 2**(attempt-1), max)
    worker_failure_threshold crashes after which a worker slot is excluded
                             and the remaining chunks replanned over the
                             survivors
    min_workers              never exclude below this many survivors
    checkpoint_every         checkpoint every N completed rounds (None = no
                             periodic checkpointing; requires a
                             `checkpoint_path` either way)
    degrade_gracefully       on exhausted retries return the current anytime
                             `ProfileResult` tagged with `fraction_done`
                             instead of raising
    sleep                    injectable clock (tests pass a no-op)

    The profile service reads the retry knobs only; the other four are
    `run_supervised`'s.
    """

    max_retries: int = 3
    backoff_base: float = 0.05
    backoff_max: float = 2.0
    worker_failure_threshold: int = 2
    min_workers: int = 1
    checkpoint_every: int | None = None
    degrade_gracefully: bool = True
    sleep: Callable[[float], None] = dataclasses.field(default=time.sleep)

    def backoff(self, attempt: int) -> float:
        """Delay before retry `attempt` (1-based)."""
        return min(self.backoff_base * (2.0 ** max(attempt - 1, 0)),
                   self.backoff_max)


@dataclasses.dataclass
class SupervisedReport:
    """What one `run_supervised` call did — the observable fault history."""

    rounds: int = 0
    retries: int = 0
    worker_failures: dict = dataclasses.field(default_factory=dict)
    excluded_workers: list = dataclasses.field(default_factory=list)
    replans: int = 0
    checkpoints_written: int = 0
    checkpoint_failures: int = 0
    checkpoints_corrupted: int = 0
    degraded: bool = False
    fraction_done: float = 1.0


@dataclasses.dataclass
class FaultInjector:
    """Deterministic fault schedule, keyed by a tick counter (one tick per
    round: a scheduling iteration, or a shard-group dispatch of the profile
    service) and a checkpoint serial.

    worker_crashes    tick -> worker slots that crash that round (their
                      chunk contribution is discarded and replanned)
    round_failures    tick -> number of consecutive attempts that fail with
                      `RoundFailure` before the round succeeds
    checkpoint_kills  checkpoint serials whose write dies before commit
    checkpoint_flips  checkpoint serials whose committed file gets bit-flips
                      (silent disk corruption; detected by checksums on
                      resume)
    seed              drives the deterministic bit-flip positions
    """

    worker_crashes: dict = dataclasses.field(default_factory=dict)
    round_failures: dict = dataclasses.field(default_factory=dict)
    checkpoint_kills: set = dataclasses.field(default_factory=set)
    checkpoint_flips: set = dataclasses.field(default_factory=set)
    seed: int = 0

    @classmethod
    def seeded(cls, seed: int, *, n_rounds: int, n_workers: int,
               p_worker_crash: float = 0.0, p_round_failure: float = 0.0,
               max_round_failures: int = 1, p_checkpoint_kill: float = 0.0,
               p_checkpoint_flip: float = 0.0,
               n_checkpoints: int | None = None) -> "FaultInjector":
        """Build a random-but-reproducible schedule: same seed, same faults.
        `n_rounds` should upper-bound the ticks the loop will take (retried
        and replanned rounds consume extra ticks)."""
        rng = np.random.default_rng(seed)
        crashes: dict = {}
        failures: dict = {}
        for t in range(int(n_rounds)):
            hit = rng.random(n_workers) < p_worker_crash
            if hit.any():
                crashes[t] = set(int(w) for w in np.flatnonzero(hit))
            if rng.random() < p_round_failure:
                failures[t] = 1 + int(rng.integers(0, max(
                    int(max_round_failures), 1)))
        kills: set = set()
        flips: set = set()
        for s in range(int(n_checkpoints if n_checkpoints is not None
                           else n_rounds)):
            r = rng.random()
            if r < p_checkpoint_kill:
                kills.add(s)
            elif r < p_checkpoint_kill + p_checkpoint_flip:
                flips.add(s)
        return cls(worker_crashes=crashes, round_failures=failures,
                   checkpoint_kills=kills, checkpoint_flips=flips,
                   seed=int(seed))

    # -- round hooks, consulted once per tick -----------------------------

    def crashed_workers(self, tick: int) -> set:
        return set(self.worker_crashes.get(tick, ()))

    def round_should_fail(self, tick: int, attempt: int) -> bool:
        """True while `attempt` (0-based) is below the scheduled failure
        count for this tick — retry `attempt = count` then succeeds."""
        return attempt < int(self.round_failures.get(tick, 0))

    # -- hooks consulted by the checkpoint writer -------------------------

    def on_checkpoint_write(self, serial: int) -> None:
        """Called mid-write, before the atomic commit."""
        if serial in self.checkpoint_kills:
            raise CheckpointWriteError(
                f"injected kill during checkpoint write (serial {serial})")

    def after_checkpoint_write(self, serial: int, path: str) -> bool:
        """Called after a successful commit; corrupts the file in place when
        scheduled. Returns True if the file was corrupted."""
        if serial in self.checkpoint_flips:
            flip_bits(path, seed=self.seed * 1_000_003 + serial)
            return True
        return False


def flip_bits(path: str, *, seed: int, n_flips: int = 16) -> None:
    """Flip `n_flips` deterministic bits of the file in place — the chaos
    harness's model of silent disk corruption. Flips land in the strict
    interior so the corruption hits array payloads, not just the zip
    directory at either end."""
    rng = np.random.default_rng(seed)
    with open(path, "r+b") as f:
        f.seek(0, 2)
        size = f.tell()
        lo, hi = size // 4, max(size // 4 + 1, 3 * size // 4)
        for off in rng.integers(lo, hi, size=n_flips):
            f.seek(int(off))
            b = f.read(1)
            if not b:
                continue
            f.seek(int(off))
            f.write(bytes([b[0] ^ (1 << int(rng.integers(0, 8)))]))
