"""Anytime scheduler: rounds, progress, checkpoint, elasticity — port of
`repro.core.scheduler`, over a list of devices in one process or one rank
per worker of a `torch.distributed` group.

Builds a distributed-backend `SweepPlan` (core.plan) and steps the round
function the plan executor provides (`plan.round_executor`) over an
`AnytimePlan` of equal-work chunks (`core.partition`):

  - every chunk is TWO-SIDED: each streamed cell updates both profile sides
    (row and column for self-joins; A's and B's profiles for AB joins), so a
    completed plan IS the exact answer;
  - after every round the merged profile is a valid interruptible answer
    (SCRIMP's anytime property, preserved by the interleaved chunk order);
  - progress is a per-chunk done-bitmap; (profile, bitmap) checkpoints make
    a failure cost at most one round — AB checkpoints carry both sides;
  - `resume()` replans the remaining chunks for ANY worker count (elastic
    scale-up/down and failed-worker exclusion take the same path).

`devices` takes the place of the reference's `(mesh, axis)`: one torch
device per worker, where one card may repeat (8 workers on one card);
`devices=None` is one worker on the card. Or a 1-D `DeviceMesh`
(`launch.mesh.make_worker_mesh()`), one rank per worker: every rank runs
the same scheduler on the same series (checked at construction), sweeps
its own chunk of each round and ends the round holding the same merged
state, bit for bit what the list path computes over the same chunks.
Under a group, rank 0 writes the checkpoints and every rank reads them;
a crashed worker is a `fail_workers` slot as in one process, but a real
failure of one rank is not survived: its peers stop at their next
collective and the group's timeout ends the run with an error. At k = 1
every non-empty chunk is one launch of the NATSA kernel (ROADMAP.md
§C (15)). The control plane is host-side numpy; checkpoints are the
reference's format 2, and each package, and either form of the port's
scheduler, resumes the other's.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import warnings
import zlib

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import distributed, partition
from repro_torch.core import plan as plan_mod
from repro_torch.core.faults import (CheckpointCorruptionError,
                                     CheckpointWriteError, FaultPolicy,
                                     RoundFailure, SupervisedReport)
from repro_torch.core.matrix_profile import ProfileState, TopKState
from repro_torch.core.partition import AnytimePlan
from repro_torch.core.result import ProfileResult
from repro_torch.core.validate import validate_series
from repro_torch.core.zstats import (compute_cross_stats_host,
                                     compute_stats_host)
from repro_torch.utils import trace
from repro_torch.utils.device import resolve_device

#: Checkpoint format written by `AnytimeScheduler.checkpoint`. Format 2 adds
#: per-array crc32 checksums to the meta record; format-1 files (no `format`
#: tag) still load, without checksum verification.
CHECKPOINT_FORMAT = 2


def _crc32(a: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(a).tobytes())


def _load_checkpoint_file(path: str) -> tuple[dict, dict]:
    """Load + verify one checkpoint file -> (arrays, meta).

    Raises `CheckpointCorruptionError` for anything that smells like disk
    damage (unreadable/truncated archive, missing arrays, checksum mismatch,
    unparseable meta) — the caller may then fall back to the previous good
    checkpoint. A format written by a NEWER version raises a plain
    ValueError: that is a caller error, not corruption.
    """
    with trace.span("repro_torch.scheduler.checkpoint_read"):
        try:
            with np.load(path, allow_pickle=False) as z:
                arrays = {k: z[k] for k in z.files}
        except Exception as e:  # BadZipFile, zlib errors, truncation, OSError
            raise CheckpointCorruptionError(
                f"unreadable checkpoint {path!r}: {e}") from e
        if "meta" not in arrays:
            raise CheckpointCorruptionError(
                f"checkpoint {path!r} carries no meta record")
        try:
            meta = json.loads(str(arrays["meta"]))
        except Exception as e:
            raise CheckpointCorruptionError(
                f"checkpoint {path!r} meta record is not valid JSON: "
                f"{e}") from e
        fmt = int(meta.get("format", 1))
        if fmt > CHECKPOINT_FORMAT:
            raise ValueError(
                f"checkpoint {path!r} has format {fmt}, newer than this "
                f"scheduler's supported format {CHECKPOINT_FORMAT}")
        if fmt >= 2:
            for name, want in meta.get("checksums", {}).items():
                if name not in arrays:
                    raise CheckpointCorruptionError(
                        f"checkpoint {path!r} is truncated: array {name!r} "
                        f"listed in meta but missing from the archive")
                got = _crc32(arrays[name])
                if got != int(want):
                    raise CheckpointCorruptionError(
                        f"checkpoint {path!r} failed checksum verification "
                        f"for array {name!r} (stored {want}, recomputed "
                        f"{got})")
        return arrays, meta


@dataclasses.dataclass
class SchedulerState:
    plan: AnytimePlan
    done: np.ndarray            # (C,) bool
    # merged running state (A side) on devices[0]: a ProfileState for
    # k == 1, a (l, k) TopKState for top-k schedules
    profile: ProfileState | TopKState
    rounds_completed: int
    # AB joins: B side of the sweep
    profile_b: ProfileState | TopKState | None = None

    @property
    def fraction_done(self) -> float:
        """Fraction of the ANSWER covered (true cells swept). Chunk cuts are
        balanced under the row-clamped engine COST model, so equal-time
        rounds can advance this coverage metric slightly unevenly on skewed
        AB rectangles."""
        w = self.plan.chunk_work().astype(np.float64)
        t = w.sum()
        return float((w * self.done).sum() / t) if t else 1.0


class AnytimeScheduler:
    """Round-based anytime matrix profile over a list of devices, or a 1-D
    mesh of ranks.

    Self-join by default; pass `ts_b` for an AB join — the plan then covers
    the SIGNED diagonal space of the (l_a, l_b) rectangle (no exclusion zone
    unless requested) and every round also accumulates B's profile
    (`distance_profile_b`). Rounds stay anytime-monotone; chunks harvest both
    profile sides in the same sweep, so `run()` alone is exact. The default
    self-join exclusion is the reference scheduler's max(1, window // 4),
    which rounds down where the entry points' `default_exclusion` rounds up.
    """

    def __init__(self, ts, window: int, devices=None, *, band: int = 64,
                 chunks_per_worker: int = 8, exclusion: int | None = None,
                 ts_b=None, k: int = 1):
        self.window = int(window)
        if distributed._is_mesh(devices):
            # one worker slot per rank, the state on this rank's device
            distributed._worker_group(devices)          # 1-D or raises
            self.mesh, self.devices = devices, devices
            self.slots = devices.size()
            self.home = distributed._rank_device(devices)
        else:
            self.mesh = None
            self.devices = [resolve_device(d) for d in
                            (devices if devices is not None else [None])]
            if not self.devices:
                raise ValueError("devices must name at least one device")
            self.slots = len(self.devices)
            self.home = self.devices[0]
        self.band = band
        self.k = int(k)
        self.ab = ts_b is not None
        validate_series(ts, self.window)
        if self.ab:
            validate_series(ts_b, self.window, name="ts_b")
        ts = np.asarray(ts, np.float32)
        ts_b = None if ts_b is None else np.asarray(ts_b, np.float32)
        n_workers = self.slots
        home = self.home
        if self.ab:
            self.exclusion = 0 if exclusion is None else int(exclusion)
            self.cross = compute_cross_stats_host(
                ts, ts_b, self.window, device=home)
            self.l = self.cross.l_a
            self.l_b = self.cross.l_b
            self.plan = partition.interleaved_chunks_ab(
                self.l, self.l_b, n_workers,
                chunks_per_worker=chunks_per_worker, band=band,
                excl=self.exclusion)
        else:
            self.exclusion = int(max(1, self.window // 4)
                                 if exclusion is None else exclusion)
            self.stats = compute_stats_host(ts, self.window, device=home)
            self.l = self.stats.n_subsequences
            self.l_b = None
            self.plan = partition.interleaved_chunks(
                self.l, self.exclusion, n_workers,
                chunks_per_worker=chunks_per_worker, band=band)
        self.sweep_plan = plan_mod.plan_sweep(
            self.window, self.l, self.l_b, exclusion=self.exclusion,
            band=band, backend="distributed", k=self.k, device=home)
        if self.mesh is not None:
            distributed._agree(self.mesh, "series or plan", (
                _crc32(ts), -1 if ts_b is None else _crc32(ts_b),
                self.window, self.exclusion, band, self.k,
                _crc32(np.asarray(self.plan.chunks, np.int64))))
        self._round_fn = self._make_round_fn(self.plan)
        self.state = SchedulerState(
            plan=self.plan,
            done=np.zeros(len(self.plan.chunks), bool),
            profile=self._empty_state(self.l),
            rounds_completed=0,
            profile_b=self._empty_state(self.l_b) if self.ab else None,
        )
        # set by run_supervised(): the fault history of the last supervised
        # run (core.faults.SupervisedReport), None before any such run
        self.supervised_report: SupervisedReport | None = None

    def _empty_state(self, l: int):
        if self.k > 1:
            return TopKState.empty(l, self.k, device=self.home)
        return ProfileState.empty(l, device=self.home)

    def _make_round_fn(self, plan: AnytimePlan):
        """One round step via the plan executor — the scheduler never
        touches the worker sweeps directly. `n_bands` (the band count of the
        widest chunk) is only known after partitioning, so it is stamped
        into the plan here."""
        widths = [max(0, k1 - k0) for k0, k1 in plan.chunks]
        self.n_bands = max(1, -(-max(widths) // self.band)) if widths else 1
        self.sweep_plan = dataclasses.replace(self.sweep_plan,
                                              n_bands=self.n_bands)
        return plan_mod.round_executor(self.sweep_plan, self.devices)

    @property
    def _round_stats(self):
        return self.cross if self.ab else self.stats

    @property
    def _k_empty(self) -> int:
        """Sentinel diagonal past the end of the space (empty chunk)."""
        return self.l_b if self.ab else self.l

    # -- execution ---------------------------------------------------------

    def _round_bounds(self, chunk_ids: tuple[int, ...]
                      ) -> tuple[np.ndarray, np.ndarray]:
        empty = self._k_empty
        k0s, k1s = [], []
        for c in chunk_ids:
            if c < 0 or self.state.done[c]:
                k0s.append(empty)
                k1s.append(empty)      # empty
            else:
                k0, k1 = self.plan.chunks[c]
                k0s.append(k0)
                k1s.append(k1)
        # elastic shrink: a plan for fewer workers than there are slots
        # leaves the surplus devices or ranks idle (empty chunks)
        while len(k0s) < self.slots:
            k0s.append(empty)
            k1s.append(empty)
        return (np.asarray(k0s, np.int32), np.asarray(k1s, np.int32))

    def _run_round(self, prev: SchedulerState, k0s, k1s):
        """One dispatch; returns (profile, profile_b)."""
        if self.ab:
            return self._round_fn(self._round_stats, prev.profile,
                                  prev.profile_b, k0s, k1s)
        return self._round_fn(self._round_stats, prev.profile, k0s,
                              k1s), None

    def step_round(self, *, fail_workers: set[int] | None = None,
                   injector=None, tick: int = 0,
                   attempt: int = 0) -> SchedulerState:
        """Execute the next round. `fail_workers` simulates worker
        failure: those workers' chunks are NOT marked done, their
        contribution is discarded (their chunks are emptied before the one
        dispatch, which is what the reference's re-run of the round gives)
        and they will be replanned.

        `injector`/`tick`/`attempt` thread the chaos harness through the
        dispatch: when the injector schedules a transient failure for this
        (tick, attempt) the round raises `RoundFailure` BEFORE committing
        anything — the running state is untouched, so the caller
        (`run_supervised`) can simply retry."""
        with trace.span("repro_torch.scheduler.step_round"):
            plan = self.state.plan
            r = self.state.rounds_completed
            if r >= plan.n_rounds:
                return self.state
            if (injector is not None
                    and injector.round_should_fail(tick, attempt)):
                raise RoundFailure(
                    f"injected round dispatch failure (tick {tick}, "
                    f"attempt {attempt})")
            ids = plan.rounds[r]
            fail_workers = fail_workers or set()
            with trace.span("repro_torch.scheduler.bounds"):
                k0s, k1s = self._round_bounds(ids)
                for w in fail_workers:
                    k0s[w] = self._k_empty
                    k1s[w] = self._k_empty
            merged, merged_b = self._run_round(self.state, k0s, k1s)
            done = self.state.done.copy()
            for w, c in enumerate(ids):
                if c >= 0 and w not in fail_workers:
                    done[c] = True
            self.state = SchedulerState(plan=plan, done=done, profile=merged,
                                        rounds_completed=r + 1,
                                        profile_b=merged_b)
            return self.state

    def run(self, max_rounds: int | None = None) -> SchedulerState:
        n = self.state.plan.n_rounds if max_rounds is None else max_rounds
        for _ in range(n):
            self.step_round()
        return self.state

    def run_supervised(self, policy: FaultPolicy | None = None, *,
                       checkpoint_path: str | None = None,
                       injector=None,
                       max_rounds: int | None = None) -> ProfileResult:
        """Run to completion under supervision: retries, worker exclusion,
        elastic replanning, periodic checkpointing, graceful degradation.

          * a round that raises (`RoundFailure` or any runtime dispatch
            error) is retried up to `policy.max_retries` times with
            exponential backoff; a failed attempt never touches the running
            profile, so retries are idempotent;
          * workers crashing `policy.worker_failure_threshold`+ rounds
            (their chunk contributions were discarded each time) are
            excluded and the remaining chunks replanned over the survivors
            (never below `policy.min_workers`);
          * every `policy.checkpoint_every` completed rounds the profile is
            checkpointed to `checkpoint_path` (crc32 checksums, `.prev`
            rotation);
          * if retries are exhausted and `policy.degrade_gracefully`, the
            CURRENT anytime answer is returned — tagged with its
            `fraction_done` coverage — instead of raising.

        Faults are observable afterwards in `self.supervised_report`;
        `injector` threads the deterministic chaos schedule
        (`core.faults.FaultInjector`) through rounds and checkpoint writes.
        Under a group every rank runs this loop with the same policy and
        injector, so the ranks retry, exclude and replan in step; an error
        of a collective is not retried. Returns the final (or degraded)
        `ProfileResult`.
        """
        policy = FaultPolicy() if policy is None else policy
        report = SupervisedReport()
        self.supervised_report = report
        n_devices = self.slots
        active = self.state.plan.n_workers
        tick = 0
        serial = 0
        since_ckpt = 0
        while not self.state.done.all():
            if max_rounds is not None and report.rounds >= max_rounds:
                break
            if self.state.rounds_completed >= self.state.plan.n_rounds:
                # the plan's rounds ran out but crashed chunks remain:
                # replan ONLY the not-yet-done chunks over the active
                # workers and keep going (no committed work recomputed)
                self._replan(active)
                report.replans += 1
                continue
            crashed: set[int] = set()
            if injector is not None:
                crashed = {int(w) for w in injector.crashed_workers(tick)
                           if int(w) < n_devices}
            attempt = 0
            while True:
                try:
                    self.step_round(fail_workers=crashed, injector=injector,
                                    tick=tick, attempt=attempt)
                    break
                except RuntimeError as e:
                    # RoundFailure and real dispatch errors retry alike; a
                    # failed attempt committed nothing, so the retry re-runs
                    # the SAME round against the same previous profile.
                    # Under a group only the schedule's RoundFailure, which
                    # every rank raises alike, retries: a collective's
                    # error leaves the ranks out of step.
                    if self.mesh is not None and not isinstance(
                            e, RoundFailure):
                        raise
                    attempt += 1
                    report.retries += 1
                    if attempt > policy.max_retries:
                        report.degraded = True
                        report.fraction_done = self.state.fraction_done
                        if policy.degrade_gracefully:
                            return self.result()
                        raise
                    policy.sleep(policy.backoff(attempt))
            tick += 1
            report.rounds += 1
            since_ckpt += 1
            if crashed:
                for w in sorted(crashed):
                    report.worker_failures[w] = (
                        report.worker_failures.get(w, 0) + 1)
                flaky = sorted(
                    w for w, c in report.worker_failures.items()
                    if c >= policy.worker_failure_threshold
                    and w not in report.excluded_workers)
                if flaky:
                    survivors = active - len(flaky)
                    if survivors >= max(int(policy.min_workers), 1):
                        report.excluded_workers.extend(flaky)
                        active = survivors
                        self._replan(active)
                        report.replans += 1
            if (checkpoint_path is not None and policy.checkpoint_every
                    and since_ckpt >= int(policy.checkpoint_every)):
                since_ckpt = 0
                try:
                    corrupted = self.checkpoint(
                        checkpoint_path, injector=injector, serial=serial)
                    report.checkpoints_written += 1
                    if corrupted:
                        report.checkpoints_corrupted += 1
                except CheckpointWriteError:
                    # interrupted before the atomic commit — the previous
                    # checkpoint on disk is still the good one
                    report.checkpoint_failures += 1
                serial += 1
        report.fraction_done = self.state.fraction_done
        return self.result()

    # -- fault tolerance / elasticity ---------------------------------------

    def _replan(self, n_workers: int) -> None:
        """Elastic in-flight replan: keep the merged profile and the
        done-bitmap, reassign only the remaining chunks across `n_workers`
        (the path `resume()` takes, minus the disk round-trip). Chunk
        boundaries never change, so no committed work is lost."""
        plan = partition.replan_remaining(self.plan, self.state.done,
                                          n_workers)
        self._round_fn = self._make_round_fn(plan)
        self.plan = plan
        self.state = SchedulerState(plan=plan, done=self.state.done,
                                    profile=self.state.profile,
                                    rounds_completed=0,
                                    profile_b=self.state.profile_b)

    def checkpoint(self, path: str, *, injector=None,
                   serial: int = 0) -> bool:
        """Atomically write the current (profile, done-bitmap) checkpoint,
        in the reference's format 2.

        Meta schema (JSON in the `meta` array):
          format     int   — CHECKPOINT_FORMAT of the writer
          l, l_b     int   — subsequence counts (l_b None for self-joins)
          window     int
          exclusion  int
          band, k    int
          chunks     list  — the plan's chunk boundaries (resume keeps them)
          fused      bool  — done-chunks carry BOTH profile halves
          checksums  dict  — array name -> crc32 of its raw bytes; verified
                             on load

        The write is tmpfile + `os.replace` (a crash mid-write leaves the
        old file intact); before committing, an existing checkpoint at
        `path` is rotated to `path + ".prev"` so `resume()` can fall back
        when the latest file fails verification. `injector`/`serial` thread
        the chaos harness's kill/bit-flip hooks through the commit points;
        returns True if the injector corrupted the committed file.

        Under a group rank 0 writes (every rank holds the same state) and
        broadcasts the outcome, which doubles as the barrier: every rank
        returns once the file is committed, or raises as rank 0 did
        (`CheckpointWriteError` for an interrupted write). `path` must be
        on storage every rank reads.
        """
        if self.mesh is None:
            return self._write_checkpoint(path, injector, serial)
        group, _, rank = distributed._worker_group(self.mesh)
        # 1 committed, 2 committed and corrupted, 3 interrupted, 4 failed
        outcome, err = 0, None
        if rank == 0:
            try:
                outcome = 2 if self._write_checkpoint(path, injector,
                                                      serial) else 1
            except CheckpointWriteError as e:
                outcome, err = 3, e
            except Exception as e:
                outcome, err = 4, e
        flag = torch.tensor([outcome], dtype=torch.int32, device=self.home)
        dist.broadcast(flag, src=dist.get_global_rank(group, 0), group=group)
        outcome = int(flag.item())
        if err is not None:
            raise err
        if outcome == 3:
            raise CheckpointWriteError(
                f"checkpoint write interrupted on rank 0 (serial {serial})")
        if outcome == 4:
            raise RuntimeError(f"checkpoint write to {path!r} failed on "
                               "rank 0")
        return outcome == 2

    def _write_checkpoint(self, path: str, injector, serial: int) -> bool:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = tempfile.NamedTemporaryFile(
            dir=os.path.dirname(path) or ".", delete=False, suffix=".tmp")
        arrays = dict(corr=self.state.profile.corr.cpu().numpy(),
                      index=self.state.profile.index.cpu().numpy(),
                      done=self.state.done,
                      rounds_completed=np.int64(
                          self.state.rounds_completed))
        if self.ab:
            arrays.update(corr_b=self.state.profile_b.corr.cpu().numpy(),
                          index_b=self.state.profile_b.index.cpu().numpy())
        meta = dict(format=CHECKPOINT_FORMAT, l=self.l, l_b=self.l_b,
                    window=self.window, exclusion=self.exclusion,
                    band=self.band, k=self.k,
                    chunks=list(self.plan.chunks),
                    fused=True,
                    checksums={name: _crc32(a)
                               for name, a in arrays.items()})
        try:
            np.savez(tmp, meta=json.dumps(meta), **arrays)
            tmp.close()
            if injector is not None:
                injector.on_checkpoint_write(serial)
        except BaseException:
            tmp.close()
            os.unlink(tmp.name)
            raise
        if os.path.exists(path):
            os.replace(path, path + ".prev")
        os.replace(tmp.name, path)
        if injector is not None:
            return injector.after_checkpoint_write(serial, path)
        return False

    def resume(self, path: str, *, n_workers: int | None = None) -> None:
        """Restart from a checkpoint (either package's), replanning the
        remaining chunks for `n_workers` (default: one per device) —
        elastic scaling. The chunk boundaries are the checkpoint's.

        The file is verified on load (readable archive, meta record, crc32
        checksums for format-2 files). A file that fails verification falls
        back, with a warning, to `path + ".prev"` where the writer rotated
        a previous good checkpoint; only when none exists does the
        `CheckpointCorruptionError` propagate. Mismatched geometry
        (l/window/l_b), a pre-fusion checkpoint and a k mismatch raise
        ValueError."""
        with trace.span("repro_torch.scheduler.resume"):
            try:
                arrays, meta = _load_checkpoint_file(path)
            except CheckpointCorruptionError as e:
                prev = path + ".prev"
                if not os.path.exists(prev):
                    raise
                warnings.warn(
                    f"checkpoint {path!r} failed verification ({e}); falling "
                    f"back to previous checkpoint {prev!r} — at most one "
                    f"checkpoint interval of progress is lost", stacklevel=2)
                arrays, meta = _load_checkpoint_file(prev)
            z = arrays
            if meta["l"] != self.l or meta["window"] != self.window:
                raise ValueError(
                    f"checkpoint geometry mismatch: it was written for "
                    f"l={meta['l']}, window={meta['window']} but this "
                    f"scheduler has l={self.l}, window={self.window}")
            if meta.get("l_b") != self.l_b:
                raise ValueError(
                    f"checkpoint geometry mismatch: it was written for "
                    f"l_b={meta.get('l_b')} but this scheduler has "
                    f"l_b={self.l_b}")
            # pre-fusion checkpoints' done-chunks contributed only the row half
            if not meta.get("fused"):
                raise ValueError(
                    "checkpoint predates the fused two-sided engine; its "
                    "completed chunks lack column-half updates — recompute "
                    "from scratch")
            # a k-mismatched resume would silently truncate or pad the sets
            ck = int(meta.get("k", 1))
            if ck != self.k:
                raise ValueError(f"checkpoint carries k={ck} neighbour sets "
                                 f"but this scheduler was built with "
                                 f"k={self.k}")
            done = z["done"]
            if self.mesh is not None:
                # every rank read the same file, and none writes the next
                # checkpoint before all have read this one
                with trace.span("repro_torch.scheduler.agree"):
                    distributed._agree(self.mesh, "checkpoint", [
                        _crc32(z[name])
                        for name in ("done", "corr", "index")])
            workers = n_workers or self.slots
            if workers > self.slots:
                raise ValueError(f"n_workers={workers} exceeds the "
                                 f"scheduler's {self.slots} worker slots")
            state_cls = TopKState if self.k > 1 else ProfileState
            home = self.home

            def state(corr, index):
                return state_cls(torch.from_numpy(corr).to(home),
                                 torch.from_numpy(index).to(home))

            if self.ab and "corr_b" not in z:
                raise ValueError("AB checkpoint must carry the B-side state")
            with trace.span("repro_torch.scheduler.upload"):
                profile = state(z["corr"], z["index"])
                profile_b = (state(z["corr_b"], z["index_b"]) if self.ab
                             else None)
            base = AnytimePlan(l=self.l, exclusion=self.exclusion,
                               n_workers=workers,
                               chunks=tuple(tuple(c) for c in meta["chunks"]),
                               rounds=(), l_b=self.l_b)
            with trace.span("repro_torch.scheduler.replan"):
                plan = partition.replan_remaining(base, done, workers)
                self._round_fn = self._make_round_fn(plan)
            self.plan = plan
            self.state = SchedulerState(plan=plan, done=done,
                                        profile=profile, rounds_completed=0,
                                        profile_b=profile_b)

    # -- results -------------------------------------------------------------

    def _side(self, state) -> tuple[torch.Tensor, torch.Tensor]:
        """(dist, index) of one running state — slot 0 for top-k."""
        d = state.to_distance(self.window)
        if self.k > 1:
            return d[..., 0], state.index[..., 0]
        return d, state.index

    def result(self) -> ProfileResult:
        """The current merged anytime answer as a `ProfileResult` (exact
        after `run()`; monotonically improving after any round). Top-k
        schedules fill `topk_p/topk_i` (and the B side for AB joins); the
        left/right split is not carried through rounds."""
        with trace.span("repro_torch.scheduler.result"):
            kw = dict(kind="ab" if self.ab else "self", window=self.window,
                      exclusion=self.exclusion, k=self.k,
                      backend="distributed",
                      fraction_done=self.state.fraction_done)
            if self.k > 1:
                # convert the (l, k) state ONCE; slot 0 is then bitwise-
                # consistent with topk_p[..., 0] by construction
                dk = self.state.profile.to_distance(self.window)
                p, i = dk[..., 0], self.state.profile.index[..., 0]
                kw.update(topk_p=dk, topk_i=self.state.profile.index)
            else:
                p, i = self._side(self.state.profile)
            if self.ab:
                if self.k > 1:
                    dkb = self.state.profile_b.to_distance(self.window)
                    kw.update(b_p=dkb[..., 0],
                              b_i=self.state.profile_b.index[..., 0],
                              b_topk_p=dkb,
                              b_topk_i=self.state.profile_b.index)
                else:
                    bp, bi = self._side(self.state.profile_b)
                    kw.update(b_p=bp, b_i=bi)
            return ProfileResult(p=p, i=i, **kw)

    def distance_profile(self) -> ProfileResult:
        """The same `ProfileResult` as `result()`."""
        return self.result()

    def distance_profile_b(self) -> tuple[torch.Tensor, torch.Tensor]:
        """B's profile against A — the column harvest of the same rounds.
        AB joins only."""
        if not self.ab:
            raise ValueError("distance_profile_b() requires an AB scheduler "
                             "(construct with ts_b=...)")
        return self._side(self.state.profile_b)
