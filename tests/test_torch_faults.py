"""The port's fault primitives (`repro_torch.core.faults`) against the
reference's (`repro.core.faults`): both are numpy only, so for the same
seed the schedules are EQUAL and `flip_bits` flips the same bytes (exact
comparison, no tolerance)."""

import numpy as np
import pytest

from repro.core import faults as rf
from repro_torch.core import faults as tf

SCHEDULES = [
    dict(seed=0, n_rounds=12, n_workers=1, p_checkpoint_kill=0.25,
         p_checkpoint_flip=0.25, n_checkpoints=12),
    dict(seed=5, n_rounds=12, n_workers=1, p_checkpoint_kill=0.25,
         p_checkpoint_flip=0.25, n_checkpoints=12),
    dict(seed=7, n_rounds=40, n_workers=4, p_worker_crash=0.1,
         p_round_failure=0.2, max_round_failures=3),
    dict(seed=123, n_rounds=25, n_workers=8, p_worker_crash=0.05,
         p_round_failure=0.5, max_round_failures=2, p_checkpoint_kill=0.1,
         p_checkpoint_flip=0.3),
]


def _fields(inj):
    return (inj.worker_crashes, inj.round_failures, inj.checkpoint_kills,
            inj.checkpoint_flips, inj.seed)


@pytest.mark.parametrize("kw", SCHEDULES, ids=lambda kw: f"seed{kw['seed']}")
def test_seeded_schedule_equals_reference(kw):
    kw = dict(kw)
    seed = kw.pop("seed")
    got, want = (tf.FaultInjector.seeded(seed, **kw),
                 rf.FaultInjector.seeded(seed, **kw))
    assert _fields(got) == _fields(want)


@pytest.mark.parametrize("seed,n_flips", [(3, 16), (9, 64), (1_000_008, 16)])
def test_flip_bits_flips_the_same_bytes(tmp_path, seed, n_flips):
    payload = np.random.default_rng(seed).integers(
        0, 256, size=4096, dtype=np.uint8).tobytes()
    paths = [tmp_path / name for name in ("port", "ref")]
    for p in paths:
        p.write_bytes(payload)
    tf.flip_bits(str(paths[0]), seed=seed, n_flips=n_flips)
    rf.flip_bits(str(paths[1]), seed=seed, n_flips=n_flips)
    got, want = (p.read_bytes() for p in paths)
    assert got == want and got != payload


def test_checkpoint_hooks_match_reference(tmp_path):
    kw = dict(n_rounds=12, n_workers=1, p_checkpoint_kill=0.25,
              p_checkpoint_flip=0.25, n_checkpoints=12)
    got, want = tf.FaultInjector.seeded(5, **kw), rf.FaultInjector.seeded(5,
                                                                         **kw)
    payload = bytes(range(256)) * 8
    for serial in range(12):
        killed = []
        for inj, err in ((got, tf.CheckpointWriteError),
                         (want, rf.CheckpointWriteError)):
            try:
                inj.on_checkpoint_write(serial)
                killed.append(False)
            except err:
                killed.append(True)
        assert killed[0] == killed[1] == (serial in want.checkpoint_kills)
        paths = [tmp_path / f"{name}{serial}" for name in ("p", "r")]
        for p in paths:
            p.write_bytes(payload)
        assert (got.after_checkpoint_write(serial, str(paths[0]))
                == want.after_checkpoint_write(serial, str(paths[1])))
        assert paths[0].read_bytes() == paths[1].read_bytes()


@pytest.mark.parametrize("name,base", [
    ("CheckpointWriteError", RuntimeError),
    ("CheckpointCorruptionError", ValueError)])
def test_exceptions_match_reference(name, base):
    got, want = getattr(tf, name), getattr(rf, name)
    assert issubclass(got, base) and want.__mro__[1] is got.__mro__[1]
