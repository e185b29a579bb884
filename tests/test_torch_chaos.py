"""The chaos harness of `tests/test_chaos.py` on the port's supervised
scheduler: the same seven fault schedules, run in-process over 8 CPU
workers (`devices=["cpu"] * 8`), must each land BITWISE on the port's
clean run, and every `SupervisedReport` outcome — rounds, retries,
per-worker failures, excluded workers, replans, checkpoints written,
failed and corrupted, degradation and `fraction_done` — must equal the
reference's under the same schedule.

Bitwise equality is attainable for the reason the reference's harness
gives: a chunk's contribution is a pure function of its bounds, and the
f32 max-merge is commutative in value, so any fault-and-replan history
that commits every chunk reproduces the clean run. The reference runs once
per module in a subprocess with 8 forced host devices, as
`tests/test_chaos.py` runs it; its profiles (band engine) are not compared
here beyond the degraded answer's validity — `tests/test_torch_scheduler.py`
holds the two packages' rounds to 1e-4.
"""

import dataclasses
import json
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

from repro_torch.core.faults import FaultInjector, FaultPolicy, flip_bits
from repro_torch.core.scheduler import AnytimeScheduler

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
N_WORKERS = 8
SEEDS = (0, 1, 2)

# schedule name -> (injector kwargs, policy kwargs, checkpoint file or None)
_SCHEDULES = {
    "crash_every_round": (
        dict(worker_crashes={t: {t % 8} for t in range(64)}),
        dict(worker_failure_threshold=100), None),
    "transient": (dict(round_failures={0: 1, 2: 3, 5: 2}), {}, None),
    "ckpt_chaos": (dict(checkpoint_kills={1}, checkpoint_flips={3}, seed=7),
                   dict(checkpoint_every=1), "chaos.npz"),
    "shrink_to_one": (
        dict(worker_crashes={t: set(range(1, 8)) for t in range(400)}),
        dict(worker_failure_threshold=1, min_workers=1), None),
    "degraded": (dict(round_failures={2: 10**6}), dict(max_retries=2), None),
}
_SEEDED = dict(n_rounds=64, n_workers=8, p_worker_crash=0.15,
               p_round_failure=0.3, max_round_failures=2,
               p_checkpoint_kill=0.2, p_checkpoint_flip=0.2)
_SEEDED_POLICY = dict(checkpoint_every=1, worker_failure_threshold=3)

# the reference side: the same schedules, every report as a dict
_SNIPPET = r"""
import os, json, tempfile, warnings, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import sys
sys.path.insert(0, %(src)r)
import numpy as np
from repro.core.scheduler import AnytimeScheduler
from repro.core.faults import FaultInjector, FaultPolicy, flip_bits
from repro.launch.mesh import compat_mesh

SCHEDULES = %(schedules)s
SEEDED, SEEDED_POLICY, SEEDS = %(seeded)s
mesh = compat_mesh((8,), ("workers",))
rng = np.random.default_rng(3)
ts = np.cumsum(rng.normal(size=700)).astype(np.float32)
mk = lambda: AnytimeScheduler(ts, 24, mesh, chunks_per_worker=4, band=16)
nosleep = lambda s: None
td = tempfile.mkdtemp()

def report(s):
    r = dataclasses.asdict(s.supervised_report)
    r["worker_failures"] = sorted(r["worker_failures"].items())
    return r

clean = mk()
clean.run()
out = {"clean_p": np.asarray(clean.result().p).tolist()}
for name, (inj, pol, ck) in SCHEDULES.items():
    inj = {k: ({t: set(v) if isinstance(v, list) else v
                for t, v in val.items()} if isinstance(val, dict)
               else set(val) if isinstance(val, list) else val)
           for k, val in inj.items()}
    s = mk()
    res = s.run_supervised(
        FaultPolicy(sleep=nosleep, **pol),
        checkpoint_path=None if ck is None else os.path.join(td, ck),
        injector=FaultInjector(**inj))
    out[name] = report(s)
    out[name + "_p"] = np.asarray(res.p).tolist()
ck2 = os.path.join(td, "resume.npz")
s = mk()
s.run_supervised(FaultPolicy(sleep=nosleep, checkpoint_every=1),
                 checkpoint_path=ck2, max_rounds=3)
out["corrupt_first"] = report(s)
flip_bits(ck2, seed=11, n_flips=64)
s2 = mk()
with warnings.catch_warnings(record=True) as w:
    warnings.simplefilter("always")
    s2.resume(ck2)
out["fallback_warned"] = any("falling back" in str(x.message) for x in w)
s2.run_supervised(FaultPolicy(sleep=nosleep))
out["corrupt_resume"] = report(s2)
for seed in SEEDS:
    s = mk()
    s.run_supervised(
        FaultPolicy(sleep=nosleep, **SEEDED_POLICY),
        checkpoint_path=os.path.join(td, "seed%%d.npz" %% seed),
        injector=FaultInjector.seeded(seed, **SEEDED))
    out["seeded_%%d" %% seed] = report(s)
print(json.dumps(out))
"""


def _jsonable(schedules):
    """The schedules as Python literals (sets become lists)."""
    def conv(v):
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        if isinstance(v, set):
            return sorted(v)
        return v

    return repr({name: (conv(inj), pol, ck)
                 for name, (inj, pol, ck) in schedules.items()})


@pytest.fixture(scope="module")
def ref():
    code = _SNIPPET % dict(src=SRC, schedules=_jsonable(_SCHEDULES),
                           seeded=repr((_SEEDED, _SEEDED_POLICY, SEEDS)))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _report(s):
    r = dataclasses.asdict(s.supervised_report)
    r["worker_failures"] = [list(x) for x in
                            sorted(r["worker_failures"].items())]
    return r


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    td = str(tmp_path_factory.mktemp("chaos"))
    rng = np.random.default_rng(3)
    ts = np.cumsum(rng.normal(size=700)).astype(np.float32)

    def mk():
        return AnytimeScheduler(ts, 24, ["cpu"] * N_WORKERS,
                                chunks_per_worker=4, band=16)

    nosleep = dict(sleep=lambda _s: None)
    clean = mk()
    clean.run()
    out = {"clean": clean.result()}
    for name, (inj, pol, ck) in _SCHEDULES.items():
        s = mk()
        out[name + "_res"] = s.run_supervised(
            FaultPolicy(**nosleep, **pol),
            checkpoint_path=None if ck is None else os.path.join(td, ck),
            injector=FaultInjector(**inj))
        out[name] = _report(s)
    ck2 = os.path.join(td, "resume.npz")
    s = mk()
    s.run_supervised(FaultPolicy(checkpoint_every=1, **nosleep),
                     checkpoint_path=ck2, max_rounds=3)
    out["corrupt_first"] = _report(s)
    flip_bits(ck2, seed=11, n_flips=64)
    s2 = mk()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        s2.resume(ck2)
    out["fallback_warned"] = any("falling back" in str(x.message) for x in w)
    out["corrupt_resume_res"] = s2.run_supervised(FaultPolicy(**nosleep))
    out["corrupt_resume"] = _report(s2)
    for seed in SEEDS:
        s = mk()
        out[f"seeded_{seed}_res"] = s.run_supervised(
            FaultPolicy(**nosleep, **_SEEDED_POLICY),
            checkpoint_path=os.path.join(td, f"seed{seed}.npz"),
            injector=FaultInjector.seeded(seed, **_SEEDED))
        out[f"seeded_{seed}"] = _report(s)
    return out


def _bitwise_clean(port, name):
    got, clean = port[name + "_res"], port["clean"]
    return torch.equal(got.p, clean.p) and torch.equal(got.i, clean.i)


def test_crash_every_round_bitwise(port, ref):
    assert _bitwise_clean(port, "crash_every_round")
    assert port["crash_every_round"] == ref["crash_every_round"]
    assert port["crash_every_round"]["replans"] >= 1
    assert port["crash_every_round_res"].fraction_done == 1.0


def test_transient_failures_retry_to_bitwise(port, ref):
    assert _bitwise_clean(port, "transient")
    assert port["transient"] == ref["transient"]
    # ticks 0 and 2 fire (1 + 3 retries); the tick-5 entry lies past the
    # 4-round plan and never fires
    assert port["transient"]["retries"] == 4


def test_checkpoint_chaos_does_not_disturb_answer(port, ref):
    assert _bitwise_clean(port, "ckpt_chaos")
    rep = port["ckpt_chaos"]
    assert rep == ref["ckpt_chaos"]
    assert (rep["checkpoint_failures"], rep["checkpoints_corrupted"]) == (1,
                                                                          1)
    assert rep["checkpoints_written"] >= 3


def test_corrupted_checkpoint_resume_falls_back_bitwise(port, ref):
    assert port["fallback_warned"] and ref["fallback_warned"]
    assert _bitwise_clean(port, "corrupt_resume")
    for name in ("corrupt_first", "corrupt_resume"):
        assert port[name] == ref[name], name


def test_shrink_to_single_worker_bitwise(port, ref):
    assert port["shrink_to_one"]["excluded_workers"] == [1, 2, 3, 4, 5, 6, 7]
    assert port["shrink_to_one"] == ref["shrink_to_one"]
    assert _bitwise_clean(port, "shrink_to_one")


def test_graceful_degradation_partial_but_valid(port, ref):
    rep = port["degraded"]
    assert rep == ref["degraded"]
    assert rep["degraded"] and 0.0 < rep["fraction_done"] < 1.0
    res = port["degraded_res"]
    assert res.fraction_done == rep["fraction_done"]
    # anytime-valid: no entry better than the exact profile, in both
    # packages
    assert bool((res.p >= port["clean"].p - 1e-5).all())
    assert (np.asarray(ref["degraded_p"])
            >= np.asarray(ref["clean_p"]) - 1e-5).all()


@pytest.mark.parametrize("seed", SEEDS)
def test_seeded_schedules_all_bitwise(port, ref, seed):
    assert _bitwise_clean(port, f"seeded_{seed}")
    assert port[f"seeded_{seed}"] == ref[f"seeded_{seed}"]
    assert not port[f"seeded_{seed}"]["degraded"]
