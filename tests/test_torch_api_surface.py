"""The port's public surface against the reference's
(`tests/test_api_surface.py`): `repro_torch.core.__all__` is the
reference's less what is not ported yet, each missing name with the
ROADMAP.md item that brings it; the `ProfileResult`, `HarvestSpec`,
`PrecisionSpec`, analytics and `serve` surfaces are the reference's;
`SweepPlan`'s fields are the reference's with `interpret` as `device`.
"""

import dataclasses
import inspect

import pytest

import repro.core as rcore
import repro_torch.core as tcore
from repro.core.plan import SweepPlan as RefSweepPlan
from repro.core.result import ProfileResult as RefProfileResult
from repro_torch.core.plan import SweepPlan
from repro_torch.core.result import HarvestSpec, ProfileResult

# reference names the port does not export yet -> the item that brings them
NOT_PORTED = {
    "round_executor": "ROADMAP.md §A6 (distributed rounds)",
}


# `repro.core.faults.FaultPolicy`'s supervised-scheduler knobs, read only by
# `run_supervised` (ROADMAP.md §A6)
POLICY_DEFERRED = ("worker_failure_threshold", "min_workers",
                   "checkpoint_every", "degrade_gracefully")


def _fields(cls):
    return [f.name for f in dataclasses.fields(cls)]


def test_core_all_is_the_reference_less_the_unported():
    assert tcore.__all__ == [n for n in rcore.__all__ if n not in NOT_PORTED]
    assert set(rcore.__all__) - set(tcore.__all__) == set(NOT_PORTED)
    for name in tcore.__all__:
        assert hasattr(tcore, name), name
    for name in NOT_PORTED:
        assert not hasattr(tcore, name), name


def test_analytics_surface():
    from repro_torch.core import analytics

    for name in ("top_motifs", "discords", "top_discord", "regimes",
                 "corrected_arc_curve", "Motif", "Discord", "Regimes"):
        assert hasattr(analytics, name), name
    assert tcore.analytics is analytics


def test_result_and_harvest_surfaces_match_reference():
    def params(cls):
        return [p for p in inspect.signature(cls.__init__).parameters
                if p != "self"]

    assert params(ProfileResult) == params(RefProfileResult)
    assert ProfileResult.LAZY_FIELDS == RefProfileResult.LAZY_FIELDS
    for name in ProfileResult.LAZY_FIELDS:
        assert isinstance(getattr(ProfileResult, name), property), name
    for dunder in ("__iter__", "__getitem__", "__len__"):
        assert not hasattr(ProfileResult, dunder), dunder
    assert _fields(HarvestSpec) == ["sides", "k"]
    assert _fields(tcore.PrecisionSpec) == _fields(rcore.PrecisionSpec)


def test_sweep_plan_fields_match_reference():
    ref = ["device" if f == "interpret" else f for f in _fields(RefSweepPlan)]
    assert _fields(SweepPlan) == ref


def test_entry_points_return_profile_result():
    for fn in (tcore.matrix_profile, tcore.ab_join):
        assert "ProfileResult" in inspect.signature(fn).return_annotation
    assert "normalize" in inspect.signature(tcore.matrix_profile).parameters


def test_only_distributed_plans_are_refused():
    """The planner refuses only what NOT_PORTED's §A6 brings."""
    from repro_torch.core import plan

    assert set(plan._NOT_PORTED) == {"distributed"}
    with pytest.raises(NotImplementedError, match="ROADMAP.md §A6"):
        plan.plan_sweep(16, 300, backend="distributed", device="cpu")


def test_fleet_monitor_checkpoint_and_fault_surfaces_match_reference():
    """The reference's signatures and fields, plus a keyword-only `device`
    on the fleet's constructor and restore and on `TelemetryMonitor`."""
    from repro.checkpoint import ckpt as rckpt
    from repro.core import faults as rfaults
    from repro.core import monitor as rmonitor
    from repro.core.fleet import StreamingFleet as RefFleet
    from repro_torch.checkpoint import ckpt
    from repro_torch.core import faults, monitor

    def params(fn):
        return list(inspect.signature(fn).parameters)

    fleet = tcore.StreamingFleet
    assert params(fleet.__init__) == params(RefFleet.__init__) + ["device"]
    assert params(fleet.restore) == params(RefFleet.restore) + ["device"]
    for name in ("ingest", "snapshot", "save", "rescale"):
        assert params(getattr(fleet, name)) == params(getattr(RefFleet, name))
    for name in ("counts", "totals", "epochs"):
        assert isinstance(getattr(fleet, name), property), name
    for name in ("Discord", "FleetAlert", "FleetMonitor"):
        assert (_fields(getattr(monitor, name))
                == _fields(getattr(rmonitor, name))), name
    ref_fields = _fields(rmonitor.TelemetryMonitor)
    assert _fields(monitor.TelemetryMonitor) == (
        ref_fields[:-1] + ["device"] + ref_fields[-1:])
    assert ckpt.FORMAT == rckpt.FORMAT
    for name in ("save", "restore", "all_steps", "latest_step"):
        assert params(getattr(ckpt, name)) == params(getattr(rckpt, name))
    for name in ("CheckpointWriteError", "CheckpointCorruptionError",
                 "FaultInjector", "flip_bits"):
        assert hasattr(faults, name) and hasattr(rfaults, name), name
    assert _fields(faults.FaultInjector) == _fields(rfaults.FaultInjector)
    # the profile service's round pieces are ported; the supervised
    # scheduler's report and policy knobs come with it (ROADMAP.md §A6)
    for name in ("RoundFailure", "FaultPolicy"):
        assert hasattr(faults, name) and hasattr(rfaults, name), name
    assert _fields(faults.FaultPolicy) == [
        f for f in _fields(rfaults.FaultPolicy) if f not in POLICY_DEFERRED]
    assert set(POLICY_DEFERRED) <= set(_fields(rfaults.FaultPolicy))
    for name in ("crashed_workers", "round_should_fail"):
        assert (params(getattr(faults.FaultInjector, name))
                == params(getattr(rfaults.FaultInjector, name))), name
    assert (hasattr(rfaults, "SupervisedReport")
            and not hasattr(faults, "SupervisedReport"))


def test_serve_surface_matches_reference():
    """`repro_torch.serve` exports the reference's names; `ServeAnswer`,
    `QueueStats` and `PendingQuery` have its fields; the service's and the
    queue's methods its parameters; the corpus takes `devices=` where the
    reference takes `mesh=`."""
    import repro.serve as rserve
    import repro_torch.serve as tserve
    from repro.serve import queue as rqueue
    from repro_torch.serve import queue as tqueue

    def params(fn):
        return list(inspect.signature(fn).parameters)

    assert tserve.__all__ == rserve.__all__
    for name in tserve.__all__:
        assert hasattr(tserve, name), name
    assert _fields(tserve.ServeAnswer) == _fields(rserve.ServeAnswer)
    assert _fields(tserve.QueueStats) == _fields(rserve.QueueStats)
    assert _fields(tqueue.PendingQuery) == _fields(rqueue.PendingQuery)
    for cls, names in (("ProfileService", ("__init__", "submit", "step",
                                           "drain", "serve")),
                       ("AdmissionQueue", ("__init__", "submit",
                                           "take_expired", "take_batch",
                                           "mark_completed")),
                       ("RoundLoop", ("__init__", "dispatch", "deliver_next",
                                      "drain")),
                       ("ShardedCorpus", ("side", "reload", "groups"))):
        for name in names:
            got = params(getattr(getattr(tserve, cls), name))
            want = params(getattr(getattr(rserve, cls), name))
            assert got == want, (cls, name)
    # every pair runs its own `ab_join` plan (ROADMAP.md §C (14)): no
    # batched plan, no stacked payload
    assert params(tserve.ShardedCorpus.plan_for) == [
        p for p in params(rserve.ShardedCorpus.plan_for) if p != "batch"]
    assert not hasattr(tserve.ShardedCorpus, "assemble_batch")
    assert hasattr(rserve.ShardedCorpus, "assemble_batch")
    corpus = params(tserve.ShardedCorpus.__init__)
    assert corpus == ["devices" if p == "mesh" else p
                      for p in params(rserve.ShardedCorpus.__init__)]
