"""The port's public surface against the reference's
(`tests/test_api_surface.py`): `repro_torch.core.__all__` is the
reference's less what is not ported yet, each missing name with the
ROADMAP.md item that brings it; the `ProfileResult`, `HarvestSpec`,
`PrecisionSpec` and analytics surfaces are the reference's; `SweepPlan`'s
fields are the reference's with `interpret` as `device`.
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
    # the supervised scheduler's pieces come with it (ROADMAP.md §A6)
    for name in ("RoundFailure", "FaultPolicy", "SupervisedReport"):
        assert hasattr(rfaults, name) and not hasattr(faults, name), name
