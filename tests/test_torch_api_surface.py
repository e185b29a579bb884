"""The port's public surface against the reference's
(`tests/test_api_surface.py`): `repro_torch.core.__all__` is the
reference's, name for name; the `ProfileResult`, `HarvestSpec`,
`PrecisionSpec`, analytics, fault, scheduler and `serve` surfaces are the
reference's; `SweepPlan`'s fields are the reference's with `interpret` as
`device`, and a list of `devices` takes the place of a `mesh` (and its
`axis`) wherever the reference takes one. The LM substrate's modules
(`configs`, `models`, `utils.flops`, `optim.adamw`, `data.pipeline`,
`launch.train`) have the reference's names and signatures, a sharding
context (`ctx`) included. The mesh tooling (`launch.mesh`,
`launch.sharding`, `launch.dryrun`, `launch.report`) has the reference's
names and signatures, less what `LAUNCH_LEFT_OUT` gives a reason for
(ROADMAP.md §C (25)). The roofline
model (`launch.roofline`, and `kernels.ops`' `hbm_bytes_per_cell` and
`kernel_roofline`) has the reference's names and signatures, less what
models XLA's HLO, its TPU lowering and TPU VMEM (ROADMAP.md §C (23)).
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
NOT_PORTED = {}


def _fields(cls):
    return [f.name for f in dataclasses.fields(cls)]


def test_core_all_is_the_reference_less_the_unported():
    assert NOT_PORTED == {}
    assert tcore.__all__ == rcore.__all__
    for name in tcore.__all__:
        assert hasattr(tcore, name), name


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


def test_only_distributed_plans_are_refused(monkeypatch, tmp_path):
    """Nothing of the planner is left unported: distributed plans are
    planned, and their round executor takes a device list in one process
    or a 1-D mesh of ranks (a one-rank gloo group, in a subprocess, runs
    it). Under a multi-rank group a device list raises `ValueError`
    naming the mesh, where it would run every worker on each rank."""
    import dataclasses as dc

    import torch

    from _torch_mesh_run import run_suite
    from repro_torch.core import plan

    assert plan._NOT_PORTED == {}
    p = plan.plan_sweep(16, 300, backend="distributed", device="cpu")
    assert p.backend == "distributed"
    runner = plan.round_executor(dc.replace(p, n_bands=2), ["cpu"])
    assert callable(runner)
    one = run_suite("one_rank", tmp_path, world=1, timeout=240)
    assert one["not_ported"] == {} and one["executor"]
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 4)
    with pytest.raises(ValueError, match="DeviceMesh"):
        plan.round_executor(dc.replace(p, n_bands=2), ["cpu"])


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
    # the round pieces, the supervised scheduler's policy knobs and its
    # report: the reference's fields and defaults
    for name in ("RoundFailure", "FaultPolicy", "SupervisedReport"):
        assert hasattr(faults, name) and hasattr(rfaults, name), name
    for name in ("FaultPolicy", "SupervisedReport"):
        got, want = (dataclasses.fields(getattr(mod, name))
                     for mod in (faults, rfaults))
        assert [f.name for f in got] == [f.name for f in want], name
        for g, w in zip(got, want):
            if g.name == "sleep":
                continue
            assert (g.default, g.default_factory) == (
                w.default, w.default_factory), (name, g.name)
    assert len(_fields(faults.FaultPolicy)) == 8
    assert len(_fields(faults.SupervisedReport)) == 10
    for name in ("crashed_workers", "round_should_fail"):
        assert (params(getattr(faults.FaultInjector, name))
                == params(getattr(rfaults.FaultInjector, name))), name


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


def test_scheduler_surface_matches_reference():
    """`AnytimeScheduler`, `SchedulerState`, `round_executor` and the
    checkpoint format are the reference's, with `devices` in place of
    `mesh` and `axis`."""
    from repro.core import distributed as rdist
    from repro.core import partition as rpart
    from repro.core import scheduler as rsched
    from repro_torch.core import distributed, partition, plan, scheduler

    def params(fn):
        return list(inspect.signature(fn).parameters)

    def devices_for_mesh(names):
        return [n for n in ("devices" if p == "mesh" else p
                            for p in names) if n != "axis"]

    assert scheduler.CHECKPOINT_FORMAT == rsched.CHECKPOINT_FORMAT
    cls, ref = scheduler.AnytimeScheduler, rsched.AnytimeScheduler
    assert params(cls.__init__) == devices_for_mesh(params(ref.__init__))
    for name in ("step_round", "run", "run_supervised", "checkpoint",
                 "resume", "result", "distance_profile",
                 "distance_profile_b", "_replan"):
        assert params(getattr(cls, name)) == params(getattr(ref, name)), name
    assert (_fields(scheduler.SchedulerState)
            == _fields(rsched.SchedulerState))
    assert isinstance(scheduler.SchedulerState.fraction_done, property)
    assert params(plan.round_executor) == devices_for_mesh(
        params(rcore.round_executor))
    assert tcore.round_executor is plan.round_executor
    for name in ("make_round_fn", "make_round_fn_ab"):
        assert params(getattr(distributed, name)) == devices_for_mesh(
            params(getattr(rdist, name))), name
    for name in ("live_bands", "worker_chunk_topk", "worker_chunk_ab_topk"):
        assert (params(getattr(distributed, name))
                == params(getattr(rdist, name))), name
    assert (_fields(partition.AnytimePlan) == _fields(rpart.AnytimePlan))
    for name in ("diag_work", "balanced_ranges", "range_work",
                 "diag_work_ab", "balanced_ranges_ab", "range_work_ab",
                 "interleaved_chunks", "interleaved_chunks_ab",
                 "replan_remaining", "balance_badness",
                 "balance_badness_ab"):
        assert (params(getattr(partition, name))
                == params(getattr(rpart, name))), name


# the LM substrate (ROADMAP.md §A9): reference names the port has no
# counterpart for yet -> the item that brings them
LM_NOT_PORTED = {
    "configs.base": {}, "configs": {}, "utils.flops": {},
    "models.common": {}, "models.moe": {},
    "models.rwkv": {}, "models.mamba": {}, "models.attention": {},
    "models.transformer": {}, "models.steps": {},
    "optim.adamw": {}, "data.pipeline": {}, "launch.train": {},
}
# parameters the port's functions drop: the reference's attention query
# chunks (one flash call tiles its own way, ROADMAP.md §C (16); MLA and
# cross attention read `cfg.q_chunk`, §C (21), (24)); `layer_param_spec`'s
# `bidir`, which the reference ignores too (`ls.mixer` carries it:
# "attn_bidir"); `init_params` takes a torch.Generator where the
# reference takes a key
LM_DROPPED = {"q_chunk", "bidir"}
# parameters the port's functions add at the end: `rope_freqs` builds on a
# device; `apply_updates` takes the paths that decay, which the reference
# reads off its stacked layout's ranks (the train step passes them); the
# mixers take the block's view of the mesh inside the layer's `local_map`
# (`lc`, a `parallel.Local`; None computes unsharded), where the reference
# reads GSPMD's layout (ROADMAP.md §C (25))
LM_ADDED = {"rope_freqs": ["device"], "apply_updates": ["decay"],
            **{name: ["lc"] for name in (
                "gqa_full", "gqa_prefill", "gqa_decode", "mla_full",
                "mla_decode", "cross_kv", "cross_attend", "time_mix_full",
                "time_mix_step", "channel_mix_full", "channel_mix_step",
                "mamba_step")}}


@pytest.mark.parametrize("mod", sorted(LM_NOT_PORTED))
def test_lm_surface_matches_reference(mod):
    import importlib

    ref = importlib.import_module(f"repro.{mod}")
    port = importlib.import_module(f"repro_torch.{mod}")
    public = {n for n, v in vars(ref).items() if not n.startswith("_")
              and (inspect.isfunction(v) or inspect.isclass(v)
                   or isinstance(v, dict))
              and getattr(v, "__module__", ref.__name__) == ref.__name__}
    missing = {n for n in public if not hasattr(port, n)}
    assert missing == set(LM_NOT_PORTED[mod])
    for name in sorted(public - missing):
        r, p = getattr(ref, name), getattr(port, name)
        if inspect.isclass(r) and dataclasses.is_dataclass(r):
            assert _fields(p) == _fields(r), (mod, name)
        if not inspect.isfunction(r):
            continue
        want = [{"key": "gen"}.get(a, a)
                for a in inspect.signature(r).parameters
                if a not in LM_DROPPED]
        got = list(inspect.signature(p).parameters)
        assert got == want + LM_ADDED.get(name, []), (mod, name)


# the mesh tooling (ROADMAP.md §A9 (iv)): reference names with no
# counterpart in the port -> why; parameters the port adds at the end
LAUNCH_LEFT_OUT = {
    "launch.mesh": {}, "launch.sharding": {},
    "launch.dryrun": {
        "lower_layer_cost": "§C (25): eager torch counts every layer; one "
                            "trace is split by region",
        "head_cost": "§C (25): the head is a region of the one trace"},
    "launch.report": {"V5E_HBM_GB": "§C (25): a TPU's HBM (H100_HBM_GB "
                                    "here)"},
}
LAUNCH_ADDED = {"run_cell": ["cfg", "mesh"], "main": ["argv"]}


def _reference_names(mod):
    """{public function or class or dict name: parameters or None} of a
    reference module, read from its source: `repro.launch.dryrun` sets
    XLA's device count for the whole process when imported."""
    import ast
    import importlib.util

    spec = importlib.util.find_spec(f"repro.{mod}")
    tree = ast.parse(open(spec.origin).read())
    out = {}
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and not node.name.startswith(
                "_"):
            a = node.args
            out[node.name] = [x.arg for x in a.posonlyargs + a.args
                              + a.kwonlyargs]
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            out[node.name] = None
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id.isupper():
                    out[t.id] = None
    return out


@pytest.mark.parametrize("mod", sorted(LAUNCH_LEFT_OUT))
def test_launch_mesh_surface_matches_reference(mod):
    import importlib

    port = importlib.import_module(f"repro_torch.{mod}")
    names = _reference_names(mod)
    for name in LAUNCH_LEFT_OUT[mod]:
        assert name in names and not hasattr(port, name), (mod, name)
    for name, params in names.items():
        if name in LAUNCH_LEFT_OUT[mod]:
            continue
        assert hasattr(port, name), (mod, name)
        if params is not None:
            got = list(inspect.signature(getattr(port, name)).parameters)
            assert got == params + LAUNCH_ADDED.get(name, []), (mod, name)


def test_nothing_in_the_port_imports_jax_or_the_reference():
    import pathlib
    import re

    root = pathlib.Path(__file__).resolve().parent.parent / "src" / \
        "repro_torch"
    pat = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)
    hits = [str(p) for p in root.rglob("*.py") if pat.search(p.read_text())]
    assert hits == []


# the roofline model (ROADMAP.md §A8): reference names with no counterpart
# in the port -> why
ROOFLINE_LEFT_OUT = {
    "launch.roofline": {"parse_collectives": "§C (23): parses XLA HLO",
                        "collective_wire_bytes": "§C (23): parses XLA HLO",
                        "ICI_BW": "§C (23): a TPU rate (NVLINK_BW here)"},
    "kernels.ops": {"kernel_vmem_bytes": "§C (23): TPU VMEM",
                    "VMEM_BYTES": "§C (23): TPU VMEM (L2_BYTES here)",
                    "aot_export_tpu": "§C (23): a TPU lowering",
                    "compiled_lowering_smoke": "§C (23): a TPU lowering"},
}
ROOFLINE_NAMES = {
    "launch.roofline": ["shape_bytes", "RooflineTerms", "Collective",
                        "matrix_profile_roofline", "roofline_fraction",
                        "PEAK_FLOPS", "HBM_BW"],
    "kernels.ops": ["hbm_bytes_per_cell", "FLOPS_PER_CELL",
                    "kernel_roofline"],
}


@pytest.mark.parametrize("mod", sorted(ROOFLINE_NAMES))
def test_roofline_surface_matches_reference(mod):
    import importlib

    ref = importlib.import_module(f"repro.{mod}")
    port = importlib.import_module(f"repro_torch.{mod}")
    for name in ROOFLINE_LEFT_OUT[mod]:
        assert hasattr(ref, name) and not hasattr(port, name), (mod, name)
    for name in ROOFLINE_NAMES[mod]:
        r, p = getattr(ref, name), getattr(port, name)
        if inspect.isfunction(r):
            assert (list(inspect.signature(p).parameters)
                    == list(inspect.signature(r).parameters)), (mod, name)
        elif name == "Collective":    # the dry-run's traced collectives
            assert _fields(p) == _fields(r), (mod, name)
            for kind in ("all-reduce", "all-gather", "reduce-scatter",
                         "all-to-all", "collective-permute"):
                for n in (1, 2, 16):
                    assert (p(kind, 4096, n).wire_bytes
                            == r(kind, 4096, n).wire_bytes)
        elif inspect.isclass(r):
            # the one field the port adds: the peak a term's FLOPs run at
            assert _fields(p) == _fields(r) + ["peak_flops"], (mod, name)
        elif name == "FLOPS_PER_CELL":
            assert p == r
        else:                     # a rate: the card's, not the TPU's
            assert p != r, (mod, name)
