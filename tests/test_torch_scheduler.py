"""The port's anytime scheduler (`repro_torch.core.scheduler`) on the CPU:

  * against `repro.core.scheduler` on the reference's in-process 1-worker
    mesh and the port's one CPU worker, after EVERY round and at the end,
    for k = 1 and k = 4, self and AB, with and without an exclusion: the
    same chunks done, the same `fraction_done`, correlations within
    TOL_CORR, and indices equal except at near-ties (where they differ,
    the f64 correlations of both picks are within TOL_CORR). At k = 1 the
    port's chunks run the NATSA kernel's plain version, the reference's
    its band engine (ROADMAP.md §C (15));
  * the chunked k = 1 sweep bit for bit one plain call over the same
    diagonals (one per span of an AB exclusion gap), for any worker count;
  * empty chunks launch nothing;
  * the twins of `tests/test_ab_scheduler.py` and of the scheduler cases of
    `tests/test_checkpoint.py:115-225`;
  * checkpoints across the two packages: the same keys and meta, the same
    `done` bytes and crc32s, each package resuming the other's file;
  * the distributed plan and `round_executor`'s refusals; a one-rank
    group's mesh runs the one-process bits, and a device list under a
    group of more ranks raises.

The `gpu`-marked tests hold kernel chunks bit for bit one launch, and a
supervised run bit for bit a clean one, on the card; they skip here.
"""

import dataclasses
import json
import os
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import plan as rplan
from repro.core.ref import ab_join_bruteforce
from repro.core.scheduler import AnytimeScheduler as RefScheduler
from repro.launch.mesh import compat_mesh
from repro_torch.core import plan as tplan
from repro_torch.core.faults import (CheckpointCorruptionError,
                                     CheckpointWriteError, FaultInjector,
                                     FaultPolicy, flip_bits)
from repro_torch.core.matrix_profile import ProfileState
from repro_torch.core.scheduler import CHECKPOINT_FORMAT, AnytimeScheduler
from repro_torch.core.zstats import (compute_cross_stats_host,
                                     compute_stats_host, dist_to_corr)
from repro_torch.kernels import natsa_mp, ops

from _torch_mesh_run import run_suite
from _torch_mesh_worker import any_dump, any_make

TOL_CORR = 1e-4      # the reference's own kernel standard, in correlation
NO_SLEEP = dict(sleep=lambda _t: None)


@pytest.fixture(scope="module")
def mesh():
    return compat_mesh((1,), ("workers",))


def walk(n, seed):
    return np.cumsum(np.random.default_rng(seed).normal(size=n))


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _unit(ts, m):
    """f64 unit-norm centered windows of the f32 series the schedulers
    sweep."""
    t = np.asarray(ts, np.float32).astype(np.float64)
    w = np.lib.stride_tricks.sliding_window_view(t, m)
    w = w - w.mean(axis=1, keepdims=True)
    return w / np.linalg.norm(w, axis=1, keepdims=True)


def _assert_near(got, want, u_rows, u_cols, ctx=""):
    """(corr, index) states, (l,) or (l, k): correlations within TOL_CORR,
    indices equal but at near-ties."""
    gc, gi, wc, wi = (_np(x) for x in (got.corr, got.index, want.corr,
                                       want.index))
    assert gc.shape == wc.shape, ctx
    np.testing.assert_allclose(gc, wc, rtol=0, atol=TOL_CORR, err_msg=ctx)
    for at in map(tuple, np.argwhere(gi != wi)):
        assert gi[at] >= 0 and wi[at] >= 0, (ctx, at, gi[at], wi[at])
        r = at[0]
        e_got, e_want = u_rows[r] @ u_cols[gi[at]], u_rows[r] @ u_cols[wi[at]]
        assert abs(e_got - e_want) < TOL_CORR, (ctx, at, e_got, e_want)


def _pair(kind, seed=2):
    a = walk(360, seed)
    return (a, None) if kind == "self" else (a, walk(200, seed + 1))


# -- against the reference, round by round ----------------------------------


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("kind,exclusion", [("self", None), ("self", 7),
                                            ("ab", None), ("ab", 3)])
def test_rounds_match_reference(mesh, k, kind, exclusion):
    a, b = _pair(kind)
    m = 16
    kw = dict(band=16, chunks_per_worker=4, exclusion=exclusion, ts_b=b, k=k)
    ref = RefScheduler(a, m, mesh, **kw)
    port = AnytimeScheduler(a, m, ["cpu"], **kw)
    assert dataclasses.astuple(port.plan) == dataclasses.astuple(ref.plan)
    assert port.exclusion == ref.exclusion
    ua = _unit(a, m)
    ub = ua if b is None else _unit(b, m)
    fracs = []
    for r in range(ref.plan.n_rounds):
        rs, ts_ = ref.step_round(), port.step_round()
        assert np.array_equal(ts_.done, rs.done)
        assert ts_.fraction_done == rs.fraction_done
        fracs.append(ts_.fraction_done)
        _assert_near(ts_.profile, rs.profile, ua, ub, f"round {r} A")
        if b is not None:
            _assert_near(ts_.profile_b, rs.profile_b, ub, ua, f"round {r} B")
    assert all(f2 > f1 for f1, f2 in zip(fracs, fracs[1:]))
    assert fracs[-1] == 1.0
    got, want = port.result(), ref.result()
    assert (got.kind, got.exclusion, got.k, got.backend, got.fraction_done
            ) == (want.kind, want.exclusion, want.k, want.backend,
                  want.fraction_done)
    fields = [("p", "i")] + ([("b_p", "b_i")] if b is not None else [])
    if k > 1:
        fields += [("topk_p", "topk_i")]
    for fp, fi in fields:
        gp = _np(dist_to_corr(getattr(got, fp).double(), m))
        wp = _np(dist_to_corr(torch.from_numpy(
            np.asarray(getattr(want, fp), np.float64)), m))
        np.testing.assert_allclose(gp, wp, rtol=0, atol=TOL_CORR)
        assert np.array_equal(_np(getattr(got, fi)) >= 0,
                              np.asarray(getattr(want, fi)) >= 0)


def test_default_exclusion_rounds_down_like_the_reference(mesh):
    """The scheduler keeps the reference scheduler's max(1, m // 4), where
    the entry points' default rounds up (ROADMAP.md §C (15))."""
    ts = walk(300, 4)
    for m in (13, 16, 3):
        port = AnytimeScheduler(ts, m, ["cpu"], chunks_per_worker=2)
        ref = RefScheduler(ts, m, mesh, chunks_per_worker=2)
        assert port.exclusion == ref.exclusion == max(1, m // 4)


# -- chunked kernel sweeps: bit for bit one call, empty chunks launch nothing


@pytest.mark.parametrize("n_workers", [1, 3, 8])
def test_chunked_self_join_equals_one_plain_call_bitwise(n_workers):
    ts, m, excl = walk(420, 9), 16, 5
    sch = AnytimeScheduler(ts, m, ["cpu"] * n_workers, band=16,
                           chunks_per_worker=3, exclusion=excl)
    sch.run()
    stats = compute_stats_host(np.asarray(ts, np.float32), m, device="cpu")
    cr, ir, cc, ic = ops.rowmax_from_stats(stats, excl=excl)
    one = ProfileState(cr, ir).merge(ProfileState(cc, ic))
    assert torch.equal(sch.state.profile.corr, one.corr)
    assert torch.equal(sch.state.profile.index, one.index)


@pytest.mark.parametrize("exclusion", [0, 4])
def test_chunked_ab_join_equals_one_plain_call_per_span_bitwise(exclusion):
    a, b, m = walk(380, 10), walk(250, 11), 16
    sch = AnytimeScheduler(a, m, ["cpu"] * 4, band=16, chunks_per_worker=3,
                           exclusion=exclusion, ts_b=b)
    sch.run()
    cross = compute_cross_stats_host(np.asarray(a, np.float32),
                                     np.asarray(b, np.float32), m,
                                     device="cpu")
    ca, ia, cb, ib = ops.ab_rowmax_from_stats(cross, exclusion=exclusion)
    for got, want in ((sch.state.profile, (ca, ia)),
                      (sch.state.profile_b, (cb, ib))):
        assert torch.equal(got.corr, want[0])
        assert torch.equal(got.index, want[1])


def test_chunk_functions_split_a_span_bitwise():
    """Any cut of a span into chunks merges to the one call's correlations
    bit for bit, on both AB sides and across the sign change."""
    a, b, m = walk(300, 12), walk(180, 13), 16
    cross = compute_cross_stats_host(a, b, m, device="cpu")
    la, lb = cross.l_a, cross.l_b
    one = ops.ab_rowmax_chunk(cross, -(la - 1), lb)
    ca, ia, cb, ib = ops._empty_sides(la, lb, "cpu")
    for k0, k1 in ((-(la - 1), -200), (-200, -1), (-1, 5), (5, 77),
                   (77, lb)):
        c = ops.ab_rowmax_chunk(cross, k0, k1)
        ca, ia = ops._merge_corr(ca, ia, c[0], c[1])
        cb, ib = ops._merge_corr(cb, ib, c[2], c[3])
    assert torch.equal(ca, one[0]) and torch.equal(cb, one[2])


def test_empty_chunks_launch_nothing(monkeypatch):
    calls = []
    real = natsa_mp.rowmax_profile_ab

    def counting(*args, **kw):
        calls.append((kw["k_start"], kw["k_end"]))
        return real(*args, **kw)

    monkeypatch.setattr(natsa_mp, "rowmax_profile_ab", counting)
    ts, m = walk(300, 14), 16
    stats = compute_stats_host(ts, m, device="cpu")
    l = stats.n_subsequences
    for k0, k1 in ((l, l), (40, 40), (50, 10)):
        c, i, cc, ci = ops.rowmax_chunk(stats, k0, k1)
        assert (c == ops.NEG).all() and (i == -1).all()
        assert (cc == ops.NEG).all() and (ci == -1).all()
    cross = compute_cross_stats_host(ts, walk(120, 15), m, device="cpu")
    c = ops.ab_rowmax_chunk(cross, cross.l_b, cross.l_b)
    assert all(bool((x == f).all()) for x, f in zip(c, (ops.NEG, -1) * 2))
    assert calls == []
    # fewer live chunks than 8 workers (band alignment collapses cuts into
    # empty ranges): a round launches only its live chunks, and a crashed
    # worker's chunk is emptied, not swept
    sch = AnytimeScheduler(ts, m, ["cpu"] * 8, band=64, chunks_per_worker=1)
    live = [w for w, c in enumerate(sch.plan.chunks) if c[1] > c[0]]
    assert len(live) < 8 and sch.plan.rounds == (tuple(range(8)),)
    sch.step_round(fail_workers={live[0]})
    assert calls == [sch.plan.chunks[w] for w in live[1:]]
    assert list(np.flatnonzero(~sch.state.done)) == [live[0]]


# -- twins of tests/test_ab_scheduler.py --------------------------------------


def _ab_pair(na=420, nb=200, seed=2):
    rng = np.random.default_rng(seed)
    return (np.cumsum(rng.normal(size=na)).astype(np.float32),
            np.cumsum(rng.normal(size=nb)).astype(np.float32))


def test_ab_rounds_monotone_and_exact():
    a, b = _ab_pair()
    m = 16
    sch = AnytimeScheduler(a, m, ["cpu"], ts_b=b, chunks_per_worker=6,
                           band=16)
    p_ref, _ = ab_join_bruteforce(jnp.asarray(a), jnp.asarray(b), m)
    prev, fracs = None, []
    for _ in range(sch.plan.n_rounds):
        st = sch.step_round()
        d = _np(st.profile.to_distance(m))
        if prev is not None:
            assert (d <= prev + 1e-5).all(), "anytime merge must be monotone"
        prev = d
        fracs.append(st.fraction_done)
    r = sch.distance_profile()
    np.testing.assert_allclose(_np(r.p), np.asarray(p_ref), rtol=2e-3,
                               atol=2e-3)
    lb = len(b) - m + 1
    assert ((_np(r.i) >= 0) & (_np(r.i) < lb)).all()
    assert all(f2 > f1 for f1, f2 in zip(fracs, fracs[1:]))
    assert fracs[-1] == pytest.approx(1.0)


def test_ab_checkpoint_resume_identical(tmp_path):
    a, b = _ab_pair(seed=5)
    m, path = 20, str(tmp_path / "ab.npz")
    mk = lambda: AnytimeScheduler(a, m, ["cpu"], ts_b=b, chunks_per_worker=4,
                                  band=16)
    full = mk()
    full.run()
    part = mk()
    part.step_round()
    part.step_round()
    assert 0.0 < part.state.fraction_done < 1.0
    part.checkpoint(path)
    res = mk()
    res.resume(path)
    res.run()
    got, want = res.result(), full.result()
    for f in ("p", "i", "b_p", "b_i"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    bp, bi = res.distance_profile_b()
    assert torch.equal(bp, want.b_p) and torch.equal(bi, want.b_i)


def test_ab_scheduler_with_exclusion_matches_self():
    a, _ = _ab_pair(na=380, nb=0, seed=9)
    m, excl = 16, 4
    ab = AnytimeScheduler(a, m, ["cpu"], ts_b=a, exclusion=excl,
                          chunks_per_worker=4, band=16)
    ab.run()
    selfj = AnytimeScheduler(a, m, ["cpu"], exclusion=excl,
                             chunks_per_worker=4, band=16)
    selfj.run()
    np.testing.assert_allclose(_np(ab.distance_profile().p),
                               _np(selfj.distance_profile().p), rtol=1e-3,
                               atol=1e-3)
    with pytest.raises(ValueError, match="requires an AB scheduler"):
        selfj.distance_profile_b()


def test_ab_checkpoint_refuses_mismatched_geometry(tmp_path):
    a, b = _ab_pair(seed=11)
    path = str(tmp_path / "geom.npz")
    sch = AnytimeScheduler(a, 16, ["cpu"], ts_b=b, chunks_per_worker=2)
    sch.step_round()
    sch.checkpoint(path)
    other = AnytimeScheduler(a, 16, ["cpu"], chunks_per_worker=2)
    with pytest.raises(ValueError, match="geometry mismatch"):
        other.resume(path)


# -- twins of the scheduler cases of tests/test_checkpoint.py ----------------


@pytest.fixture
def mk_sched():
    ts = np.cumsum(np.random.default_rng(5).normal(size=240))
    return lambda **kw: AnytimeScheduler(ts, 12, ["cpu"], chunks_per_worker=4,
                                         band=16, **kw)


def _corrupt_payload(path):
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.seek(size // 3)
        f.write(b"\xa5" * (size // 3))


def test_scheduler_checkpoint_meta_has_checksums(mk_sched, tmp_path):
    s = mk_sched()
    s.run(2)
    path = str(tmp_path / "ck.npz")
    s.checkpoint(path)
    with np.load(path) as z:
        meta = json.loads(str(z["meta"]))
    assert meta["format"] == CHECKPOINT_FORMAT == 2
    assert set(meta["checksums"]) >= {"corr", "index", "done"}


def test_scheduler_resume_rotation_and_corruption_fallback(mk_sched,
                                                          tmp_path):
    path = str(tmp_path / "ck.npz")
    s = mk_sched()
    s.run(1)
    s.checkpoint(path)
    s.run(1)
    s.checkpoint(path)
    assert os.path.exists(path + ".prev")
    flip_bits(path, seed=9, n_flips=64)
    s2 = mk_sched()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        s2.resume(path)
    assert any("falling back" in str(x.message) for x in w)
    s2.run()
    clean = mk_sched()
    clean.run()
    assert torch.equal(s2.result().p, clean.result().p)
    assert torch.equal(s2.result().i, clean.result().i)


def test_scheduler_resume_corruption_without_fallback_raises(mk_sched,
                                                             tmp_path):
    path = str(tmp_path / "ck.npz")
    s = mk_sched()
    s.run(1)
    s.checkpoint(path)
    assert not os.path.exists(path + ".prev")
    _corrupt_payload(path)
    with pytest.raises(CheckpointCorruptionError):
        mk_sched().resume(path)


def test_scheduler_resume_geometry_mismatch_is_valueerror(mk_sched,
                                                          tmp_path):
    path = str(tmp_path / "ck.npz")
    s = mk_sched()
    s.run(1)
    s.checkpoint(path)
    other = AnytimeScheduler(np.cumsum(np.ones(300)), 12, ["cpu"])
    with pytest.raises(ValueError, match="geometry mismatch"):
        other.resume(path)
    wrong_window = AnytimeScheduler(
        np.cumsum(np.random.default_rng(5).normal(size=240)), 24, ["cpu"])
    with pytest.raises(ValueError, match="geometry mismatch"):
        wrong_window.resume(path)
    with pytest.raises(ValueError, match="k=1 neighbour sets"):
        mk_sched(k=2).resume(path)


def test_scheduler_checkpoint_kill_leaves_previous_intact(mk_sched,
                                                          tmp_path):
    path = str(tmp_path / "ck.npz")
    s = mk_sched()
    s.run(1)
    s.checkpoint(path)
    good = open(path, "rb").read()
    s.run(1)
    with pytest.raises(CheckpointWriteError):
        s.checkpoint(path, injector=FaultInjector(checkpoint_kills={0}),
                     serial=0)
    assert open(path, "rb").read() == good
    assert [p for p in os.listdir(tmp_path) if p.endswith(".tmp")] == []
    mk_sched().resume(path)


def test_scheduler_future_format_and_unfused_rejected(mk_sched, tmp_path):
    path = str(tmp_path / "ck.npz")
    s = mk_sched()
    s.run(1)
    s.checkpoint(path)
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    meta = json.loads(str(arrays.pop("meta")))
    for key, val, match in (("format", 99, "format 99"),
                            ("fused", False, "predates the fused")):
        bad = dict(meta, **{key: val})
        np.savez(path, meta=json.dumps(bad), **arrays)
        with pytest.raises(ValueError, match=match):
            mk_sched().resume(path)


def test_elastic_resume_and_replan_keep_the_bits(mk_sched, tmp_path):
    """Resuming on another worker count, or shrinking in flight, re-groups
    the remaining chunks but commits the same chunks: the same bits."""
    ts = np.cumsum(np.random.default_rng(5).normal(size=240))
    clean = mk_sched()
    clean.run()
    path = str(tmp_path / "ck.npz")
    s = AnytimeScheduler(ts, 12, ["cpu"] * 4, chunks_per_worker=4, band=16)
    s.run(2)
    s.checkpoint(path)
    for workers in (1, 3):
        r = AnytimeScheduler(ts, 12, ["cpu"] * 4, chunks_per_worker=4,
                             band=16)
        r.resume(path, n_workers=workers)
        assert r.plan.n_workers == workers
        r.run()
        assert torch.equal(r.result().p, clean.result().p)
        assert torch.equal(r.result().i, clean.result().i)
    s._replan(2)
    s.run()
    assert torch.equal(s.result().p, clean.result().p)


# -- checkpoints across the two packages --------------------------------------


def _load(path):
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    return arrays, json.loads(str(arrays.pop("meta")))


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("kind", ["self", "ab"])
def test_checkpoints_restore_across_packages(mesh, tmp_path, kind, k):
    a, b = _pair(kind, seed=21)
    m = 16
    kw = dict(band=16, chunks_per_worker=4, ts_b=b, k=k)
    port, ref = AnytimeScheduler(a, m, ["cpu"], **kw), RefScheduler(
        a, m, mesh, **kw)
    port.run(2)
    ref.run(2)
    pp, rp = str(tmp_path / "port.npz"), str(tmp_path / "ref.npz")
    port.checkpoint(pp)
    ref.checkpoint(rp)
    (pa, pm), (ra, rm) = _load(pp), _load(rp)
    assert list(pa) == list(ra)
    for name in pa:
        assert pa[name].dtype == ra[name].dtype, name
        assert pa[name].shape == ra[name].shape, name
    assert pa["done"].tobytes() == ra["done"].tobytes()
    assert int(pa["rounds_completed"]) == int(ra["rounds_completed"])
    assert {f: pm[f] for f in pm if f != "checksums"} == {
        f: rm[f] for f in rm if f != "checksums"}
    for name in ("done", "rounds_completed"):
        assert pm["checksums"][name] == rm["checksums"][name]
    # each package resumes the other's file and finishes the exact answer
    port_clean = AnytimeScheduler(a, m, ["cpu"], **kw)
    port_clean.run()
    ref_clean = RefScheduler(a, m, mesh, **kw)
    ref_clean.run()
    ua = _unit(a, m)
    ub = ua if b is None else _unit(b, m)
    port_from_ref = AnytimeScheduler(a, m, ["cpu"], **kw)
    port_from_ref.resume(rp)
    port_from_ref.run()
    ref_from_port = RefScheduler(a, m, mesh, **kw)
    ref_from_port.resume(pp)
    ref_from_port.run()
    for got, want in ((port_from_ref.state, port_clean.state),
                      (ref_from_port.state, ref_clean.state),
                      (ref_from_port.state, port_clean.state)):
        _assert_near(got.profile, want.profile, ua, ub)
        if b is not None:
            _assert_near(got.profile_b, want.profile_b, ub, ua)


# -- the distributed plan and the round executor ------------------------------


@pytest.mark.parametrize("kind", ["self", "ab"])
def test_distributed_plan_matches_reference(kind):
    l_b = None if kind == "self" else 211
    for k, excl in ((1, None), (4, 5), (2, 3)):
        ref = rplan.plan_sweep(16, 300, l_b, exclusion=excl, band=16,
                               backend="distributed", k=k)
        port = tplan.plan_sweep(16, 300, l_b, exclusion=excl, band=16,
                                backend="distributed", k=k, device="cpu")
        got = {f.name: getattr(port, f.name)
               for f in dataclasses.fields(port) if f.name != "device"}
        want = {f.name: getattr(ref, f.name)
                for f in dataclasses.fields(ref) if f.name != "interpret"}
        for name in ("harvest", "precision"):
            assert (dataclasses.astuple(got.pop(name))
                    == dataclasses.astuple(want.pop(name))), name
        assert got == want
    with pytest.raises(ValueError, match="accumulates in f32"):
        tplan.plan_sweep(16, 300, backend="distributed", precision="f64",
                         device="cpu")


@pytest.mark.parametrize("kind", ["self", "ab"])
@pytest.mark.parametrize("option", [dict(reseed_every=64),
                                    dict(clamp_rows=False)])
def test_kernel_chunk_plan_refuses_the_engine_options(kind, option):
    """A k = 1 distributed plan runs NATSA kernel chunks, which never
    reseed and always clamp: the reference plans these options for its
    engine chunks, the port refuses them (ROADMAP.md §C (15)) rather than
    record options its rounds would not honour. `band` still aligns the
    chunks, and k > 1 plans keep the engine's options."""
    l_b = None if kind == "self" else 211
    ref = rplan.plan_sweep(16, 300, l_b, backend="distributed", **option)
    assert ref.backend == "distributed"
    with pytest.raises(NotImplementedError, match=r"§C \(15\)"):
        tplan.plan_sweep(16, 300, l_b, backend="distributed", device="cpu",
                         **option)
    with pytest.raises(NotImplementedError):
        tplan.plan_sweep(16, 300, l_b, backend="distributed", k=1,
                         device="cpu", **option)
    assert tplan.plan_sweep(16, 300, l_b, backend="distributed", band=16,
                            device="cpu").band == 16
    if "reseed_every" in option:
        port = tplan.plan_sweep(16, 300, l_b, backend="distributed", k=4,
                                exclusion=3, device="cpu", **option)
        assert port.reseed_every == 64


def test_execute_and_round_executor_refusals(monkeypatch, tmp_path):
    plan = tplan.plan_sweep(16, 285, backend="distributed", device="cpu")
    stats = compute_stats_host(walk(300, 3), 16, device="cpu")
    with pytest.raises(ValueError, match="round-by-round"):
        tplan.execute(plan, stats)
    with pytest.raises(ValueError, match="lacks n_bands"):
        tplan.round_executor(plan, ["cpu"])
    kernel = tplan.plan_sweep(16, 285, device="cpu")
    with pytest.raises(ValueError, match="needs a distributed plan"):
        tplan.round_executor(kernel, ["cpu"])
    planned = dataclasses.replace(plan, n_bands=4)
    with pytest.raises(ValueError, match="at least one device"):
        tplan.round_executor(planned, [])
    fn = tplan.round_executor(planned, ["cpu", "cpu"])
    with pytest.raises(ValueError, match="one \\(k0, k1\\) per worker"):
        fn(stats, ProfileState.empty(285), [4], [20])
    assert tplan._NOT_PORTED == {}
    # a one-rank group (a subprocess): the scheduler over the mesh runs
    # every case to the one-process scheduler's bits
    one = run_suite("one_rank", tmp_path, world=1, timeout=240)
    for case, got in one["runs"].items():
        sch = any_make(AnytimeScheduler, ["cpu"], case)
        assert json.dumps(got) == json.dumps(any_dump(sch.run())), case
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    with pytest.raises(ValueError, match="DeviceMesh"):
        tplan.round_executor(planned, ["cpu"])
    with pytest.raises(ValueError, match="DeviceMesh"):
        AnytimeScheduler(walk(300, 3), 16, ["cpu"])


def test_round_fn_merges_workers_with_the_reference_tie_rules():
    """k = 1: `pmax_w(running.merge(local_w))` — ties go to the highest
    index across workers, to the running state within one. k > 1: the
    stable slot-major, worker-minor union, then the running state."""
    from repro_torch.core.distributed import allreduce_topk, pmax_profile
    from repro_torch.core.matrix_profile import TopKState

    run = ProfileState(torch.tensor([0.5, 0.5, 0.1]),
                       torch.tensor([7, 7, 7], dtype=torch.int32))
    w0 = ProfileState(torch.tensor([0.5, 0.9, 0.3]),
                      torch.tensor([1, 1, 1], dtype=torch.int32))
    w1 = ProfileState(torch.tensor([0.2, 0.9, 0.3]),
                      torch.tensor([2, 4, 0], dtype=torch.int32))
    got = pmax_profile([run.merge(w0), run.merge(w1)])
    assert got.corr.tolist() == pytest.approx([0.5, 0.9, 0.3])
    assert got.index.tolist() == [7, 4, 1]
    t0 = TopKState(torch.tensor([[0.9, 0.4]]),
                   torch.tensor([[3, 5]], dtype=torch.int32))
    t1 = TopKState(torch.tensor([[0.9, 0.8]]),
                   torch.tensor([[1, 6]], dtype=torch.int32))
    u = allreduce_topk([t0, t1])
    assert u.index.tolist() == [[3, 1]]


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (and nvcc) to run the NATSA kernel")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["self", "ab"])
def test_kernel_chunks_equal_one_launch_on_card(card, kind):
    """Every non-empty k = 1 chunk is one NATSA launch; the chunked
    correlations are one launch's bit for bit."""
    a, m = walk(20000, 31), 64
    b = None if kind == "self" else walk(6000, 32)
    sch = AnytimeScheduler(a, m, [card] * 8, ts_b=b)
    live = sum(c[1] > c[0] for c in sch.plan.chunks)
    before = natsa_mp.LAUNCHES
    sch.run()
    assert natsa_mp.LAUNCHES - before == live
    if b is None:
        cr, ir, cc, ic = ops.rowmax_from_stats(sch.stats, excl=sch.exclusion)
        one = ProfileState(cr, ir).merge(ProfileState(cc, ic))
        assert torch.equal(sch.state.profile.corr, one.corr)
    else:
        ca, _, cb, _ = ops.ab_rowmax_from_stats(sch.cross)
        assert torch.equal(sch.state.profile.corr, ca)
        assert torch.equal(sch.state.profile_b.corr, cb)


@pytest.mark.gpu
def test_supervised_run_equals_clean_run_on_card(card, tmp_path):
    ts, m = walk(20000, 33), 64
    mk = lambda: AnytimeScheduler(ts, m, [card] * 8)
    clean = mk()
    clean.run()
    inj = FaultInjector.seeded(4, n_rounds=64, n_workers=8,
                               p_worker_crash=0.15, p_round_failure=0.3,
                               max_round_failures=2, p_checkpoint_kill=0.2,
                               p_checkpoint_flip=0.2)
    s = mk()
    res = s.run_supervised(FaultPolicy(checkpoint_every=1,
                                       worker_failure_threshold=3,
                                       **NO_SLEEP),
                           checkpoint_path=str(tmp_path / "ck.npz"),
                           injector=inj)
    assert not s.supervised_report.degraded
    assert torch.equal(res.p, clean.result().p)
    assert torch.equal(res.i, clean.result().i)
