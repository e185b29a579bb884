"""The port's `StreamingFleet` (`repro_torch.core.fleet`) on the CPU:

  * against the port's own `StreamingProfile` epoch replay, BIT FOR BIT
    (the fleet contract, twins of `tests/test_fleet.py:57` and `:82`),
    whatever the tenant chunk size, with exact argmin ties;
  * against the reference fleet (`repro.core.fleet`) on the same arrivals:
    both accumulate in f64 and differ only in summation order, so profiles
    agree within 1e-9, indices are equal except at near-ties (1e-9), and
    counts, totals and epochs are equal;
  * snapshots, validation, reduced-precision `wk` (within the reference's
    analytic `profile_tolerance`), checkpoints under the seeded fault
    schedule, and checkpoints across the two packages (snapshots bitwise
    equal to the saver's; a later equal ingest on both within 1e-9).

The reference fleet runs under `repro.core.zstats.x64_scope`, which needs
`jax.experimental.enable_x64` (missing from jax 0.9.0); the `ref_x64`
fixture swaps it for `jax.enable_x64(True)` for these tests only. The
`gpu`-marked twins run the bitwise replay and the cross-package restore on
the card and skip elsewhere.
"""

import warnings

import jax
import numpy as np
import pytest
import torch

from repro.core import zstats as rz
from repro.core.fleet import StreamingFleet as RefFleet
from repro_torch.core.fleet import StreamingFleet
from repro_torch.core.precision import PrecisionSpec, profile_tolerance
from repro_torch.core.replay import EpochReplay
from repro_torch.core.streaming import StreamingProfile

F64_TOL = 1e-9
SIDES = (("p", "i"), ("left_p", "left_i"), ("right_p", "right_i"))


@pytest.fixture
def ref_x64(monkeypatch):
    monkeypatch.setattr(rz, "x64_scope", lambda: jax.enable_x64(True))


def _fleet(n, m, cap, device="cpu", **kw):
    return StreamingFleet(n, window=m, capacity=cap, device=device, **kw)


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_result_equal(got, want, ctx=""):
    for fp, fi in SIDES:
        for name in (fp, fi):
            a, b = _host(getattr(got, name)), _host(getattr(want, name))
            assert a.shape == b.shape, f"{ctx}/{name}: {a.shape} vs {b.shape}"
            assert a.dtype == b.dtype, f"{ctx}/{name}: {a.dtype} vs {b.dtype}"
            assert np.array_equal(a, b, equal_nan=True), f"{ctx}/{name}"


def _assert_close_to_reference(got, want, ctx=""):
    """Within F64_TOL, the same finite pattern, indices equal except where
    both picks' distances are within F64_TOL."""
    for fp, fi in SIDES:
        gp, wp = _host(getattr(got, fp)), np.asarray(getattr(want, fp))
        gi, wi = _host(getattr(got, fi)), np.asarray(getattr(want, fi))
        assert gp.shape == wp.shape, ctx
        np.testing.assert_array_equal(np.isfinite(gp), np.isfinite(wp))
        fin = np.isfinite(wp)
        if fin.any():
            assert np.abs(gp[fin] - wp[fin]).max() <= F64_TOL, f"{ctx}/{fp}"
        mism = gi != wi
        assert not (mism & ~fin).any(), f"{ctx}/{fi}"
        assert np.abs(gp[mism] - wp[mism]).max(initial=0) <= F64_TOL, ctx


def _mixed_batches(seed=42, n=5, batches=12, p_nan=0.08):
    rng = np.random.RandomState(seed)
    for _ in range(batches):
        k = rng.randint(1, 40)
        tids = rng.randint(0, n, size=k)
        vals = rng.randn(k)
        vals[rng.rand(k) < p_nan] = np.nan      # masked arrivals ride along
        yield tids, vals


def _replay_check(normalize, device, block_elements=None):
    n, m, cap = 5, 8, 32
    fleet = _fleet(n, m, cap, device, normalize=normalize)
    if block_elements is not None:
        fleet.BLOCK_ELEMENTS = block_elements
    oracles = [EpochReplay(m, cap, normalize=normalize, device=device)
               for _ in range(n)]
    for tids, vals in _mixed_batches(n=n):
        fleet.ingest(tids, vals)
        for t in range(n):
            for v in vals[tids == t]:
                oracles[t].push(v)
    assert fleet.epochs.max() >= 1, "test must exercise wraparound"
    assert np.isnan(np.concatenate([o.hist for o in oracles])).any()
    for t in range(n):
        _assert_result_equal(fleet.snapshot(t), oracles[t].sp.snapshot(),
                             ctx=f"tenant {t}")
        assert fleet.epochs[t] == oracles[t].epochs
        assert fleet.counts[t] == len(oracles[t].hist)
    np.testing.assert_array_equal(fleet._cnt_host, fleet.counts)


@pytest.mark.parametrize("block_elements", [None, 8 * 25])
@pytest.mark.parametrize("normalize", [True, False])
def test_fleet_bitwise_equals_streaming_replay(normalize, block_elements):
    """:57 — mixed-length batches, NaN arrivals, wraparound; the second
    case runs the product one tenant per chunk: same bits."""
    _replay_check(normalize, "cpu", block_elements)


def test_fleet_single_vs_grouped_ingest_equivalent():
    """:82 — one big mixed batch == the same arrivals one at a time."""
    rng = np.random.RandomState(3)
    n, m, cap = 4, 6, 40
    tids = rng.randint(0, n, size=150)
    vals = rng.randn(150)
    bulk = _fleet(n, m, cap)
    bulk.ingest(tids, vals)
    seq = _fleet(n, m, cap)
    for t, v in zip(tids, vals):
        seq.ingest(t, v)
    for t in range(n):
        _assert_result_equal(bulk.snapshot(t), seq.snapshot(t),
                             ctx=f"tenant {t}")


@pytest.mark.parametrize("normalize", [True, False])
def test_exact_argmin_ties_follow_the_replay_and_the_reference(ref_x64,
                                                               normalize):
    """A constant stretch gives windows at exactly equal distance: the row
    argmin takes the FIRST minimum and right-side updates need a strict <,
    in the replay's and the reference's order."""
    m, cap = 6, 64
    vals = np.r_[np.sin(np.arange(10.0)), np.full(30, 2.5),
                 np.cos(np.arange(12.0)), np.full(8, 2.5)]
    fleet, ref = _fleet(2, m, cap, normalize=normalize), RefFleet(
        2, window=m, capacity=cap, normalize=normalize)
    sp = StreamingProfile(m, normalize=normalize, device="cpu")
    for f in (fleet, ref):
        f.ingest(np.zeros(len(vals), np.int64), vals)
        f.ingest(np.ones(len(vals), np.int64), vals[::-1].copy())
    sp.append(vals)
    got = fleet.snapshot(0)
    _assert_result_equal(got, sp.snapshot())
    d = got.p.numpy()
    assert np.unique(d[np.isfinite(d)], return_counts=True)[1].max() > 2
    for t in range(2):
        res, want = fleet.snapshot(t), ref.snapshot(t)
        for _, fi in SIDES:
            np.testing.assert_array_equal(getattr(res, fi).numpy(),
                                          np.asarray(getattr(want, fi)))


@pytest.mark.parametrize("normalize", [True, False])
def test_fleet_matches_reference_fleet(ref_x64, normalize):
    """(a) :57's arrivals through both packages' fleets."""
    n, m, cap = 5, 8, 32
    fleet = _fleet(n, m, cap, normalize=normalize)
    ref = RefFleet(n, window=m, capacity=cap, normalize=normalize)
    for tids, vals in _mixed_batches(n=n):
        fleet.ingest(tids, vals)
        ref.ingest(tids, vals)
    assert ref.epochs.max() >= 1
    for name in ("counts", "totals", "epochs"):
        got, want = getattr(fleet, name), getattr(ref, name)
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want)
    for t in range(n):
        _assert_close_to_reference(fleet.snapshot(t), ref.snapshot(t),
                                   ctx=f"tenant {t}")


def test_fleet_snapshot_is_profile_result():
    """:100 — plus f64/int64 tensors on the fleet's device, and the
    whole-fleet snapshot equal to the per-tenant ones."""
    fleet = _fleet(2, 4, 16)
    fleet.ingest(np.zeros(10, int), np.sin(np.arange(10.0)))
    res = fleet.snapshot(0)
    assert res.kind == "self" and res.backend == "fleet"
    assert res.window == 4 and res.exclusion == 1 and res.normalize
    assert res.p.shape == (7,) and res.i.dtype == torch.int64
    assert res.p.dtype == torch.float64 and res.p.device.type == "cpu"
    allr = fleet.snapshot()
    assert len(allr) == 2 and allr[1].p.shape == (0,)
    _assert_result_equal(allr[0], res)
    before = res.p.clone()
    fleet.ingest(np.zeros(4, int), np.cos(np.arange(4.0)))
    assert torch.equal(res.p, before), "a snapshot must not change later"
    with pytest.raises(ValueError):
        fleet.snapshot(2)
    with pytest.raises(ValueError):
        fleet.snapshot(-1)


def test_fleet_validates_inputs(monkeypatch):
    """:113 — plus the device rule: the card by default, which raises on a
    host without CUDA."""
    with pytest.raises(ValueError):
        _fleet(0, 4, 16)
    with pytest.raises(ValueError):
        _fleet(1, 1, 16)
    with pytest.raises(ValueError):
        _fleet(1, 8, 4)                       # capacity < window
    fleet = _fleet(2, 4, 16)
    with pytest.raises(ValueError):
        fleet.ingest([2], [1.0])              # tenant out of range
    with pytest.raises(ValueError):
        fleet.ingest([0, 1], [1.0])           # length mismatch
    with pytest.raises(ValueError):
        fleet.ingest([[0]], [[1.0]])          # not 1-D
    assert fleet.ingest([], []) == 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StreamingFleet(2, window=4, capacity=16)


@pytest.mark.parametrize("stream", ["float64", "bfloat16", "float16"])
def test_fleet_reduced_wk_within_budget(stream):
    """test_precision.py:128 — only `stream` applies to the fleet (the wk
    window cache); accumulation stays f64."""
    ts = np.cumsum(np.random.default_rng(6).normal(size=200))
    m, cap = 8, 200
    tol = profile_tolerance(PrecisionSpec(stream=stream, accum="float64"), m)
    oracle = _fleet(1, m, cap, exclusion=2)
    reduced = _fleet(1, m, cap, exclusion=2,
                     precision=PrecisionSpec(stream=stream))
    for f in (oracle, reduced):
        f.ingest(np.zeros(len(ts), np.int64), ts)
    want = {"float64": torch.float64, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[stream]
    assert reduced._state["wk"].dtype == want
    assert oracle._state["wk"].dtype == torch.float64
    p0, p1 = oracle.snapshot(0).p, reduced.snapshot(0).p
    finite = torch.isfinite(p0) & torch.isfinite(p1)
    assert bool(finite.any())
    assert float((p0[finite] - p1[finite]).abs().max()) <= tol, stream


def test_reduced_wk_needs_normalization():
    with pytest.raises(ValueError, match="requires normalize=True"):
        _fleet(2, 8, 32, normalize=False, precision="bf16")
    for prec in (None, "f32", PrecisionSpec(stream="float64")):
        assert _fleet(2, 8, 32, precision=prec)._state["wk"].dtype \
            == torch.float64


def test_fleet_checkpoint_restore_and_rescale_under_faults(tmp_path):
    """(e) :128 — a killed save loses nothing committed, a flipped save
    falls back to the previous intact step, grow/shrink keep survivors
    bitwise."""
    from repro_torch.core.faults import CheckpointWriteError, FaultInjector

    rng = np.random.RandomState(11)
    n, m, cap = 4, 6, 24
    ckdir = str(tmp_path / "fleet_ck")
    inj = FaultInjector.seeded(5, n_rounds=12, n_workers=1,
                               p_checkpoint_kill=0.25,
                               p_checkpoint_flip=0.25, n_checkpoints=12)
    assert inj.checkpoint_kills and inj.checkpoint_flips
    fleet = _fleet(n, m, cap)
    committed, corrupted = {}, set()
    for _ in range(10):
        fleet.ingest(rng.randint(0, n, 15), rng.randn(15))
        step = fleet._ingests
        try:
            fleet.save(ckdir, keep=10, injector=inj)
        except CheckpointWriteError:
            continue
        committed[step] = fleet.snapshot()
        if step in inj.checkpoint_flips:
            corrupted.add(step)
    intact = sorted(set(committed) - corrupted)
    assert intact and corrupted
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        restored, got_step = StreamingFleet.restore(ckdir, device="cpu")
    assert got_step == intact[-1], "must fall back to newest INTACT step"
    for t in range(n):
        _assert_result_equal(restored.snapshot(t), committed[got_step][t])
    restored.rescale(n + 3)
    assert restored.n == n + 3
    for t in range(n):
        _assert_result_equal(restored.snapshot(t), committed[got_step][t])
    restored.ingest(np.full(2 * m, n + 1), rng.randn(2 * m))
    assert restored.snapshot(n + 1).p.shape == (m + 1,)
    restored.rescale(2)
    assert restored.n == 2
    for t in range(2):
        _assert_result_equal(restored.snapshot(t), committed[got_step][t])
    with pytest.raises(ValueError):
        restored.ingest([2], [0.0])
    with pytest.raises(ValueError):
        restored.rescale(0)
    restored.save(ckdir, keep=10)
    again, _ = StreamingFleet.restore(ckdir, device="cpu")
    assert again.n == 2
    _assert_result_equal(again.snapshot(1), committed[got_step][1])
    np.testing.assert_array_equal(again._cnt_host, again.counts)


def _cross_package_check(tmp_path, normalize, device, precision=None):
    """(f) A port save restored by the reference and a reference save
    restored by the port: snapshots bitwise equal to the saver's, and a
    later equal ingest on both within F64_TOL of each other."""
    n, m, cap = 5, 8, 32
    batches = list(_mixed_batches(seed=7, n=n, batches=14))
    tail = list(_mixed_batches(seed=8, n=n, batches=3, p_nan=0.0))
    port = _fleet(n, m, cap, device, normalize=normalize, precision=precision)
    ref = RefFleet(n, window=m, capacity=cap, normalize=normalize,
                   precision=precision)
    for tids, vals in batches:
        port.ingest(tids, vals)
        ref.ingest(tids, vals)
    port.save(str(tmp_path / "port"))
    ref.save(str(tmp_path / "ref"))
    ref_from_port, s1 = RefFleet.restore(str(tmp_path / "port"))
    port_from_ref, s2 = StreamingFleet.restore(str(tmp_path / "ref"),
                                               device=device)
    assert s1 == s2 == len(batches)
    assert port_from_ref._state["wk"].dtype == port._state["wk"].dtype
    for t in range(n):
        _assert_result_equal(ref_from_port.snapshot(t), port.snapshot(t))
        _assert_result_equal(port_from_ref.snapshot(t), ref.snapshot(t))
    for tids, vals in tail:
        ref_from_port.ingest(tids, vals)
        port_from_ref.ingest(tids, vals)
    for t in range(n):
        _assert_close_to_reference(port_from_ref.snapshot(t),
                                   ref_from_port.snapshot(t), ctx=f"t{t}")


@pytest.mark.parametrize("normalize", [True, False])
def test_checkpoints_restore_across_packages(ref_x64, tmp_path, normalize):
    _cross_package_check(tmp_path, normalize, "cpu")


def test_bf16_checkpoint_restores_across_packages(ref_x64, tmp_path):
    """A reduced `wk` goes to disk in f64 (the stream dtype in the
    metadata) and comes back in its stream dtype in either package."""
    _cross_package_check(tmp_path, True, "cpu", precision="bf16")


@pytest.mark.gpu
@pytest.mark.parametrize("normalize", [True, False])
def test_fleet_bitwise_equals_streaming_replay_on_card(normalize):
    """(b) on the card, with the default and with one-tenant chunks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _replay_check(normalize, "cuda")
    _replay_check(normalize, "cuda", block_elements=8 * 25)


@pytest.mark.gpu
@pytest.mark.parametrize("normalize", [True, False])
def test_checkpoints_restore_across_packages_on_card(ref_x64, tmp_path,
                                                     normalize):
    """(f) with the port's fleet on the card (the reference on the CPU)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _cross_package_check(tmp_path, normalize, "cuda")
