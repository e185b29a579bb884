"""The port's analytics (`repro_torch.core.analytics`) against the
reference's on the SAME profile: each `repro` result is carried over bit for
bit into a port `ProfileResult` (tensors), and every pick, score and arc
curve must be equal — the analytics are exact selections and integer arc
counts, so there is no tolerance.
"""

import numpy as np
import pytest
import torch

from repro.core import ab_join as ref_ab_join
from repro.core import analytics as ra
from repro.core import matrix_profile as ref_matrix_profile
from repro.core.result import ProfileResult as RefProfileResult
from repro_torch.core import analytics as ta
from repro_torch.core import matrix_profile
from repro_torch.core.result import ProfileResult

_ARRAYS = ("p", "i", "topk_p", "topk_i")


def _walk(n, seed):
    return np.cumsum(np.random.default_rng(seed).normal(size=n))


def _carry(ref) -> ProfileResult:
    """A reference result as a port result, bits unchanged."""
    arrays = {f: torch.from_numpy(np.array(getattr(ref, f)))
              for f in _ARRAYS if getattr(ref, f) is not None}
    return ProfileResult(**arrays, kind=ref.kind, window=ref.window,
                         exclusion=ref.exclusion, normalize=ref.normalize,
                         k=ref.k, backend=ref.backend)


def _pair(ref):
    """(reference result, its port twin), both eager: the reference's lazy
    fields are dropped so both see the same arrays."""
    fields = {f: np.array(getattr(ref, f)) for f in _ARRAYS
              if getattr(ref, f) is not None}
    ref = RefProfileResult(**fields, kind=ref.kind, window=ref.window,
                           exclusion=ref.exclusion,
                           normalize=ref.normalize, k=ref.k,
                           backend=ref.backend)
    return ref, _carry(ref)


def _self(n=600, m=16, seed=1, k=1, holes=()):
    ts = _walk(n, seed)
    for h in holes:
        ts[h] = np.nan
    return _pair(ref_matrix_profile(ts, m, k=k))


def _fields(d):
    return d.position, d.score, d.neighbor


def _assert_motifs(want, got):
    assert len(got) == len(want)
    for w, g in zip(want, got):
        assert (g.a, g.b, g.neighbors) == (w.a, w.b, w.neighbors)
        assert g.d == w.d


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("kw", [dict(), dict(max_motifs=5, exclusion=30),
                                dict(radius=1.2)])
def test_top_motifs_equal_reference(k, kw):
    ref, port = _self(k=k)
    _assert_motifs(ra.top_motifs(ref, **kw), ta.top_motifs(port, **kw))
    if k > 1:
        assert any(m.neighbors for m in ta.top_motifs(port, **kw))


@pytest.mark.parametrize("kw", [dict(), dict(n=6), dict(n=4, exclusion=2)])
def test_discords_equal_reference(kw):
    ref, port = _self(holes=(100, 101, 350))        # inf entries skipped
    want, got = ra.discords(ref, **kw), ta.discords(port, **kw)
    assert [_fields(d) for d in got] == [_fields(d) for d in want]
    assert _fields(ta.top_discord(port)) == _fields(ra.top_discord(ref))


def test_corrected_arc_curve_and_regimes_equal_reference():
    """A series with three regimes: the arc curve bit for bit, and the
    same boundaries."""
    rng = np.random.default_rng(4)
    t = np.arange(1500)
    ts = np.concatenate([np.sin(2 * np.pi * t[:500] / 25),
                         np.sign(np.sin(2 * np.pi * t[500:1000] / 40)),
                         np.sin(2 * np.pi * t[1000:] / 9)])
    ts = ts + 0.05 * rng.normal(size=1500)
    ref, port = _pair(ref_matrix_profile(ts, 24))
    cac = ta.corrected_arc_curve(port)
    assert cac.dtype == torch.float64
    np.testing.assert_array_equal(cac.numpy(), ra.corrected_arc_curve(ref))
    for kw in (dict(), dict(n_regimes=3), dict(n_regimes=4, exclusion=50)):
        want, got = ra.regimes(ref, **kw), ta.regimes(port, **kw)
        assert got.boundaries == want.boundaries
        np.testing.assert_array_equal(got.cac.numpy(), want.cac)
    b = ta.regimes(port, n_regimes=3).boundaries
    assert min(abs(x - 500) for x in b) < 60 and min(
        abs(x - 1000) for x in b) < 60


def test_analytics_on_ab_and_port_results():
    """AB results: motifs suppress only A's axis, arc curves refuse; the
    port's own results (tensors from its sweeps) run the same code."""
    a, b = _walk(400, 5), _walk(300, 6)
    ref, port = _pair(ref_ab_join(a, b, 16))
    _assert_motifs(ra.top_motifs(ref), ta.top_motifs(port))
    with pytest.raises(ValueError, match="SELF-join"):
        ta.corrected_arc_curve(port)
    own = matrix_profile(_walk(500, 7), 16, k=3, device="cpu")
    assert len(ta.top_motifs(own)) == 3 and len(ta.discords(own)) == 3
    assert ta.regimes(own).cac.shape == (485,)


def test_analytics_edges():
    """No finite entry: no motif, no discord; a stacked profile refuses."""
    _, port = _self()
    empty = ProfileResult(torch.full((50,), torch.inf),
                          torch.full((50,), -1, dtype=torch.int32),
                          window=8, exclusion=2)
    assert ta.top_motifs(empty) == [] and ta.discords(empty) == []
    assert ta.top_discord(empty) is None
    stacked = ProfileResult(port.p[None].repeat(2, 1), port.i[None].repeat(
        2, 1), window=16, exclusion=4)
    for fn in (ta.top_motifs, ta.discords, ta.corrected_arc_curve):
        with pytest.raises(ValueError, match="single-series"):
            fn(stacked)
