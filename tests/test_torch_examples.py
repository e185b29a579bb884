"""The port's twins of the reference's examples, on the CPU.

`examples/serve_profiles_torch.py`: the probe names the planted series 2
near position 300, a lapsed query comes back expired with coverage 0 and
an all-inf profile, and the ninth pending query is rejected; the script
also runs as the command its docstring gives.

`examples/quickstart_torch.py`, `ab_query_torch.py` and
`anomaly_monitor_torch.py`: each twin's findings (motif pair, discords,
best query window and match, flagged series, alarms) equal those of the
reference package's functions on the same numpy inputs, its profiles lie
within the port's standard of the reference's (1e-4 in correlation;
raw squared distances 1e-4 relative, as `test_torch_nonnorm.py`), and the
planted positions are recovered. On the quickstart's series the
reference's f32 sweep itself strays 1.44e-4 from the f64 exact profile at
a few rows (row 4537), where the port's reads 2.9e-5: there the port is
held to the exact profile at 1e-4, and to the reference's at 1e-4 on every
row where the reference keeps to the exact profile within 1e-4.
The streaming queries are held against the reference's `ab_join` of the
query with the corpus so far: the question a query answers, one sweep
each. `train_lm_torch.py` runs a shortened schedule: the loss falls from
its first logged value, and the restart resumes from the written step.
"""

import importlib.util
import os
import re
import subprocess
import sys

import numpy as np
import torch

from repro_torch.core.zstats import dist_to_corr

HERE = os.path.dirname(os.path.abspath(__file__))
EXAMPLES = os.path.join(HERE, "..", "examples")
CORR_TOL = 1e-4   # the port's standard against the reference, in correlation
RAW_RTOL = 1e-4   # raw squared distances: 1e-4 max(1, d2) (slice 6)


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _corr_err(got, want, m, where=None) -> float:
    """Max |corr| difference over the entries finite on both sides (and
    `where`, a mask); both sides must be finite at the same entries."""
    got = torch.as_tensor(got).double()
    want = torch.as_tensor(np.asarray(want, np.float64))
    fin = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), fin)
    if where is not None:
        fin &= where
    return float((dist_to_corr(got[fin], m)
                  - dist_to_corr(want[fin], m)).abs().max())


def _exact_self_profile(ts, m, exclusion):
    """The f64 exact self-join profile of every row."""
    from repro_torch.core import ref as tref

    ts = np.asarray(ts, np.float64)
    d, _ = tref.profile_rows(ts, ts, m, np.arange(len(ts) - m + 1),
                             exclusion=exclusion)
    return d


def test_serve_profiles_twin_finds_the_planted_pattern():
    out = _example("serve_profiles_torch").main(device="cpu")
    series, pos = out["probe"]
    assert series == 2 and abs(pos - 300) < 16
    assert out["expired"] == ["expired", 0.0, True]
    assert out["rejected"] == 1


def test_serve_profiles_twin_runs_as_a_script():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, os.path.join(EXAMPLES, "serve_profiles_torch.py"),
         "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "OK — probe matched the planted pattern in series 2." in \
        proc.stdout
    assert "query 9 rejected" in proc.stdout


def test_quickstart_twin_matches_the_reference():
    from repro.core import analytics as ranalytics
    from repro.core.matrix_profile import matrix_profile as ref_mp

    ex = _example("quickstart_torch")
    out = ex.main(device="cpu")
    m = ex.M
    ref = ref_mp(ex.series(), m, k=4)
    mot = ranalytics.top_motifs(ref, max_motifs=1)[0]
    assert out["motif"] == (mot.a, mot.b)
    assert out["discords"] == [d.position for d in ranalytics.discords(
        ref, n=3, exclusion=m)]
    assert out["kernel_motif"] == (mot.a, mot.b)
    exact = _exact_self_profile(ex.series(), m, ref.exclusion)
    ref_dist = torch.as_tensor(np.asarray(ref.p, np.float64))
    ref_err = (dist_to_corr(ref_dist, m) - dist_to_corr(exact, m)).abs()
    ref_sound = ref_err <= CORR_TOL
    assert int((~ref_sound).sum()) <= 3
    for key in ("profile", "kernel_profile"):
        assert _corr_err(out[key], exact, m) <= CORR_TOL
        assert _corr_err(out[key], ref.p, m, where=ref_sound) <= CORR_TOL
    a, b = sorted(out["motif"])
    assert abs(a - 800) < 40 and abs(b - 4200) < 40
    assert any(abs(d - 2600) < m for d in out["discords"])


def test_ab_query_twin_matches_the_reference():
    from repro.core.matrix_profile import ab_join as ref_ab
    from repro.core.matrix_profile import batch_profile as ref_batch

    ex = _example("ab_query_torch")
    out = ex.main(device="cpu")
    m, data = ex.M, ex.inputs()
    query, corpus = data["query"], data["ref"]
    ref = ref_ab(query, corpus, m, return_b=True, k=3)
    best_q = int(np.argmin(np.asarray(ref.p)))
    best_r = int(np.argmin(np.asarray(ref.b_p)))
    assert (out["best_q"], out["match"]) == (best_q, int(ref.i[best_q]))
    assert out["topk"] == np.asarray(ref.topk_i[best_q]).tolist()
    assert (out["best_r"], out["b_match"]) == (best_r, int(ref.b_i[best_r]))
    prof = out["profiles"]
    assert _corr_err(prof["p"], ref.p, m) <= CORR_TOL
    assert _corr_err(prof["b_p"], ref.b_p, m) <= CORR_TOL
    assert _corr_err(prof["topk_p"], ref.topk_p, m) <= CORR_TOL
    assert _corr_err(prof["kernel_p"], ref.p, m) <= CORR_TOL
    for k, (upto, key) in enumerate(((4000, "q1"), (len(corpus), "q2"))):
        want = ref_ab(query, corpus[:upto], m)
        best = int(np.argmin(np.asarray(want.p)))
        assert out["stream_best"][k] == (best, int(want.i[best]))
        assert _corr_err(prof[key], want.p, m) <= CORR_TOL
    bref = np.asarray(ref_batch(data["fleet"], 32).p)
    assert out["flagged"] == int(np.argmax(bref.max(axis=1))) == 4
    assert _corr_err(prof["batch"].flatten(), bref.flatten(), 32) <= CORR_TOL
    assert abs(best_q - 400) <= 3 and abs(out["match"] - 3000) <= 3
    assert abs(best_r - 3000) <= 3


def test_anomaly_monitor_twin_matches_the_reference():
    from repro.core import analytics as ranalytics
    from repro.core.matrix_profile import matrix_profile as ref_mp
    from repro.core.monitor import TelemetryMonitor as RefMonitor

    ex = _example("anomaly_monitor_torch")
    out = ex.main(device="cpu")
    loss, w = ex.loss_trace(), ex.WINDOW
    ref = ref_mp(loss.astype(np.float32), w, normalize=False)
    assert out["discords"] == [(h.position, h.neighbor)
                               for h in ranalytics.discords(ref, n=3)]
    want = np.asarray(ref.p, np.float64) ** 2
    got = out["profile"].double().numpy() ** 2
    assert (np.abs(got - want) <= RAW_RTOL * np.maximum(1.0, want)).all()
    mon = RefMonitor(window=w, min_history=128, zscore_alarm=3.0)
    mon.extend(loss)
    alarms = mon.scan(top_k=3)
    assert [p for p, _ in out["alarms"]] == [h.position for h in alarms]
    np.testing.assert_allclose([z for _, z in out["alarms"]],
                               [h.zscore for h in alarms], rtol=1e-3)
    assert out["motif"] == mon.motif()
    assert min(abs(p - 400) for p, _ in out["alarms"]) < 30
    assert min(abs(p - 400) for p, _ in out["discords"]) < 30


def test_anomaly_monitor_twin_runs_as_a_script():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, os.path.join(EXAMPLES, "anomaly_monitor_torch.py"),
         "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "OK — corruption window (planted at step 400) flagged." in \
        proc.stdout
    assert "[TelemetryMonitor] alarmed:" in proc.stdout


def test_train_lm_twin_learns_and_resumes(tmp_path, capsys):
    from repro_torch import configs
    from repro_torch.checkpoint import ckpt

    ex = _example("train_lm_torch")
    loss, loss2, _ = ex.train_and_restart("cpu", steps=30,
                                          ckpt_dir=str(tmp_path),
                                          ckpt_every=10, restart=5)
    log = capsys.readouterr().out
    first = float(re.search(r"\[train\] step\s+0 loss (\S+)", log).group(1))
    assert np.isfinite(loss) and loss < first - 1.0, (first, loss)
    assert "[train] resumed from step 30" in log
    assert re.search(r"\[train\] step\s+34 loss", log)
    assert np.isfinite(loss2)
    assert ckpt.latest_step(str(tmp_path)) == 35
    assert ex.ARCH not in configs.REGISTRY
