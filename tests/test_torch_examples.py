"""`examples/serve_profiles_torch.py`, the port's twin of the reference's
profile-service example, on the CPU: the probe names the planted series 2
near position 300, a lapsed query comes back expired with coverage 0 and
an all-inf profile, and the ninth pending query is rejected. The script
also runs as the command its docstring gives."""

import importlib.util
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
EXAMPLE = os.path.join(HERE, "..", "examples", "serve_profiles_torch.py")


def _example():
    spec = importlib.util.spec_from_file_location("serve_profiles_torch",
                                                  EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_serve_profiles_twin_finds_the_planted_pattern():
    out = _example().main(device="cpu")
    series, pos = out["probe"]
    assert series == 2 and abs(pos - 300) < 16
    assert out["expired"] == ["expired", 0.0, True]
    assert out["rejected"] == 1


def test_serve_profiles_twin_runs_as_a_script():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, EXAMPLE, "--device", "cpu"],
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "OK — probe matched the planted pattern in series 2." in \
        proc.stdout
    assert "query 9 rejected" in proc.stdout
