"""Shared launcher of `_torch_mesh_worker.py` for the `test_torch_mesh_*`
files: gloo ranks over a `FileStore` under pytest's `tmp_path`, each in a
subprocess with a timeout, and the reference's side in a process of its
own."""

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
WORKER = os.path.join(HERE, "_torch_mesh_worker.py")


def _env(tmp):
    env = dict(os.environ, MESH_WORKER_TMP=str(tmp),
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return env


def run_suite(suite, tmp, world=4, timeout=600):
    out = os.path.join(str(tmp), f"{suite}.json")
    store = os.path.join(str(tmp), f"{suite}.store")
    ranks = [0] if suite == "trace" else range(world)
    procs = [subprocess.Popen([sys.executable, WORKER, suite, str(r),
                               str(world), store, out], env=_env(tmp),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in ranks]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    bad = [(i, p.returncode) for i, p in enumerate(procs) if p.returncode]
    assert not bad, (bad, logs[bad[0][0]][-3000:])
    with open(out) as f:
        return json.load(f)


def run_reference(tmp, part, timeout=900):
    out = os.path.join(str(tmp), f"reference_{part}.json")
    proc = subprocess.run([sys.executable, WORKER, "reference", part, out],
                          env=_env(tmp), capture_output=True, text=True,
                          timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(out) as f:
        return json.load(f)
