"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each `csrc/<name>.cu` becomes its own shared library with a plain C
interface, built at first use into `build/kernels/` at the root of the
checkout and keyed by a hash of the source and the flags, so an edited
source rebuilds and an unchanged one is loaded as is. nvcc's output
(`-Xptxas -v`: registers, shared memory, spills) is kept beside the
library. Any build or load failure raises with nvcc's output; nothing
falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: dict[str, ctypes.CDLL] = {}
# per source loaded in this process: build seconds (0 when the library was
# already built), whether it was, and nvcc's output
BUILD_LOGS: dict[str, dict] = {}


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin and PATH): the CUDA kernels "
                       "cannot be built")


def _target(name: str) -> pathlib.Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{key}.so"


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed. The
    caller sets `argtypes`/`restype` of its entry points."""
    lib = _LOADED.get(name)
    if lib is not None:
        return lib
    target = _target(name)
    log_path = target.with_suffix(".log")
    t0 = time.perf_counter()
    cached = target.exists()
    if not cached:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(
            [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
             str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                               f"(exit {proc.returncode}):\n{proc.stdout}")
        log_path.write_text(proc.stdout)
        os.replace(tmp, target)   # atomic: a concurrent loader sees all or none
    try:
        lib = ctypes.CDLL(str(target))
    except OSError as e:
        raise RuntimeError(f"cannot load the built csrc/{name}.cu: {e}") from e
    BUILD_LOGS[name] = {
        "seconds": 0.0 if cached else time.perf_counter() - t0,
        "cached": cached,
        "log": log_path.read_text() if log_path.exists() else ""}
    _LOADED[name] = lib
    return lib
