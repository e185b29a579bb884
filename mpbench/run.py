"""Run one cell of the benchmark on the card and print its result line.

    python3 mpbench/run.py --workload ecg-256k.oneshot --seed 7 \
        --seconds 10 --trace 0

Run from the root of a checkout that holds `BENCHMARK.json`, `mpbench/`
and the program under `src/repro_torch`. With `--trace 0` the line carries
the cell's end-to-end metrics, with `--trace 1` its per-layer metrics read
from a profiler trace of the window. The compared numbers and their limits
are the last lines on standard error and the last key of the line.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
BUILD = ROOT / "build"
# every build and kernel cache at a fixed place inside the checkout
os.environ["TRITON_CACHE_DIR"] = str(BUILD / "triton")
# one process, few threads: no BLAS or OpenMP pool beside the main thread
for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[var] = "1"
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


if __name__ == "__main__":
    args = parse()
    from repro_torch.kernels import _build  # noqa: E402

    _build.BUILD_DIR = BUILD / "kernels"
    from mpbench import harness  # noqa: E402

    sys.exit(harness.main(args, T_START))
