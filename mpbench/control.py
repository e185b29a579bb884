"""Readings that set the limits of the comparison, many seeds in one
process: the program's timed path (the lower reading), and with
`--controls` the controls that must come out not correct (the upper):

  * `reference_bf16`: the plain reference in the program's place,
    computing the whole profile from bfloat16 z-normalized windows (the
    configuration's kind gives it, `kinds/<kind>.py control`);
  * `program_bf16` (one-shot cells): the program's own bfloat16-stream
    path, `plan_sweep(precision="bf16")`, through the same kernel.

    python3 mpbench/control.py --workload ecg-256k.oneshot \
        --seeds 11,12,13 --controls

Prints one JSON line per seed and source with the compared numbers, and
whether the cell's limits pass them. Needs the card, as `run.py` does.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def readings(cell, cfg, traffic, seed, device, controls: bool) -> list:
    import torch

    from mpbench import check, jobs, registry

    ref = registry.reference(cfg["reference"])
    kind = registry.kind(cfg["kind"])
    data = kind.inputs(cfg, seed)
    out = []

    def record(source, answer, seconds):
        vals = kind.readings(data, cfg, answer, ref, device)
        ok, _ = check.judge(vals, cfg["limits"], kind.EXACT)
        out.append({"workload": cell["name"], "seed": seed, "source": source,
                    "seconds": seconds, "passes_limits": ok, **vals})

    def program(**kw):
        import tempfile
        with tempfile.TemporaryDirectory(prefix="mpbench-") as tmp:
            job = jobs.build(cfg, traffic, data, device, ckpt_dir=tmp, **kw)
            job.run()
            t0 = time.perf_counter()
            answer = job.run()
            jobs.sync(device)
            secs = time.perf_counter() - t0
            job.close()
        torch.cuda.empty_cache()
        return answer, secs

    record("program", *program())
    if controls:
        t0 = time.perf_counter()
        answer = kind.control(data, cfg, ref, device)
        record("reference_bf16", answer, time.perf_counter() - t0)
        if traffic["job"] == "oneshot":
            record("program_bf16", *program(precision="bf16"))
    return out


def main() -> int:
    import torch

    from mpbench import registry

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True,
                   help="comma-separated seeds")
    p.add_argument("--controls", action="store_true")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    bench = registry.benchmark()
    cell = registry.cell(bench, args.workload)
    cfg = registry.config(bench, cell["config"])
    traffic = registry.traffic(cell["traffic"])
    for seed in (int(s) for s in args.seeds.split(",")):
        for rec in readings(cell, cfg, traffic, seed, "cuda:0",
                            args.controls):
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
