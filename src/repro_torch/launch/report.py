"""Render the dry-run's tables from artifacts/dryrun_torch — port of
`repro.launch.report`.

Usage: PYTHONPATH=src python -m repro_torch.launch.report [--artifacts DIR]

The memory column reads against the H100's 80 GB (the reference's 16 GB
of a v5e); the roofline terms are the card's (`launch.roofline`).
"""

from __future__ import annotations

import argparse
import glob
import json
import os

SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
H100_HBM_GB = 80.0


def load(outdir):
    recs = {}
    for f in glob.glob(os.path.join(outdir, "*.json")):
        with open(f) as fh:
            r = json.load(fh)
        if r.get("layout", "tp") != "tp":
            continue
        recs[(r["arch"], r["shape"], r["mesh"])] = r
    return recs


def fmt_mem(r):
    m = r.get("memory", {})
    tot = (m.get("argument_gb", 0) + m.get("temp_gb", 0)
           + m.get("output_gb", 0) - m.get("alias_gb", 0))
    return m.get("temp_gb", 0), tot


def advice(r, cfgname, shape):
    b = r["roofline"]["bottleneck"]
    if b == "collective":
        return ("TP all-reduce wire dominates -> more DP/less TP in the mesh, "
                "bf16 collectives, reduce-scatter+all-gather (SP) norms")
    if b == "memory":
        if "decode" in shape or "long" in shape:
            return ("weight/KV streaming bound -> larger decode batch, "
                    "quantized KV, MLA-style latent cache")
        return ("HBM-stream bound -> fuse/eliminate intermediate writes, "
                "larger per-chip batch")
    return ("compute-bound (healthy) -> raise per-chip batch or "
            "tensor-core-align tiles")


def _order(key):
    arch, shape, mesh = key
    return (arch, SHAPE_ORDER.index(shape) if shape in SHAPE_ORDER else 9,
            mesh)


def dryrun_table(recs):
    lines = [
        "| arch | shape | mesh | status | temp GB/dev | collectives (AR/AG/RS/A2A/CP) | build+trace s |",
        "|---|---|---|---|---|---|---|",
    ]
    for key in sorted(recs, key=_order):
        arch, shape, mesh = key
        r = recs[key]
        if r.get("skipped"):
            lines.append(f"| {arch} | {shape} | {mesh} | SKIP "
                         f"({r['reason'][:40]}…) | — | — | — |")
            continue
        if not r.get("ok"):
            lines.append(f"| {arch} | {shape} | {mesh} | FAIL "
                         f"({r.get('error', '')[:60]}) | — | — | — |")
            continue
        temp, _ = fmt_mem(r)
        c = r.get("collectives_raw", {}).get("counts", {})
        cc = "/".join(str(c.get(k, 0)) for k in
                      ("all-reduce", "all-gather", "reduce-scatter",
                       "all-to-all", "collective-permute"))
        t = r.get("timings", {})
        fits = ("ok" if temp < H100_HBM_GB
                else f"ok (temp>{H100_HBM_GB:.0f}G)")
        lines.append(
            f"| {arch} | {shape} | {mesh} | {fits} | {temp:.1f} | {cc} | "
            f"{t.get('lower_s', 0)+t.get('compile_s', 0):.1f} |")
    return "\n".join(lines)


def roofline_table(recs):
    lines = [
        "| arch | shape | t_compute | t_memory | t_collective | bottleneck | MODEL_FLOPs/traced | MFU bound | what moves the dominant term |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for key in sorted(recs, key=_order):
        arch, shape, mesh = key
        if mesh != "single":
            continue
        r = recs[key]
        if r.get("skipped") or "roofline" not in r:
            continue
        rf = r["roofline"]
        lines.append(
            f"| {arch} | {shape} | {rf['t_compute_s']*1e3:.2f} ms | "
            f"{rf['t_memory_s']*1e3:.2f} ms | {rf['t_collective_s']*1e3:.2f} ms | "
            f"**{rf['bottleneck']}** | {rf['useful_ratio']:.2f} | "
            f"{rf['mfu_bound']*100:.1f}% | {advice(r, arch, shape)} |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--artifacts", default="artifacts/dryrun_torch")
    args = ap.parse_args(argv)
    recs = load(args.artifacts)
    n_ok = sum(1 for r in recs.values() if r.get("ok"))
    n_skip = sum(1 for r in recs.values() if r.get("skipped"))
    print(f"<!-- {n_ok} ok, {n_skip} skipped of {len(recs)} cells -->\n")
    print("### Dry-run table\n")
    print(dryrun_table(recs))
    print("\n### Roofline table (single-pod, per card, per step)\n")
    print(roofline_table(recs))


if __name__ == "__main__":
    main()
