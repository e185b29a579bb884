#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. device: the card's name, count and power limit (no card -> exit 1);
  2. build: the CUDA source of the NATSA kernel, built with nvcc for
     sm_90a, with ptxas' register / spill lines;
  3. the NATSA kernel against its plain PyTorch version on the same CUDA
     tensors, on small cases (self-join, AB with and without an exclusion
     split, NaN gaps, bf16 streams): within 1e-4 in correlation, indices
     differing only at near-ties;
  4. the main path at full size, self-join: `matrix_profile` on a seeded
     random walk of n=262144, m=512 (the ecg-256k workload) with a planted
     motif pair, checked against an f64 exact profile of 64 sampled rows;
  5. the main path at full size, AB join: `ab_join(a, b, 128,
     return_b=True)` with |a| = 131072 (epilepsy-128k), |b| = 32768;
  6. `{"kernels": [...]}`: each ported kernel with its launches on the main
     path, its error against the plain version and its times beside its
     bound.
The last line is `{"ok": true, "device": {...}}`. Any failed check raises
and the script exits non-zero without it. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

SEED = 20240611
TOL_KERNEL = 1e-4     # kernel vs plain version, correlation (the reference's own kernel standard)
TOL_ORACLE = 1e-3     # full size vs f64 oracle: un-reseeded f32 drift measured ~1.6e-4 at n=262144
FP32_PEAK = 67e12     # H100 SXM, FP32 outside the tensor cores (NVIDIA data sheet)
HBM_RATE = 3.35e12    # H100 SXM HBM3 bytes/s
SELF_N, SELF_M = 262144, 512           # ecg-256k (src/repro/configs/natsa.py:17)
AB_NA, AB_NB, AB_M = 131072, 32768, 128  # epilepsy-128k (configs/natsa.py:16) vs 32768
SAMPLED_ROWS = 64
DEVICE = "cuda"

KERNEL_SOURCE = "src/repro_torch/kernels/csrc/natsa_mp.cu"
KERNEL_REPLACES = "src/repro/kernels/natsa_mp.py:113"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def walk(rng, n):
    return np.cumsum(rng.standard_normal(n))


def plant(ts, src, dst, m, other=None):
    """Copy the window at `src` (of `other`, default `ts`) to `dst` in `ts`,
    shifted to continue the series: a z-normalized exact match."""
    o = ts if other is None else other
    ts[dst:dst + m] = o[src:src + m] - o[src] + ts[dst - 1]
    return ts


def cuda_ms(fn, reps: int) -> float:
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(kern, plain, tol: float = TOL_KERNEL) -> dict:
    """Max |corr| error of both sides and index mismatches; indices may
    differ only where the two correlations are within `tol`."""
    out = {"max_abs_err": 0.0, "idx_mismatch": 0, "tie_violations": 0}
    for (ck, ik), (cp, ip) in (((kern[0], kern[1]), (plain[0], plain[1])),
                               ((kern[2], kern[3]), (plain[2], plain[3]))):
        check(ck.shape == cp.shape, f"shapes {ck.shape} vs {cp.shape}")
        err = (ck - cp).abs()
        mism = ik != ip
        out["max_abs_err"] = max(out["max_abs_err"], float(err.max()))
        out["idx_mismatch"] += int(mism.sum())
        out["tie_violations"] += int((mism & (err >= tol)).sum())
    return out


def _exact_corr(ts_rows, ts_cols, m, i, j):
    """f64 z-normalized correlation of row window i with column window j
    (index tensors on the card), computed directly from the series."""
    import torch

    def unit_windows(ts, at):
        w = torch.from_numpy(ts).to(DEVICE).unfold(0, m, 1)[at.long()]
        w = w - w.mean(dim=1, keepdim=True)
        return w / w.norm(dim=1, keepdim=True)

    return (unit_windows(ts_rows, i) * unit_windows(ts_cols, j)).sum(dim=1)


def compare_full_size(kern, plain, ts_rows, ts_cols, m, jpad) -> dict:
    """`compare` at TOL_ORACLE, plus the near-tie rule on the exact pairs:
    where the two sides pick different valid indices, the f64 correlations
    of the two picked pairs must be within TOL_ORACLE of each other."""
    out = compare(kern, plain, TOL_ORACLE)
    out["exact_pair_violations"] = 0
    for side in (0, 1):
        ik, ip = kern[2 * side + 1], plain[2 * side + 1]
        at = ((ik != ip) & (ik >= 0) & (ip >= 0)).nonzero().flatten()
        if side == 0:      # row r -> column idx
            ek = _exact_corr(ts_rows, ts_cols, m, at, ik[at])
            ep = _exact_corr(ts_rows, ts_cols, m, at, ip[at])
        else:              # column entry c = j + jpad -> row idx
            ek = _exact_corr(ts_rows, ts_cols, m, ik[at], at - jpad)
            ep = _exact_corr(ts_rows, ts_cols, m, ip[at], at - jpad)
        out["exact_pair_violations"] += int(
            ((ek - ep).abs() >= TOL_ORACLE).sum())
    return out


def phase_device() -> tuple[str, str]:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "name": name,
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return name, smi


def phase_build() -> None:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.load("natsa_mp")
    seconds = time.perf_counter() - t0
    info = _build.BUILD_LOGS["natsa_mp"]
    ptxas = [ln.strip() for ln in info["log"].splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    emit({"phase": "build", "source": KERNEL_SOURCE, "seconds": seconds,
          "cached": info["cached"], "ptxas": ptxas})


def _self_case(ts, m, dtype=None):
    from repro_torch.core.matrix_profile import default_exclusion
    from repro_torch.core.zstats import compute_stats_host
    from repro_torch.kernels import DEFAULT_DT, DEFAULT_IT, ops

    excl = default_exclusion(m)
    stats = compute_stats_host(ts, m, out_dtype=dtype, device=DEVICE)
    df, dg, invn, cov0p, n_rows, _, l = ops._pad_streams(
        stats, DEFAULT_IT, DEFAULT_DT, excl)
    rows = n_rows * DEFAULT_IT
    return ((df[:rows], dg[:rows], invn[:rows], df, dg, invn, cov0p),
            dict(k_start=excl, k_end=l, l_i=l, l_j=l, jpad=0))


def _ab_cases(ts_rows, ts_cols, m, exclusion):
    """Kernel inputs of every span of an AB sweep (rows = the first side)."""
    from repro_torch.core.zstats import compute_cross_stats_host
    from repro_torch.kernels import DEFAULT_DT, DEFAULT_IT, ops

    cross = compute_cross_stats_host(ts_rows, ts_cols, m, device=DEVICE)
    cases = []
    for s0, s1 in ops.ab_spans(cross.l_a, cross.l_b, exclusion):
        *args, _, _, jpad = ops._pad_streams_ab(cross, DEFAULT_IT,
                                                DEFAULT_DT, s0, s1)
        cases.append((tuple(args), dict(k_start=s0, k_end=s1, l_i=cross.l_a,
                                        l_j=cross.l_b, jpad=jpad)))
    return cases


def phase_kernel_cases() -> float:
    import torch

    from repro_torch.kernels import natsa_mp

    rng = np.random.default_rng(SEED)
    m = 128
    gaps = walk(rng, 16384)
    for s in (1000, 5000, 5003, 12000):
        gaps[s:s + 7] = np.nan
    cases = [("self_n16384_m128", _self_case(walk(rng, 16384), m))]
    a, b = walk(rng, 16384), walk(rng, 4096)
    # the planner sweeps the short side on rows
    for excl in (0, 32):
        for n, case in enumerate(_ab_cases(b, a, m, excl)):
            cases.append((f"ab_16384x4096_m128_excl{excl}_span{n}", case))
    cases.append(("self_nan_gaps", _self_case(gaps, m)))
    cases.append(("self_bf16", _self_case(walk(rng, 16384), m,
                                          torch.bfloat16)))
    worst = 0.0
    for name, (args, kw) in cases:
        kern = natsa_mp.rowmax_profile_ab(*args, **kw)
        torch.cuda.synchronize()
        plain = natsa_mp.rowmax_profile_ab_plain(*args, **kw)
        res = compare(kern, plain)
        emit({"phase": "kernel_vs_plain", "case": name,
              "dtype": str(args[0].dtype), "rows": args[0].shape[0],
              "diagonals": args[6].shape[0], **res})
        check(res["max_abs_err"] <= TOL_KERNEL,
              f"{name}: kernel vs plain {res['max_abs_err']} > {TOL_KERNEL}")
        check(res["tie_violations"] == 0,
              f"{name}: {res['tie_violations']} index mismatches off ties")
        worst = max(worst, res["max_abs_err"])
    return worst


def _bound(args, kw, cells: float) -> dict:
    """Least time for the call: max(FLOPs / FP32 peak, bytes / HBM rate),
    each input read once and each output written once."""
    from repro_torch.kernels.ops import FLOPS_PER_CELL

    rows, jp, n_diag = args[0].shape[0], args[3].shape[0], args[6].shape[0]
    col_len = max(rows + kw["k_start"] + n_diag + kw["jpad"],
                  kw["l_j"] + kw["jpad"])
    sb = args[0].element_size()
    nbytes = 3 * rows * sb + 3 * jp * sb + 4 * n_diag + (rows + col_len) * 8
    t_ops = cells * FLOPS_PER_CELL / FP32_PEAK
    t_bytes = nbytes / HBM_RATE
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bytes": nbytes, "flops": cells * FLOPS_PER_CELL}


def _time_kernel(args, kw, cells: float, ts_rows, ts_cols, m) -> dict:
    """Kernel ms (CUDA events, after a warm-up), plain ms (one run) and
    the kernel-vs-plain comparison at the main path's shapes."""
    import torch

    from repro_torch.kernels import natsa_mp

    kern = natsa_mp.rowmax_profile_ab(*args, **kw)        # warm-up
    torch.cuda.synchronize()
    ms = cuda_ms(lambda: natsa_mp.rowmax_profile_ab(*args, **kw), 3)
    plain_box = []
    plain_ms = cuda_ms(lambda: plain_box.append(
        natsa_mp.rowmax_profile_ab_plain(*args, **kw)), 1)
    res = compare_full_size(kern, plain_box[0], ts_rows, ts_cols, m,
                            kw["jpad"])
    check(res["max_abs_err"] <= TOL_ORACLE and res["tie_violations"] == 0
          and res["exact_pair_violations"] == 0,
          f"full size kernel vs plain {res}")
    b = _bound(args, kw, cells)
    return {"ms": ms, "plain_ms": plain_ms, **b, "cells": cells,
            "cells_per_s": cells / (ms * 1e-3),
            "share_of_bound": b["bound_ms"] / ms,
            "full_size_vs_plain": res}


def _oracle_rows(prof_p, ts_rows, ts_cols, m, rows, exclusion) -> float:
    """Max correlation error of the profile at `rows` against the f64 exact
    profile of those rows, computed on the card."""
    import torch

    from repro_torch.core import ref
    from repro_torch.core.zstats import dist_to_corr

    dev = torch.device(DEVICE)
    d_ref, _ = ref.profile_rows(torch.from_numpy(ts_rows).to(dev),
                                torch.from_numpy(ts_cols).to(dev), m, rows,
                                exclusion=exclusion)
    got = prof_p[torch.as_tensor(rows, device=dev)].double()
    check(bool(torch.isfinite(got).all()), "sampled profile has non-finite")
    return float((dist_to_corr(got, m) - dist_to_corr(d_ref, m)).abs().max())


def phase_self() -> dict:
    import torch

    from repro_torch.core import matrix_profile
    from repro_torch.core.matrix_profile import default_exclusion
    from repro_torch.core.zstats import compute_stats_host, dist_to_corr
    from repro_torch.kernels import natsa_mp

    rng = np.random.default_rng(SEED + 1)
    n, m = SELF_N, SELF_M
    pa, pb = n // 5, (3 * n) // 5 + 17
    ts = plant(walk(rng, n), pa, pb, m)
    excl = default_exclusion(m)

    natsa_mp.LAUNCHES = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = matrix_profile(ts, m, device=DEVICE)
    p, i = res.p, res.i
    torch.cuda.synchronize()
    e2e = time.perf_counter() - t0
    launches = natsa_mp.LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    check(launches > 0, "self-join main path launched no kernel")
    check(p.shape == (n - m + 1,) and p.dtype == torch.float32
          and i.dtype == torch.int32 and p.device.type == DEVICE,
          "self-join result shape")
    check(bool(torch.isfinite(p).all()), "self-join profile has non-finite")

    ia, ib = int(i[pa]), int(i[pb])
    motif_corr = float(dist_to_corr(p[[pa, pb]].double(), m).min())
    check(ia == pb and ib == pa, f"motif pair ({pa},{pb}) -> ({ia},{ib})")
    check(motif_corr >= 1 - TOL_ORACLE, f"motif corr {motif_corr}")
    rows = np.sort(np.random.default_rng(SEED + 2).choice(
        n - m + 1, SAMPLED_ROWS, replace=False))
    oracle_err = _oracle_rows(p, ts, ts, m, rows, excl)
    check(oracle_err <= TOL_ORACLE, f"self oracle error {oracle_err}")

    t0 = time.perf_counter()
    stats = compute_stats_host(ts, m, device="cpu")
    prep = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats.to(DEVICE)
    torch.cuda.synchronize()
    h2d = time.perf_counter() - t0

    args, kw = _self_case(ts, m)
    l = n - m + 1
    cells = (l - excl) * (l - excl + 1) / 2
    kt = _time_kernel(args, kw, cells, ts, ts, m)
    out = {"phase": "main_self", "n": n, "m": m, "launches": launches,
           "motif": [pa, pb], "motif_corr": motif_corr,
           "oracle_rows": SAMPLED_ROWS, "oracle_max_corr_err": oracle_err,
           "host_prep_s": prep, "h2d_s": h2d, "e2e_s": e2e,
           "peak_device_bytes": peak, **kt}
    emit(out)
    return out


def phase_ab() -> dict:
    import torch

    from repro_torch.core import ab_join
    from repro_torch.core.zstats import compute_cross_stats_host, dist_to_corr
    from repro_torch.kernels import natsa_mp

    rng = np.random.default_rng(SEED + 3)
    m = AB_M
    a, b = walk(rng, AB_NA), walk(rng, AB_NB)
    pa, pb = (2 * AB_NA) // 3, AB_NB // 4
    b = plant(b, pa, pb, m, other=a)

    natsa_mp.LAUNCHES = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = ab_join(a, b, m, return_b=True, device=DEVICE)
    p, i, bp, bi = res.p, res.i, res.b_p, res.b_i
    torch.cuda.synchronize()
    e2e = time.perf_counter() - t0
    launches = natsa_mp.LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    la, lb = AB_NA - m + 1, AB_NB - m + 1
    check(launches > 0, "AB main path launched no kernel")
    check(p.shape == (la,) and bp.shape == (lb,) and p.device.type == DEVICE,
          "AB result shapes")
    check(bool(torch.isfinite(p).all() and torch.isfinite(bp).all()),
          "AB profile has non-finite")
    ia, ib = int(i[pa]), int(bi[pb])
    motif_corr = float(min(dist_to_corr(p[pa].double(), m),
                           dist_to_corr(bp[pb].double(), m)))
    check(ia == pb and ib == pa, f"AB pair ({pa},{pb}) -> ({ia},{ib})")
    check(motif_corr >= 1 - TOL_ORACLE, f"AB motif corr {motif_corr}")
    srng = np.random.default_rng(SEED + 4)
    err_a = _oracle_rows(p, a, b, m, np.sort(srng.choice(
        la, SAMPLED_ROWS, replace=False)), 0)
    err_b = _oracle_rows(bp, b, a, m, np.sort(srng.choice(
        lb, SAMPLED_ROWS, replace=False)), 0)
    check(max(err_a, err_b) <= TOL_ORACLE, f"AB oracle {err_a}, {err_b}")

    t0 = time.perf_counter()
    cross = compute_cross_stats_host(b, a, m, device="cpu")  # swept: b on rows
    prep = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cross.to(DEVICE)
    torch.cuda.synchronize()
    h2d = time.perf_counter() - t0

    (args, kw), = _ab_cases(b, a, m, 0)
    kt = _time_kernel(args, kw, float(la) * lb, b, a, m)
    out = {"phase": "main_ab", "n_a": AB_NA, "n_b": AB_NB, "m": m,
           "launches": launches, "motif": [pa, pb], "motif_corr": motif_corr,
           "oracle_rows": SAMPLED_ROWS, "oracle_max_corr_err_a": err_a,
           "oracle_max_corr_err_b": err_b, "host_prep_s": prep, "h2d_s": h2d,
           "e2e_s": e2e, "peak_device_bytes": peak, **kt}
    emit(out)
    return out


def main() -> None:
    import torch

    name, smi = phase_device()
    phase_build()
    small_err = phase_kernel_cases()
    s = phase_self()
    ab = phase_ab()
    emit({"kernels": [{
        "name": "natsa_mp", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": s["launches"] + ab["launches"],
        "launches_by_path": {"matrix_profile": s["launches"],
                             "ab_join": ab["launches"]},
        "max_abs_err": small_err,
        "ms": s["ms"], "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
        "bound_by": s["bound_by"], "library_ms": None,
        "shape": f"self-join n={SELF_N} m={SELF_M}",
        "ab": {"ms": ab["ms"], "plain_ms": ab["plain_ms"],
               "bound_ms": ab["bound_ms"], "bound_by": ab["bound_by"],
               "shape": f"ab n_a={AB_NA} n_b={AB_NB} m={AB_M}"},
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
