"""Profile-service driver: a resident sharded corpus answering AB queries —
port of `repro.launch.serve`.

  PYTHONPATH=src python -m repro_torch.launch.serve --series 16 --n 4000 \
      --window 64 --queries 32 --k 1

Loads `--series` synthetic reference series ONCE into a `ShardedCorpus`
(z-stats + centered windows resident, one shard per visible CUDA card when
there are several), then pushes `--queries` concurrent AB-join queries
through the `ProfileService` front-end and reports throughput. Runs on the
CUDA card unless `--device cpu` is given; `--no-mesh` keeps one device.
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def run_service(n_series: int, n: int, window: int, n_queries: int,
                query_n: int, k: int, *, seed: int = 0,
                use_mesh: bool = True, device=None):
    """Build corpus + service, answer the query load, return a report.
    The series and queries are the reference's draws for the same seed."""
    import torch

    from repro_torch.serve import ProfileService, ShardedCorpus
    from repro_torch.utils.device import resolve_device

    rng = np.random.default_rng(seed)
    series = [rng.normal(size=n) for _ in range(n_series)]
    devices = [resolve_device(device)]
    if (use_mesh and devices[0].type == "cuda"
            and torch.cuda.device_count() > 1):
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]

    t0 = time.monotonic()
    corpus = ShardedCorpus(series, window, devices=devices)
    t_load = time.monotonic() - t0

    svc = ProfileService(corpus, max_pending=max(64, n_queries),
                         max_batch=n_queries)
    queries = [rng.normal(size=query_n) for _ in range(n_queries)]
    svc.serve(queries[:1], k=k)               # warm the plans and kernels

    t0 = time.monotonic()
    answers = svc.serve(queries, k=k)
    t_serve = time.monotonic() - t0
    return {
        "mesh_devices": len(devices),
        "shards": corpus.n_shards,
        "load_s": t_load,
        "serve_s": t_serve,
        "qps": n_queries / t_serve,
        "answers": answers,
        "stats": svc.stats,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--series", type=int, default=16,
                    help="reference series resident in the corpus")
    ap.add_argument("--n", type=int, default=4000,
                    help="points per reference series")
    ap.add_argument("--window", type=int, default=64)
    ap.add_argument("--queries", type=int, default=32,
                    help="concurrent queries pushed through the front-end")
    ap.add_argument("--query-n", type=int, default=512,
                    help="points per query")
    ap.add_argument("--k", type=int, default=1,
                    help="neighbors per profile position")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-mesh", action="store_true",
                    help="one device even when several cards are visible")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the host (default: the CUDA card)")
    args = ap.parse_args(argv)

    rep = run_service(args.series, args.n, args.window, args.queries,
                      args.query_n, args.k, seed=args.seed,
                      use_mesh=not args.no_mesh, device=args.device)
    print(f"[serve] corpus: {args.series} series x {args.n} pts, "
          f"{rep['shards']} shards on {rep['mesh_devices']} device(s), "
          f"resident in {rep['load_s']:.2f}s")
    print(f"[serve] {args.queries} queries (m={args.window}, k={args.k}) in "
          f"{rep['serve_s']:.2f}s -> {rep['qps']:.1f} queries/s")
    a = rep["answers"][0]
    p = np.asarray(a.result.p)
    print(f"[serve] sample answer: status={a.status} coverage={a.coverage:.2f}"
          f" best d={float(np.min(p)):.4f} "
          f"(series {int(a.series[int(np.argmin(p))])})")
    print(f"[serve] queue: {rep['stats']}")
    return rep


if __name__ == "__main__":
    main()
