"""AB-join quickstart on the PyTorch/CUDA port: query a reference corpus,
batch a fleet of series — `examples/ab_query.py`'s scenario through
`repro_torch`.

Three serving-shaped workloads on synthetic telemetry, all through the
`ProfileResult` API:

  1. `ab_join`     — which part of the reference corpus does each piece of
                     the query stream resemble most? (cross-series join,
                     no exclusion zone; `return_b=True` rides B's profile
                     and `k=3` exact top-k neighbor sets on the same sweep,
                     on the band engine); `natsa_ab_join` answers the same
                     join with the NATSA CUDA kernel
  2. `StreamingProfile.query` — same question against an append-only
                     reference that keeps growing between queries (one
                     NATSA launch a query)
  3. `batch_profile` — self-join profiles for a whole fleet of series in
                     ONE batched call

    PYTHONPATH=src python examples/ab_query_torch.py               # the card
    PYTHONPATH=src python examples/ab_query_torch.py --device cpu  # the host
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch.core.matrix_profile import ab_join, batch_profile
from repro_torch.core.streaming import StreamingProfile
from repro_torch.kernels import ops
from repro_torch.utils.device import resolve_device

M = 100


def inputs() -> dict:
    """The reference example's series, made by the same numpy calls in the
    same order from one generator: the corpus (a chirp at 3000), the query
    (the chirp replayed at 400) and the fleet of 6 periodic series (a noise
    burst in series 4)."""
    m = M
    rng = np.random.default_rng(17)

    # reference corpus: smooth background with a distinctive chirp at 3000
    n_ref = 5000
    ref = np.convolve(np.cumsum(rng.normal(size=n_ref + 40)),
                      np.ones(41) / 41, mode="valid")[:n_ref]
    t = np.linspace(0, 1, m)
    chirp = np.sin(2 * np.pi * (3 * t + 5 * t * t)) * 4
    ref[3000:3000 + m] = chirp
    ref = ref.astype(np.float32)

    # query stream: mostly novel, but re-plays the chirp at offset 400
    n_q = 900
    query = np.convolve(np.cumsum(rng.normal(size=n_q + 40)),
                        np.ones(41) / 41, mode="valid")[:n_q]
    query[400:400 + m] = chirp + 0.05 * rng.normal(size=m)
    query = query.astype(np.float32)

    # fleet batching: 6 periodic series, one with a shape anomaly
    tt = np.arange(1200)
    fleet = np.stack([
        np.sin(2 * np.pi * tt / 60 + rng.uniform(0, 6))
        + 0.05 * rng.normal(size=1200)
        for _ in range(6)
    ]).astype(np.float32)
    fleet[4, 600:632] = 0.5 * rng.normal(size=32)   # noise burst in series 4
    return {"ref": ref, "query": query, "fleet": fleet}


def main(device=None) -> dict:
    """Run the scenario on `device` (None: the card); returns what it
    found: the best query window and its corpus match (A side and B side),
    the top-3 matches, both streaming queries' best match, the flagged
    fleet series, and the profiles behind them."""
    m = M
    data = inputs()
    ref, query, fleet = data["ref"], data["query"], data["fleet"]
    dev = resolve_device(device)
    print(f"reference n={len(ref)}, query n={len(query)}, window m={m}")

    # 1. AB join via the band engine — ONE sweep yields both directions
    #    plus exact top-3 neighbor sets per query window
    res = ab_join(query, ref, m, return_b=True, k=3, device=dev)
    dist, idx = res.p, res.i
    best_q = int(torch.argmin(dist))
    print(f"[ab_join] best query window starts at {best_q} "
          f"(chirp planted at 400), matches reference position "
          f"{int(idx[best_q])} (planted at 3000), "
          f"dist={float(dist[best_q]):.3f}")
    assert abs(best_q - 400) <= 3 and abs(int(idx[best_q]) - 3000) <= 3
    print(f"[ab_join k=3] its top-3 reference matches: "
          f"{res.topk_i[best_q].tolist()} at distances "
          f"{np.round(res.topk_p[best_q].cpu().numpy(), 3).tolist()}")

    # the SAME sweep also harvested the reference's profile against the
    # query (the column side of each band tile) — no second join needed
    db = res.b_p
    best_r = int(torch.argmin(db))
    print(f"[ab_join .b_p] best reference window {best_r} "
          f"(chirp planted at 3000) matches query position "
          f"{int(res.b_i[best_r])}, dist={float(db[best_r]):.3f} — "
          f"B-side profile for free from the one-pass engine")
    assert abs(best_r - 3000) <= 3

    # same join through the NATSA kernel (its plain version on the host)
    kres = ops.natsa_ab_join(query, ref, m, device=dev)
    label = ("NATSA CUDA kernel" if dev.type == "cuda"
             else "NATSA kernel's plain version, CPU")
    err = (kres.p - dist).abs()
    err = float(err[torch.isfinite(err)].max())
    print(f"[{label}] max |Δ| vs engine: {err:.2e}")

    # 2. streaming corpus + query scoring
    sp = StreamingProfile(m, exclusion=m // 4, device=dev)
    sp.append(ref[:4000])
    q1 = sp.query(query)
    sp.append(ref[4000:])            # corpus grows, queries re-scored
    q2 = sp.query(query)
    d1, d2 = q1.p, q2.p
    # a larger corpus minimizes over a superset, so scores only improve —
    # up to f32 sweep jitter: the grown corpus re-centers its streams
    # (the host prep shifts by the global mean), so re-scored prefix
    # distances wobble at f32 scale
    best2 = int(torch.argmin(d2))
    improves = bool((d2 <= d1 + 2e-3).all())
    print(f"[streaming.query] best match {float(d2.min()):.3f} at query "
          f"{best2} -> ref {int(q2.i[best2])}; "
          f"growing the corpus only improves: {improves}")
    assert improves

    # 3. fleet batching: 6 periodic series, one with a shape anomaly
    bres = batch_profile(fleet, 32, device=dev)
    discord_scores = bres.p.max(dim=1).values
    worst = int(torch.argmax(discord_scores))
    print(f"[batch_profile] fleet discord scores: "
          f"{np.round(discord_scores.cpu().numpy(), 2)} -> series {worst} "
          f"flagged (anomaly planted in series 4)")
    assert worst == 4
    print("OK — AB query, streaming query, and fleet batching all recovered "
          "the planted structure.")
    best1 = int(torch.argmin(d1))
    return {"best_q": best_q, "match": int(idx[best_q]),
            "topk": res.topk_i[best_q].tolist(), "best_r": best_r,
            "b_match": int(res.b_i[best_r]), "kernel_vs_engine": err,
            "stream_best": [(best1, int(q1.i[best1])),
                            (best2, int(q2.i[best2]))],
            "flagged": worst,
            "profiles": {"p": dist.cpu(), "b_p": db.cpu(),
                         "topk_p": res.topk_p.cpu(), "kernel_p": kres.p.cpu(),
                         "q1": d1.cpu(), "q2": d2.cpu(), "batch": bres.p.cpu()}}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    main(ap.parse_args().device)
