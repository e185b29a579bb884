"""Reduce a `torch.profiler` trace of the window to what the readers need:
the harness's spans on the host, and every device operation with the host
time of the call that launched it.

Device operations are the trace's kernels, memory copies and memsets; a
launch is matched to its operation by the profiler's correlation id. A
span's device time is the union of the intervals of the operations
launched inside it, so overlapping operations count once.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
US = 1e-6


def merged(intervals) -> list[tuple[float, float]]:
    """The union of (start, end) intervals, as disjoint sorted intervals."""
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def union(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    return sum(b - a for a, b in merged(intervals))


class Trace:
    """Spans by name, device operations and their launches, in seconds on
    the profiler's clock."""

    def __init__(self, events: list[dict]):
        self.spans: dict[str, list[tuple[float, float]]] = {}
        launches: dict[int, float] = {}
        ops = []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            t0 = float(e["ts"]) * US
            t1 = t0 + float(e.get("dur", 0)) * US
            corr = (e.get("args") or {}).get("correlation")
            if cat == "user_annotation" and e["name"].startswith("mpbench."):
                self.spans.setdefault(e["name"], []).append((t0, t1))
            elif cat in LAUNCH_CATS and corr is not None:
                launches[int(corr)] = t0
            elif cat in DEVICE_CATS:
                ops.append((e["name"], cat, t0, t1, corr))
        for v in self.spans.values():
            v.sort()
        # (name, cat, start, end, host time of its launch or None)
        self.ops = sorted(
            (n, c, a, b, None if k is None else launches.get(int(k)))
            for n, c, a, b, k in ops)

    @classmethod
    def from_profiler(cls, prof) -> "Trace":
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                return cls(json.load(f)["traceEvents"])

    def window(self) -> tuple[float, float] | None:
        w = self.spans.get("mpbench.window")
        return w[0] if w else None

    def launched_in(self, name: str, kinds=DEVICE_CATS):
        """Per span called `name`: (span, the device operations of `kinds`
        launched inside it)."""
        spans = self.spans.get(name, [])
        starts = [a for a, _ in spans]
        out = [(s, []) for s in spans]
        for op in self.ops:
            t = op[4]
            if t is None or op[1] not in kinds:
                continue
            k = bisect.bisect_right(starts, t) - 1
            if k >= 0 and t <= spans[k][1]:
                out[k][1].append(op)
        return out

    def busy(self, lo: float, hi: float) -> list[tuple[float, float]]:
        """Merged device-busy intervals clipped to [lo, hi]."""
        return merged((max(a, lo), min(b, hi)) for _, _, a, b, _ in self.ops
                      if b > lo and a < hi)

    def open_span(self, t: float) -> str:
        """The innermost harness span open on the host at time t."""
        best, width = "outside the window", float("inf")
        for name, spans in self.spans.items():
            k = bisect.bisect_right([a for a, _ in spans], t) - 1
            if k >= 0 and t <= spans[k][1] and spans[k][1] - spans[k][0] < width:
                best, width = name, spans[k][1] - spans[k][0]
        return best

    def breakdown(self, top: int = 10) -> dict | None:
        """The device operations that took most time in the window, and the
        longest idle gaps by the span the host had open at their middle."""
        w = self.window()
        if w is None or not self.ops:
            return None
        by_name: dict[str, float] = {}
        for n, _, a, b, _ in self.ops:
            if b > w[0] and a < w[1]:
                by_name[n] = by_name.get(n, 0.0) + min(b, w[1]) - max(a, w[0])
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        busy = self.busy(*w)
        edges = [w[0]] + [x for iv in busy for x in iv] + [w[1]]
        gaps = [(edges[k], edges[k + 1]) for k in range(0, len(edges), 2)
                if edges[k + 1] > edges[k]]
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[n[:200], s] for n, s in ops],
                "idle_gaps": [[self.open_span((a + b) / 2), b - a]
                              for a, b in gaps]}
