"""program_idle_pct: the share of the traced window's wall in which no
device operation runs while a span of the program (`repro_torch.*`) is
open on the host, in percent: the part of `device_idle_pct` that the
program's own steps hold; the rest of it is the harness's. None where the
trace holds no span of the program."""

from mpbench import program_spans
from mpbench.trace import merged

PREFIX = "repro_torch."


def overlap(xs, ys) -> float:
    """Length of the intersection of two lists of disjoint sorted
    intervals."""
    out, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        lo, hi = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        out += max(hi - lo, 0.0)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def read(obs):
    t = program_spans.of(obs)
    w = None if t is None else t.window()
    if w is None or not t.ops:
        return None
    spans = merged((max(a, w[0]), min(b, w[1]))
                   for name, v in t.spans.items() if name.startswith(PREFIX)
                   for a, b in v if b > w[0] and a < w[1])
    if not spans:
        return None
    idle = sum(b - a for a, b in spans) - overlap(spans, t.busy(*w))
    return 100.0 * idle / (w[1] - w[0])
