"""sweep_roofline: the least time the window's sweeps could take on the
card (the larger of the harness's cells at 9 FLOP a cell at the FP32 peak
and its bytes, each input once and each output once, at the HBM rate) over
the device time of every operation launched inside the sweep spans,
whatever its name, in percent. None on a card the peaks table lacks."""

from mpbench import arith
from mpbench.trace import union


def read(obs):
    t = obs.trace
    if t is None or not t.ops:
        return None
    spans = t.launched_in(obs.sweep_span)
    device_s = sum(union((x, y) for _, _, x, y, _ in ops)
                   for _, ops in spans)
    jobs = len(t.spans.get("mpbench.job", []))
    bound = arith.bound_s(jobs * obs.cells_per_job, jobs * obs.bytes_per_job,
                          obs.kind, obs.chips)
    if bound is None or device_s <= 0:
        return None
    return 100.0 * bound / device_s
