"""round_device_ms: the device time of each round, the union of the
intervals of every operation launched inside its span, as a mean."""

from mpbench.trace import union


def read(obs):
    t = obs.trace
    if t is None or not t.ops:
        return None
    per = [union((x, y) for _, _, x, y, _ in ops)
           for _, ops in t.launched_in("mpbench.round")]
    return 1e3 * sum(per) / len(per) if per else None
