"""merge_collective_ms: the merges of `core/distributed.py` across cards,
the device time of their own exchange in a round, as a mean over the
rounds.

A rank's reading is, for each round's span, the union of the intervals of
the collective kernels (NCCL's) it launched there. A rank that arrives
early waits inside its collective for the others, so its NCCL time holds
that wait; the rank that arrives last waits for nobody. So the cell's
number takes, round by round, the least reading over the ranks: the last
one's, the exchange itself."""

from mpbench.trace import union


def read(obs):
    t = obs.trace
    if t is None or not t.ops:
        return None
    per = [union((x, y) for n, _, x, y, _ in ops if "nccl" in n.lower())
           for _, ops in t.launched_in("mpbench.round", kinds=("kernel",))]
    if not per or not any(per):
        return None
    return [1e3 * v for v in per]


def combine(readings):
    """Round by round the least over the ranks, then the mean."""
    per = [min(r) for r in zip(*readings)]
    return sum(per) / len(per)
