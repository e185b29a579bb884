"""merge_wait_ms: on several cards, the time a rank waits in a round's
merge for the rank that sweeps longest, as a mean over the rounds.

A rank's reading is, for each round's span (`mpbench.round`), the union
of the intervals of the collective kernels (NCCL's) launched inside the
program's merge spans (`repro_torch.distributed.merge`) in that round. A
collective ends on no rank before the last rank has joined it, so the
last one to arrive reads the exchange alone and every other rank its wait
besides. The cell's number takes, round by round, the mean over the ranks
less the least, then the mean over the rounds. None where the trace holds
no merge span or no collective in one."""

import bisect

from mpbench import program_spans
from mpbench.trace import union

MERGE = "repro_torch.distributed.merge"


def read(obs):
    t = program_spans.of(obs)
    if t is None or not t.ops:
        return None
    rounds = t.spans.get("mpbench.round", [])
    starts = [a for a, _ in rounds]
    per = [[] for _ in rounds]
    for (a, _), ops in t.launched_in(MERGE, kinds=("kernel",)):
        k = bisect.bisect_right(starts, a) - 1
        if k >= 0 and a <= rounds[k][1]:
            per[k].extend((x, y) for n, _, x, y, _ in ops
                          if "nccl" in n.lower())
    per = [union(iv) for iv in per]
    if not any(per):
        return None
    return [1e3 * v for v in per]


def combine(readings):
    """Round by round the mean over the ranks less the least, then the
    mean."""
    per = [sum(r) / len(r) - min(r) for r in zip(*readings)]
    return sum(per) / len(per)
