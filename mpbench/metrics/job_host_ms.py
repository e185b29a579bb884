"""job_host_ms: a job's host wall time less the device time of what it
launched (the union of those operations' intervals), as a mean over the
window's jobs: the planner, the result and the delivery on the host."""

from mpbench.trace import union


def read(obs):
    t = obs.trace
    if t is None or not t.ops:
        return None
    per = []
    for (a, b), ops in t.launched_in("mpbench.job"):
        per.append((b - a) - union((max(x, a), min(y, b))
                                   for _, _, x, y, _ in ops if y > a))
    return 1e3 * sum(per) / len(per) if per else None
