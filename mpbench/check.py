"""The comparison that decides `correct`: the numbers a configuration's
kind reads from the answer a job delivered (`kinds/<kind>.py`), and the
harness's own, each held to its limit.

The harness's numbers (exact: 0):

  * `jobs_differing`: jobs of the window whose delivered answer is not bit
    for bit the first job's; the last job's is the one the kind checks;
  * `jobs_unfinished`: jobs that ended short of the whole profile.
"""

from __future__ import annotations

EXACT = ("jobs_differing", "jobs_unfinished")


def judge(values: dict, limits: dict, exact=()) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): the numbers named in `exact`
    or `EXACT` must be 0, the others at most their limit in `limits`."""
    exact = set(exact) | set(EXACT)
    out = {}
    ok = True
    for name, v in values.items():
        lim = 0 if name in exact else limits.get(name)
        out[name] = {"value": v, "limit": lim}
        ok = ok and lim is not None and v <= lim
    return ok, out
