"""round_p95_ms: the 95th percentile of every round of every job in the
window, host clock from the round's start to its synchronize."""

import numpy as np


def read(obs):
    return (float(np.percentile(obs.rounds_ms, 95)) if obs.rounds_ms
            else None)
