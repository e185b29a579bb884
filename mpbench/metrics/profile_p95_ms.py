"""profile_p95_ms: the 95th percentile of every job's latency, host clock
from its start until the profile and its indices are in host memory."""

import numpy as np


def read(obs):
    return float(np.percentile(obs.jobs_ms, 95)) if obs.jobs_ms else None
