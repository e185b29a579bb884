"""Core of the port: stream prep, planning, results, analytics and the
entry points."""

from repro_torch.core import analytics
from repro_torch.core.fleet import StreamingFleet
from repro_torch.core.matrix_profile import (
    ProfileState, TopKState, ab_join, batch_ab_join, batch_profile,
    matrix_profile, top_discords, top_motif,
)
from repro_torch.core.plan import SweepPlan, SweepResult, execute, plan_sweep
from repro_torch.core.precision import (
    DEFAULT_PRECISION, PrecisionSpec, as_precision,
)
from repro_torch.core.result import HarvestSpec, ProfileResult
from repro_torch.core.zstats import (
    CrossStats, ZStats, compute_cross_stats_host, compute_stats, corr_to_dist,
    self_cross,
)

# The reference's public surface less what is not ported yet:
# `round_executor` (ROADMAP.md §A6).
__all__ = [
    "CrossStats", "DEFAULT_PRECISION", "HarvestSpec", "PrecisionSpec",
    "ProfileResult", "ProfileState", "StreamingFleet", "SweepPlan",
    "SweepResult", "TopKState",
    "ZStats", "ab_join", "analytics", "as_precision", "batch_ab_join",
    "batch_profile", "compute_cross_stats_host", "compute_stats",
    "corr_to_dist", "execute", "matrix_profile", "plan_sweep", "self_cross",
    "top_discords", "top_motif",
]
