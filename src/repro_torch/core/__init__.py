"""Core of the port: stream prep, planning, results and the entry points."""

from repro_torch.core.matrix_profile import (
    ProfileState, TopKState, ab_join, batch_ab_join, batch_profile,
    default_exclusion, matrix_profile, top_discords, top_motif,
)
from repro_torch.core.plan import SweepPlan, SweepResult, execute, plan_sweep
from repro_torch.core.precision import (
    DEFAULT_PRECISION, PrecisionSpec, as_precision,
)
from repro_torch.core.result import HarvestSpec, ProfileResult, build_result
from repro_torch.core.zstats import (
    CrossStats, ZStats, compute_cross_stats_host, compute_stats,
    compute_stats_host, corr_to_dist, dist_to_corr, self_cross,
)

__all__ = [
    "CrossStats", "DEFAULT_PRECISION", "HarvestSpec", "PrecisionSpec",
    "ProfileResult", "ProfileState", "SweepPlan", "SweepResult", "TopKState",
    "ZStats", "ab_join", "as_precision", "batch_ab_join", "batch_profile",
    "build_result", "compute_cross_stats_host", "compute_stats",
    "compute_stats_host", "corr_to_dist", "default_exclusion",
    "dist_to_corr", "execute", "matrix_profile", "plan_sweep", "self_cross",
    "top_discords", "top_motif",
]
