"""Core of the port: stream prep, planning, results, analytics, the entry
points, partitioning and anytime scheduling."""

from repro_torch.core import analytics
from repro_torch.core.fleet import StreamingFleet
from repro_torch.core.matrix_profile import (
    ProfileState, TopKState, ab_join, batch_ab_join, batch_profile,
    matrix_profile, top_discords, top_motif,
)
from repro_torch.core.plan import (
    SweepPlan, SweepResult, execute, plan_sweep, round_executor,
)
from repro_torch.core.precision import (
    DEFAULT_PRECISION, PrecisionSpec, as_precision,
)
from repro_torch.core.result import HarvestSpec, ProfileResult
from repro_torch.core.zstats import (
    CrossStats, ZStats, compute_cross_stats_host, compute_stats, corr_to_dist,
    self_cross,
)

# The reference's public surface (`repro.core.__all__`), name for name.
__all__ = [
    "CrossStats", "DEFAULT_PRECISION", "HarvestSpec", "PrecisionSpec",
    "ProfileResult", "ProfileState", "StreamingFleet", "SweepPlan",
    "SweepResult", "TopKState",
    "ZStats", "ab_join", "analytics", "as_precision", "batch_ab_join",
    "batch_profile", "compute_cross_stats_host", "compute_stats",
    "corr_to_dist", "execute", "matrix_profile", "plan_sweep",
    "round_executor", "self_cross",
    "top_discords", "top_motif",
]
