"""Roofline terms at the NVIDIA H100 SXM's rates — port of
`repro.launch.roofline`.

Three terms per step, all **seconds, per card**:

    compute    = FLOPs / peak_flops        (989 TFLOP/s dense bf16, 67 f32)
    memory     = HBM bytes / HBM_BW        (3.35 TB/s)
    collective = wire bytes / NVLINK_BW    (450 GB/s a direction)

The reference divides by a TPU's rates; these are the card's own, and
`chip_smoke.py` reads its bounds from here, so each rate has one
definition. `RooflineTerms` carries the peak its FLOPs run at
(`peak_flops`, a field the reference lacks): the NATSA sweep is f32
arithmetic on CUDA cores, so `matrix_profile_roofline` divides its FLOPs
by `FP32_PEAK`, where the reference divides every term by one bf16 peak
(ROADMAP.md §C (23)). `Collective` carries the reference's ring-cost
wire formula for the collectives the dry-run traces (`launch.dryrun`);
the HLO collective parser, the XLA lowering smoke and the TPU VMEM model
have no counterpart here (§C (23), (25)).
"""

from __future__ import annotations

import dataclasses
import re

PEAK_FLOPS = 989e12          # H100 SXM, dense bf16 on the tensor cores
FP32_PEAK = 67e12            # H100 SXM, f32 on the CUDA cores
HBM_BW = 3.35e12             # H100 SXM, HBM3 bytes/s
NVLINK_BW = 450e9            # H100 SXM, NVLink bytes/s a direction
L2_BYTES = 50 * 2**20        # H100 SXM, L2 cache

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "tuple": 0, "token": 0, "s4": 1, "u4": 1, "f8e4m3fn": 1, "f8e5m2": 1,
}

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")


def shape_bytes(shape_str: str) -> int:
    """Total bytes of a shape string such as `bf16[2048,4096]` or a tuple
    `(f32[4,4], bf16[2,2])` (the reference's HLO notation)."""
    total = 0
    for dt, dims in _SHAPE_RE.findall(shape_str):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


@dataclasses.dataclass
class Collective:
    """One collective: its kind (all-reduce, all-gather, reduce-scatter,
    all-to-all, collective-permute), result bytes and group size; wire
    bytes by ring cost: all-reduce 2(n-1)/n, all-gather and all-to-all
    (n-1)/n of the result, reduce-scatter (n-1) of its shard, a permute
    its bytes."""
    kind: str
    result_bytes: int
    group: int

    @property
    def wire_bytes(self) -> float:
        n = max(self.group, 2)
        if self.kind == "all-reduce":
            return 2 * self.result_bytes * (n - 1) / n
        if self.kind == "all-gather":
            return self.result_bytes * (n - 1) / n
        if self.kind == "reduce-scatter":
            return self.result_bytes * (n - 1)      # result is the shard
        if self.kind == "all-to-all":
            return self.result_bytes * (n - 1) / n
        return float(self.result_bytes)             # collective-permute


@dataclasses.dataclass
class RooflineTerms:
    flops_per_chip: float
    bytes_per_chip: float
    wire_bytes_per_chip: float
    model_flops_total: float
    n_chips: int
    peak_flops: float = PEAK_FLOPS

    @property
    def t_compute(self) -> float:
        return self.flops_per_chip / self.peak_flops

    @property
    def t_memory(self) -> float:
        return self.bytes_per_chip / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.wire_bytes_per_chip / NVLINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def step_time(self) -> float:
        """No-overlap upper bound estimate: max of the three terms."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs (total): remat and redundancy waste."""
        total = self.flops_per_chip * self.n_chips
        return self.model_flops_total / total if total else 0.0

    @property
    def mfu_bound(self) -> float:
        """Model-FLOPs utilization ceiling implied by the dominant term."""
        t = self.step_time
        if t <= 0:
            return 0.0
        return (self.model_flops_total / self.n_chips / t) / self.peak_flops

    def to_dict(self) -> dict:
        return {
            "flops_per_chip": self.flops_per_chip,
            "bytes_per_chip": self.bytes_per_chip,
            "wire_bytes_per_chip": self.wire_bytes_per_chip,
            "model_flops_total": self.model_flops_total,
            "n_chips": self.n_chips,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_ratio": self.useful_ratio,
            "mfu_bound": self.mfu_bound,
            "peak_flops": self.peak_flops,
        }


def matrix_profile_roofline(l: int, excl: int, it: int | None = None,
                            dt: int | None = None,
                            n_chips: int = 1,
                            stream_bytes: int = 4) -> RooflineTerms:
    """`RooflineTerms` for one NATSA matrix-profile sweep of `l` rows: the
    FLOPs of `ops.FLOPS_PER_CELL` over the admissible triangle at
    `FP32_PEAK`, the HBM bytes of `ops.hbm_bytes_per_cell` at the
    reference's tile geometry (`repro_torch.kernels.DEFAULT_IT/DT` unless
    given), and no wire bytes (a single-card sweep). `stream_bytes` is
    the width of the df/dg/invn streams (4 for f32, 2 for a 16-bit
    `PrecisionSpec`)."""
    from repro_torch.kernels import DEFAULT_DT, DEFAULT_IT, ops

    it = DEFAULT_IT if it is None else it
    dt = DEFAULT_DT if dt is None else dt
    cells = float(ops.sweep_cells(l, excl))
    flops = cells * ops.FLOPS_PER_CELL
    hbm_bytes = cells * ops.hbm_bytes_per_cell(l, excl, it=it, dt=dt,
                                               stream_bytes=stream_bytes)
    return RooflineTerms(flops_per_chip=flops / n_chips,
                         bytes_per_chip=hbm_bytes / n_chips,
                         wire_bytes_per_chip=0.0,
                         model_flops_total=flops,
                         n_chips=n_chips, peak_flops=FP32_PEAK)


def roofline_fraction(l: int, excl: int, elapsed_s: float,
                      it: int | None = None, dt: int | None = None,
                      stream_bytes: int = 4) -> float:
    """Achieved fraction of the HBM roofline for one measured sweep:
    (modelled HBM bytes / `HBM_BW`) / elapsed seconds."""
    if elapsed_s <= 0.0:
        raise ValueError(f"elapsed_s must be positive, got {elapsed_s}")
    terms = matrix_profile_roofline(l, excl, it=it, dt=dt,
                                    stream_bytes=stream_bytes)
    return terms.t_memory / float(elapsed_s)
