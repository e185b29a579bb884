"""Mixed-precision policy for streamed sweeps — decided at PLAN time.

Port of `repro.core.precision`. `PrecisionSpec` names the three dtype roles
once and `plan_sweep` freezes the choice into the `SweepPlan`:

  * `stream`   — the dtype of the O(l) z-stat streams (`df`/`dg`/`invn`)
    the sweep reads per cell;
  * `accum`    — the dtype covariance updates and harvest reductions
    accumulate in. Never below float32;
  * `seed_dot` — the dtype the diagonal seed covariances (`cov0`/`cov0s`)
    are EMITTED in. Seeds are always computed in float64 on the host.

Names are stored as strings (cheap to hash and compare, and identical to
the reference's, so plans compare field by field); `torch_dtype` maps a
name to the torch dtype. The CUDA kernel backend streams f32/bf16/f16 with
f32 accumulation and rejects `accum="float64"` at plan time.
"""

from __future__ import annotations

import dataclasses

import torch

_STREAM_DTYPES = ("float16", "bfloat16", "float32", "float64")
_ACCUM_DTYPES = ("float32", "float64")

TORCH_DTYPES = {
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float64": torch.float64,
}


def torch_dtype(dtype) -> torch.dtype:
    """A dtype name ("bfloat16"), a torch dtype, or None (float32) -> the
    torch dtype."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return TORCH_DTYPES[str(dtype)]
    except KeyError:
        raise ValueError(f"unknown dtype {dtype!r}; one of "
                         f"{sorted(TORCH_DTYPES)}") from None


@dataclasses.dataclass(frozen=True)
class PrecisionSpec:
    """Frozen (stream, accum, seed_dot) dtype policy for one sweep."""

    stream: str = "float32"
    accum: str = "float32"
    seed_dot: str = "float32"

    def __post_init__(self):
        if self.stream not in _STREAM_DTYPES:
            raise ValueError(f"stream dtype must be one of {_STREAM_DTYPES}, "
                             f"got {self.stream!r}")
        if self.accum not in _ACCUM_DTYPES:
            raise ValueError(f"accum dtype must be one of {_ACCUM_DTYPES}, "
                             f"got {self.accum!r}")
        if self.seed_dot not in _STREAM_DTYPES:
            raise ValueError(f"seed_dot dtype must be one of "
                             f"{_STREAM_DTYPES}, got {self.seed_dot!r}")

    @property
    def stream_dtype(self) -> torch.dtype:
        return TORCH_DTYPES[self.stream]

    @property
    def accum_dtype(self) -> torch.dtype:
        return TORCH_DTYPES[self.accum]

    @property
    def seed_dtype(self) -> torch.dtype:
        return TORCH_DTYPES[self.seed_dot]

    @property
    def reduced_stream(self) -> bool:
        """True when streams are below 32-bit."""
        return self.stream_bytes < 4

    @property
    def stream_bytes(self) -> int:
        return self.stream_dtype.itemsize

    @property
    def is_default(self) -> bool:
        return self == PrecisionSpec()


DEFAULT_PRECISION = PrecisionSpec()

PRESETS = {
    "f32": PrecisionSpec(),
    "default": PrecisionSpec(),
    "bf16": PrecisionSpec(stream="bfloat16"),
    "f16": PrecisionSpec(stream="float16"),
    "f64": PrecisionSpec(stream="float64", accum="float64",
                         seed_dot="float64"),
}


def as_precision(spec) -> PrecisionSpec:
    """Coerce None / preset name / PrecisionSpec to a `PrecisionSpec`."""
    if spec is None:
        return DEFAULT_PRECISION
    if isinstance(spec, PrecisionSpec):
        return spec
    if isinstance(spec, str):
        try:
            return PRESETS[spec]
        except KeyError:
            raise ValueError(f"unknown precision preset {spec!r}; choose "
                             f"from {sorted(PRESETS)} or pass a "
                             f"PrecisionSpec") from None
    raise TypeError(f"precision must be None, a preset name, or a "
                    f"PrecisionSpec, got {type(spec).__name__}")


def _eps(name: str) -> float:
    """Unit roundoff of a dtype by name. bfloat16 is tabulated at 2**-8, as
    the reference has it (torch's `finfo.eps` says 2**-7)."""
    if name == "bfloat16":
        return 2.0 ** -8
    return float(torch.finfo(TORCH_DTYPES[name]).eps)


def corr_tolerance(spec: PrecisionSpec, window: int) -> float:
    """Analytic bound on |corr_spec − corr_f64| for a z-normalized sweep:
    ~6 stream roundoffs on a quantity bounded by 1 (Cauchy–Schwarz) plus
    the 2·m·ε_accum summation bound (derivation in the reference's
    `core/precision.py`)."""
    return 6.0 * _eps(spec.stream) + 2.0 * float(window) * _eps(spec.accum)


def profile_tolerance(spec: PrecisionSpec, window: int) -> float:
    """Bound on |p_spec − p_f64| in DISTANCE units: sqrt(2m·corr_tol)."""
    return float((2.0 * window * corr_tolerance(spec, window)) ** 0.5)
