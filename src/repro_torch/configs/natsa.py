"""Paper workloads — port of `repro.configs.natsa`, the same data. NATSA
(ICCD'20) evaluates the matrix profile on series of 2^16..2^19 samples with
windows in the hundreds. On the H100 these are the sizes the card runs
(`chip_smoke.py`'s phases take them by name, `main_paper` all four paper
workloads at full size); the CPU tests run far smaller series. The bench
workloads are the smaller cells the reference sizes for its benchmarks.

Not part of `configs.REGISTRY`, which lists the LM architectures."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class NatsaWorkload:
    name: str
    n: int
    window: int


PAPER_WORKLOADS = (
    NatsaWorkload("seismology-64k", 65536, 256),
    NatsaWorkload("epilepsy-128k", 131072, 128),
    NatsaWorkload("ecg-256k", 262144, 512),
    NatsaWorkload("power-512k", 524288, 1024),
)

BENCH_WORKLOADS = (
    NatsaWorkload("bench-4k", 4096, 64),
    NatsaWorkload("bench-8k", 8192, 128),
    NatsaWorkload("bench-16k", 16384, 128),
)
