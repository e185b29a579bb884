"""`repro_torch.configs.natsa`, the paper's workloads, against
`repro.configs.natsa`: the same dataclass fields and the same tuples, in
the same order, name for name and size for size. The registry of LM
architectures does not list the module, in either package."""

import dataclasses

import pytest

from repro.configs import natsa as ref_natsa
from repro_torch.configs import natsa


def test_workload_fields_match_reference():
    assert ([(f.name, f.type) for f in dataclasses.fields(natsa.NatsaWorkload)]
            == [(f.name, f.type)
                for f in dataclasses.fields(ref_natsa.NatsaWorkload)])
    w = natsa.NatsaWorkload("x", 1, 2)
    with pytest.raises(dataclasses.FrozenInstanceError):
        w.n = 3


@pytest.mark.parametrize("table", ["PAPER_WORKLOADS", "BENCH_WORKLOADS"])
def test_workloads_match_reference(table):
    got = getattr(natsa, table)
    want = getattr(ref_natsa, table)
    assert isinstance(got, tuple)
    assert [dataclasses.astuple(w) for w in got] == \
        [dataclasses.astuple(w) for w in want]
    assert all(type(w) is natsa.NatsaWorkload for w in got)


def test_not_in_the_architecture_registry():
    from repro import configs as ref_configs
    from repro_torch import configs

    assert set(configs.REGISTRY) == set(ref_configs.REGISTRY)
    assert natsa not in configs.REGISTRY.values()
    assert not any(n.startswith(("seismology", "epilepsy", "ecg", "power",
                                 "bench")) for n in configs.REGISTRY)
