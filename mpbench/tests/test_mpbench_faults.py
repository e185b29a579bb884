"""A run with the timed path broken underneath comes out not correct:
a round that returns its state unchanged, a sweep that leaves half of its
diagonals out, one answer altered where the kernel produces it, and on
several cards the exchange between them left out. The run is driven on the
CPU at a small size, past the look for a card; on several cards every rank
runs broken."""

import sys

import pytest
import torch

import mpbench_small
from repro_torch.core import distributed, scheduler
from repro_torch.kernels import natsa_mp

SWEEP = natsa_mp.rowmax_profile_ab


def half_the_diagonals(*args, k_start, k_end, **kw):
    cov0 = args[6]
    end = min(k_end, k_start + cov0.shape[0])
    return SWEEP(*args, k_start=k_start, k_end=k_start + (end - k_start) // 2,
                 **kw)


def one_answer_altered(*args, **kw):
    corr, idx, col_corr, col_idx = SWEEP(*args, **kw)
    corr = corr.clone()
    corr[7] = torch.clamp(corr[7] + 0.05, max=1.0)
    return corr, idx, col_corr, col_idx


def state_unchanged(self, prev, k0s, k1s):
    return prev.profile, prev.profile_b


def exchange_left_out(state, group):
    return state


FAULTS = {
    "half_the_diagonals": (natsa_mp, "rowmax_profile_ab", half_the_diagonals),
    "one_answer_altered": (natsa_mp, "rowmax_profile_ab", one_answer_altered),
    "state_unchanged": (scheduler.AnytimeScheduler, "_run_round",
                        state_unchanged),
    "exchange_left_out": (distributed, "_pmax_group", exchange_left_out),
}

RANK = """import sys
sys.path[:0] = {paths!r}
import test_mpbench_faults as F
owner, name, broken = F.FAULTS[{fault!r}]
setattr(owner, name, broken)
from mpbench import ranks
sys.exit(ranks.rank_main(sys.argv[1]))
"""


def cases():
    """Every fault each cell can have: a one-shot job carries no state from
    step to step."""
    for cell_name in mpbench_small.cells():
        _, cell, _, traffic = mpbench_small.small(cell_name)
        for fault in sorted(FAULTS):
            if fault == "state_unchanged" and traffic["job"] != "anytime":
                continue
            if fault == "exchange_left_out" and cell["chips"] == 1:
                continue
            yield cell_name, fault


@pytest.mark.parametrize("cell_name,fault", list(cases()))
def test_fault_is_not_correct(cell_name, fault, monkeypatch, tmp_path):
    owner, name, broken = FAULTS[fault]
    monkeypatch.setattr(owner, name, broken)
    rank = tmp_path / "rank.py"
    rank.write_text(RANK.format(paths=sys.path[:], fault=fault))
    out, checks = mpbench_small.run(cell_name, 2 ** 31 + 17, 0.1,
                                    rank_cmd=[sys.executable, str(rank)])
    assert out["correct"] is False, checks
