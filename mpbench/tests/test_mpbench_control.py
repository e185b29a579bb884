"""The controls come out not correct under each cell's limits: the plain
reference in the program's place computed from bfloat16 windows, and the
program's own bfloat16-stream path (the step that would tempt a later
change), at a size the CPU holds. The program itself passes them. A cell on several cards shares its
configuration's limits and controls with the one-card cells; its own run
passes them in `test_mpbench_run.py`."""

import tempfile

import pytest

import mpbench_small
from mpbench import check, jobs, registry


def _judge(cfg, answer, data):
    kind = registry.kind(cfg["kind"])
    ref = registry.reference(cfg["reference"])
    vals = kind.readings(data, cfg, answer, ref, "cpu")
    return check.judge(vals, cfg["limits"], kind.EXACT)


def _program(cfg, traffic, data, **kw):
    with tempfile.TemporaryDirectory() as tmp:
        job = jobs.build(cfg, traffic, data, "cpu", ckpt_dir=tmp, **kw)
        return job.run()


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 9, 2 ** 40])
@pytest.mark.parametrize("cell_name", [
    c for c in mpbench_small.cells() if mpbench_small.small(c)[1]["chips"] == 1])
def test_controls_fail_program_passes(cell_name, seed):
    _, _, cfg, traffic = mpbench_small.small(cell_name)
    kind = registry.kind(cfg["kind"])
    data = kind.inputs(cfg, seed)
    ok, _ = _judge(cfg, _program(cfg, traffic, data), data)
    assert ok
    ref = registry.reference(cfg["reference"])
    control = kind.control(data, cfg, ref, "cpu")
    ok, _ = _judge(cfg, control, data)
    assert not ok
    if traffic["job"] == "oneshot":
        answer = _program(cfg, traffic, data, precision="bf16")
        ok, _ = _judge(cfg, answer, data)
        assert not ok
