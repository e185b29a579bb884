"""The expert-parallel / tensor-parallel MoE twin of `tests/test_ep_moe.py`
on 4 gloo ranks (2 data x 2 model): the port's `moe_ffn` under a
`ShardCtx` with dp, tp and ep rules matches both the port's unsharded
path and the reference's (`_moe_local`, and its `moe_ffn` under the same
rules on 4 forced host devices) on the same numpy inputs, within
1e-4 · max(scale, 1). aux: every sharded mode averages each data
shard's aux (the reference's pmean over the batch axes), the same value
in dp, tp and ep; the reference's dp and tp give it too, while its EP
rank counts only its own experts' entries (ROADMAP.md §C (25)). The
same group checks `launch.mesh`'s builders."""

import numpy as np
import pytest

from _torch_mesh_run import run_reference, run_suite


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_moe")
    return run_suite("moe", tmp), run_reference(tmp, "moe")["moe"]


def _bound(ref):
    return 1e-4 * max(float(np.abs(np.asarray(ref)).max()), 1.0)


def test_local_matches_reference(results):
    port, ref = results
    assert np.abs(np.asarray(port["local"])
                  - np.asarray(ref["local"])).max() < _bound(ref["local"])
    assert abs(port["aux_local"] - ref["aux_local"]) < 1e-5


@pytest.mark.parametrize("mode", ["dp", "tp", "ep"])
def test_mode_matches_local_and_reference(results, mode):
    port, ref = results
    got = np.asarray(port[mode])
    assert np.abs(got - np.asarray(port["local"])).max() < _bound(
        port["local"])
    assert np.abs(got - np.asarray(ref["local"])).max() < _bound(
        ref["local"])
    assert np.abs(got - np.asarray(ref[mode])).max() < _bound(ref[mode])
    # each rank holds its data shard's tokens
    assert port[f"local_{mode}"] == [2, 16, 64]


@pytest.mark.parametrize("mode", ["dp", "tp", "ep"])
def test_aux_is_the_mean_over_data_shards(results, mode):
    port, ref = results
    assert abs(port[f"aux_{mode}"] - ref["aux_dp"]) < 1e-5
    assert abs(port[f"aux_{mode}"] - ref["aux_tp"]) < 1e-5


def test_mesh_builders_on_the_group(results):
    """`launch.mesh`: a mesh of another size than the group raises (it
    never builds a smaller mesh), `make_worker_mesh` spans the group,
    `dp_axes` names the data axes."""
    port, _ = results
    m = port["mesh"]
    assert "8" in m["mismatch"] and "4" in m["mismatch"]
    assert m["workers"] == [[4], ["workers"]]
    assert m["dp_axes"] == ["data"] and m["names"] == ["data", "model"]
    assert m["coordinate"] == [0, 0]
