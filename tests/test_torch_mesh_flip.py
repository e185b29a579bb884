"""The SP decode flip on a real 4-rank gloo group (2 data x 2 model): a
decode of global batch 1, below the 2 data ranks, replicates the batch
and splits every K/V (and MLA latent) cache on its sequence over "data"
(`launch.sharding.make_rules`, as the reference's rule table). Each rank
holds half the slots, the ring buffer's slot is written by the rank that
holds it, and the ranks' partial softmaxes merge by their log-sum-exp
(`models.parallel.softmax_merge`).

Every case (dense GQA, one KV head so that the cache splits on the head
dim too, the jamba hybrid, MLA, whisper's self cache beside its whole
cross cache, RWKV6 with no sequence leaf) runs a 16-token prompt and 6
teacher-forced decode steps with the flip's ctx against ctx=None on the
same weights: the prefill's last-position logits and every cache leaf
gathered whole, each step's logits and the cache after them, within the
dense bound 1e-4 · (1 + max|ref|). The wrap case decodes into 20 slots,
so its writes cross from rank 1's slots into rank 0's. Two planted faults
of the merge (no rescale by the global max; each rank's own denominator)
must fail the bound. llama3-8b (with its wrap case: ctx=None's ring
write is the port's own code) and jamba also run on the reference's
weights against the reference's own flipped decode on 4 forced host
devices (its `flip` part, run first: it writes the weights). The
dry-run records a flipped decode cell at smoke size on a fake 2 x 2
group."""

import numpy as np
import pytest

from _torch_mesh_run import run_reference, run_suite
from _torch_mesh_worker import (
    FLIP_CASES, FLIP_FAULTS, FLIP_REF_CASES, smoke)

BOUND = 1e-4         # of 1 + max|ref|, the dense bound of the LM tests


@pytest.fixture(scope="module")
def flip(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_flip")
    ref = run_reference(tmp, "flip")
    return run_suite("flip", tmp), ref


@pytest.fixture(scope="module")
def dry(tmp_path_factory):
    return run_suite("flip_dryrun", tmp_path_factory.mktemp("flip_dryrun"))


@pytest.mark.parametrize("case", FLIP_CASES)
def test_flip_matches_unsharded(flip, case):
    r = flip[0][case]
    assert r["rules"] == {"batch": None, "kv_seq": "data"}
    for key in ("prefill", "prefill_cache", "decode", "decode_cache"):
        assert r[key] < BOUND, (key, r[key])
    arch = case.partition("|")[0]
    cfg = smoke(arch)
    seq_layers = [i for i in range(cfg.n_layers)
                  if cfg.layer_kind(i).mixer in ("attn", "mla")]
    keys = ("ckv", "kr") if cfg.kv_lora_rank else ("k", "v")
    # the flip splits exactly the sequence leaves (none for RWKV6)
    assert r["split_leaves"] == sorted(f"{i}.{k}" for i in seq_layers
                                       for k in keys)


@pytest.mark.parametrize("fault", FLIP_FAULTS)
def test_planted_merge_fault_fails_the_bound(flip, fault):
    r = flip[0]["llama3-8b|wrap"][f"fault_{fault}"]
    assert r["prefill"] < BOUND          # the prefill merges nothing
    assert r["decode"] > BOUND
    assert r["decode_cache"] > BOUND


@pytest.mark.parametrize("case", FLIP_REF_CASES)
def test_flip_matches_reference_flip(flip, case):
    port, ref = flip
    assert (ref[case]["batch"], ref[case]["kv_seq"]) == (None, "data")
    for key in ("prefill", "decode"):
        got = np.asarray(port[f"ref|{case}"][key])
        want = np.asarray(ref[case][key])
        assert got.shape == want.shape
        assert np.abs(got - want).max() < BOUND * (1 + np.abs(want).max())


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "llama3-8b"])
def test_flip_dryrun_cell_records_ok(dry, arch):
    rec = dry[arch]
    assert rec["ok"], rec["error"]
    cfg = smoke(arch)
    attn = sum(cfg.layer_kind(i).mixer == "attn" for i in range(cfg.n_layers))
    counts = rec["collectives_raw"]["counts"]
    assert set(counts) == {"all-reduce"}
    # each attention layer's merge adds three all-reduces over "data" (the
    # maxima, the rescaled sums, P·V) beside the layer's two over "model"
    assert counts["all-reduce"] >= 1 + cfg.n_layers * 2 + 3 * attn
    if arch == "llama3-8b":
        assert counts["all-reduce"] == 1 + cfg.n_layers * (2 + 3)
