"""The LM steps with a `ShardCtx` against ctx=None, on a real 4-rank gloo
group (2 data x 2 model), for every family under `tp` (dense GQA, MoE,
MLA with and without q-LoRA, RWKV6, Mamba/jamba, whisper's encoder and
cross attention, M-RoPE), plus `ep` for olmoe-1b-7b, `sp` for llama3-8b,
llama3-8b with one KV head, whose cache splits on the head dim (the
partial-logits decode), rwkv6-3b and whisper with one head (a head split
over the model axis, over a cache split on the head dim), remat, and
three heads on the 2-way model axis, which cuts a head (`h3`: llama3-8b
under tp and sp, whisper, qwen2-vl-2b, rwkv6-3b at width 48, MLA with
and without q-LoRA). Train: one step against ctx=None over 2
microbatches, one per data shard (a data-sharded step averages the
shards' losses and gradients; an MoE's aux is per shard, as the
reference's pmean): loss, grad norm, AdamW's m, and every parameter's
update, at one warmup step so that the step is the full lr.
Prefill: last-position logits and the cache. Decode: 6 teacher-forced
steps' logits. All within the dense bounds of the existing LM tests,
1e-4 · (1 + max|ref|)."""

import pytest

from _torch_mesh_run import run_suite
from _torch_mesh_worker import STEP_CASES

CASES = [f"{a}|{l}" for a, l in STEP_CASES]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_suite("steps", tmp_path_factory.mktemp("mesh_steps"))


@pytest.mark.parametrize("case", CASES)
def test_train_step_matches_unsharded(results, case):
    r = results[case]
    (l0, l1), (g0, g1) = r["loss"], r["grad_norm"]
    assert abs(l1 - l0) < 1e-4 * (1 + abs(l0))
    assert abs(g1 - g0) < 1e-4 * (1 + abs(g0))
    # the update reached the sharded leaves: one step at the full lr
    # moves each weight by ~lr; where AdamW's step is well conditioned it
    # is ctx=None's within 1% of the largest step, and nowhere off by a
    # tenth of it
    step = r["param_step"]
    assert step > 1e-4
    assert r["update_err"] < 1e-2 * step
    assert r["ill_conditioned"] < 0.05
    assert r["param_err"] < 0.1 * step
    assert r["m_err"] < 1e-4


@pytest.mark.parametrize("case", CASES)
def test_prefill_and_decode_match_unsharded(results, case):
    r = results[case]
    assert r["prefill"] < 1e-4 * (1 + r["scale"])
    assert r["prefill_cache"] < 1e-4 * (1 + r["scale"]) * 10
    assert r["decode"] < 1e-4 * (1 + r["decode_scale"])
