"""The port's LM substrate (`repro_torch.configs`, `repro_torch.models`,
`repro_torch.utils.flops`) against the reference's (`repro.configs`,
`repro.models`, `repro.utils.flops`), on the CPU, for every family:
dense GQA (llama3-8b, qwen2-7b, qwen2.5-32b), MoE (olmoe-1b-7b), MLA
(minicpm3-4b), MLA with MoE and a dense first layer
(deepseek-v2-lite-16b), RWKV6, Mamba / attention with MoE (jamba), the
encoder-decoder with cross attention (whisper-large-v3, its frames drawn
with numpy) and M-RoPE (qwen2-vl-2b, over (3, B, T) positions whose t and
h streams differ from a strictly rising w stream).

Configs, input specs, parameter and cache specs, parameter counts and
model FLOPs are compared exactly. Logits and caches are compared with the
reference's weights carried across by `models.convert`, within
1e-4 · (1 + max|ref|) in f32 (the smoke configs compute in f32 over bf16
weights; the two frameworks sum in other orders, ~1e-6 observed), at
T = 12 (the reference's unchunked causal branch, 12 % q_chunk != 0) and
T = 16 (its two `q_chunk` = 8 chunks); the MoE aux loss within 1e-6. The
port's full and prefill GQA attention is one flash call over repeated K/V
on every device: the plain version here, the kernel on the card, so these
comparisons cover the route the card runs. MLA is torch ops on every
device. The `gpu`-marked test holds the model's kernel route
against the same model on the plain version, on the card.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import attention as rattention
from repro.models import steps as rsteps
from repro.models import transformer as rtransformer
from repro.models.common import init_params as rinit
from repro.utils import flops as rflops
from repro_torch import configs
from repro_torch.kernels import flash_attn
from repro_torch.models import attention, convert, steps, transformer
from repro_torch.models.common import (
    ParamSpec, count_params, init_params, stack_spec, tree_leaves,
)
from repro_torch.utils import flops

DENSE = ["llama3-8b", "qwen2-7b", "qwen2.5-32b", "olmoe-1b-7b",
         "deepseek-v2-lite-16b", "minicpm3-4b", "rwkv6-3b", "jamba-v0.1-52b",
         "whisper-large-v3", "qwen2-vl-2b"]
SEQ_LENS = [12, 16]


def _tol(ref):
    return 1e-4 * (1.0 + float(np.abs(ref).max()))


def _numpy(tree):
    """A tree of host tensors from `convert` -> numpy leaves, bfloat16 as
    ml_dtypes' (the reference's arrays' dtype)."""
    return jax.tree.map(convert._to_numpy, tree)


def _dtype_name(dt) -> str:
    if isinstance(dt, torch.dtype):
        return str(dt).removeprefix("torch.")
    return np.dtype(dt).name


def _ref_model(arch, seed=7):
    """(reference cfg, its params, the port's cfg, the port's model with
    the reference's weights)."""
    rcfg, cfg = rconfigs.get_smoke(arch), configs.get_smoke(arch)
    params = rinit(jax.random.key(seed), rtransformer.model_spec(rcfg))
    model = transformer.Transformer(cfg, device="cpu")
    model.load_state_dict(convert.params_from_reference(
        jax.tree.map(np.asarray, params)))
    return rcfg, params, cfg, model


def _tokens(cfg, b, t, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, t)).astype(np.int32)


def _mrope_positions(b, t):
    """(3, b, t): a strictly rising w stream, t and h streams apart from it
    (frames of 6 tokens, rows of 2), as an image's patches would have."""
    w = np.arange(t)
    return np.broadcast_to(np.stack([w // 6, (w // 2) % 3, w])[:, None],
                           (3, b, t)).astype(np.int32)


def _extras(cfg, b, t, seed=3):
    """The inputs beside the tokens, as numpy: whisper's frames (scale
    0.02, as the reference's tests draw them) and M-RoPE's positions."""
    out = {}
    if cfg.is_encdec:
        out["frames"] = (np.random.default_rng(seed).standard_normal(
            (b, cfg.encoder_seq, cfg.d_model)) * 0.02).astype(np.float32)
    if cfg.mrope_sections:
        out["positions"] = _mrope_positions(b, t)
    return out


def _jnp(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _torch(d):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in d.items()}


def _ref_layer(tree, cfg, i):
    """(the reference's subtree holding decoder layer i, stacked?): a
    `prefix` entry, or the `period` entry of its position in the period."""
    prefix, period, _ = cfg.layer_groups()
    if i < len(prefix):
        return tree["prefix"][str(i)], False
    return tree["period"][str((i - len(prefix)) % len(period))], True


def _ref_layout(tree) -> dict:
    """The reference's spec tree in the port's layer-by-layer naming:
    path -> (shape, axes, init, scale, dtype name)."""
    out = {}

    def walk(node, path, unstack):
        for key, val in node.items():
            if isinstance(val, dict):
                walk(val, f"{path}{key}.", unstack)
                continue
            shape, axes = val.shape, val.axes
            if unstack:
                shape, axes = shape[1:], axes[1:]
            out[f"{path}{key}"] = (tuple(shape), tuple(axes), val.init,
                                   val.scale, _dtype_name(val.dtype))

    walk({k: tree[k] for k in ("emb", "ln_f", "pos_emb") if k in tree}, "",
         False)
    if "enc" in tree:
        n = next(iter(tree_leaves(tree["enc"]["blk"])))[1].shape[0]
        for i in range(n):
            walk(tree["enc"]["blk"], f"enc.layers.{i}.", True)
        walk(tree["enc"]["ln_f"], "enc.ln_f.", False)
    prefix, period = tree.get("prefix", {}), tree["period"]
    for i in range(len(prefix)):
        walk(prefix[str(i)], f"layers.{i}.", False)
    n = next(iter(tree_leaves(tree["period"])))[1].shape[0]
    for p in range(n):
        for j in range(len(period)):
            walk(period[str(j)],
                 f"layers.{len(prefix) + p * len(period) + j}.", True)
    return out


# ---------------------------------------------------------------------------
# configs


@pytest.mark.parametrize("arch", rconfigs.list_archs())
def test_configs_match_reference(arch):
    assert configs.list_archs() == rconfigs.list_archs()
    for get in ("get_config", "get_smoke"):
        ref, got = getattr(rconfigs, get)(arch), getattr(configs, get)(arch)
        for f in dataclasses.fields(ref):
            a, b = getattr(ref, f.name), getattr(got, f.name)
            if f.name == "dtype":
                assert _dtype_name(b) == _dtype_name(a)
            else:
                assert b == a, (arch, get, f.name)
        assert [dataclasses.astuple(got.layer_kind(i))
                for i in range(got.n_layers)] == [
            dataclasses.astuple(ref.layer_kind(i)) for i in range(ref.n_layers)]
        rp, rq, rn = ref.layer_groups()
        gp, gq, gn = got.layer_groups()
        assert ([dataclasses.astuple(x) for x in gp + gq], gn) == (
            [dataclasses.astuple(x) for x in rp + rq], rn)
        assert (got.padded_vocab, got.is_encdec, got.sub_quadratic) == (
            ref.padded_vocab, ref.is_encdec, ref.sub_quadratic)


@pytest.mark.parametrize("arch", rconfigs.list_archs())
def test_input_specs_match_reference(arch):
    cfg, rcfg = configs.get_config(arch), rconfigs.get_config(arch)
    assert list(configs.SHAPES) == list(rconfigs.SHAPES)
    for name, shape in configs.SHAPES.items():
        assert dataclasses.astuple(shape) == dataclasses.astuple(
            rconfigs.SHAPES[name])
        got = configs.input_specs(cfg, shape)
        ref = rconfigs.input_specs(rcfg, rconfigs.SHAPES[name])
        assert list(got) == list(ref)
        for key, (shp, dt) in got.items():
            assert shp == ref[key].shape, (name, key)
            assert _dtype_name(dt) == _dtype_name(ref[key].dtype), (name, key)


# ---------------------------------------------------------------------------
# specs, counts, FLOPs (no allocation)


@pytest.mark.parametrize("which", ["get_config", "get_smoke"])
@pytest.mark.parametrize("arch", DENSE)
def test_param_spec_matches_reference_leaf_by_leaf(arch, which):
    cfg = getattr(configs, which)(arch)
    rcfg = getattr(rconfigs, which)(arch)
    got = {path: (s.shape, s.axes, s.init, s.scale, _dtype_name(s.dtype))
           for path, s in tree_leaves(transformer.model_spec(cfg))}
    assert got == _ref_layout(rtransformer.model_spec(rcfg))
    # the reference's stacked period is stack_spec of one layer's spec
    ref_period = rtransformer.model_spec(rcfg)["period"]["0"]
    prefix, _, n_periods = cfg.layer_groups()
    stacked = stack_spec(transformer.layer_param_spec(
        cfg, cfg.layer_kind(len(prefix))), n_periods)
    assert sorted((path, s.shape, s.axes)
                  for path, s in tree_leaves(stacked)) == sorted(
        (path, s.shape, s.axes) for path, s in tree_leaves(ref_period))


def test_mask_padded_vocab_and_greedy_match_reference():
    cfg = dataclasses.replace(configs.get_smoke("llama3-8b"), vocab_size=100)
    rcfg = dataclasses.replace(rconfigs.get_smoke("llama3-8b"),
                               vocab_size=100)
    assert cfg.padded_vocab == rcfg.padded_vocab == 128
    lg = np.random.default_rng(0).standard_normal((2, 3, 128)).astype(
        np.float32)
    lg[0, -1, 120] = 50.0                      # a padded column's maximum
    got = steps.mask_padded_vocab(cfg, torch.from_numpy(lg))
    ref = np.asarray(rsteps.mask_padded_vocab(rcfg, jnp.asarray(lg)))
    np.testing.assert_array_equal(got.numpy(), ref)
    nxt = steps.greedy_next(got)
    assert nxt.dtype == torch.int32 and nxt.shape == (2, 1)
    np.testing.assert_array_equal(nxt.numpy(),
                                  np.asarray(rsteps.greedy_next(ref)))


@pytest.mark.parametrize("arch", DENSE)
def test_cache_spec_matches_reference(arch):
    cfg, rcfg = configs.get_config(arch), rconfigs.get_config(arch)
    b, s = 4, 2112
    ref_tree = rtransformer.cache_spec(rcfg, b, s)
    got = transformer.cache_spec(cfg, b, s)
    assert len(got) == cfg.n_layers
    for i, layer in enumerate(got):
        ref, stacked = _ref_layer(ref_tree, cfg, i)
        assert sorted(layer) == sorted(ref)
        for key in layer:
            cut = 1 if stacked else 0
            assert layer[key].shape == ref[key].shape[cut:]
            assert layer[key].axes == ref[key].axes[cut:]
            assert _dtype_name(layer[key].dtype) == _dtype_name(ref[key].dtype)


@pytest.mark.parametrize("arch", DENSE)
def test_param_counts_match_reference(arch):
    cfg, rcfg = configs.get_config(arch), rconfigs.get_config(arch)
    from repro.models.common import count_params as rcount

    assert count_params(transformer.model_spec(cfg)) == rcount(
        rtransformer.model_spec(rcfg))
    assert flops.param_counts(cfg) == rflops.param_counts(rcfg)
    # the figures chip_smoke.py's bounds use
    total = {"llama3-8b": 7_504_924_672, "olmoe-1b-7b": 6_816_073_728,
             "deepseek-v2-lite-16b": 15_496_755_200}
    if arch in total:
        assert flops.param_counts(cfg)["total"] == total[arch]


@pytest.mark.parametrize("arch", DENSE)
def test_model_flops_and_byte_floor_match_reference(arch):
    cfg, rcfg = configs.get_config(arch), rconfigs.get_config(arch)
    shapes = list(configs.SHAPES.values()) + [
        configs.ShapeSpec("prefill_32k_b1", 32768, 1, "prefill"),
        configs.ShapeSpec("decode_2112_b4", 2112, 4, "decode")]
    for shape in shapes:
        rshape = rconfigs.ShapeSpec(*dataclasses.astuple(shape))
        assert flops.model_flops(cfg, shape) == rflops.model_flops(rcfg,
                                                                   rshape)
        for n in (1, 4):
            assert flops.hbm_bytes_floor(cfg, shape, n) == \
                rflops.hbm_bytes_floor(rcfg, rshape, n)


def test_init_params_follows_the_reference_rules():
    spec = {"z": ParamSpec((3, 4), ("a", "b"), init="zeros"),
            "o": ParamSpec((5,), ("a",), init="ones", dtype=torch.float32),
            "c": ParamSpec((2,), ("a",), init="const", scale=0.5),
            "n": ParamSpec((400, 300), ("a", "b"), init="normal", scale=0.02),
            "f": ParamSpec((256, 3, 200), ("a", "b", "c"))}
    gen = torch.Generator("cpu").manual_seed(0)
    p = init_params(gen, spec)
    assert [p[k].dtype for k in spec] == [torch.bfloat16, torch.float32,
                                          torch.bfloat16, torch.bfloat16,
                                          torch.bfloat16]
    assert not p["z"].any() and bool((p["o"] == 1).all())
    assert bool((p["c"] == 0.5).all())
    assert abs(float(p["n"].float().std()) - 0.02) < 0.02 * 0.02
    # fan_in: the second-to-last dim (3 here), as the reference reads it
    assert abs(float(p["f"].float().std()) - 3 ** -0.5) < 0.02 * 3 ** -0.5
    again = init_params(torch.Generator("cpu").manual_seed(0), spec)
    assert all(torch.equal(p[k], again[k]) for k in spec)
    other = init_params(torch.Generator("cpu").manual_seed(1), spec)
    assert not torch.equal(p["n"], other["n"])


def test_model_is_drawn_on_its_device_and_defaults_to_the_card(monkeypatch):
    cfg = configs.get_smoke("llama3-8b")
    gen = torch.Generator("cpu").manual_seed(3)
    model = transformer.Transformer(cfg, device="cpu", generator=gen)
    names = [n for n, _ in model.named_parameters()]
    assert sorted(names) == sorted(
        p for p, _ in tree_leaves(transformer.model_spec(cfg)))
    assert names[:3] == ["emb", "ln_f", "layers.0.ln1"]
    again = transformer.Transformer(
        cfg, device="cpu", generator=torch.Generator("cpu").manual_seed(3))
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                  again.parameters()))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        transformer.Transformer(cfg)


# ---------------------------------------------------------------------------
# values against the reference, weights carried across


@pytest.mark.parametrize("t", SEQ_LENS)
@pytest.mark.parametrize("arch", DENSE)
def test_train_logits_match_reference(arch, t):
    rcfg, params, cfg, model = _ref_model(arch)
    tok = _tokens(cfg, 2, t)
    ex = _extras(cfg, 2, t)
    ref, raux, _ = rtransformer.forward(rcfg, params, jnp.asarray(tok),
                                        mode="train", **_jnp(ex))
    with torch.no_grad():
        got, aux, cache = transformer.forward(cfg, model,
                                              torch.from_numpy(tok),
                                              mode="train", **_torch(ex))
    ref = np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == torch.float32
    assert cache == [] and aux.dtype == torch.float32
    assert abs(float(aux) - float(raux)) <= 1e-6
    assert (float(aux) > 0) == (cfg.n_experts > 0)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=_tol(ref))
    # the loss forward too
    labels = _tokens(cfg, 2, t, seed=2)
    batch = {"tokens": tok, "labels": labels, **ex}
    rloss, rmet = rsteps.make_loss_fn(rcfg, None)(params, _jnp(batch))
    with torch.no_grad():
        loss, met = steps.make_loss_fn(cfg)(model, _torch(batch))
    assert abs(float(loss) - float(rloss)) <= 1e-5 * (1 + abs(float(rloss)))
    assert abs(float(met["ce"]) - float(rmet["ce"])) <= 1e-5 * (
        1 + abs(float(rmet["ce"])))
    assert abs(float(met["aux"]) - float(rmet["aux"])) <= 1e-6


@pytest.mark.parametrize("t", SEQ_LENS)
@pytest.mark.parametrize("arch", DENSE)
def test_prefill_logits_and_cache_match_reference(arch, t):
    rcfg, params, cfg, model = _ref_model(arch)
    tok = _tokens(cfg, 2, t)
    ex = _extras(cfg, 2, t)
    ref_lg, ref_cache = rsteps.make_prefill_step(rcfg, None)(
        params, _jnp({"tokens": tok, **ex}))
    got_lg, got_cache = steps.make_prefill_step(cfg)(
        model, _torch({"tokens": tok, **ex}))
    ref_lg = np.asarray(ref_lg)
    assert got_lg.shape == ref_lg.shape == (2, 1, cfg.padded_vocab)
    np.testing.assert_allclose(got_lg.numpy(), ref_lg, rtol=0,
                               atol=_tol(ref_lg))
    ref_c = jax.tree.map(np.asarray, ref_cache)
    got_c = _numpy(convert.cache_to_reference(got_cache, cfg))
    assert jax.tree.structure(got_c) == jax.tree.structure(ref_c)
    assert len(got_cache) == cfg.n_layers
    for i, layer in enumerate(got_cache):
        spec = transformer.layer_cache_spec(cfg, cfg.layer_kind(i), 2, t)
        assert {k: tuple(v.shape) for k, v in layer.items()} == {
            k: v.shape for k, v in spec.items()}
    for g, r in zip(jax.tree.leaves(got_c), jax.tree.leaves(ref_c)):
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, rtol=0, atol=_tol(r))
    # the full prefill forward (all positions) against the reference's
    ref_all, _, _ = rtransformer.forward(rcfg, params, jnp.asarray(tok),
                                         mode="prefill", **_jnp(ex))
    with torch.no_grad():
        got_all, _, _ = transformer.forward(cfg, model,
                                            torch.from_numpy(tok),
                                            mode="prefill", **_torch(ex))
    ref_all = np.asarray(ref_all)
    np.testing.assert_allclose(got_all.numpy(), ref_all, rtol=0,
                               atol=_tol(ref_all))


@pytest.mark.parametrize("s", SEQ_LENS)
@pytest.mark.parametrize("arch", DENSE)
def test_decode_step_logits_and_cache_match_reference(arch, s):
    """One decode step at cache_len 3 on a seeded cache of s slots (the
    reference's ring-slot write and valid-key mask; the recurrent states
    and token shifts of RWKV6 and Mamba change whole; whisper's cross K/V
    are read, and stay as they were)."""
    rcfg, params, cfg, model = _ref_model(arch)
    rng = np.random.default_rng(5)
    ref_cache = jax.tree.map(
        lambda sp: (rng.standard_normal(sp.shape) * 0.5).astype(np.float32),
        rtransformer.cache_spec(rcfg, 2, s),
        is_leaf=lambda x: hasattr(x, "axes"))
    tok = _tokens(cfg, 2, 1, seed=6)
    port_cache = convert.cache_from_reference(ref_cache)
    ref_lg, ref_new = rsteps.make_decode_step(rcfg, None)(
        params, jax.tree.map(jnp.asarray, ref_cache),
        {"tokens": jnp.asarray(tok), "cache_len": jnp.int32(3)})
    got_lg, got_new = steps.make_decode_step(cfg)(
        model, port_cache, {"tokens": torch.from_numpy(tok), "cache_len": 3})
    ref_lg = np.asarray(ref_lg)
    assert got_lg.shape == ref_lg.shape == (2, 1, cfg.padded_vocab)
    np.testing.assert_allclose(got_lg.numpy(), ref_lg, rtol=0,
                               atol=_tol(ref_lg))
    got_c = _numpy(convert.cache_to_reference(got_new, cfg))
    for g, r in zip(jax.tree.leaves(got_c),
                    jax.tree.leaves(jax.tree.map(np.asarray, ref_new))):
        np.testing.assert_allclose(g, r, rtol=0, atol=_tol(r))
    # in place, and of the sequence leaves only slot 3 changed
    assert all(layer[k] is port_cache[i][k]
               for i, layer in enumerate(got_new) for k in layer)
    for i, (layer, before) in enumerate(zip(
            got_new, convert.cache_from_reference(ref_cache))):
        spec = transformer.layer_cache_spec(cfg, cfg.layer_kind(i), 2, s)
        for key, t in layer.items():
            if "kv_seq" not in spec[key].axes:
                continue
            assert np.array_equal(np.delete(t.numpy(), 3, axis=1),
                                  np.delete(before[key].numpy(), 3, axis=1))


@pytest.mark.parametrize("arch", DENSE)
def test_weights_round_trip_both_ways(arch):
    rcfg, params, cfg, model = _ref_model(arch)
    ref = jax.tree.map(np.asarray, params)
    back = _numpy(convert.params_to_reference(model, cfg))
    assert jax.tree.structure(back) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8))
    # a port-drawn model carried to the reference computes the same logits
    drawn = transformer.Transformer(
        cfg, device="cpu", generator=torch.Generator("cpu").manual_seed(11))
    rparams = jax.tree.map(jnp.asarray,
                           _numpy(convert.params_to_reference(drawn, cfg)))
    tok = _tokens(cfg, 1, 12)
    ex = _extras(cfg, 1, 12)
    ref_lg, _, _ = rtransformer.forward(rcfg, rparams, jnp.asarray(tok),
                                        mode="train", **_jnp(ex))
    with torch.no_grad():
        got, _, _ = drawn(torch.from_numpy(tok), mode="train", **_torch(ex))
    ref_lg = np.asarray(ref_lg)
    np.testing.assert_allclose(got.numpy(), ref_lg, rtol=0,
                               atol=_tol(ref_lg))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_functions_match_reference(dtype):
    """The norms, RoPE (positions up to 32767), dense with bias and both
    FFNs on the same inputs: f32 within 1e-5 · (1 + max|ref|); bf16 within
    one bf16 rounding step of the output's largest value (2^-7 · max)."""
    from repro.models import common as rcommon
    from repro.models import moe as rmoe
    from repro_torch.models import common, moe

    rng = np.random.default_rng(12)
    d, f, hd = 64, 96, 16
    tdt = getattr(torch, dtype)

    def both(shape, scale=1.0):
        a = (rng.standard_normal(shape) * scale).astype(np.float32)
        return (jnp.asarray(a).astype(dtype),
                torch.from_numpy(a).to(tdt))

    def close(got, ref):
        ref = np.asarray(ref, np.float32)
        tol = (1e-5 * (1 + np.abs(ref).max()) if dtype == "float32"
               else 2 ** -7 * np.abs(ref).max())
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=0, atol=tol)

    x_r, x_t = both((2, 5, d))
    w = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    close(common.rmsnorm(x_t, torch.from_numpy(w)),
          rcommon.rmsnorm(x_r, jnp.asarray(w)))
    ln = {"scale": w, "bias": (0.1 * rng.standard_normal(d)).astype(np.float32)}
    close(common.layernorm(x_t, {k: torch.from_numpy(v) for k, v in ln.items()}),
          rcommon.layernorm(x_r, {k: jnp.asarray(v) for k, v in ln.items()}))
    h_r, h_t = both((2, 5, 3, hd))
    pos = rng.integers(0, 32768, (2, 5)).astype(np.int32)
    close(common.apply_rope(h_t, torch.from_numpy(pos), 5e5),
          rcommon.apply_rope(h_r, jnp.asarray(pos), 5e5))
    p_r = {"w": both((d, f), 0.1)[0], "b": jnp.asarray(
        rng.standard_normal(f).astype(np.float32))}
    p_t = {"w": torch.from_numpy(np.array(p_r["w"], np.float32)).to(tdt),
           "b": torch.from_numpy(np.array(p_r["b"]))}
    close(common.dense(x_t, p_t), rcommon.dense(x_r, p_r))
    for name, spec in (("swiglu", rmoe.swiglu_spec(d, f)),
                       ("gelu_mlp", rmoe.gelu_mlp_spec(d, f))):
        pr = {k: jnp.asarray((rng.standard_normal(s.shape) * 0.1)
                             .astype(np.float32)).astype(s.dtype)
              for k, s in spec.items()}
        pt = {k: convert._to_torch(np.asarray(v)) for k, v in pr.items()}
        close(getattr(moe, name)(pt, x_t), getattr(rmoe, name)(pr, x_r))


# ---------------------------------------------------------------------------
# the card's attention route, on the CPU


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h,kv", [(4, 2), (4, 1), (4, 4)])
def test_flash_over_repeated_kv_equals_grouped_attention(h, kv, causal):
    """The port's prefill route (the flash function over K/V repeated to H
    heads, here its plain version) equals the grouped einsum decode runs,
    and the reference's `_grouped_attn`, within 2e-6 (f32)."""
    rng = np.random.default_rng(h * 10 + kv)
    b, s, hd = 2, 24, 16
    q = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    k, v = (rng.standard_normal((b, s, kv, hd)).astype(np.float32)
            for _ in range(2))
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    g = h // kv
    card = flash_attn.flash_attention_plain(
        qt.transpose(1, 2).contiguous(),
        kt.transpose(1, 2).repeat_interleave(g, dim=1).contiguous(),
        vt.transpose(1, 2).repeat_interleave(g, dim=1).contiguous(),
        causal=causal).transpose(1, 2)
    pos = torch.arange(s).expand(b, s)
    mask = pos[:, :, None] >= pos[:, None, :] if causal else None
    host = attention._grouped_attn(qt, kt, vt, mask)
    ref = np.asarray(rattention._grouped_attn(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if mask is None else jnp.asarray(mask.numpy())))
    np.testing.assert_allclose(card.numpy(), host.numpy(), rtol=0, atol=2e-6)
    np.testing.assert_allclose(host.numpy(), ref, rtol=0, atol=2e-6)


def test_a_device_tensor_reaches_the_flash_function(monkeypatch):
    """Full and prefill attention go to `flash_attn.flash_attention` with
    (B, H, S, D) contiguous q and K/V repeated to H heads, on a device
    tensor as on a CPU one, and never to the grouped einsum."""
    seen = []

    def flash(q, k, v, *, bq, bk, causal):
        seen.append((q.device.type, q.shape, k.shape, v.shape,
                     q.is_contiguous(), k.is_contiguous(), bq, bk, causal))
        return torch.zeros_like(q)

    def grouped(*a, **k):
        raise AssertionError("the grouped einsum reached for a prefill")

    monkeypatch.setattr(flash_attn, "flash_attention", flash)
    monkeypatch.setattr(attention, "_grouped_attn", grouped)
    for dev in ("meta", "cpu"):
        q = torch.zeros(2, 24, 4, 16, device=dev)
        k = torch.zeros(2, 24, 2, 16, device=dev)
        out = attention._flash(q, k, k, causal=True)
        assert out.shape == q.shape and out.device.type == dev
    want = ((2, 4, 24, 16), (2, 4, 24, 16), (2, 4, 24, 16), True, True, 8,
            8, True)
    assert seen == [("meta", *want), ("cpu", *want)]
    cfg = configs.get_smoke("llama3-8b")
    model = transformer.Transformer(cfg, device="cpu",
                                    generator=torch.Generator().manual_seed(0))
    seen.clear()
    steps.make_prefill_step(cfg)(model, {"tokens": torch.zeros(
        1, 16, dtype=torch.int32)})
    assert [c[0] for c in seen] == ["cpu"] * cfg.n_layers


def test_the_flash_wrapper_raises_off_cuda_and_positions_must_rise():
    q = torch.empty(1, 2, 16, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attn.flash_attention(q, q, q, bq=16, bk=16)
    cfg = configs.get_smoke("llama3-8b")
    transformer._require_increasing(cfg, torch.arange(5).expand(2, 5))
    with pytest.raises(ValueError, match="increase strictly"):
        transformer._require_increasing(cfg, torch.tensor([[0, 1, 2],
                                                           [0, 2, 1]]))
    with pytest.raises(ValueError, match="increase strictly"):
        transformer._require_increasing(cfg, torch.tensor([[0, 1, 1]]))
    # M-RoPE masks by its w stream, the last: only that one must rise
    vl = configs.get_smoke("qwen2-vl-2b")
    pos = torch.from_numpy(_mrope_positions(2, 12))
    assert not bool((pos[0, :, 1:] > pos[0, :, :-1]).all())
    transformer._require_increasing(vl, pos)
    with pytest.raises(ValueError, match="increase strictly"):
        transformer._require_increasing(vl, pos.flip(0))
    # the model checks positions a caller passes, on the CPU too
    model = transformer.Transformer(cfg, device="cpu",
                                    generator=torch.Generator().manual_seed(0))
    tokens = torch.zeros(1, 8, dtype=torch.int32)
    back = torch.arange(8, 0, -1, dtype=torch.int32)[None]
    for mode in ("train", "prefill"):
        with pytest.raises(ValueError, match="increase strictly"):
            transformer.forward(cfg, model, tokens, mode=mode,
                                positions=back)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_model_prefill_through_the_kernel_on_card(dtype):
    """A 2-layer llama3-8b smoke model prefills through the flash kernel
    (one launch per layer) and matches the same model with the kernel
    replaced by its plain version: f32 within 1e-4 · (1 + max|plain|) (the
    fma route, 2e-4 per attention output), bf16 within 2^-5 · max|plain|
    (chip_smoke.TOL_LM_BF16: four bf16 roundings of the largest logit)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (and nvcc) to run the flash kernel")
    cfg = dataclasses.replace(configs.get_smoke("llama3-8b"), dtype=dtype,
                              head_dim=64, n_heads=4, d_model=256)
    model = transformer.Transformer(
        cfg, generator=torch.Generator("cuda").manual_seed(0))
    tok = torch.from_numpy(_tokens(cfg, 2, 256)).cuda()
    before = flash_attn.LAUNCHES
    lg, cache = steps.make_prefill_step(cfg)(model, {"tokens": tok})
    torch.cuda.synchronize()
    assert flash_attn.LAUNCHES - before == cfg.n_layers
    plain = flash_attn.flash_attention_plain
    mp = pytest.MonkeyPatch()
    mp.setattr(flash_attn, "flash_attention",
               lambda q, k, v, *, bq, bk, causal: plain(q, k, v,
                                                        causal=causal))
    try:
        ref, _ = steps.make_prefill_step(cfg)(model, {"tokens": tok})
    finally:
        mp.undo()
    err = float((lg.float() - ref.float()).abs().max())
    scale = float(ref.float().abs().max())
    tol = 1e-4 * (1 + scale) if dtype == torch.float32 else 2 ** -5 * scale
    assert err <= tol, (err, tol)
