"""whisper's encoder and cross attention, and qwen2-vl's M-RoPE, in the
port (`repro_torch.models`) against the reference's (`repro.models`), on
the CPU, at the smoke configs' widths.

Tolerances, each element against its reference value:
- `_sinusoid`: within 1e-6 + (S - 1) · 2^-23, one f32 rounding of the
  largest angle (position / 10000^(i / (D/2)): the libraries' f32 powers
  differ by an ulp, which a position up to S - 1 scales; 3.1e-5 read at
  S = 1500), plus an ulp or two of sin / cos.
- `apply_mrope`'s band selection: bit for bit the reference's one-hot
  einsum (`repro/models/common.py:236-238`) on the same angles; the whole
  rotation within 1e-5 · (1 + max|ref|) in f32 (RoPE's own bound) and one
  bf16 rounding of the largest output (2^-7 · max|ref|) in bf16.
- `cross_full`, `encode`, `_cross_decode`, the cross K/V of `init_cache`
  and of a prefill: within 1e-5 · (1 + max|ref|) in f32 (the smoke
  configs compute in f32), with the reference's weights carried across by
  `models.convert`. `cross_full` in `q_chunk` query chunks against one
  chunk: within 1e-6 (each row's softmax is its own).
- `utils.flops.encdec_param_counts`, `encdec_model_flops` and
  `encdec_hbm_bytes_floor` (the port's own, for whisper's bounds on the
  card): exact, against the reference's parameter tree and its
  `model_flops` / `hbm_bytes_floor` with the terms it counts differently
  moved.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import attention as rattention
from repro.models import common as rcommon
from repro.models import transformer as rtransformer
from repro.models.common import init_params as rinit
from repro.utils import flops as rflops
from repro_torch import configs
from repro_torch.models import attention, common, convert, steps, transformer
from repro_torch.utils import flops

WHISPER, QWEN_VL = "whisper-large-v3", "qwen2-vl-2b"


def _tol(ref):
    return 1e-5 * (1.0 + float(np.abs(np.asarray(ref, np.float64)).max()))


def _close(got, ref, tol=None):
    ref = np.asarray(ref, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=_tol(ref) if tol is None else tol)


def _models(arch, seed=7):
    rcfg, cfg = rconfigs.get_smoke(arch), configs.get_smoke(arch)
    params = rinit(jax.random.key(seed), rtransformer.model_spec(rcfg))
    model = transformer.Transformer(cfg, device="cpu")
    model.load_state_dict(convert.params_from_reference(
        jax.tree.map(np.asarray, params)))
    return rcfg, params, cfg, model


def _frames(cfg, b, seed=3):
    return (np.random.default_rng(seed).standard_normal(
        (b, cfg.encoder_seq, cfg.d_model)) * 0.02).astype(np.float32)


def _positions3(b, t, seed=0):
    """(3, b, t): a strictly rising w stream (with gaps), t and h streams
    that differ from it and from row to row."""
    rng = np.random.default_rng(seed)
    w = np.cumsum(rng.integers(1, 4, (b, t)), axis=1)
    return np.stack([w // 7 + rng.integers(0, 3, (b, 1)),
                     rng.integers(0, 50, (b, t)), w]).astype(np.int32)


# ---------------------------------------------------------------------------
# M-RoPE


@pytest.mark.parametrize("sections,hd", [((2, 3, 3), 16), ((16, 24, 24), 128),
                                         ((1, 0, 3), 8)])
def test_mrope_bands_are_the_one_hot_einsum_bit_for_bit(sections, hd):
    pos = _positions3(2, 11)
    ang = common._mrope_angles(torch.from_numpy(pos), sections, hd, 1e6)
    # the reference's selection, on the port's own per-stream angles
    freqs = common.rope_freqs(hd, 1e6).numpy()
    ang_all = pos[..., None].astype(np.float32) * freqs
    band = np.concatenate([np.full(n, i) for i, n in enumerate(sections)])
    sel = jax.nn.one_hot(jnp.asarray(band, jnp.int32), 3, dtype=jnp.float32)
    ref = np.asarray(jnp.einsum("c...sh,hc->...sh", jnp.asarray(ang_all),
                                sel))
    assert ang.dtype == torch.float32 and ang.shape == ref.shape
    assert np.array_equal(ang.numpy(), ref)
    # each band follows its stream: t, h, w
    edges = np.cumsum((0,) + tuple(sections))
    for c in range(3):
        got = ang.numpy()[..., edges[c]:edges[c + 1]]
        assert np.array_equal(got, ang_all[c][..., edges[c]:edges[c + 1]])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_mrope_matches_reference(dtype):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 11, 3, 16)).astype(np.float32)
    pos = _positions3(2, 11, seed=5) * 1000       # angles far from 0
    ref = rcommon.apply_mrope(jnp.asarray(x).astype(dtype), jnp.asarray(pos),
                              (2, 3, 3), 1e6)
    got = common.apply_mrope(torch.from_numpy(x).to(getattr(torch, dtype)),
                             torch.from_numpy(pos), (2, 3, 3), 1e6)
    assert got.dtype == getattr(torch, dtype)
    ref = np.asarray(ref, np.float32)
    _close(got, ref, None if dtype == "float32"
           else 2 ** -7 * float(np.abs(ref).max()))
    # equal streams give plain RoPE
    same = np.broadcast_to(pos[2], (3, *pos.shape[1:])).copy()
    x32 = torch.from_numpy(x)
    flat = common.apply_rope(x32, torch.from_numpy(pos[2]), 1e6)
    assert torch.equal(common.apply_mrope(x32, torch.from_numpy(same),
                                          (2, 3, 3), 1e6), flat)
    with pytest.raises(ValueError, match="half the head dim"):
        common.apply_mrope(x32, torch.from_numpy(pos), (2, 3, 2), 1e6)


def test_mrope_model_masks_by_the_w_stream():
    """The port's causal attention masks by index; with M-RoPE the
    reference masks by the w stream, so the two agree on positions whose w
    stream rises (checked: t and h may do anything), and a falling w
    stream is refused."""
    rcfg, params, cfg, model = _models(QWEN_VL)
    tok = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                            (2, 12)).astype(np.int32)
    pos = _positions3(2, 12, seed=2)
    ref, _, _ = rtransformer.forward(rcfg, params, jnp.asarray(tok),
                                     mode="train", positions=jnp.asarray(pos))
    with torch.no_grad():
        got, _, _ = transformer.forward(cfg, model, torch.from_numpy(tok),
                                        mode="train",
                                        positions=torch.from_numpy(pos))
    _close(got, ref)
    with pytest.raises(ValueError, match="increase strictly"):
        transformer.forward(cfg, model, torch.from_numpy(tok), mode="train",
                            positions=torch.from_numpy(pos[:, :, ::-1].copy()))


# ---------------------------------------------------------------------------
# whisper


def test_sinusoid_matches_reference():
    for s, d in ((24, 64), (1500, 1280)):
        ref = np.asarray(rtransformer._sinusoid(s, d, jnp.float32))
        got = transformer._sinusoid(s, d, torch.float32)
        assert got.shape == (s, d) and got.dtype == torch.float32
        _close(got, ref, 1e-6 + (s - 1) * 2.0 ** -23)


@pytest.mark.parametrize("sq", [5, 20])
def test_cross_full_matches_reference(sq):
    """Cross attention over 24 encoder frames at 5 decoder tokens (one
    query chunk) and 20 (chunks of 8, the last ragged)."""
    rcfg, params, cfg, model = _models(WHISPER)
    assert cfg.q_chunk == 8
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, sq, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, cfg.encoder_seq, cfg.d_model)).astype(
        np.float32)
    rp = params["period"]["0"]["cross"]
    ref = rattention.cross_full(rcfg, jax.tree.map(lambda a: a[1], rp),
                                jnp.asarray(x), jnp.asarray(enc))
    p = model.layers[1]["cross"]
    with torch.no_grad():
        got = attention.cross_full(cfg, p, torch.from_numpy(x),
                                   torch.from_numpy(enc))
        one = attention.cross_full(dataclasses.replace(cfg, q_chunk=64), p,
                                   torch.from_numpy(x),
                                   torch.from_numpy(enc))
    _close(got, ref)
    _close(got, one.numpy(), 1e-6)
    # the reference's uniform biases: q and v biased, k not
    assert sorted(p["wk"]._parameters) == ["w"]
    assert sorted(p["wq"]._parameters) == sorted(p["wv"]._parameters) == [
        "b", "w"]


def test_encode_matches_reference():
    rcfg, params, cfg, model = _models(WHISPER)
    frames = _frames(cfg, 2)
    ref = rtransformer.encode(rcfg, params, jnp.asarray(frames), None)
    with torch.no_grad():
        got = transformer.encode(cfg, model, torch.from_numpy(frames))
    _close(got, ref)
    # with remat under autograd: the same values, and gradients reach the
    # encoder's weights
    rcfg_r = dataclasses.replace(cfg, remat=True)
    again = transformer.encode(rcfg_r, model, torch.from_numpy(frames))
    assert torch.equal(again.detach(), got)
    again.sum().backward()
    assert model.enc.layers[0]["mixer"]["wq"]["w"].grad is not None


def test_whisper_cache_cross_kv_matches_reference():
    """`init_cache(frames=)` runs the encoder once and writes each layer's
    cross K/V; the prefill returns the same ones; a decode step reads them
    and leaves them as they were (the same tensors); `_cross_decode`
    equals the reference's on them."""
    rcfg, params, cfg, model = _models(WHISPER)
    b, s = 2, 10
    frames = _frames(cfg, b)
    ref_cache = rtransformer.init_cache(rcfg, params, b, s,
                                        frames=jnp.asarray(frames))
    cache = transformer.init_cache(cfg, model, b, s,
                                   frames=torch.from_numpy(frames))
    got = convert.cache_to_reference(cache, cfg)
    for key in ("ck", "cv"):
        r = np.asarray(ref_cache["period"]["0"][key])
        g = torch.stack([c[key] for c in cache]).numpy()
        assert g.shape == r.shape == (cfg.n_layers, b, cfg.encoder_seq,
                                      cfg.n_heads, cfg.head_dim)
        _close(torch.from_numpy(g), r)
        assert not np.asarray(ref_cache["period"]["0"][
            key.removeprefix("c")]).any()
        assert torch.equal(got["period"]["0"][key], torch.from_numpy(g))
    tok = np.random.default_rng(2).integers(0, cfg.vocab_size,
                                            (b, s)).astype(np.int32)
    _, pre = steps.make_prefill_step(cfg)(
        model, {"tokens": torch.from_numpy(tok),
                "frames": torch.from_numpy(frames)})
    for layer, c in zip(pre, cache):
        for key in ("ck", "cv"):
            np.testing.assert_allclose(layer[key].numpy(), c[key].numpy(),
                                       rtol=0, atol=1e-6)
    before = [{k: c[k].clone() for k in ("ck", "cv")} for c in cache]
    _, new = steps.make_decode_step(cfg)(
        model, cache, {"tokens": torch.from_numpy(tok[:, :1]),
                       "cache_len": 0})
    for layer, c, was in zip(new, cache, before):
        for key in ("ck", "cv"):
            assert layer[key] is c[key] and torch.equal(layer[key], was[key])
    # one token's cross attention over the cache
    x = np.random.default_rng(8).standard_normal((b, 1, cfg.d_model)).astype(
        np.float32)
    rp = jax.tree.map(lambda a: a[0], params["period"]["0"]["cross"])
    ref = rtransformer._cross_decode(
        rcfg, rp, jnp.asarray(x), ref_cache["period"]["0"]["ck"][0],
        ref_cache["period"]["0"]["cv"][0])
    with torch.no_grad():
        got = transformer._cross_decode(cfg, model.layers[0]["cross"],
                                        torch.from_numpy(x), cache[0]["ck"],
                                        cache[0]["cv"])
    _close(got, ref)


def test_whisper_needs_frames_and_keeps_its_positions():
    _, _, cfg, model = _models(WHISPER)
    tok = torch.zeros(1, 4, dtype=torch.int32)
    for mode in ("train", "prefill"):
        with pytest.raises(ValueError, match="needs `frames`"):
            transformer.forward(cfg, model, tok, mode=mode)
    with pytest.raises(ValueError, match="frames hold 1 requests"):
        transformer.init_cache(cfg, model, 2, 4,
                               frames=torch.from_numpy(_frames(cfg, 1)))
    # the learned positions: decode at cache_len t adds pos_emb[t], and
    # clamps past the table's end as the reference's dynamic_slice does
    assert model.pos_emb.shape == (cfg.max_position, cfg.d_model)
    spec = transformer.model_spec(cfg)
    assert list(spec)[-2:] == ["pos_emb", "enc"]
    assert sorted(spec["enc"]) == ["layers", "ln_f"]
    assert len(spec["enc"]["layers"]) == cfg.encoder_layers
    assert list(spec["layers"]["0"]) == ["ln1", "mixer", "ln_x", "cross",
                                         "ln2", "ffn"]
    cache = transformer.init_cache(cfg, model, 1, 4)
    dec = steps.make_decode_step(cfg)
    last, _ = dec(model, cache, {"tokens": tok[:, :1],
                                 "cache_len": cfg.max_position - 1})
    cache = transformer.init_cache(cfg, model, 1, 4)
    past, _ = dec(model, cache, {"tokens": tok[:, :1],
                                 "cache_len": cfg.max_position + 5})
    assert torch.equal(last, past)


def test_whisper_weights_round_trip_with_the_encoder_stacked():
    """The reference stacks the encoder under `enc.blk`; the port's state
    dict holds `enc.layers.<i>` and carries back bit for bit; AdamW decays
    the encoder layers' 1-d leaves too (rank 2 in the stacked layout) but
    not `enc.ln_f`, and decays `pos_emb`."""
    rcfg, params, cfg, model = _models(WHISPER)
    names = set(model.state_dict())
    assert {"pos_emb", "enc.ln_f.scale", "enc.layers.1.mixer.wq.w",
            "layers.0.cross.wk.w", "layers.0.ln_x.bias"} <= names
    back = jax.tree.map(convert._to_numpy, convert.params_to_reference(
        model, cfg))
    ref = jax.tree.map(np.asarray, params)
    assert jax.tree.structure(back) == jax.tree.structure(ref)
    for a, r in zip(jax.tree.leaves(back), jax.tree.leaves(ref)):
        assert a.dtype == r.dtype and np.array_equal(
            a.view(np.uint8), r.view(np.uint8))
    decay = convert.decayed_paths(model, cfg)
    assert {"pos_emb", "enc.layers.0.ln1.scale",
            "enc.layers.1.mixer.wq.b"} <= decay
    assert not {"enc.ln_f.scale", "enc.ln_f.bias"} & decay


def test_encdec_param_counts_split_the_reference_tree():
    """The encoder's parameters are the reference's `enc` subtree, the
    cross K/V projections its stacked `cross.wk` / `cross.wv`, and the
    decoder's the rest of the active (non-embedding) count."""
    cfg, rcfg = configs.get_config(WHISPER), rconfigs.get_config(WHISPER)
    spec = rtransformer.model_spec(rcfg)
    n = flops.encdec_param_counts(cfg)
    size = lambda t: sum(int(np.prod(x.shape)) for x in jax.tree.leaves(
        t, is_leaf=lambda x: hasattr(x, "shape")))
    assert n["encoder"] == size(spec["enc"])
    cross = [v for k, v in jax.tree_util.tree_leaves_with_path(
        spec, is_leaf=lambda x: hasattr(x, "shape"))
        if "'cross'" in jax.tree_util.keystr(k)
        and ("'wk'" in jax.tree_util.keystr(k)
             or "'wv'" in jax.tree_util.keystr(k))]
    assert n["cross_kv"] == size(cross) > 0
    assert sum(n.values()) == rflops.param_counts(rcfg)["active"]


@pytest.mark.parametrize("kind,b,s", [("prefill", 4, 32768),
                                      ("decode", 128, 1600),
                                      ("train", 2, 4096)])
def test_encdec_work_moves_the_encoder_to_the_frames(kind, b, s):
    """`encdec_model_flops` is the reference's `model_flops` with the
    encoder's and the cross K/V projections' parameters charged to the
    frames (none in decode) in place of the decoder tokens, cross
    attention added (2·Dh a score and a value per head, over 1,500
    frames), and the encoder's attention as the reference's train term
    (added in prefill, where the reference has none); the byte floor is
    the reference's less the encoder's and cross wk / wv's weights in
    decode, plus the cross K/V a step reads."""
    cfg, rcfg = configs.get_config(WHISPER), rconfigs.get_config(WHISPER)
    shape = configs.ShapeSpec("x", s, b, kind)
    rshape = rconfigs.ShapeSpec("x", s, b, kind)
    got, ref = flops.encdec_model_flops(cfg, shape), rflops.model_flops(
        rcfg, rshape)
    n = flops.encdec_param_counts(cfg)
    mult = 6 if kind == "train" else 2
    f, hd = cfg.encoder_seq, cfg.n_heads * cfg.head_dim
    tokens = b if kind == "decode" else b * s
    frames = 0 if kind == "decode" else b * f
    moved = n["encoder"] + n["cross_kv"]
    assert got["dense"] == ref["dense"] + mult * (frames - tokens) * moved
    cross = mult * cfg.n_layers * tokens * f * 2 * hd
    enc_attn = mult * cfg.encoder_layers * b * f * f * 2 * hd
    assert got["attn"] == ref["attn"] + cross + (
        enc_attn if kind == "prefill" else 0)
    assert got["logits"] == ref["logits"] and got["tokens"] == ref["tokens"]
    assert got["total"] == got["dense"] + got["attn"] + got["logits"]
    floor = rflops.hbm_bytes_floor(rcfg, rshape, 1)
    if kind == "decode":
        floor += -2 * moved + b * f * hd * 2 * 2 * cfg.n_layers
    assert flops.encdec_hbm_bytes_floor(cfg, shape) == floor
