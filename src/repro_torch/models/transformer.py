"""LM assembly — port of `repro.models.transformer` for every family of
`repro.configs`.

The reference scans stacked "period" parameters; here the stack is a loop
over per-layer modules (`Transformer.layers`, one `ParamTree` each),
and `models.convert` carries weights between the two layouts. A model is
built on the card unless `device="cpu"` is given, its weights drawn layer
by layer from a `torch.Generator` on that device. A layer's mixer is GQA
attention (`attn`), multi-head latent attention (`mla`), RWKV6 time mixing
(`rwkv`) or a Mamba selective SSM (`mamba`), its FFN a SwiGLU, a GELU MLP,
a routed MoE (`moe`) or RWKV6 channel mixing (`rwkv_cm`): llama3-8b,
qwen2-7b, qwen2.5-32b, olmoe-1b-7b, deepseek-v2-lite-16b (its dense first
layer included), minicpm3-4b, rwkv6-3b and jamba-v0.1-52b (Mamba layers,
GQA without RoPE at in-period index 4, MoE on odd layers). qwen2-vl-2b
rotates q and k by M-RoPE over (3, B, S) positions (t, h, w).
whisper-large-v3 is an encoder-decoder: `encode` runs bidirectional GQA
layers over precomputed frames, and each decoder layer adds a cross
sublayer (`ln_x`, `cross`) over the encoder's output, with learned
decoder positions (`pos_emb`).

Modes: train (no cache), prefill (returns the cache), decode (one token;
writes the cache in place, see `attention.gqa_decode`,
`attention.mla_decode`, `rwkv.time_mix_step` and `mamba.mamba_step`). A
layer's cache is {k, v} (GQA), {ckv, kr} (MLA), {state, xp_tm, xp_cm}
(RWKV6: the f32 WKV state and the token shifts of both mixers) or {ssm,
conv} (Mamba: the f32 SSM state and the conv window), plus {ck, cv} with
cross attention (the encoder's K/V, which decode reads and never writes).
The output head is tied: `x @ emb.T`. Each MoE layer returns its
load-balancing aux loss; `trunk` sums them. With `cfg.remat`, a
train-mode forward under autograd recomputes each layer in the backward
(`torch.utils.checkpoint`, non-reentrant): only the layer's input is
kept, as the reference's `jax.checkpoint(..., nothing_saveable)` per
layer does, and the layer's aux comes out beside its output.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.models import attention, mamba, moe, rwkv
from repro_torch.models.common import (
    ParamSpec, ParamTree, Tree, dense, empty_params, init_params, make_norm,
)
from repro_torch.utils.device import resolve_device

# ---------------------------------------------------------------------------
# param specs


def _enc_layer(cfg: ModelConfig) -> LayerSpec:
    """The encoder's layer: bidirectional GQA and a GELU MLP."""
    return LayerSpec("attn_bidir", "gelu", cfg.d_ff)


def layer_param_spec(cfg: ModelConfig, ls: LayerSpec) -> Tree:
    """One layer's tree: `ln1`, `mixer`, with cross attention `ln_x` and
    `cross`, then `ln2`, `ffn`."""
    d = cfg.d_model
    norm_spec, _ = make_norm(cfg.norm_type, d)
    mixers = {"attn": attention.gqa_spec, "attn_bidir": attention.gqa_spec,
              "mla": attention.mla_spec, "rwkv": rwkv.time_mix_spec,
              "mamba": mamba.mamba_spec}
    if ls.mixer not in mixers:
        raise ValueError(ls.mixer)
    s: Tree = {"ln1": norm_spec, "mixer": mixers[ls.mixer](cfg)}
    if ls.cross:
        s["ln_x"] = norm_spec
        s["cross"] = attention.cross_spec(cfg)
    if ls.ffn == "moe":
        ffn = moe.moe_spec(cfg)
    elif ls.ffn == "swiglu":
        ffn = moe.swiglu_spec(d, ls.d_ff)
    elif ls.ffn == "rwkv_cm":
        ffn = rwkv.channel_mix_spec(cfg)
    elif ls.ffn == "gelu":
        ffn = moe.gelu_mlp_spec(d, ls.d_ff)
    else:
        raise ValueError(ls.ffn)
    s["ln2"] = norm_spec
    s["ffn"] = ffn
    return s


def model_spec(cfg: ModelConfig) -> Tree:
    """The port's parameter tree: `emb`, `ln_f`, `layers.<i>` per decoder
    layer (the reference stacks these under `period`), then whisper's
    learned decoder positions `pos_emb` and its encoder `enc` (`layers.<i>`,
    stacked under `enc.blk` in the reference, and `ln_f`)."""
    norm_spec, _ = make_norm(cfg.norm_type, cfg.d_model)
    spec: Tree = {
        "emb": ParamSpec((cfg.padded_vocab, cfg.d_model), ("vocab", "embed"),
                         init="normal", scale=0.02),
        "ln_f": norm_spec,
        "layers": {str(i): layer_param_spec(cfg, cfg.layer_kind(i))
                   for i in range(cfg.n_layers)},
    }
    if cfg.learned_pos:
        spec["pos_emb"] = ParamSpec((cfg.max_position, cfg.d_model),
                                    ("null", "embed"), init="normal",
                                    scale=0.02)
    if cfg.is_encdec:
        spec["enc"] = {
            "layers": {str(i): layer_param_spec(cfg, _enc_layer(cfg))
                       for i in range(cfg.encoder_layers)},
            "ln_f": norm_spec}
    return spec


# ---------------------------------------------------------------------------
# cache specs


def layer_cache_spec(cfg: ModelConfig, ls: LayerSpec, b: int, s: int) -> Tree:
    d = cfg.d_model
    if ls.mixer == "rwkv":
        h, k = d // cfg.rwkv_head_dim, cfg.rwkv_head_dim
        shift = ParamSpec((b, 1, d), ("batch", "null", "embed"),
                          dtype=cfg.dtype)
        out = {"state": ParamSpec((b, h, k, k),
                                  ("batch", "heads", "head_dim", "null"),
                                  dtype=torch.float32),
               "xp_tm": shift, "xp_cm": shift}
    elif ls.mixer == "mamba":
        di = cfg.mamba_expand * d
        out = {"ssm": ParamSpec((b, di, cfg.mamba_d_state),
                                ("batch", "mlp", "state"),
                                dtype=torch.float32),
               "conv": ParamSpec((b, cfg.mamba_conv - 1, di),
                                 ("batch", "null", "mlp"), dtype=cfg.dtype)}
    elif ls.mixer == "mla":
        out = {"ckv": ParamSpec((b, s, cfg.kv_lora_rank),
                                ("batch", "kv_seq", "kv_lora"),
                                dtype=cfg.dtype),
               "kr": ParamSpec((b, s, cfg.qk_rope_dim),
                               ("batch", "kv_seq", "head_dim"),
                               dtype=cfg.dtype)}
    elif ls.mixer == "attn":
        shape = (b, s, cfg.n_kv_heads, cfg.head_dim)
        axes = ("batch", "kv_seq", "kv_heads", "head_dim")
        out = {"k": ParamSpec(shape, axes, dtype=cfg.dtype),
               "v": ParamSpec(shape, axes, dtype=cfg.dtype)}
    else:
        raise ValueError(ls.mixer)
    if ls.cross:
        shape = (b, cfg.encoder_seq, cfg.n_heads, cfg.head_dim)
        axes = ("batch", "null", "kv_heads", "head_dim")
        out["ck"] = ParamSpec(shape, axes, dtype=cfg.dtype)
        out["cv"] = ParamSpec(shape, axes, dtype=cfg.dtype)
    return out


def cache_spec(cfg: ModelConfig, b: int, s: int) -> list[Tree]:
    """One layer cache spec per decoder layer."""
    return [layer_cache_spec(cfg, cfg.layer_kind(i), b, s)
            for i in range(cfg.n_layers)]


def init_cache(cfg: ModelConfig, params, b: int, s: int, *,
               frames=None) -> list[Tree]:
    """Zero-initialized decode cache on the parameters' device. For an
    encoder-decoder model given `frames` (B, encoder_seq, D), the encoder
    runs once here and each layer's cross K/V (`ck`, `cv`) is written
    into the cache (the serving flow); it runs before the self K/V are
    allocated, so its activations and the full cache never coexist."""
    dev = params["emb"].device
    cross = {}
    if cfg.is_encdec and frames is not None:
        if frames.shape[0] != b:
            raise ValueError(f"frames hold {frames.shape[0]} requests, the "
                             f"cache {b}")
        with torch.no_grad():
            enc_out = encode(cfg, params, frames)
            for i, layer in enumerate(params["layers"]):
                if cfg.layer_kind(i).cross:
                    cross[i] = dict(zip(("ck", "cv"), attention.cross_kv(
                        cfg, layer["cross"], enc_out)))
            del enc_out
    return [{key: cross[i][key] if key in cross.get(i, {}) else torch.zeros(
                 sp.shape, dtype=sp.dtype, device=dev)
             for key, sp in ls.items()}
            for i, ls in enumerate(cache_spec(cfg, b, s))]


# ---------------------------------------------------------------------------
# modules


class Transformer(ParamTree):
    """The model: `emb`, `ln_f` and `layers` (an `nn.ModuleList` of one
    `ParamTree` per decoder layer: `ln1`, `mixer`, [`ln_x`, `cross`,]
    `ln2`, `ffn`), then whisper's `pos_emb` and `enc` (its `layers` a
    `ModuleList` too, and `ln_f`), named as `model_spec`'s tree.

    `device=None` is the card. With a `generator` (a `torch.Generator` on
    that device) every weight is drawn by the reference's init rules,
    layer by layer in the tree's order; without one the weights are left
    uninitialized, for `load_state_dict` (see `models.convert`)."""

    def __init__(self, cfg: ModelConfig, *, device=None,
                 generator: torch.Generator | None = None):
        spec = model_spec(cfg)
        dev = resolve_device(device)
        if generator is not None and generator.device.type != dev.type:
            raise ValueError(f"the generator lies on {generator.device}, "
                             f"the model on {dev}")

        def make(sp):
            return (init_params(generator, sp) if generator is not None
                    else empty_params(sp, dev))

        def stack(layers):
            return nn.ModuleList(ParamTree(make(layers[str(i)]))
                                 for i in range(len(layers)))

        super().__init__(make({k: spec[k] for k in ("emb", "ln_f")}))
        self.cfg = cfg
        self.layers = stack(spec["layers"])
        if "pos_emb" in spec:
            self.register_parameter("pos_emb", nn.Parameter(
                make({"pos_emb": spec["pos_emb"]})["pos_emb"]))
        if "enc" in spec:
            layers = stack(spec["enc"]["layers"])
            self.enc = ParamTree(make({"ln_f": spec["enc"]["ln_f"]}))
            self.enc.layers = layers

    def forward(self, tokens, **kw):
        return forward(self.cfg, self, tokens, **kw)


# ---------------------------------------------------------------------------
# layer application


def _norm(cfg):
    return make_norm(cfg.norm_type, cfg.d_model)[1]


def _mixer(cfg, ls, p, h, *, mode, positions, cache, cache_len):
    """The layer's mixer in `mode`: (output, new cache entries)."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode must be train, prefill or decode, got {mode}")
    if ls.mixer == "attn_bidir":
        return attention.gqa_full(cfg, p, h, positions, causal=False), {}
    if ls.mixer == "rwkv":
        if mode == "decode":
            o, st, xp = rwkv.time_mix_step(cfg, p, h, cache["state"],
                                           cache["xp_tm"])
            return o, {"state": st, "xp_tm": xp}
        if mode == "prefill":
            o, st, xp = rwkv.time_mix_full(cfg, p, h, chunk=cfg.rwkv_chunk,
                                           return_state=True)
            return o, {"state": st, "xp_tm": xp}
        return rwkv.time_mix_full(cfg, p, h, chunk=cfg.rwkv_chunk), {}
    if ls.mixer == "mamba":
        if mode == "decode":
            o, st, cv = mamba.mamba_step(cfg, p, h, cache["ssm"],
                                         cache["conv"])
            return o, {"ssm": st, "conv": cv}
        if mode == "prefill":
            o, st, cv = mamba.mamba_full(cfg, p, h, chunk=cfg.mamba_chunk,
                                         return_state=True)
            return o, {"ssm": st, "conv": cv}
        return mamba.mamba_full(cfg, p, h, chunk=cfg.mamba_chunk), {}
    if ls.mixer == "mla":
        if mode == "decode":
            return attention.mla_decode(cfg, p, h, cache, cache_len,
                                        positions)
        if mode == "prefill":
            return attention.mla_full(cfg, p, h, positions,
                                      return_cache=True)
        return attention.mla_full(cfg, p, h, positions), {}
    if mode == "decode":
        return attention.gqa_decode(cfg, p, h, cache, cache_len, positions)
    if mode == "prefill":
        return attention.gqa_prefill(cfg, p, h, positions)
    return attention.gqa_full(cfg, p, h, positions, causal=True), {}


def _cross(cfg, p, hx, *, mode, cache, enc_out):
    """The cross sublayer: (output, new cache entries). Decode reads `ck`
    / `cv` from the cache and returns the same tensors; prefill computes
    them from `enc_out` once, attends over them and returns them; train
    attends over `enc_out` (`attention.cross_full`)."""
    if mode == "decode":
        return (_cross_decode(cfg, p, hx, cache["ck"], cache["cv"]),
                {"ck": cache["ck"], "cv": cache["cv"]})
    if enc_out is None:
        raise ValueError(f"{cfg.name}: an encoder-decoder model needs "
                         f"`frames` in {mode} mode")
    if mode == "prefill":
        ck, cv = attention.cross_kv(cfg, p, enc_out)
        return attention.cross_attend(cfg, p, hx, ck, cv), {"ck": ck,
                                                            "cv": cv}
    return attention.cross_full(cfg, p, hx, enc_out), {}


def apply_layer(cfg: ModelConfig, ls: LayerSpec, p, x, *, mode: str,
                positions=None, cache: Tree | None = None, cache_len=None,
                enc_out=None):
    """Returns (x, aux, new_cache); aux is the MoE layer's load-balancing
    loss (an f32 scalar), 0.0 for a dense FFN."""
    norm = _norm(cfg)
    o, new_cache = _mixer(cfg, ls, p["mixer"], norm(x, p["ln1"]), mode=mode,
                          positions=positions, cache=cache,
                          cache_len=cache_len)
    x = x + o
    if ls.cross:
        o, c = _cross(cfg, p["cross"], norm(x, p["ln_x"]), mode=mode,
                      cache=cache, enc_out=enc_out)
        new_cache.update(c)
        x = x + o
    h = norm(x, p["ln2"])
    aux = 0.0
    if ls.ffn == "moe":
        o, aux = moe.moe_ffn(cfg, p["ffn"], h)
    elif ls.ffn == "rwkv_cm":
        if mode == "decode":
            o, new_cache["xp_cm"] = rwkv.channel_mix_step(
                cfg, p["ffn"], h, cache["xp_cm"])
        else:
            o = rwkv.channel_mix_full(cfg, p["ffn"], h)
            if mode == "prefill":
                new_cache["xp_cm"] = h[:, -1:].clone()
    else:
        o = (moe.swiglu if ls.ffn == "swiglu" else moe.gelu_mlp)(p["ffn"], h)
    return x + o, aux, new_cache


def _cross_decode(cfg, p, x, ck, cv):
    """One token's cross attention over the cached K/V (B, Sk, H, Dh)."""
    b = x.shape[0]
    q = dense(x, p["wq"]).reshape(b, 1, cfg.n_heads, cfg.head_dim)
    o = attention._grouped_attn(q, ck, cv, None)
    return dense(o.reshape(b, 1, -1), p["wo"])


# ---------------------------------------------------------------------------
# full model


def _positions(cfg, tokens):
    """0..S-1 along each row; (3, B, S), the same in every stream, for
    M-RoPE."""
    b, s = tokens.shape[-2:]
    pos = torch.arange(s, dtype=torch.int32, device=tokens.device).expand(b,
                                                                          s)
    return pos.expand(3, b, s) if cfg.mrope_sections else pos


def _require_increasing(cfg, positions) -> None:
    """Causal attention masks by index (`attention._flash`) or skips the
    keys past a query chunk (`attention.mla_full`); either equals the
    reference's position mask only where positions rise along each row.
    With M-RoPE the reference masks by the last (w) stream
    (`repro/models/attention.py:83`), and only that stream is checked."""
    pos = positions[-1] if cfg.mrope_sections else positions
    if pos.shape[-1] > 1 and not bool((pos[..., 1:] > pos[..., :-1]).all()):
        raise ValueError("causal attention masks by index: positions must "
                         "increase strictly along each sequence")


def _sinusoid(s: int, d: int, dtype, device=None):
    """The encoder's fixed (S, D) position table: sin | cos halves."""
    pos = torch.arange(s, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / (10000.0 ** (dim / (d // 2)))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def encode(cfg: ModelConfig, params, frames):
    """Whisper's encoder over precomputed frame embeddings (B, S, D) (the
    conv frontend is the reference's stub too): the sinusoid table added,
    then `encoder_layers` bidirectional layers (each attention a
    non-causal flash call), then `enc.ln_f`. With `cfg.remat`, under
    autograd each layer is recomputed in the backward, as the decoder's."""
    b, s, d = frames.shape
    x = frames + _sinusoid(s, d, frames.dtype, frames.device)[None]
    ls = _enc_layer(cfg)
    pos = torch.arange(s, dtype=torch.int32, device=frames.device).expand(b,
                                                                          s)
    remat = cfg.remat and torch.is_grad_enabled()
    for layer in params["enc"]["layers"]:
        if remat:
            x = checkpoint(lambda x, layer=layer: apply_layer(
                cfg, ls, layer, x, mode="train", positions=pos)[0], x,
                use_reentrant=False)
        else:
            x = apply_layer(cfg, ls, layer, x, mode="train", positions=pos)[0]
    return _norm(cfg)(x, params["enc"]["ln_f"])


def trunk(cfg: ModelConfig, params, tokens, *, mode: str, positions=None,
          cache: list[Tree] | None = None, cache_len=None, frames=None):
    """Everything before the output head: (final-normed hidden states
    (B, S, D), aux, new_cache). aux is the sum of the MoE layers' aux
    losses (f32). new_cache is a list of per-layer caches (see the module
    docstring) for prefill and decode, empty for train. Positions a caller
    passes for train or prefill must rise along each row (checked once
    here; M-RoPE's (3, B, S) along its w stream). An encoder-decoder model
    encodes `frames` in train and prefill (decode reads the cross K/V from
    the cache) and adds its learned positions. With `cfg.remat`, a train
    forward under autograd checkpoints each layer, its aux carried out
    beside its output."""
    x = params["emb"][tokens.long()].to(cfg.dtype)
    if positions is None:
        if mode == "decode":
            positions = torch.full((tokens.shape[0], 1), int(cache_len),
                                   dtype=torch.int32, device=tokens.device)
            if cfg.mrope_sections:
                positions = positions.expand(3, *positions.shape)
        else:
            positions = _positions(cfg, tokens)
    elif mode != "decode":
        _require_increasing(cfg, positions)
    enc_out = None
    if cfg.is_encdec and mode != "decode" and frames is not None:
        enc_out = encode(cfg, params, frames)
    if cfg.learned_pos:
        if mode == "decode":     # the reference's dynamic_slice clamps
            at = min(max(int(cache_len), 0), cfg.max_position - 1)
            pe = params["pos_emb"][at:at + 1]
        else:
            pe = params["pos_emb"][:tokens.shape[-1]]
        x = x + pe[None].to(x.dtype)
    new_cache: list[Tree] = []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat and mode == "train" and torch.is_grad_enabled()
    for i, layer in enumerate(params["layers"]):
        ls = cfg.layer_kind(i)
        if remat:
            x, a = checkpoint(lambda x, e, ls=ls, layer=layer: apply_layer(
                cfg, ls, layer, x, mode=mode, positions=positions,
                enc_out=e)[:2], x, enc_out, use_reentrant=False)
            aux = aux + a
            continue
        x, a, nc = apply_layer(cfg, ls, layer, x, mode=mode,
                               positions=positions,
                               cache=None if cache is None else cache[i],
                               cache_len=cache_len, enc_out=enc_out)
        aux = aux + a
        if mode in ("prefill", "decode"):
            new_cache.append(nc)
    return _norm(cfg)(x, params["ln_f"]), aux, new_cache


def head(cfg: ModelConfig, params, x):
    """The tied output head: x @ emb.T in the model dtype."""
    return x @ params["emb"].T.to(cfg.dtype)


def forward(cfg: ModelConfig, params, tokens, *, mode: str, positions=None,
            cache: list[Tree] | None = None, cache_len=None, frames=None):
    """Unified forward. Returns (logits (B, S, V), aux, new_cache)."""
    x, aux, new_cache = trunk(cfg, params, tokens, mode=mode,
                              positions=positions, cache=cache,
                              cache_len=cache_len, frames=frames)
    return head(cfg, params, x), aux, new_cache
