"""LM assembly — port of `repro.models.transformer` for the dense GQA,
MLA, MoE, RWKV6 and Mamba / attention hybrid families.

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
GQA without RoPE at in-period index 4, MoE on odd layers). The
encoder-decoder with cross-attention and M-RoPE raise
`NotImplementedError` naming ROADMAP.md §A9 (iii).

Modes: train (no cache), prefill (returns the cache), decode (one token;
writes the cache in place, see `attention.gqa_decode`,
`attention.mla_decode`, `rwkv.time_mix_step` and `mamba.mamba_step`). A
layer's cache is {k, v} (GQA), {ckv, kr} (MLA), {state, xp_tm, xp_cm}
(RWKV6: the f32 WKV state and the token shifts of both mixers) or {ssm,
conv} (Mamba: the f32 SSM state and the conv window). The output head is
tied: `x @ emb.T`. Each MoE
layer returns its load-balancing aux loss; `trunk` sums them. With
`cfg.remat`, a train-mode forward under autograd recomputes each layer in
the backward (`torch.utils.checkpoint`, non-reentrant): only the layer's
input is kept, as the reference's `jax.checkpoint(..., nothing_saveable)`
per layer does, and the layer's aux comes out beside its output.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.models import attention, mamba, moe, rwkv
from repro_torch.models.common import (
    ParamSpec, ParamTree, Tree, empty_params, init_params, make_norm,
    tree_map,
)
from repro_torch.utils.device import resolve_device

UNPORTED = "ROADMAP.md §A9 (iii)"


MIXERS = ("attn", "mla", "rwkv", "mamba")
FFNS = ("swiglu", "gelu", "moe", "rwkv_cm")


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError unless every layer of `cfg` has a ported
    mixer and FFN, with no M-RoPE and no encoder."""
    parts = set()
    if cfg.mrope_sections:
        parts.add("M-RoPE")
    if cfg.is_encdec or cfg.learned_pos:
        parts.add("an encoder-decoder with cross-attention")
    for i in range(cfg.n_layers):
        ls = cfg.layer_kind(i)
        if ls.mixer not in MIXERS:
            parts.add(f"the {ls.mixer} mixer")
        if ls.ffn not in FFNS:
            parts.add(f"the {ls.ffn} FFN")
    if parts:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(sorted(parts))} is not ported yet "
            f"({UNPORTED}); this package builds the GQA, MLA, MoE, RWKV6 "
            "and Mamba families only")


# ---------------------------------------------------------------------------
# param specs


def layer_param_spec(cfg: ModelConfig, ls: LayerSpec) -> Tree:
    if ls.mixer not in MIXERS or ls.ffn not in FFNS or ls.cross:
        raise NotImplementedError(f"{ls} is not ported yet ({UNPORTED})")
    d = cfg.d_model
    norm_spec, _ = make_norm(cfg.norm_type, d)
    mixer = {"attn": attention.gqa_spec, "mla": attention.mla_spec,
             "rwkv": rwkv.time_mix_spec,
             "mamba": mamba.mamba_spec}[ls.mixer](cfg)
    if ls.ffn == "moe":
        ffn = moe.moe_spec(cfg)
    elif ls.ffn == "swiglu":
        ffn = moe.swiglu_spec(d, ls.d_ff)
    elif ls.ffn == "rwkv_cm":
        ffn = rwkv.channel_mix_spec(cfg)
    else:
        ffn = moe.gelu_mlp_spec(d, ls.d_ff)
    return {"ln1": norm_spec, "mixer": mixer, "ln2": norm_spec, "ffn": ffn}


def model_spec(cfg: ModelConfig) -> Tree:
    """The port's parameter tree: `emb`, `ln_f`, then `layers.<i>` per
    decoder layer (the reference stacks these under `period`)."""
    check_supported(cfg)
    norm_spec, _ = make_norm(cfg.norm_type, cfg.d_model)
    return {
        "emb": ParamSpec((cfg.padded_vocab, cfg.d_model), ("vocab", "embed"),
                         init="normal", scale=0.02),
        "ln_f": norm_spec,
        "layers": {str(i): layer_param_spec(cfg, cfg.layer_kind(i))
                   for i in range(cfg.n_layers)},
    }


# ---------------------------------------------------------------------------
# cache specs


def layer_cache_spec(cfg: ModelConfig, ls: LayerSpec, b: int, s: int) -> Tree:
    d = cfg.d_model
    if ls.mixer == "rwkv":
        h, k = d // cfg.rwkv_head_dim, cfg.rwkv_head_dim
        shift = ParamSpec((b, 1, d), ("batch", "null", "embed"),
                          dtype=cfg.dtype)
        return {"state": ParamSpec((b, h, k, k),
                                   ("batch", "heads", "head_dim", "null"),
                                   dtype=torch.float32),
                "xp_tm": shift, "xp_cm": shift}
    if ls.mixer == "mamba":
        di = cfg.mamba_expand * d
        return {"ssm": ParamSpec((b, di, cfg.mamba_d_state),
                                 ("batch", "mlp", "state"),
                                 dtype=torch.float32),
                "conv": ParamSpec((b, cfg.mamba_conv - 1, di),
                                  ("batch", "null", "mlp"), dtype=cfg.dtype)}
    if ls.mixer == "mla":
        return {"ckv": ParamSpec((b, s, cfg.kv_lora_rank),
                                 ("batch", "kv_seq", "kv_lora"),
                                 dtype=cfg.dtype),
                "kr": ParamSpec((b, s, cfg.qk_rope_dim),
                                ("batch", "kv_seq", "head_dim"),
                                dtype=cfg.dtype)}
    if ls.mixer != "attn":
        raise NotImplementedError(f"{ls} is not ported yet ({UNPORTED})")
    shape = (b, s, cfg.n_kv_heads, cfg.head_dim)
    axes = ("batch", "kv_seq", "kv_heads", "head_dim")
    return {"k": ParamSpec(shape, axes, dtype=cfg.dtype),
            "v": ParamSpec(shape, axes, dtype=cfg.dtype)}


def cache_spec(cfg: ModelConfig, b: int, s: int) -> list[Tree]:
    """One layer cache spec per decoder layer."""
    return [layer_cache_spec(cfg, cfg.layer_kind(i), b, s)
            for i in range(cfg.n_layers)]


def init_cache(cfg: ModelConfig, params, b: int, s: int) -> list[Tree]:
    """Zero-initialized decode cache on the parameters' device."""
    dev = params["emb"].device
    return [tree_map(lambda ps: torch.zeros(ps.shape, dtype=ps.dtype,
                                            device=dev), ls)
            for ls in cache_spec(cfg, b, s)]


# ---------------------------------------------------------------------------
# modules


class Transformer(ParamTree):
    """The model: `emb`, `ln_f` and `layers` (an `nn.ModuleList` of one
    `ParamTree` per decoder layer: `ln1`, `mixer`, `ln2`, `ffn`), named as
    `model_spec`'s tree.

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

        super().__init__(make({k: spec[k] for k in ("emb", "ln_f")}))
        self.cfg = cfg
        self.layers = nn.ModuleList(ParamTree(make(spec["layers"][str(i)]))
                                    for i in range(cfg.n_layers))

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


def apply_layer(cfg: ModelConfig, ls: LayerSpec, p, x, *, mode: str,
                positions=None, cache: Tree | None = None, cache_len=None):
    """Returns (x, aux, new_cache); aux is the MoE layer's load-balancing
    loss (an f32 scalar), 0.0 for a dense FFN."""
    norm = _norm(cfg)
    o, new_cache = _mixer(cfg, ls, p["mixer"], norm(x, p["ln1"]), mode=mode,
                          positions=positions, cache=cache,
                          cache_len=cache_len)
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


# ---------------------------------------------------------------------------
# full model


def _positions(tokens):
    b, s = tokens.shape[-2:]
    return torch.arange(s, dtype=torch.int32,
                        device=tokens.device).expand(b, s)


def _require_increasing(positions) -> None:
    """Causal attention masks by index (`attention._flash`) or skips the
    keys past a query chunk (`attention.mla_full`); either equals the
    reference's position mask only where positions rise along each
    row."""
    if positions.shape[-1] > 1 and not bool(
            (positions[..., 1:] > positions[..., :-1]).all()):
        raise ValueError("causal attention masks by index: positions must "
                         "increase strictly along each sequence")


def trunk(cfg: ModelConfig, params, tokens, *, mode: str, positions=None,
          cache: list[Tree] | None = None, cache_len=None):
    """Everything before the output head: (final-normed hidden states
    (B, S, D), aux, new_cache). aux is the sum of the MoE layers' aux
    losses (f32). new_cache is a list of per-layer caches (see the module
    docstring) for prefill and decode, empty for train. Positions a caller
    passes for train or prefill must rise along each row (checked once
    here). With `cfg.remat`, a train forward under autograd checkpoints
    each layer, its aux carried out beside its output."""
    x = params["emb"][tokens.long()].to(cfg.dtype)
    if positions is None:
        if mode == "decode":
            positions = torch.full((tokens.shape[0], 1), int(cache_len),
                                   dtype=torch.int32, device=tokens.device)
        else:
            positions = _positions(tokens)
    elif mode != "decode":
        _require_increasing(positions)
    new_cache: list[Tree] = []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat and mode == "train" and torch.is_grad_enabled()
    for i, layer in enumerate(params["layers"]):
        ls = cfg.layer_kind(i)
        if remat:
            x, a = checkpoint(lambda x, ls=ls, layer=layer: apply_layer(
                cfg, ls, layer, x, mode=mode, positions=positions)[:2],
                x, use_reentrant=False)
            aux = aux + a
            continue
        x, a, nc = apply_layer(cfg, ls, layer, x, mode=mode,
                               positions=positions,
                               cache=None if cache is None else cache[i],
                               cache_len=cache_len)
        aux = aux + a
        if mode in ("prefill", "decode"):
            new_cache.append(nc)
    return _norm(cfg)(x, params["ln_f"]), aux, new_cache


def head(cfg: ModelConfig, params, x):
    """The tied output head: x @ emb.T in the model dtype."""
    return x @ params["emb"].T.to(cfg.dtype)


def forward(cfg: ModelConfig, params, tokens, *, mode: str, positions=None,
            cache: list[Tree] | None = None, cache_len=None):
    """Unified forward. Returns (logits (B, S, V), aux, new_cache)."""
    x, aux, new_cache = trunk(cfg, params, tokens, mode=mode,
                              positions=positions, cache=cache,
                              cache_len=cache_len)
    return head(cfg, params, x), aux, new_cache
