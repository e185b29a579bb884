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

import dataclasses

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.models import attention, mamba, moe, parallel, rwkv
from repro_torch.models.common import (
    ParamSpec, ParamTree, Tree, dense, empty_params, init_params, make_norm,
    placements, sanitize_pspec, logical_to_pspec,
)
from repro_torch.models.moe import ShardCtx
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
               frames=None, ctx=None) -> list[Tree]:
    """Zero-initialized decode cache on the parameters' device. For an
    encoder-decoder model given `frames` (B, encoder_seq, D), the encoder
    runs once here and each layer's cross K/V (`ck`, `cv`) is written
    into the cache (the serving flow); it runs before the self K/V are
    allocated, so its activations and the full cache never coexist. With
    a `ShardCtx` every leaf is a DTensor in its cache layout."""
    if ctx is not None:
        return _init_cache_sharded(cfg, params, b, s, frames, ctx)
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

    `device=None` is the card ("meta" builds shapes only, for the
    dry-run). With a `generator` (a `torch.Generator` on
    that device) every weight is drawn by the reference's init rules,
    layer by layer in the tree's order; without one the weights are left
    uninitialized, for `load_state_dict` (see `models.convert`)."""

    def __init__(self, cfg: ModelConfig, *, device=None,
                 generator: torch.Generator | None = None):
        spec = model_spec(cfg)
        dev = (torch.device("meta") if str(device) == "meta"
               else resolve_device(device))
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


def _mixer(cfg, ls, p, h, *, mode, positions, cache, cache_len, lc=None):
    """The layer's mixer in `mode`: (output, new cache entries); on a
    rank's shards with the block's `parallel.Local`."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode must be train, prefill or decode, got {mode}")
    if ls.mixer == "attn_bidir":
        return attention.gqa_full(cfg, p, h, positions, causal=False,
                                  lc=lc), {}
    if ls.mixer == "rwkv":
        if mode == "decode":
            o, st, xp = rwkv.time_mix_step(cfg, p, h, cache["state"],
                                           cache["xp_tm"], lc)
            return o, {"state": st, "xp_tm": xp}
        if mode == "prefill":
            o, st, xp = rwkv.time_mix_full(cfg, p, h, chunk=cfg.rwkv_chunk,
                                           return_state=True, lc=lc)
            st = rwkv._state_layout(p, st, cfg.d_model // cfg.rwkv_head_dim,
                                    cfg.rwkv_head_dim, lc)
            return o, {"state": st, "xp_tm": xp}
        return rwkv.time_mix_full(cfg, p, h, chunk=cfg.rwkv_chunk,
                                  lc=lc), {}
    if ls.mixer == "mamba":
        if mode == "decode":
            o, st, cv = mamba.mamba_step(cfg, p, h, cache["ssm"],
                                         cache["conv"], lc)
            return o, {"ssm": st, "conv": cv}
        if mode == "prefill":
            o, st, cv = mamba.mamba_full(cfg, p, h, chunk=cfg.mamba_chunk,
                                         return_state=True, ctx=lc)
            return o, {"ssm": st, "conv": cv}
        return mamba.mamba_full(cfg, p, h, chunk=cfg.mamba_chunk,
                                ctx=lc), {}
    if ls.mixer == "mla":
        if mode == "decode":
            return attention.mla_decode(cfg, p, h, cache, cache_len,
                                        positions, lc)
        if mode == "prefill":
            return attention.mla_full(cfg, p, h, positions,
                                      return_cache=True, lc=lc)
        return attention.mla_full(cfg, p, h, positions, lc=lc), {}
    if mode == "decode":
        return attention.gqa_decode(cfg, p, h, cache, cache_len, positions,
                                    lc)
    if mode == "prefill":
        return attention.gqa_prefill(cfg, p, h, positions, lc)
    return attention.gqa_full(cfg, p, h, positions, causal=True,
                              lc=lc), {}


def _cross(cfg, p, hx, *, mode, cache, enc_out, lc=None):
    """The cross sublayer: (output, new cache entries). Decode reads `ck`
    / `cv` from the cache and returns the same tensors; prefill computes
    them from `enc_out` once, attends over them and returns them; train
    attends over `enc_out` (`attention.cross_full`)."""
    if mode == "decode":
        return (_cross_decode(cfg, p, hx, cache["ck"], cache["cv"], lc),
                {"ck": cache["ck"], "cv": cache["cv"]})
    if enc_out is None:
        raise ValueError(f"{cfg.name}: an encoder-decoder model needs "
                         f"`frames` in {mode} mode")
    if lc is not None:
        enc_out = lc.enter(enc_out) if lc.sharded else enc_out
    ck, cv = attention.cross_kv(cfg, p, enc_out, lc)
    o = attention.cross_attend(cfg, p, hx, ck, cv, lc)
    if mode != "prefill":
        return o, {}
    if lc is not None:
        ck, cv = attention.cross_cache(cfg, p, ck, cv, lc)
    return o, {"ck": ck, "cv": cv}


def _ffn(cfg, ls, p, h, *, mode, cache, lc=None):
    """The layer's FFN: (output, aux, new cache entries); the MoE's and
    the dense FFNs' outputs are partial on a sharded block (the caller
    exits them), the GELU MLP's output bias is added after that."""
    if ls.ffn == "moe":
        ep = lc is not None and lc.ep
        o, aux = moe._moe_local(
            cfg, p, h, lc, ep_axis=lc.tp_dim if ep else None,
            batch_axes=lc.batch_dims if lc is not None else None)
        return o, aux, {}
    if ls.ffn == "rwkv_cm":
        if mode == "decode":
            o, xp = rwkv.channel_mix_step(cfg, p, h, cache["xp_cm"], lc)
            return o, 0.0, {"xp_cm": xp}
        o = rwkv.channel_mix_full(cfg, p, h, lc=lc)
        return o, 0.0, ({"xp_cm": h[:, -1:].clone()} if mode == "prefill"
                        else {})
    if ls.ffn == "swiglu":
        return moe.swiglu(p, h), 0.0, {}
    return moe._gelu_mlp_out(p, h), 0.0, {}


def _sp_constrain(x, ctx, mode):
    """The residual stream in its layout between blocks: batch-sharded over
    the data axes, and with Megatron-SP (`sp_residual`) sharded on the
    sequence over the model axis (not in decode, nor where the model axis
    does not divide the sequence); zero3 pins `residual_spec`."""
    if ctx is None:
        return x
    want = residual_placements(ctx, mode, x.shape)
    if tuple(x.placements) != want:
        x = x.redistribute(placements=want)
    return x


def residual_placements(ctx, mode, shape) -> tuple:
    seq = (getattr(ctx, "sp_residual", False) and mode != "decode"
           and parallel.tp_dim(ctx) is not None
           and shape[1] % ctx.mesh.size(parallel.tp_dim(ctx)) == 0)
    return parallel.activation_placements(ctx, seq_dim=1 if seq else None)


def apply_layer(cfg: ModelConfig, ls: LayerSpec, p, x, *, mode: str,
                ctx: ShardCtx | None = None, positions=None,
                cache: Tree | None = None, cache_len=None, enc_out=None):
    """Returns (x, aux, new_cache); aux is the MoE layer's load-balancing
    loss (an f32 scalar), 0.0 for a dense FFN. With a `ShardCtx` the
    layer runs as one `local_map` over DTensors (`_apply_sharded`)."""
    if ctx is not None:
        return _apply_sharded(cfg, ls, p, x, mode=mode, ctx=ctx,
                              positions=positions, cache=cache,
                              cache_len=cache_len, enc_out=enc_out)
    return _apply_local(cfg, ls, p, x, mode=mode, positions=positions,
                        cache=cache, cache_len=cache_len, enc_out=enc_out)


def _apply_local(cfg, ls, p, x, *, mode, positions=None, cache=None,
                 cache_len=None, enc_out=None, lcs=None):
    """The layer on local tensors; `lcs` maps block names (mixer, cross,
    ffn) to their `parallel.Local` on a rank's shards."""
    lcs = lcs or {}
    lm, lx, lf = lcs.get("mixer"), lcs.get("cross"), lcs.get("ffn")
    norm = _norm(cfg)

    def enter(lc, h):
        return h if lc is None else lc.enter(h)

    def exit_(lc, o):
        return o if lc is None else lc.exit(o)

    o, new_cache = _mixer(cfg, ls, p["mixer"],
                          enter(lm, norm(x, p["ln1"])), mode=mode,
                          positions=positions, cache=cache,
                          cache_len=cache_len, lc=lm)
    x = x + exit_(lm, o)
    if ls.cross:
        o, c = _cross(cfg, p["cross"], enter(lx, norm(x, p["ln_x"])),
                      mode=mode, cache=cache, enc_out=enc_out, lc=lx)
        new_cache.update(c)
        x = x + exit_(lx, o)
    o, aux, c = _ffn(cfg, ls, p["ffn"], enter(lf, norm(x, p["ln2"])),
                     mode=mode, cache=cache, lc=lf)
    new_cache.update(c)
    if ls.ffn != "rwkv_cm":      # channel mixing returns its sum whole
        o = exit_(lf, o)
    if ls.ffn == "gelu":
        o = o + p["ffn"]["bo"].to(o.dtype)
    return x + o, aux, new_cache


def _cross_decode(cfg, p, x, ck, cv, lc=None):
    """One token's cross attention over the cached K/V (B, Sk, H, Dh); on
    a rank's shards, as `attention.gqa_decode` reads its cache."""
    h, hd = cfg.n_heads, cfg.head_dim
    q, q0 = attention._heads(dense(x, p["wq"]), h, hd, lc)
    if lc is not None and (lc.cache_dims or {}).get("ck") == 3:
        valid = torch.ones(ck.shape[1], dtype=torch.bool, device=ck.device)
        o = attention._split_dim_attn(cfg, q, ck, cv, valid, lc)
    elif lc is not None:
        h0, h1, _ = attention._out_heads(p, h, hd, lc)
        q, q0 = q[:, :, h0 - q0:h1 - q0], h0
        k0 = attention._first_kv(ck, h, lc)
        o = attention._grouped_attn(
            q, *(attention._kv_for_heads(t, k0, h0, h1, 1) for t in (ck, cv)),
            None)
    else:
        o = attention._grouped_attn(q, ck, cv, None)
    return attention._out(p, o, h, q0, lc)


# ---------------------------------------------------------------------------
# the sharded layer


def _mixer_tp_dims(cfg, ls, mode, ctx, cache_dims) -> dict:
    """The mixer's leaves that keep their model-dim shard inside the layer
    (tensor dim by leaf path), by what its local code splits: attention's
    and RWKV6's projections always (the rank's heads, or the activations
    of a shard that cuts a head gathered; `attention._heads`,
    `rwkv._proj`), MLA heads (where they do not split evenly, `wo`'s rows
    only: the other leaves are gathered and narrowed to the heads those
    rows read, `attention._mla_core`; in decode over an r-split latent
    cache, r), Mamba's inner dim."""
    t = parallel.tp_dim(ctx)
    if t is None:
        return {}
    n = ctx.mesh.size(t)
    if ls.mixer in ("attn", "attn_bidir"):
        return {"wq.w": 1, "wq.b": 0, "wk.w": 1, "wk.b": 0, "wv.w": 1,
                "wv.b": 0, "wo.w": 0}
    if ls.mixer == "mla":
        heads = cfg.n_heads % n == 0
        out = {"wq": 1, "wuq": 1, "wo.w": 0} if heads else {"wo.w": 0}
        if mode == "decode" and cache_dims.get("ckv") is not None:
            out.update({"wdkv.w": 1, "wuk": 0, "wuv": 0})
        elif heads:
            out.update({"wuk": (1, True), "wuv": (1, True)})
        return out
    if ls.mixer == "rwkv":
        return {"wr": 1, "wk": 1, "wv": 1, "wg": 1, "wo": 0, "u": 0}
    if ls.mixer == "mamba":
        return {"in_proj": 2, "conv_w": 1, "conv_b": 0, "x_proj": 0,
                "dt_w": 1, "dt_b": 0, "a_log": 0, "dskip": 0,
                "out_proj": 0}
    return {}


def _ffn_tp_dims(cfg, ls, ctx) -> dict:
    if parallel.tp_dim(ctx) is None:
        return {}
    if ls.ffn == "moe":
        return moe.moe_tp_dims(cfg, ctx)
    if ls.ffn == "swiglu":
        return {"wi": 2, "wo": 0}
    if ls.ffn == "gelu":
        return {"wi": 1, "bi": 0, "wo": 0}
    if ls.ffn == "rwkv_cm":
        return {"wr": 1, "wk": 1, "wv": 0}
    return {}


def _cross_tp_dims(ctx) -> dict:
    if parallel.tp_dim(ctx) is None:
        return {}
    return {"wq.w": 1, "wq.b": 0, "wk.w": 1, "wv.w": 1, "wv.b": 0,
            "wo.w": 0}


def _cache_placements(cfg, ls, ctx, b, s) -> dict:
    """{leaf: placements} of a layer's cache by the rule table."""
    spec = layer_cache_spec(cfg, ls, b, s)
    rules = ctx.rules or {}
    return {k: placements(ctx.mesh, sanitize_pspec(
        sp.shape, logical_to_pspec(sp.axes, rules), ctx.mesh))
        for k, sp in spec.items()}


def _cache_dims(ctx, cache_pl: dict) -> dict:
    """Each cache leaf's tensor dim split over the model dim; a split of a
    sequence dim over the data axes (the reference's SP decode flip) has
    no local code here."""
    from torch.distributed.tensor import Shard

    t = parallel.tp_dim(ctx)
    bd = parallel.batch_dims(ctx)
    out = {}
    for k, pl in cache_pl.items():
        out[k] = None
        for i, q in enumerate(pl):
            if not isinstance(q, Shard):
                continue
            if i == t:
                out[k] = q.dim
            elif i not in bd or q.dim != 0:
                raise NotImplementedError(
                    f"cache leaf {k} split on dim {q.dim} over mesh dim "
                    f"{ctx.mesh.mesh_dim_names[i]}: a sequence-split cache "
                    "has no local attention in the port")
    return out


def _apply_sharded(cfg, ls, p, x, *, mode, ctx, positions, cache,
                   cache_len, enc_out):
    """One layer as one `local_map`: every leaf in its compute placements,
    the blocks on the rank's shards with their `Local`, the residual, the
    cache and aux back as DTensors."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    b, s = x.shape[0], x.shape[1]
    if mode == "decode" and cache:
        seq_leaf = cache.get("k", cache.get("ckv"))
        s = seq_leaf.shape[1] if seq_leaf is not None else 1
    cache_pl = (_cache_placements(cfg, ls, ctx, b, s)
                if mode in ("prefill", "decode") else {})
    cdims = _cache_dims(ctx, cache_pl)
    x_pl = tuple(x.placements)
    seq = parallel.is_sharded(ctx, x_pl)
    if seq and (ls.ffn == "rwkv_cm" or ls.cross or ls.mixer in ("rwkv",
                                                                "mamba")):
        raise NotImplementedError(f"{ls.mixer}/{ls.ffn}: a sequence-"
                                  "parallel residual has no local code")
    tp_dims = {}
    for blk, dims in (("mixer", _mixer_tp_dims(cfg, ls, mode, ctx, cdims)),
                      ("cross", _cross_tp_dims(ctx) if ls.cross
                       else {}),
                      ("ffn", _ffn_tp_dims(cfg, ls, ctx))):
        tp_dims.update({f"{blk}.{k}": v for k, v in dims.items()})
    paths, leaves, pin, pgrad, rep = parallel.prepare_params(ctx, p, tp_dims)
    blocks = {blk: any(not r for q, r in zip(paths, rep)
                       if q.startswith(blk + "."))
              for blk in ("mixer", "cross", "ffn")}
    base = parallel.local_view(ctx, seq=seq, cache_dims=cdims)
    lcs = {blk: base.block(sh) for blk, sh in blocks.items()}
    if ls.ffn == "moe" and blocks["ffn"]:
        ep = moe.moe_axes(cfg, ctx)[1] == ctx.tp
        lcs["ffn"] = dataclasses.replace(lcs["ffn"], ep=ep)   # owner mask
    wrap = [r and (seq or (blocks.get(q.split(".")[0], False)
                           and q != "ffn.bo"))
            for q, r in zip(paths, rep)]

    ckeys = list(cache) if cache is not None else []
    acts = [x, positions, enc_out] + [cache[k] for k in ckeys]
    present = [a is not None for a in acts]
    args = [a for a in acts if a is not None]
    n = len(leaves)
    act_pl = [parallel.placements_of(a) for a in args]

    def body(*flat):
        ps = [lcs["ffn"].local_param(t) if w else t
              for t, w in zip(flat[:n], wrap)]
        it = iter(flat[n:])
        xs = [next(it) if ok else None for ok in present]
        c = dict(zip(ckeys, xs[3:])) if cache is not None else None
        y, aux, nc = _apply_local(cfg, ls, parallel.nest(paths, ps), xs[0],
                                  mode=mode, positions=xs[1], cache=c,
                                  cache_len=cache_len, enc_out=xs[2],
                                  lcs=lcs)
        if not isinstance(aux, torch.Tensor):
            aux = y.new_zeros((), dtype=torch.float32)
        return (y, aux, *[nc[k] for k in out_keys])

    out_keys = list(cache_pl)
    rep_all = tuple(Replicate() for _ in range(ctx.mesh.ndim))
    out_pl = (x_pl, rep_all, *[cache_pl[k] for k in out_keys])
    y, aux, *nc = local_map(
        body, out_placements=out_pl,
        in_placements=tuple(pin) + tuple(act_pl),
        in_grad_placements=tuple(pgrad) + tuple(act_pl),
        device_mesh=ctx.mesh)(*leaves, *args)
    return y, aux, dict(zip(out_keys, nc))


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
    (`repro/models/attention.py:83`), and only that stream is checked
    (on a DTensor, each rank its own rows; meta positions hold no
    values)."""
    if hasattr(positions, "to_local"):
        positions = positions.to_local()
    if positions.device.type == "meta":
        return
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


def _local(ctx, fn, out_pl, *args):
    """`fn` on the local shards of DTensor `args` (no parameters)."""
    from torch.distributed.tensor.experimental import local_map

    pl = tuple(parallel.placements_of(a) for a in args)
    return local_map(fn, out_placements=(out_pl,), in_placements=pl,
                     in_grad_placements=pl, device_mesh=ctx.mesh)(*args)


def encode(cfg: ModelConfig, params, frames, ctx=None):
    """Whisper's encoder over precomputed frame embeddings (B, S, D) (the
    conv frontend is the reference's stub too): the sinusoid table added,
    then `encoder_layers` bidirectional layers (each attention a
    non-causal flash call), then `enc.ln_f`. With `cfg.remat`, under
    autograd each layer is recomputed in the backward, as the decoder's."""
    b, s, d = frames.shape
    ls = _enc_layer(cfg)
    if ctx is None:
        x = frames + _sinusoid(s, d, frames.dtype, frames.device)[None]
        pos = torch.arange(s, dtype=torch.int32,
                           device=frames.device).expand(b, s)
    else:
        pl = tuple(frames.placements)
        x = _local(ctx, lambda f: f + _sinusoid(s, d, f.dtype, f.device)[None],
                   pl, frames)
        pos = _local(ctx, lambda f: torch.arange(
            s, dtype=torch.int32, device=f.device).expand(f.shape[0], s),
            parallel.activation_placements(ctx), frames)
    remat = cfg.remat and torch.is_grad_enabled()
    for layer in params["enc"]["layers"]:
        if remat:
            x = checkpoint(lambda x, layer=layer: apply_layer(
                cfg, ls, layer, x, mode="train", ctx=ctx, positions=pos)[0],
                x, use_reentrant=False)
        else:
            x = apply_layer(cfg, ls, layer, x, mode="train", ctx=ctx,
                            positions=pos)[0]
    return _final_norm(cfg, params["enc"]["ln_f"], x, ctx)


def _final_norm(cfg, w, x, ctx):
    if ctx is None:
        return _norm(cfg)(x, w)
    from torch.distributed.tensor.experimental import local_map

    seq = parallel.is_sharded(ctx, tuple(x.placements))
    lc = parallel.local_view(ctx, seq=seq)
    single = isinstance(w, torch.Tensor)
    paths, leaves, pin, pgrad, _ = parallel.prepare_params(
        ctx, {"w": w} if single else w, {})

    def body(*a):
        ws = [lc.local_param(t) if seq else t for t in a[:-1]]
        tree = parallel.nest(paths, ws)
        return _norm(cfg)(a[-1], tree["w"] if single else tree)

    xp = tuple(x.placements)
    return local_map(body, out_placements=(xp,), in_placements=(*pin, xp),
                     in_grad_placements=(*pgrad, xp),
                     device_mesh=ctx.mesh)(*leaves, x)


def _embed(cfg, params, tokens, ctx, *, mode, cache_len):
    """The token embedding (and whisper's learned positions) on local
    shards: the rank's vocab rows looked up, the others zero, summed by
    the exit (an all-reduce; with a sequence-parallel residual a
    reduce-scatter onto the rank's sequence shard)."""
    from torch.distributed.tensor.experimental import local_map

    x_pl = residual_placements(ctx, mode, tokens.shape)
    seq = parallel.is_sharded(ctx, x_pl)
    tree = {"emb": params["emb"]}
    if cfg.learned_pos:
        tree["pos_emb"] = params["pos_emb"]
    paths, leaves, pin, pgrad, rep = parallel.prepare_params(
        ctx, tree, {"emb": 0})
    sharded = not rep[0]
    lc = parallel.local_view(ctx, seq=seq).block(sharded)
    n = len(leaves)

    def body(*a):
        w = dict(zip(paths, a[:n]))
        tok = a[n].long()
        emb = w["emb"]
        if sharded:
            v = emb.shape[0]
            lo = lc.rank * v
            inside = (tok >= lo) & (tok < lo + v)
            x = emb[torch.clamp(tok - lo, 0, v - 1)]
            x = x.masked_fill(~inside[..., None], 0)
        else:
            x = emb[tok]
        x = lc.exit(x).to(cfg.dtype) if (sharded or seq) else x.to(cfg.dtype)
        if cfg.learned_pos:
            pe = lc.local_param(w["pos_emb"]) if seq else w["pos_emb"]
            if mode == "decode":
                at = min(max(int(cache_len), 0), cfg.max_position - 1)
                pe = pe[at:at + 1]
            else:
                pe = pe[:tokens.shape[-1]]
                pe = lc.take(pe, 0) if seq else pe
            x = x + pe[None].to(x.dtype)
        return x

    tp = parallel.placements_of(tokens)
    return local_map(body, out_placements=(x_pl,), in_placements=(*pin, tp),
                     in_grad_placements=(*pgrad, tp),
                     device_mesh=ctx.mesh)(*leaves, tokens)


def trunk(cfg: ModelConfig, params, tokens, *, mode: str, positions=None,
          cache: list[Tree] | None = None, cache_len=None, frames=None,
          ctx=None):
    """Everything before the output head: (final-normed hidden states
    (B, S, D), aux, new_cache). aux is the sum of the MoE layers' aux
    losses (f32). new_cache is a list of per-layer caches (see the module
    docstring) for prefill and decode, empty for train. Positions a caller
    passes for train or prefill must rise along each row (checked once
    here; M-RoPE's (3, B, S) along its w stream). An encoder-decoder model
    encodes `frames` in train and prefill (decode reads the cross K/V from
    the cache) and adds its learned positions. With `cfg.remat`, a train
    forward under autograd checkpoints each layer, its aux carried out
    beside its output. With a `ShardCtx`, tokens (and positions, frames,
    cache) are DTensors and so are the outputs."""
    if positions is not None and mode != "decode":
        _require_increasing(cfg, positions)
    if ctx is None:
        x = params["emb"][tokens.long()].to(cfg.dtype)
        if positions is None:
            positions = _default_positions(cfg, tokens, mode, cache_len)
        if cfg.learned_pos:
            if mode == "decode":     # the reference's dynamic_slice clamps
                at = min(max(int(cache_len), 0), cfg.max_position - 1)
                pe = params["pos_emb"][at:at + 1]
            else:
                pe = params["pos_emb"][:tokens.shape[-1]]
            x = x + pe[None].to(x.dtype)
    else:
        x = _embed(cfg, params, tokens, ctx, mode=mode, cache_len=cache_len)
        if positions is None:
            pdim = 1 if cfg.mrope_sections else 0
            positions = _local(
                ctx, lambda t: _default_positions(cfg, t, mode, cache_len),
                parallel.activation_placements(ctx, batch_dim=pdim), tokens)
    enc_out = None
    if cfg.is_encdec and mode != "decode" and frames is not None:
        enc_out = encode(cfg, params, frames, ctx)
    new_cache: list[Tree] = []
    aux = 0.0
    remat = cfg.remat and mode == "train" and torch.is_grad_enabled()
    for i, layer in enumerate(params["layers"]):
        ls = cfg.layer_kind(i)
        if remat:
            x, a = checkpoint(lambda x, e, ls=ls, layer=layer: apply_layer(
                cfg, ls, layer, x, mode=mode, ctx=ctx, positions=positions,
                enc_out=e)[:2], x, enc_out, use_reentrant=False)
            aux = aux + a
            continue
        x, a, nc = apply_layer(cfg, ls, layer, x, mode=mode, ctx=ctx,
                               positions=positions,
                               cache=None if cache is None else cache[i],
                               cache_len=cache_len, enc_out=enc_out)
        x = _sp_constrain(x, ctx, mode)
        aux = aux + a
        if mode in ("prefill", "decode"):
            new_cache.append(nc)
    if not isinstance(aux, torch.Tensor):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _final_norm(cfg, params["ln_f"], x, ctx), aux, new_cache


def _default_positions(cfg, tokens, mode, cache_len):
    if mode == "decode":
        pos = torch.full((tokens.shape[0], 1), int(cache_len),
                         dtype=torch.int32, device=tokens.device)
        return pos.expand(3, *pos.shape) if cfg.mrope_sections else pos
    return _positions(cfg, tokens)


def head(cfg: ModelConfig, params, x, ctx=None, *, last: bool = False):
    """The tied output head: x @ emb.T in the model dtype (with `last`,
    of the last position only). With a `ShardCtx` the logits stay
    vocab-sharded over the model axis (`steps.logits_pspec`)."""
    if ctx is None:
        x = x[:, -1:] if last else x
        return x @ params["emb"].T.to(cfg.dtype)
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.experimental import local_map

    seq = parallel.is_sharded(ctx, tuple(x.placements))
    paths, leaves, pin, pgrad, rep = parallel.prepare_params(
        ctx, {"emb": params["emb"]}, {"emb": 0})
    sharded = not rep[0]
    lc = parallel.local_view(ctx).block(sharded)
    pl = list(parallel.activation_placements(ctx))
    if sharded:
        pl[parallel.tp_dim(ctx)] = Shard(2)

    def body(emb, xl):
        if seq:          # the sequence shards' rows, gathered
            xl = lc.gather(xl[:, -1:] if last else xl, 1)
            xl = xl[:, -1:] if last else xl
        else:
            xl = lc.enter(xl[:, -1:] if last else xl)
        return xl @ emb.T.to(cfg.dtype)

    xp = tuple(x.placements)
    return local_map(body, out_placements=(tuple(pl),),
                     in_placements=(pin[0], xp),
                     in_grad_placements=(pgrad[0], xp),
                     device_mesh=ctx.mesh)(leaves[0], x)


def forward(cfg: ModelConfig, params, tokens, *, mode: str,
            ctx: ShardCtx | None = None, positions=None,
            cache: list[Tree] | None = None, cache_len=None, frames=None):
    """Unified forward. Returns (logits (B, S, V), aux, new_cache)."""
    x, aux, new_cache = trunk(cfg, params, tokens, mode=mode,
                              positions=positions, cache=cache,
                              cache_len=cache_len, frames=frames, ctx=ctx)
    return head(cfg, params, x, ctx), aux, new_cache


# ---------------------------------------------------------------------------
# sharded caches


def local_shape(shape, mesh, pls) -> tuple:
    """The local shard's shape of an evenly split DTensor."""
    from torch.distributed.tensor import Shard

    out = list(shape)
    for i, pl in enumerate(pls):
        if isinstance(pl, Shard):
            out[pl.dim] //= mesh.size(i)
    return tuple(out)


def _init_cache_sharded(cfg, params, b, s, frames, ctx):
    from torch.distributed.tensor import DTensor

    dev = params["emb"].to_local().device
    cross = {}
    if cfg.is_encdec and frames is not None:
        with torch.no_grad():
            enc_out = encode(cfg, params, frames, ctx)
            for i, layer in enumerate(params["layers"]):
                ls = cfg.layer_kind(i)
                if ls.cross:
                    cross[i] = _cross_kv_sharded(cfg, ls, layer, enc_out,
                                                 ctx, b, s)
            del enc_out
    out = []
    for i in range(cfg.n_layers):
        ls = cfg.layer_kind(i)
        spec = layer_cache_spec(cfg, ls, b, s)
        pls = _cache_placements(cfg, ls, ctx, b, s)
        c = {}
        for k, sp in spec.items():
            if k in cross.get(i, {}):
                c[k] = cross[i][k]
                continue
            loc = torch.zeros(local_shape(sp.shape, ctx.mesh, pls[k]),
                              dtype=sp.dtype, device=dev)
            c[k] = DTensor.from_local(loc, ctx.mesh, pls[k], run_check=False)
        out.append(c)
    return out


def _cross_kv_sharded(cfg, ls, layer, enc_out, ctx, b, s):
    """A layer's cross K/V from the encoder's output, in the cache's
    layout."""
    from torch.distributed.tensor.experimental import local_map

    pls = _cache_placements(cfg, ls, ctx, b, s)
    cdims = _cache_dims(ctx, pls)
    paths, leaves, pin, _, rep = parallel.prepare_params(
        ctx, layer["cross"], _cross_tp_dims(ctx))
    lc = parallel.local_view(ctx, cache_dims=cdims).block(not all(rep))
    n = len(leaves)

    def body(*a):
        p = parallel.nest(paths, a[:n])
        return attention.cross_cache(
            cfg, p, *attention.cross_kv(cfg, p, a[n], lc), lc)

    ep = tuple(enc_out.placements)
    ck, cv = local_map(body, out_placements=(pls["ck"], pls["cv"]),
                       in_placements=(*pin, ep),
                       device_mesh=ctx.mesh)(*leaves, enc_out)
    return {"ck": ck, "cv": cv}
