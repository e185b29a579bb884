"""Analytic MODEL_FLOPS, parameter counts and the HBM byte floor per
(config, shape) — port of `repro.utils.flops`.

MODEL_FLOPS is the **useful** compute: 6·N·D for training (N = active
non-embedding params, D = tokens), 2·N·D for inference, plus the attention
score/value terms and the logits matmul. `chip_smoke.py` divides it by the
card's peak rate for the LM phases' bounds.

`encdec_model_flops` and `encdec_hbm_bytes_floor` are the port's own, for
an encoder-decoder (whisper): the reference's pair multiplies the
encoder's and the cross K/V projections' parameters by the decoder's
tokens and leaves cross attention out; these count each by the tokens or
frames it acts on, and decode reads no encoder weight.
"""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.models import transformer
from repro_torch.models.common import count_params


def param_counts(cfg: ModelConfig) -> dict:
    """total / embedding / active (per-token) parameter counts."""
    total = count_params(transformer.model_spec(cfg))
    emb = cfg.vocab_size * cfg.d_model
    if cfg.learned_pos:
        emb += cfg.max_position * cfg.d_model
    # active = replace each MoE layer's expert bank by top_k experts + shared
    inactive = 0
    for i in range(cfg.n_layers):
        if cfg.layer_kind(i).ffn == "moe":
            per_expert = 3 * cfg.d_model * cfg.d_ff  # wi(2f)+wo
            inactive += (cfg.n_experts - cfg.top_k) * per_expert
    return {"total": total, "embedding": emb,
            "active": total - emb - inactive}


def _attn_layers(cfg: ModelConfig) -> int:
    return sum(1 for i in range(cfg.n_layers)
               if cfg.layer_kind(i).mixer in ("attn", "mla"))


def model_flops(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """Useful FLOPs of the whole step (all chips): dense, attn, logits,
    total, tokens."""
    n_act = param_counts(cfg)["active"]
    d, v = cfg.d_model, cfg.vocab_size
    b, s = shape.global_batch, shape.seq_len
    # effective per-head score+value width: GQA touches K and V of Dh each
    # (fwd = 4*S_avg*H*Dh); absorbed MLA touches the latent twice + rope keys
    eff = (cfg.head_dim if cfg.attn_type != "mla"
           else (2 * cfg.kv_lora_rank + cfg.qk_rope_dim) / 2)
    if shape.kind == "train":
        tokens = b * s
        mult = 6              # fwd 2 + bwd 4
        attn = mult * _attn_layers(cfg) * tokens * (s / 2) * 2 * (
            cfg.n_heads * eff)
        if cfg.is_encdec:
            attn += mult * cfg.encoder_layers * b * cfg.encoder_seq \
                * cfg.encoder_seq * 2 * cfg.n_heads * cfg.head_dim
        logits = mult * tokens * d * v
    elif shape.kind == "prefill":
        tokens = b * s
        mult = 2
        attn = mult * _attn_layers(cfg) * tokens * (s / 2) * 2 * (
            cfg.n_heads * eff)
        logits = mult * b * d * v          # only last position matters
    else:   # decode: one token per sequence against an s-length context
        tokens = b
        mult = 2
        attn = mult * _attn_layers(cfg) * tokens * s * 2 * (cfg.n_heads * eff)
        logits = mult * tokens * d * v
    dense = mult * tokens * n_act
    return {"dense": dense, "attn": attn, "logits": logits,
            "total": dense + attn + logits, "tokens": tokens}


def hbm_bytes_floor(cfg: ModelConfig, shape: ShapeSpec, n_chips: int) -> float:
    """Lower-bound HBM traffic per chip: weights once (bf16, sharded) + KV
    cache once (decode)."""
    wbytes = 2 * param_counts(cfg)["total"] / n_chips
    if shape.kind == "decode":
        b, s = shape.global_batch, shape.seq_len
        if cfg.attn_type == "mla":
            kv = b * s * (cfg.kv_lora_rank + cfg.qk_rope_dim) * 2 * _attn_layers(cfg)
        else:
            kv = (b * s * cfg.n_kv_heads * cfg.head_dim * 2 * 2
                  * _attn_layers(cfg))
        return wbytes + kv / n_chips
    return wbytes


def encdec_param_counts(cfg: ModelConfig) -> dict:
    """An encoder-decoder's active parameters by what they act on:
    `decoder` (each decoder token: self attention, cross wq / wo, FFN,
    norms), `encoder` (each frame: the encoder's layers and `enc.ln_f`)
    and `cross_kv` (each frame, once per request: every decoder layer's
    cross wk / wv)."""
    spec = transformer.model_spec(cfg)
    enc = count_params(spec["enc"])
    ckv = sum(count_params({k: layer["cross"][k] for k in ("wk", "wv")})
              for layer in spec["layers"].values())
    return {"decoder": param_counts(cfg)["active"] - enc - ckv,
            "encoder": enc, "cross_kv": ckv}


def encdec_model_flops(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """`model_flops`' keys for an encoder-decoder, each term at the length
    it runs over: decoder parameters x decoder tokens; the encoder's and
    the cross K/V projections' x frames (train and prefill; decode reads
    the cached cross K/V); causal self attention, cross attention over
    `encoder_seq` frames, and the encoder's full attention (train and
    prefill), as score + value products of 2·Dh each per head."""
    n = encdec_param_counts(cfg)
    d, v, hd = cfg.d_model, cfg.vocab_size, cfg.n_heads * cfg.head_dim
    b, s, f = shape.global_batch, shape.seq_len, cfg.encoder_seq
    layers, frames = _attn_layers(cfg), b * f
    if shape.kind == "decode":
        mult, tokens = 2, b
        self_attn = layers * tokens * s * 2 * hd
        frames = 0
    else:
        mult, tokens = (6, b * s) if shape.kind == "train" else (2, b * s)
        self_attn = layers * tokens * (s / 2) * 2 * hd
    attn = mult * (self_attn + layers * tokens * f * 2 * hd
                   + cfg.encoder_layers * frames * f * 2 * hd)
    dense = mult * (tokens * n["decoder"]
                    + frames * (n["encoder"] + n["cross_kv"]))
    logits = mult * (tokens if shape.kind != "prefill" else b) * d * v
    return {"dense": dense, "attn": attn, "logits": logits,
            "total": dense + attn + logits, "tokens": tokens}


def encdec_hbm_bytes_floor(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """`hbm_bytes_floor` on one card for an encoder-decoder: every weight
    once (bf16) in train and prefill; in decode the weights a step reads
    (neither the encoder's nor the cross K/V projections'), the self K/V
    of `seq_len` slots and the cross K/V of `encoder_seq` frames."""
    n = encdec_param_counts(cfg)
    total = param_counts(cfg)["total"]
    if shape.kind != "decode":
        return 2 * total
    b, s = shape.global_batch, shape.seq_len
    kv = b * (s * cfg.n_kv_heads + cfg.encoder_seq * cfg.n_heads) \
        * cfg.head_dim * 2 * 2 * _attn_layers(cfg)
    return 2 * (total - n["encoder"] - n["cross_kv"]) + kv
