"""ModelConfig, the assigned input shapes and `input_specs` — port of
`repro.configs.base`.

Each architecture file instantiates `ModelConfig` as the reference's does;
`smoke()` returns the reference's reduced same-family config for CPU tests.
`dtype` is a `torch.dtype`. `input_specs()` returns `(shape, dtype)` pairs
and allocates nothing.

Every family builds a model in this package (`models.transformer`).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str                 # attn | attn_bidir | mla | rwkv | mamba
    ffn: str                   # swiglu | gelu | moe | rwkv_cm | none
    d_ff: int
    cross: bool = False        # whisper decoder cross-attention


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    qkv_bias: bool = False
    norm_type: str = "rmsnorm"
    use_rope: bool = True
    rope_theta: float = 1e6
    mrope_sections: tuple[int, ...] | None = None
    # MLA
    attn_type: str = "gqa"     # gqa | mla
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_every: int = 1         # MoE on layers where (idx % moe_every) == moe_offset
    moe_offset: int = 0
    first_dense_ff: int = 0    # deepseek: layer 0 dense with this d_ff
    moe_capacity_factor: float = 1.25
    # hybrid (jamba)
    attn_every: int = 0        # attention on layers where idx % attn_every == attn_offset
    attn_offset: int = 0
    # mamba
    mamba_d_state: int = 16
    mamba_conv: int = 4
    mamba_expand: int = 2
    # rwkv
    rwkv_head_dim: int = 64
    rwkv_mode: bool = False
    # enc-dec (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 0       # precomputed frame embeddings length
    learned_pos: bool = False  # decoder learned positions (whisper)
    max_position: int = 32768
    # numerics / exec
    dtype: Any = torch.bfloat16
    q_chunk: int = 512
    rwkv_chunk: int = 64
    mamba_chunk: int = 256
    remat: bool = True
    # shapes this arch must skip
    skip_shapes: tuple[str, ...] = ()

    # -- derived layer structure -------------------------------------------

    def decoder_layers(self) -> int:
        return self.n_layers

    def layer_kind(self, idx: int) -> LayerSpec:
        """Mixer/FFN selection for decoder layer `idx` (assignment pattern)."""
        if self.rwkv_mode:
            return LayerSpec("rwkv", "rwkv_cm", self.d_ff)
        if self.attn_every:
            mixer = "attn" if idx % self.attn_every == self.attn_offset else "mamba"
        elif self.attn_type == "mla":
            mixer = "mla"
        else:
            mixer = "attn"
        if self.first_dense_ff and idx == 0:
            return LayerSpec(mixer, "swiglu", self.first_dense_ff,
                             cross=bool(self.encoder_layers))
        if self.n_experts and idx % self.moe_every == self.moe_offset:
            ffn = "moe"
        elif self.norm_type == "layernorm":
            ffn = "gelu"
        else:
            ffn = "swiglu"
        return LayerSpec(mixer, ffn, self.d_ff, cross=bool(self.encoder_layers))

    def layer_groups(self) -> tuple[list[LayerSpec], list[LayerSpec], int]:
        """(prefix_specs, period_specs, n_periods): the reference's
        scan-over-layers grouping, which its parameter tree follows."""
        L = self.n_layers
        specs = [self.layer_kind(i) for i in range(L)]
        period = 1
        for cand in (self.attn_every or 1, self.moe_every or 1):
            period = period * cand // _gcd(period, cand)
        prefix = []
        if self.first_dense_ff:
            prefix = specs[:1]
            specs = specs[1:]
        # find smallest period that makes the remaining stack uniform
        while period < len(specs) and specs[:period] * (len(specs) // period) != specs:
            period *= 2
        if len(specs) % period != 0 or specs[:period] * (len(specs) // period) != specs:
            return prefix + specs, [], 0
        return prefix, specs[:period], len(specs) // period

    @property
    def padded_vocab(self) -> int:
        """Embedding/logits table size padded to a multiple of 128 (real ids
        < vocab_size, padded logit columns are masked in the loss and the
        sampler)."""
        return -(-self.vocab_size // 128) * 128

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def sub_quadratic(self) -> bool:
        return self.rwkv_mode or bool(self.attn_every)


def _gcd(a, b):
    while b:
        a, b = b, a % b
    return a


# ---------------------------------------------------------------------------
# assigned input shapes


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict[str, Any]:
    """`(shape, dtype)` for every model input (no allocation)."""
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    out: dict[str, Any] = {}
    if shape.kind in ("train", "prefill"):
        if cfg.is_encdec:
            out["frames"] = ((b, cfg.encoder_seq, cfg.d_model), cfg.dtype)
        out["tokens"] = ((b, s), i32)
        if shape.kind == "train":
            out["labels"] = ((b, s), i32)
        if cfg.mrope_sections:
            out["positions"] = ((3, b, s), i32)
    else:  # decode: one new token against an S-length cache/state
        out["tokens"] = ((b, 1), i32)
        out["cache_len"] = ((), i32)
    return out
