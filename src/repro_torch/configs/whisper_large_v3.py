"""whisper-large-v3 — enc-dec audio backbone; conv frontend STUB
[arXiv:2212.04356; unverified]. input_specs() feeds precomputed (B,1500,D)
frame embeddings. Deviation kept from `repro.configs`: q/k/v biases are uniform
(whisper's k-proj has none); decoder positions extended past 448 to honor
the assigned 32k shapes."""
import dataclasses
import torch
from repro_torch.configs.base import ModelConfig

def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-large-v3", family="audio", n_layers=32, d_model=1280,
        n_heads=20, n_kv_heads=20, d_ff=5120, vocab_size=51866,
        head_dim=64, qkv_bias=True, norm_type="layernorm", use_rope=False,
        learned_pos=True, max_position=32768,
        encoder_layers=32, encoder_seq=1500,
        skip_shapes=("long_500k",),  # full quadratic attention
    )

def smoke() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, encoder_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=128, vocab_size=128, encoder_seq=24,
        max_position=64, dtype=torch.float32, q_chunk=8, remat=False)
