"""olmoe-1b-7b — 64 experts top-8 MoE [arXiv:2409.02060; hf]."""
import dataclasses
import torch
from repro_torch.configs.base import ModelConfig

def config() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b", family="moe", n_layers=16, d_model=2048,
        n_heads=16, n_kv_heads=16, d_ff=1024, vocab_size=50304,
        head_dim=128, rope_theta=1e4,
        n_experts=64, top_k=8, moe_every=1,
        skip_shapes=("long_500k",),
    )

def smoke() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        head_dim=16, d_ff=32, vocab_size=128, n_experts=8, top_k=2,
        dtype=torch.float32, q_chunk=8, remat=False)
