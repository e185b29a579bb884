"""qwen2.5-32b — dense GQA kv=8, QKV bias [hf:Qwen/Qwen2.5-0.5B; hf]."""
import dataclasses
import torch
from repro_torch.configs.base import ModelConfig

def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-32b", family="dense", n_layers=64, d_model=5120,
        n_heads=40, n_kv_heads=8, d_ff=27648, vocab_size=152064,
        head_dim=128, qkv_bias=True, rope_theta=1e6,
        skip_shapes=("long_500k",),
    )

def smoke() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=128, dtype=torch.float32,
        q_chunk=8, remat=False)
