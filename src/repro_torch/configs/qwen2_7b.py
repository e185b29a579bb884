"""qwen2-7b — dense GQA kv=4, QKV bias [arXiv:2407.10671; hf]."""
import dataclasses
import torch
from repro_torch.configs.base import ModelConfig

def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-7b", family="dense", n_layers=28, d_model=3584,
        n_heads=28, n_kv_heads=4, d_ff=18944, vocab_size=152064,
        head_dim=128, qkv_bias=True, rope_theta=1e6,
        skip_shapes=("long_500k",),
    )

def smoke() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=128, dtype=torch.float32,
        q_chunk=8, remat=False)
