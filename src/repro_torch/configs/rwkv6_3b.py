"""rwkv6-3b — Finch, data-dependent decay, attention-free [arXiv:2404.05892; hf]."""
import dataclasses
import torch
from repro_torch.configs.base import ModelConfig

def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-3b", family="ssm", n_layers=32, d_model=2560,
        n_heads=40, n_kv_heads=40, d_ff=8960, vocab_size=65536,
        head_dim=64, rwkv_head_dim=64, rwkv_mode=True,
        norm_type="layernorm", use_rope=False,
        skip_shapes=(),  # attention-free: long_500k runs
    )

def smoke() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=64, n_heads=2, n_kv_heads=2,
        rwkv_head_dim=32, d_ff=128, vocab_size=128, dtype=torch.float32,
        rwkv_chunk=8, remat=False)
