"""llama3-8b — dense GQA kv=8, 128k vocab [arXiv:2407.21783; unverified]."""
import dataclasses
import torch
from repro_torch.configs.base import ModelConfig

def config() -> ModelConfig:
    return ModelConfig(
        name="llama3-8b", family="dense", n_layers=32, d_model=4096,
        n_heads=32, n_kv_heads=8, d_ff=14336, vocab_size=128256,
        head_dim=128, rope_theta=5e5,
        skip_shapes=("long_500k",),
    )

def smoke() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=128, dtype=torch.float32,
        q_chunk=8, remat=False)
