"""qwen2-vl-2b — M-RoPE VLM backbone; vision frontend STUB
[arXiv:2409.12191; hf]. input_specs() supplies (3, B, S) position ids."""
import dataclasses
import torch
from repro_torch.configs.base import ModelConfig

def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-2b", family="vlm", n_layers=28, d_model=1536,
        n_heads=12, n_kv_heads=2, d_ff=8960, vocab_size=151936,
        head_dim=128, qkv_bias=True, rope_theta=1e6,
        mrope_sections=(16, 24, 24),
        skip_shapes=("long_500k",),
    )

def smoke() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=128, mrope_sections=(2, 3, 3),
        dtype=torch.float32, q_chunk=8, remat=False)
