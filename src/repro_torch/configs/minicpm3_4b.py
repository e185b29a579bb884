"""minicpm3-4b — MLA (q_lora 768, kv_lora 256) [hf:openbmb/MiniCPM3-4B; hf].
Depth/width-scaled residual (muP-style) omitted — orthogonal to systems scope."""
import dataclasses
import torch
from repro_torch.configs.base import ModelConfig

def config() -> ModelConfig:
    return ModelConfig(
        name="minicpm3-4b", family="dense", n_layers=62, d_model=2560,
        n_heads=40, n_kv_heads=40, d_ff=6400, vocab_size=73448,
        attn_type="mla", q_lora_rank=768, kv_lora_rank=256,
        qk_nope_dim=64, qk_rope_dim=32, v_head_dim=64, head_dim=96,
        rope_theta=1e4,
        skip_shapes=("long_500k",),
    )

def smoke() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16, qk_rope_dim=8,
        v_head_dim=16, head_dim=24, d_ff=128, vocab_size=128,
        dtype=torch.float32, q_chunk=8, remat=False)
