"""jamba-v0.1-52b — Mamba+attn 1:7 interleave, MoE 16e top-2 every other
layer [arXiv:2403.19887; hf]. No positional encoding (per the release).
Period-8 pattern: attention at in-period index 4, MoE on odd layers."""
import dataclasses
import torch
from repro_torch.configs.base import ModelConfig

def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b", family="hybrid", n_layers=32, d_model=4096,
        n_heads=32, n_kv_heads=8, d_ff=14336, vocab_size=65536,
        head_dim=128, use_rope=False,
        n_experts=16, top_k=2, moe_every=2, moe_offset=1,
        attn_every=8, attn_offset=4,
        mamba_d_state=16, mamba_conv=4, mamba_expand=2,
        skip_shapes=(),  # hybrid: long_500k runs (seq-sharded KV, O(1) SSM)
    )

def smoke() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=8, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=64, vocab_size=128, n_experts=4, top_k=2,
        attn_every=4, attn_offset=2, mamba_d_state=4, mamba_conv=2,
        dtype=torch.float32, q_chunk=8, mamba_chunk=8, remat=False)
