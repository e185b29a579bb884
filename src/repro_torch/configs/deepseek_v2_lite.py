"""deepseek-v2-lite-16b — MLA kv_lora=512 + MoE 2 shared + 64 routed top-6
[arXiv:2405.04434; hf]. Assignment text lists both "64e" and "160 routed";
160 is DeepSeek-V2-236B — the Lite config has 64 routed (followed here, as
in `repro.configs`). Layer 0 is dense (d_ff 10944)."""
import dataclasses
import torch
from repro_torch.configs.base import ModelConfig

def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-16b", family="moe", n_layers=27, d_model=2048,
        n_heads=16, n_kv_heads=16, d_ff=1408, vocab_size=102400,
        attn_type="mla", q_lora_rank=0, kv_lora_rank=512,
        qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128, head_dim=192,
        rope_theta=1e4,
        n_experts=64, n_shared_experts=2, top_k=6, moe_every=1,
        first_dense_ff=10944,
        skip_shapes=("long_500k",),
    )

def smoke() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
        kv_lora_rank=16, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
        head_dim=24, d_ff=32, first_dense_ff=128, vocab_size=128,
        n_experts=8, n_shared_experts=2, top_k=2, dtype=torch.float32,
        q_chunk=8, remat=False)
