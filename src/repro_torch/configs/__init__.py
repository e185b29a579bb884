"""Architecture registry — port of `repro.configs`: `--arch <id>` resolves
here. Every architecture of the reference is listed; llama3-8b, qwen2-7b,
qwen2.5-32b, olmoe-1b-7b, deepseek-v2-lite-16b and minicpm3-4b build a
model in this package."""

from repro_torch.configs import (
    deepseek_v2_lite, jamba_v01_52b, llama3_8b, minicpm3_4b, olmoe_1b_7b,
    qwen2_5_32b, qwen2_7b, qwen2_vl_2b, rwkv6_3b, whisper_large_v3,
)
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeSpec, input_specs

REGISTRY = {
    "rwkv6-3b": rwkv6_3b,
    "whisper-large-v3": whisper_large_v3,
    "qwen2-7b": qwen2_7b,
    "llama3-8b": llama3_8b,
    "qwen2.5-32b": qwen2_5_32b,
    "minicpm3-4b": minicpm3_4b,
    "olmoe-1b-7b": olmoe_1b_7b,
    "deepseek-v2-lite-16b": deepseek_v2_lite,
    "jamba-v0.1-52b": jamba_v01_52b,
    "qwen2-vl-2b": qwen2_vl_2b,
}

__all__ = ["REGISTRY", "SHAPES", "ModelConfig", "ShapeSpec", "get_config",
           "get_smoke", "input_specs", "list_archs"]


def get_config(name: str) -> ModelConfig:
    return REGISTRY[name].config()


def get_smoke(name: str) -> ModelConfig:
    return REGISTRY[name].smoke()


def list_archs():
    return sorted(REGISTRY)
