"""internvl2-1b — InternViT stub + InternLM2/qwen2-style LM [arXiv:2404.16821; hf].

The vision frontend is a STUB per the assignment: ``input_specs()`` provides
precomputed patch embeddings (n_patches x vit_width), projected into the LM.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b", family="vlm",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, d_ff=4864,
    vocab=151655, mlp_act="swiglu", rope_theta=1_000_000.0,
    n_patches=256, vit_width=1024,
    source="arXiv:2404.16821; hf",
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab=512, n_patches=16, vit_width=48)
