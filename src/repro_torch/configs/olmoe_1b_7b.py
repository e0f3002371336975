"""olmoe-1b-7b — 64-expert top-8 MoE [arXiv:2409.02060; hf]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1024,
    vocab=50304, mlp_act="swiglu", qk_norm=True,
    n_experts=64, top_k=8,
    source="arXiv:2409.02060; hf",
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=64,
        vocab=512, n_experts=8, top_k=2)
