"""dbrx-132b — 16-expert top-4 fine-grained MoE [hf:databricks/dbrx-base; unverified]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=10752,
    vocab=100352, mlp_act="swiglu", rope_theta=500_000.0,
    n_experts=16, top_k=4, moe_2d_sharding=True,
    source="hf:databricks/dbrx-base; unverified",
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=96, n_heads=6, n_kv_heads=2, d_ff=160,
        vocab=512, n_experts=4, top_k=2)
