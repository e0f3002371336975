"""qwen3-32b — dense GQA with qk_norm, head_dim 128 [hf:Qwen/Qwen3-8B; hf]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=64, n_kv_heads=8, d_ff=25600,
    vocab=151936, head_dim=128, mlp_act="swiglu", qk_norm=True,
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen3-8B; hf",
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=192,
        vocab=512, head_dim=32)
