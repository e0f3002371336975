"""qwen2-0.5b — dense GQA with QKV bias [arXiv:2407.10671; hf]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b", family="dense",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, d_ff=4864,
    vocab=151936, mlp_act="swiglu", qkv_bias=True, tie_embeddings=True,
    rope_theta=1_000_000.0,
    source="arXiv:2407.10671; hf",
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=160,
        vocab=512)
