"""starcoder2-7b — dense GQA + RoPE code model [arXiv:2402.19173; hf]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b", family="dense",
    n_layers=32, d_model=4608, n_heads=36, n_kv_heads=4, d_ff=18432,
    vocab=49152, mlp_act="gelu", norm="layernorm", qkv_bias=True,
    rope_theta=1_000_000.0,
    source="arXiv:2402.19173; hf",
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=72, n_heads=6, n_kv_heads=2, d_ff=256,
        vocab=512)
