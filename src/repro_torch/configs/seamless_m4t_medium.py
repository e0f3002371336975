"""seamless-m4t-medium — enc-dec multimodal backbone [arXiv:2308.11596; hf].

The speech frontend is a STUB per the assignment: ``input_specs()`` provides
precomputed frame embeddings; this config covers the transformer backbone
(12 encoder + 12 decoder layers).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="encdec",
    n_layers=12, enc_layers=12, dec_layers=12,
    d_model=1024, n_heads=16, n_kv_heads=16, d_ff=4096,
    vocab=256206, mlp_act="gelu", norm="layernorm", qkv_bias=True,
    source="arXiv:2308.11596; hf",
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, enc_layers=2, dec_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=128, vocab=512)
