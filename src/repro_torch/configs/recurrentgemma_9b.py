"""recurrentgemma-9b — RG-LRU + local attention hybrid, 1 attn : 2 recurrent
[arXiv:2402.19427; unverified]. MQA (kv=1), window 2048."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, d_ff=12288,
    vocab=256000, head_dim=256, mlp_act="geglu",
    window=2048, attn_every=3, rnn_width=4096, d_conv=4,
    source="arXiv:2402.19427; unverified",
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=1, d_ff=128,
        vocab=512, head_dim=16, window=32, rnn_width=64)
