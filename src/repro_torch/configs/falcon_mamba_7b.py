"""falcon-mamba-7b — attention-free Mamba-1 SSM [arXiv:2410.05355; unverified]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=1, n_kv_heads=1, d_ff=0,
    vocab=65024, d_state=16, d_conv=4, expand=2, dt_rank=256,
    source="arXiv:2410.05355; unverified",
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, vocab=512, d_state=8, dt_rank=8)
