"""Assigned architecture pool: 10 configs, exact numbers from the pool list."""
from . import (dbrx_132b, falcon_mamba_7b, internvl2_1b, olmoe_1b_7b,
               phi3_mini_3_8b, qwen2_0_5b, qwen3_32b, recurrentgemma_9b,
               seamless_m4t_medium, starcoder2_7b)
from .base import SHAPES, ModelConfig, ShapeConfig, cells_for

ARCHS = {
    "seamless-m4t-medium": seamless_m4t_medium,
    "internvl2-1b": internvl2_1b,
    "olmoe-1b-7b": olmoe_1b_7b,
    "dbrx-132b": dbrx_132b,
    "starcoder2-7b": starcoder2_7b,
    "phi3-mini-3.8b": phi3_mini_3_8b,
    "qwen3-32b": qwen3_32b,
    "qwen2-0.5b": qwen2_0_5b,
    "recurrentgemma-9b": recurrentgemma_9b,
    "falcon-mamba-7b": falcon_mamba_7b,
}


def get_config(name: str) -> ModelConfig:
    return ARCHS[name].CONFIG


def get_reduced(name: str) -> ModelConfig:
    return ARCHS[name].reduced()
