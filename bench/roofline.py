"""The yardstick's arithmetic: the card's published peaks, a kernel's least
time, and the model FLOPs of a prefill and of a training step.

Frozen copies of ``chip_smoke.py``'s ``PEAK_FLOPS``, ``bytes_ms`` and
``_bound`` and of its counting rule for ``flash_attention``: each input
read and each output written once, and the least time is the larger of
the operations at the type's peak and the bytes at the memory rate.
"""
from __future__ import annotations

from .model import head_dim, n_matmul_params

# NVIDIA H100 SXM data sheet, dense rates at 700 W
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
ELEMENT_BYTES = {"bfloat16": 2, "float32": 4}


def bytes_ms(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def bound_ms(flops: float, nbytes: float, dtype: str) -> tuple[float, str]:
    """The least time for the work, and whether operations or bytes set it."""
    ops_ms = flops / PEAK_FLOPS[dtype] * 1e3
    mem_ms = bytes_ms(nbytes)
    return (ops_ms, "operations") if ops_ms >= mem_ms else (mem_ms, "bytes")


def flash_bound_ms(bhq: int, bhkv: int, sq: int, skv: int, d: int,
                   causal: bool, dtype: str) -> float:
    """``flash_attention``'s least time: 4 D flops per (query, key) pair it
    must see (top-left causal: key j <= query i), q and out once per query
    row, k and v once per kv row."""
    if causal:
        pairs = sq * (sq + 1) // 2 if sq <= skv \
            else skv * (skv + 1) // 2 + (sq - skv) * skv
    else:
        pairs = sq * skv
    size = ELEMENT_BYTES[dtype]
    flops = 4.0 * bhq * pairs * d
    nbytes = 2 * bhq * sq * d * size + 2 * bhkv * skv * d * size
    return bound_ms(flops, nbytes, dtype)[0]


def prefill_flops(cfg: dict, s: int) -> float:
    """Model FLOPs of one prompt of ``s`` tokens at batch 1: 2 N_active a
    token through the layers, causal attention 2 L H_q d_head S^2 (QK^T and
    PV over the S(S+1)/2 pairs, rounded to S^2/2 each), and the head once
    for the last token."""
    d, v = cfg["hidden_size"], cfg["vocab_size"]
    n_layers = n_matmul_params(cfg) - d * v
    attn = 2 * cfg["num_hidden_layers"] * cfg["num_attention_heads"] \
        * head_dim(cfg) * s * s
    return 2.0 * n_layers * s + attn + 2.0 * d * v


def train_flops_per_token(cfg: dict, seq_len: int) -> float:
    """6 N + 6 L S (H_q d_head) a token: N every matrix that multiplies
    activations, the tied head included; the attention term is PaLM's
    (arXiv:2204.02311, App. B) 12 L H Q T halved for the causal mask."""
    return 6.0 * n_matmul_params(cfg) + 6.0 * cfg["num_hidden_layers"] \
        * seq_len * cfg["num_attention_heads"] * head_dim(cfg)
