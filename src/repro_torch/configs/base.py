"""Model + run configuration for the assigned architecture pool."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class ModelConfig:
    name: str
    family: str                 # dense | moe | encdec | ssm | hybrid | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None          # default d_model // n_heads
    mlp_act: str = "swiglu"                 # swiglu | gelu | geglu
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    norm: str = "rmsnorm"                   # rmsnorm | layernorm
    # -- MoE --------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # 2-D expert sharding (EP x data): pays off only when per-expert weights
    # are large (dbrx d_ff=10752 yes; olmoe d_ff=1024 no — §Perf)
    moe_2d_sharding: bool = False
    # -- SSM (mamba1) -------------------------------------------------------
    d_state: int = 0
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0
    # -- hybrid (RG-LRU + local attention) -----------------------------------
    window: int = 0                         # local-attention window
    attn_every: int = 0                     # 1 attention layer per N layers
    rnn_width: int = 0                      # RG-LRU hidden width
    # -- encoder-decoder -------------------------------------------------------
    enc_layers: int = 0
    dec_layers: int = 0
    # -- VLM stub frontend -------------------------------------------------------
    n_patches: int = 0                      # precomputed patch embeddings
    vit_width: int = 0
    # -- numerics ------------------------------------------------------------------
    param_dtype: str = "bfloat16"
    pad_vocab_to: int = 256     # embedding tables pad up so vocab shards
    source: str = ""                        # provenance tag from the pool

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up so the vocab axis always divides the model mesh
        axis (padded logits are masked to -inf in layers.logits)."""
        m = self.pad_vocab_to
        return -(-self.vocab // m) * m

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    def n_params(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS = 6·N·D)."""
        d, v = self.d_model, self.vocab
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":
            per = (2 * d * self.d_inner            # in_proj (x, z)
                   + self.d_conv * self.d_inner    # conv
                   + self.d_inner * (self.dt_rank + 2 * self.d_state)
                   + self.dt_rank * self.d_inner   # dt proj
                   + self.d_inner * d)             # out_proj
            return emb // 2 + self.n_layers * per + v * d
        hd = self.hd
        attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
            + self.n_heads * hd * d
        if self.family == "moe":
            ff = self.n_experts * 3 * d * self.d_ff + d * self.n_experts
        elif self.mlp_act in ("swiglu", "geglu"):
            ff = 3 * d * self.d_ff
        else:
            ff = 2 * d * self.d_ff
        layers = self.n_layers
        if self.family == "encdec":
            layers = self.enc_layers + self.dec_layers
            attn = attn * 1.5  # decoder adds cross-attention
        if self.family == "hybrid":
            rec = (2 * d * self.rnn_width + self.d_conv * self.rnn_width
                   + 2 * self.rnn_width + self.rnn_width * d)
            n_attn = self.n_layers // self.attn_every
            n_rec = self.n_layers - n_attn
            return emb + n_attn * (attn + ff) + n_rec * (rec + ff)
        return emb + layers * (attn + ff)

    def active_params(self) -> int:
        """Active parameters per token (MoE: top-k experts only)."""
        if self.family != "moe":
            return self.n_params()
        d = self.d_model
        dense_part = self.n_params() - self.n_layers * (
            self.n_experts * 3 * d * self.d_ff)
        return dense_part + self.n_layers * self.top_k * 3 * d * self.d_ff


@dataclass
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode | long_decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "long_decode"),
}

# archs allowed to run long_500k (sub-quadratic sequence mixing)
SUBQUADRATIC = {"falcon-mamba-7b", "recurrentgemma-9b"}


def cells_for(cfg: ModelConfig) -> list[str]:
    """The dry-run cells this architecture participates in (skips noted in
    DESIGN.md §Arch-applicability)."""
    cells = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.name in SUBQUADRATIC:
        cells.append("long_500k")
    return cells
