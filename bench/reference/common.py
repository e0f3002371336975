"""The pieces every family's reference shares: the matrix product at a
stated precision, RMS norm, RoPE, causal grouped attention in query
blocks, and the SwiGLU MLP.  All in float32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

F32 = torch.float32
FP8_MAX = 448.0          # largest finite float8_e4m3fn


def fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale per slice along ``dim``
    (the slice's absolute maximum maps to 448), back in float32."""
    scale = t.abs().amax(dim, keepdim=True).clamp(min=1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(F32) * scale


class _StraightThrough(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim):
        return fp8(t, dim)

    @staticmethod
    def backward(ctx, g):
        return g, None


class Precision:
    """The products' precision: ``"float32"`` (the reference), ``"fp8"``
    (the control: both operands rounded to float8 e4m3, the activations
    per row and the weights per output column, products in float32; the
    gradient passes the rounding unchanged) or ``"bf16"`` (a witness of
    the served precision: operands and product rounded to bfloat16)."""

    def __init__(self, kind: str = "float32"):
        if kind not in ("float32", "fp8", "bf16"):
            raise ValueError(f"unknown precision {kind!r}")
        self.kind = kind

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``x [..., K] @ w [K, N]``."""
        if self.kind == "fp8":
            x = _StraightThrough.apply(x, -1)
            w = _StraightThrough.apply(w, 0)
        if self.kind == "bf16":
            bf = torch.bfloat16
            return (x.to(bf).to(F32) @ w.to(bf).to(F32)).to(bf).to(F32)
        return x @ w


def rms_norm(x, w, eps: float):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def rope(x, positions, theta: float):
    """x [..., S, D], rotated by halves (the first half pairs with the
    second); positions [S]."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=F32, device=x.device)
                      / half)
    ang = positions.to(F32)[:, None] * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def causal_attention(q, k, v, block: int = 1024):
    """q [B, Hq, S, D], k/v [B, Hkv, S, D] -> [B, Hq, S, D]: query i sees
    keys j <= i; query head h reads kv head h // (Hq // Hkv).  Queries in
    blocks, each against the keys up to its last query."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    qg = q.reshape(b, hkv, g, s, d)
    outs = []
    for lo in range(0, s, block):
        hi = min(s, lo + block)
        sc = torch.einsum("bhgqd,bhkd->bhgqk", qg[:, :, :, lo:hi],
                          k[:, :, :hi]) / d ** 0.5
        qi = torch.arange(lo, hi, device=q.device)[:, None]
        ki = torch.arange(hi, device=q.device)[None, :]
        sc = sc.masked_fill(ki > qi, float("-inf"))
        outs.append(torch.einsum("bhgqk,bhkd->bhgqd", torch.softmax(sc, -1),
                                 v[:, :, :hi]))
    return torch.cat(outs, 3).reshape(b, hq, s, d)


def attention_block(x, lw: dict, cfg: dict, positions, prec: Precision):
    """The attention sublayer's output (before the residual add) for x
    [B, S, d] and one layer's float32 weights ``lw``."""
    b, s, _ = x.shape
    hq, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg.get("head_dim") or cfg["hidden_size"] // hq
    q, k, v = (prec.mm(x, lw[w]) for w in ("attn.wq", "attn.wk", "attn.wv"))
    if cfg["qkv_bias"]:
        q, k, v = q + lw["attn.bq"], k + lw["attn.bk"], v + lw["attn.bv"]
    q = q.reshape(b, s, hq, hd).transpose(1, 2)
    k = k.reshape(b, s, hkv, hd).transpose(1, 2)
    v = v.reshape(b, s, hkv, hd).transpose(1, 2)
    if cfg["qk_norm"] == "per_head":
        q = rms_norm(q, lw["attn.qn"], cfg["rms_norm_eps"])
        k = rms_norm(k, lw["attn.kn"], cfg["rms_norm_eps"])
    q = rope(q, positions, cfg["rope_theta"])
    k = rope(k, positions, cfg["rope_theta"])
    o = causal_attention(q, k, v).transpose(1, 2).reshape(b, s, hq * hd)
    return prec.mm(o, lw["attn.wo"])


def swiglu(x, wg, wu, wd, prec: Precision):
    return prec.mm(F.silu(prec.mm(x, wg)) * prec.mm(x, wu), wd)


def layer_weights(w: dict, i: int) -> dict:
    """Layer ``i``'s weights in float32, keyed without ``layers.``."""
    return {p[len("layers."):]: t[i].to(F32) for p, t in w.items()
            if p.startswith("layers.")}


def head_weight(w: dict, cfg: dict) -> torch.Tensor:
    """[d, vocab] float32: the tied embedding's transpose or the unembed,
    without the padding classes."""
    v = cfg["vocab_size"]
    if cfg["tie_word_embeddings"]:
        return w["embed.tok"][:v].to(F32).T
    return w["embed.unembed"][:, :v].to(F32)
