"""Shared transformer building blocks: norms, RoPE, GQA attention (prefill
and decode), gated MLPs, embeddings.  Plain functions over param dicts of
torch tensors; each follows its inputs' device and dtype.

Attention implementations (``impl``):
  * "naive"   — full S×S scores (``ops.mha(impl="ref")``);
  * "chunked" — flash-style loop over KV blocks in plain torch;
  * "kernel"  — the hand-written flash attention kernel on a CUDA tensor,
                its plain torch version on a CPU tensor (the reference's
                "pallas" route).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels import ops as kops
from .params import P

F32 = torch.float32


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rms_norm(x, w, eps=1e-6):
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def layer_norm(x, w, b, eps=1e-5):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * w + b


def norm_spec(cfg: ModelConfig, d: Optional[int] = None):
    d = d or cfg.d_model
    if cfg.norm == "layernorm":
        return {"w": P((d,), (None,), cfg.param_dtype, "ones"),
                "b": P((d,), (None,), cfg.param_dtype, "zeros")}
    return {"w": P((d,), (None,), cfg.param_dtype, "ones")}


def apply_norm(p, x, cfg: ModelConfig):
    if cfg.norm == "layernorm":
        return layer_norm(x, p["w"], p["b"])
    return rms_norm(x, p["w"])


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope(x, positions, theta: float):
    """x [B, H, S, D]; positions [B, S]."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=F32, device=x.device)
                      / half)
    ang = positions[:, None, :, None].to(F32) * freqs      # [B,1,S,half]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     -1).to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def attn_spec(cfg: ModelConfig) -> dict:
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = cfg.param_dtype
    s = {
        "wq": P((d, hq * hd), ("embed", "q_heads"), dt),
        "wk": P((d, hkv * hd), ("embed", "kv_heads"), dt),
        "wv": P((d, hkv * hd), ("embed", "kv_heads"), dt),
        "wo": P((hq * hd, d), ("q_heads", "embed"), dt),
    }
    if cfg.qkv_bias:
        s.update({"bq": P((hq * hd,), ("q_heads",), dt, "zeros"),
                  "bk": P((hkv * hd,), ("kv_heads",), dt, "zeros"),
                  "bv": P((hkv * hd,), ("kv_heads",), dt, "zeros")})
    if cfg.qk_norm:
        s.update({"qn": P((hd,), (None,), dt, "ones"),
                  "kn": P((hd,), (None,), dt, "ones")})
    return s


def _project_qkv(p, x, cfg: ModelConfig, positions, use_rope=True):
    b, s, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, hq, hd).transpose(1, 2)
    k = k.reshape(b, s, hkv, hd).transpose(1, 2)
    v = v.reshape(b, s, hkv, hd).transpose(1, 2)
    if cfg.qk_norm:
        q = rms_norm(q, p["qn"])
        k = rms_norm(k, p["kn"])
    if use_rope and positions is not None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def project_kv(p, x, cfg: ModelConfig):
    """K/V-only projection (cross-attention memory), no RoPE."""
    b, s, _ = x.shape
    hkv, hd = cfg.n_kv_heads, cfg.hd
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        k, v = k + p["bk"], v + p["bv"]
    k = k.reshape(b, s, hkv, hd).transpose(1, 2)
    v = v.reshape(b, s, hkv, hd).transpose(1, 2)
    if cfg.qk_norm:
        k = rms_norm(k, p["kn"])
    return k, v


def attention(p, x, cfg: ModelConfig, positions=None, impl="chunked",
              causal=True, window: int = 0, kv_override=None):
    """Self (or cross, via kv_override=(k, v)) attention over full sequences
    (train/prefill). Returns (out [B,S,D_model], (k, v) for caching).

    The reference reshards the batch over (data x model) here when the head
    count does not divide a model mesh axis.  On one device the model axis
    is 1 (no active mesh), so that branch never runs, and the port leaves
    it out; it returns with the distribution slice."""
    if window:
        raise NotImplementedError(
            "local (windowed) attention comes with the hybrid family "
            "(ROADMAP Queue 1 item 5, models/rglru.py)")
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg, positions)
    if kv_override is not None:
        k, v = kv_override
    out = kops.mha(q, k, v, causal=causal,
                   impl="ref" if impl == "naive" else impl)
    out = out.transpose(1, 2).reshape(b, s, -1).to(x.dtype)
    return out @ p["wo"], (k, v)


def decode_attention_step(p, x, cfg: ModelConfig, cache_k, cache_v,
                          position, impl="chunked", window: int = 0):
    """One-token decode. x [B, 1, D]; cache [B, Hkv, S, hd]; position [B].
    Returns (out, new_cache_k, new_cache_v).  The attention over the cache
    is ``decode_mha(impl="ref")`` whatever ``impl`` says, as in the
    reference."""
    b = x.shape[0]
    q, k, v = _project_qkv(p, x, cfg, position[:, None])
    s_cache = cache_k.shape[2]
    write_pos = position % s_cache if window else position
    ck = _cache_write(cache_k, k, write_pos)
    cv = _cache_write(cache_v, v, write_pos)
    lengths = torch.clamp(position + 1,
                          max=s_cache if not window else window)
    out = kops.decode_mha(q, ck, cv, lengths, impl="ref")
    out = out.transpose(1, 2).reshape(b, 1, -1).to(x.dtype)
    return out @ p["wo"], ck, cv


def _cache_write(cache, kv, position):
    """cache [B, H, S, d]; kv [B, H, 1, d]; position [B] -> a new cache with
    row ``position[b]`` of batch ``b`` replaced.  Positions past the end
    write the last row, as ``lax.dynamic_update_slice`` clamps them."""
    out = cache.clone()
    rows = torch.arange(cache.shape[0], device=cache.device)
    pos = position.long().clamp(0, cache.shape[2] - 1)
    out[rows, :, pos] = kv[:, :, 0]
    return out


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp_spec(cfg: ModelConfig, d_ff: Optional[int] = None) -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    dt = cfg.param_dtype
    if cfg.mlp_act in ("swiglu", "geglu"):
        return {"wg": P((d, f), ("embed", "ff"), dt),
                "wu": P((d, f), ("embed", "ff"), dt),
                "wd": P((f, d), ("ff", "embed"), dt)}
    return {"wu": P((d, f), ("embed", "ff"), dt),
            "wd": P((f, d), ("ff", "embed"), dt)}


def mlp(p, x, cfg: ModelConfig):
    # jax.nn.gelu's default is the tanh approximation
    if cfg.mlp_act == "swiglu":
        h = F.silu((x @ p["wg"]).float()) * (x @ p["wu"]).float()
    elif cfg.mlp_act == "geglu":
        h = F.gelu((x @ p["wg"]).float(), approximate="tanh") \
            * (x @ p["wu"]).float()
    else:
        h = F.gelu((x @ p["wu"]).float(), approximate="tanh")
    return h.to(x.dtype) @ p["wd"]


# ---------------------------------------------------------------------------
# embeddings & logits
# ---------------------------------------------------------------------------

def embed_spec(cfg: ModelConfig) -> dict:
    dt = cfg.param_dtype
    vp = cfg.vocab_padded
    s = {"tok": P((vp, cfg.d_model), ("vocab", "embed"), dt)}
    if not cfg.tie_embeddings:
        s["unembed"] = P((cfg.d_model, vp), ("embed", "vocab"), dt)
    return s


def embed(p, tokens):
    return p["tok"][tokens]


def logits(p, x, cfg: ModelConfig):
    w = p["tok"].T if cfg.tie_embeddings else p["unembed"]
    lg = (x @ w.to(x.dtype)).float()
    if cfg.vocab_padded > cfg.vocab:
        # mask the padding classes out of softmax/argmax
        idx = torch.arange(cfg.vocab_padded, device=lg.device)
        lg = lg + torch.where(idx < cfg.vocab, 0.0, -1e30)
    return lg
