"""Shared transformer building blocks: norms, RoPE, GQA attention (prefill
and decode), gated MLPs, embeddings.  Plain functions over param dicts of
torch tensors; each follows its inputs' device and dtype.

Attention implementations (``impl``):
  * "naive"   — full S×S scores (``ops.mha(impl="ref")``);
  * "chunked" — flash-style loop over KV blocks in plain torch;
  * "kernel"  — the hand-written flash attention kernel on a CUDA tensor,
                its plain torch version on a CPU tensor (the reference's
                "pallas" route).
With a window shorter than the sequence, ``attention`` runs the banded
``_windowed_attention`` in plain torch whatever the impl (the reference has
no kernel for it).
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

    With ``window`` and S > window, every impl runs the banded
    :func:`_windowed_attention` (the reference's ``"naive"`` computes full
    attention first and then overwrites it with the banded result; the port
    skips the wasted work).  Otherwise ``ops.mha`` with ``impl``.

    The reference reshards the batch over (data x model) here when the head
    count does not divide a model mesh axis.  On one device the model axis
    is 1 (no active mesh), so that branch never runs, and the port leaves
    it out; it returns with the distribution slice."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg, positions)
    if kv_override is not None:
        k, v = kv_override
    if window and s > window:
        out = _windowed_attention(q, k, v, window)
    else:
        out = kops.mha(q, k, v, causal=causal,
                       impl="ref" if impl == "naive" else impl)
    out = out.transpose(1, 2).reshape(b, s, -1).to(x.dtype)
    return out @ p["wo"], (k, v)


def _windowed_attention(q, k, v, window: int):
    """Banded causal attention: each query block attends to its own and the
    previous KV block (block = window), masked to the exact window — O(S·W).
    q [B, Hq, S, D], k/v [B, Hkv, S, D] (kv heads repeated to q's), float32
    scores and softmax, out in q's dtype.  Any S >= 1: the last block is
    padded with zeros, which the causal mask hides from every real query
    (the reference reshapes S into whole windows)."""
    b, hq, s, d = q.shape
    k, v = kops._match_heads(k, hq), kops._match_heads(v, hq)
    blk = window
    nb = -(-s // blk)
    pad = nb * blk - s
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, pad)) for t in (q, k, v))
    qb = q.reshape(b, hq, nb, blk, d)
    kb = k.reshape(b, hq, nb, blk, d)
    vb = v.reshape(b, hq, nb, blk, d)
    kprev = torch.cat([torch.zeros_like(kb[:, :, :1]), kb[:, :, :-1]], 2)
    vprev = torch.cat([torch.zeros_like(vb[:, :, :1]), vb[:, :, :-1]], 2)
    k2 = torch.cat([kprev, kb], 3)                  # [b,h,nb,2W,d]
    v2 = torch.cat([vprev, vb], 3)
    sc = torch.einsum("bhnqd,bhnkd->bhnqk", qb.float(), k2.float()) \
        * (1.0 / d ** 0.5)
    qi = torch.arange(blk, device=q.device)[:, None] + blk  # in the 2W frame
    ki = torch.arange(2 * blk, device=q.device)[None, :]
    ok = (ki <= qi) & (ki > qi - window)
    first = torch.arange(nb, device=q.device) == 0  # no prev block for blk 0
    mask = torch.where(first[:, None, None], (ok & (ki >= blk))[None],
                       ok[None])
    sc = torch.where(mask[None, None], sc, -1e30)
    pr = torch.softmax(sc, dim=-1)
    out = torch.einsum("bhnqk,bhnkd->bhnqd", pr, v2.float())
    return out.reshape(b, hq, nb * blk, d)[:, :, :s].to(q.dtype)


def decode_attention_step(p, x, cfg: ModelConfig, cache_k, cache_v,
                          position, impl="chunked", window: int = 0):
    """One-token decode. x [B, 1, D]; cache [B, Hkv, S, hd]; position [B].
    Returns (out, new_cache_k, new_cache_v).  The attention over the cache
    is ``decode_mha(impl="ref")`` whatever ``impl`` says, as in the
    reference.  With ``window`` the cache is a ring: the new row goes to
    ``position % S`` and the valid length is ``min(position + 1, window)``
    (a length past S means every row)."""
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
    row ``position[b]`` of batch ``b`` replaced (also a scale cache
    [B, H, S] with kv [B, H, 1]).  Positions past the end write the last
    row, as ``lax.dynamic_update_slice`` clamps them."""
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
