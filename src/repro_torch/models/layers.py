"""Shared transformer building blocks: norms, RoPE, GQA attention (train,
prefill and decode), gated MLPs, embeddings, the losses (``xent_loss`` and
the vocab-chunked ``fused_xent_loss``) and ``remat``.  Plain functions over
param dicts of torch tensors; each follows its inputs' device and dtype.

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
from torch.utils.checkpoint import checkpoint

from .. import tracing
from ..configs.base import ModelConfig
from ..distributed import sharding as _sh
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
    # every block starts here: on a mesh, the residual stream enters it
    # whole on each device of the model axis, as tensor parallelism keeps
    # it (left to itself DTensor keeps the sums of the last block's row-
    # parallel product scattered over d_model, and every product after
    # them contracts a sharded dim into another pending sum)
    x = _sh.act_hint(x, ("pod", "data"), *([None] * (x.ndim - 1)))
    if cfg.norm == "layernorm":
        return layer_norm(x, p["w"], p["b"])
    return rms_norm(x, p["w"])


def pad_dim(t, dim: int, before: int, after: int):
    """``t`` with ``before`` and ``after`` zero rows around its dim ``dim``
    (``F.pad``); on a ``DTensor``, each device pads its own shards, that dim
    whole on every device (the card's torch cannot plan DTensor's pad for
    some layouts)."""
    dim %= t.ndim
    pads = [0, 0] * (t.ndim - 1 - dim) + [before, after]
    keep = {d: d for d in range(t.ndim) if d != dim}
    return _sh.per_shard(lambda a: F.pad(a, pads), (t,), (keep,), (keep,))


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
    q = _sh.whole_heads(q, hq).reshape(b, s, hq, hd).transpose(1, 2)
    k = _sh.whole_heads(k, hkv).reshape(b, s, hkv, hd).transpose(1, 2)
    v = _sh.whole_heads(v, hkv).reshape(b, s, hkv, hd).transpose(1, 2)
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
    k = _sh.whole_heads(k, hkv).reshape(b, s, hkv, hd).transpose(1, 2)
    v = _sh.whole_heads(v, hkv).reshape(b, s, hkv, hd).transpose(1, 2)
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
    skips the wasted work).  Otherwise ``ops.mha`` with ``impl``."""
    b, s, _ = x.shape
    # Beyond-paper §Perf: when n_heads does not divide the model axis (qwen2:
    # 14 heads, starcoder2: 36 heads vs 16-way TP), attention would be
    # replicated across the model axis. Reshard the batch over (data x
    # model) for the attention body instead: every device computes a
    # disjoint batch slice with all heads local. Only when the batch
    # actually divides the full mesh (train_4k yes; prefill_32k's batch 32 <
    # 256 devices no — there the grouped path is the right one).  Without
    # an active mesh, or on one device, the branch never runs.
    full_mesh = (_sh.act_mesh_axis("pod") * _sh.act_mesh_axis("data")
                 * _sh.act_mesh_axis("model"))
    reshard = (cfg.n_heads % max(_sh.act_mesh_axis("model"), 1) != 0
               and kv_override is None
               and full_mesh > 1 and b % full_mesh == 0)
    if reshard:
        x = _sh.act_hint(x, ("pod", "data", "model"), None, None)
        if positions is not None:
            positions = _sh.act_hint(positions, ("pod", "data", "model"),
                                     None)
    q, k, v = _project_qkv(p, x, cfg, positions)
    if kv_override is not None:
        k, v = kv_override
    # On DTensors whose heads cannot stay sharded over the model axis (the
    # grouped view replicates them), DTensor left to itself shards the
    # head dim d, the contraction, and all-reduces every block of scores.
    # Shard the queries' sequence over the model axis instead, in the flat
    # layout (a grouped einsum would merge that dim away): each device
    # attends for its own queries to every key (K and V whole on every
    # device of the model axis), locally.
    model = max(_sh.act_mesh_axis("model"), 1)
    seq_shard = (not reshard and not (window and s > window)
                 and _sh.is_dtensor(q)
                 and (cfg.n_heads % model or k.shape[1] % model) != 0)
    if seq_shard:
        q = _sh.act_hint(q, ("pod", "data"), None, "model", None)
        k, v = (_sh.act_hint(t, ("pod", "data"), None, None, None)
                for t in (k, v))
    if window and s > window:
        out = _windowed_attention(q, k, v, window)
    elif impl == "naive":
        out = kops.mha(q, k, v, causal=causal, impl="ref")
    else:
        # under the batch-over-model reshard every head is local: the flat
        # (heads-in-batch) layout shards better than grouped heads
        out = kops.mha(q, k, v, causal=causal, impl=impl,
                       flat=reshard or seq_shard)
    out = _sh.merged_heads(out.transpose(1, 2).reshape(b, s, -1),
                           cfg.n_heads).to(x.dtype)
    if seq_shard:
        # back from the queries' rows to wo's rows, the features: the
        # product must not flatten a sharded sequence into the batch
        out = _sh.act_hint(out, ("pod", "data"), None, "model")
    out = out @ p["wo"]
    if reshard:
        out = _sh.act_hint(out, ("pod", "data"), None, None)
    return out, (k, v)


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
        q, k, v = (pad_dim(t, 2, 0, pad) for t in (q, k, v))
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
    Returns (out, new_cache_k, new_cache_v).  ``impl`` is not read: the
    attention over the cache takes the route :func:`_decode_route` picks
    from the cache, the hand-written ``decode_attention`` kernel on a plain
    CUDA cache (each slot's K and V read in the cache's dtype, once, up to
    its length), the grouped full-softmax attention in float32 that the
    reference runs on a CPU, meta or DTensor cache.
    With ``window`` the cache is a ring: the new row goes to
    ``position % S`` and the valid length is ``min(position + 1, window)``
    (a length past S means every row)."""
    b = x.shape[0]
    q, k, v = _project_qkv(p, x, cfg, position[:, None])
    s_cache = cache_k.shape[2]
    write_pos = position % s_cache if window else position
    with tracing.span("decode.kv"):
        ck = _cache_write(cache_k, k, write_pos)
        cv = _cache_write(cache_v, v, write_pos)
        lengths = torch.clamp(position + 1,
                              max=s_cache if not window else window)
        route = _decode_route(ck)
        if tracing.on:
            rows = b * ck.shape[1]
            if route == "kernel":
                tracing.count("decode.kernel_rows", rows)
                tracing.count("decode.keys_read",
                              lengths.clamp(max=s_cache).sum() * ck.shape[1])
                tracing.count("decode.keys_held", rows * s_cache)
            else:
                tracing.count("decode.ref_rows", rows)
        out = kops.decode_mha(q, ck, cv, lengths, impl=route)
    out = out.transpose(1, 2).reshape(b, 1, -1).to(x.dtype)
    return out @ p["wo"], ck, cv


def _decode_route(cache) -> str:
    """``"kernel"`` for a plain CUDA cache: the hand-written
    ``decode_attention``, which raises on a dtype or head dim it has no
    instance for.  ``"ref"`` for every other cache: a CPU or meta tensor,
    and a DTensor (the dry-run and the sharded decode), whose local shards
    the kernel cannot take as a whole."""
    if cache.device.type == "cuda" and not _sh.is_dtensor(cache):
        return "kernel"
    return "ref"


def _cache_write(cache, kv, position):
    """cache [B, H, S, d]; kv [B, H, 1, d]; position [B] -> a new cache with
    row ``position[b]`` of batch ``b`` replaced (also a scale cache
    [B, H, S] with kv [B, H, 1]).  Positions past the end write the last
    row, as ``lax.dynamic_update_slice`` clamps them."""
    pos = position.long().clamp(0, cache.shape[2] - 1)
    # a masked select: on a DTensor each shard writes its own rows whatever
    # dim the cache is sharded on (DTensor writes rows in place only into a
    # dim that is whole on every device); tools/probe_cache_write.py times
    # it against a clone and an indexed write on the card
    rows = torch.arange(cache.shape[2], device=cache.device)
    hit = rows[None, :] == pos[:, None]                          # [B, S]
    hit = hit.reshape((hit.shape[0], 1, hit.shape[1])
                      + (1,) * (cache.ndim - 3))
    return torch.where(hit, kv.to(cache.dtype), cache)


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
    # on a DTensor, the vocab-parallel lookup: each device looks up the
    # rows its vocab shard holds, and one all-reduce sums them at once (its
    # masked pending sum can be reduced only once), as GSPMD partitions the
    # gather; an index would move the table instead
    return _sh.reduce_lookup(F.embedding(tokens, p["tok"]))


def logits(p, x, cfg: ModelConfig):
    w = p["tok"].T if cfg.tie_embeddings else p["unembed"]
    lg = (x @ w.to(x.dtype)).float()
    if cfg.vocab_padded > cfg.vocab:
        # mask the padding classes out of softmax/argmax
        idx = torch.arange(cfg.vocab_padded, device=lg.device)
        lg = lg + torch.where(idx < cfg.vocab, 0.0, -1e30)
    return lg


def _label_hits(lg, labels):
    """[..., V] booleans, true at each row's label: on a ``DTensor``, laid
    out as ``lg`` (each device compares its own vocab shard)."""
    vocab = torch.arange(lg.shape[-1], device=lg.device)
    return vocab == labels[..., None]


def _picked(lg, labels):
    """``lg``'s entry at each row's label ([..., V] -> [...]): a gather on
    plain tensors; on a ``DTensor`` a masked sum over the vocab (each device
    adds its own shard's entry or zeros, then one all-reduce), as GSPMD
    partitions the gather, since DTensor's gather from a sharded vocab
    gathers the logits whole first.  The sum is exact: one entry and
    zeros."""
    if not _sh.is_dtensor(lg):
        return torch.gather(lg, -1, labels[..., None])[..., 0]
    return _sh.reduce_partial(
        torch.where(_label_hits(lg, labels), lg, 0.0).sum(-1))


def _logsumexp(lg):
    """logsumexp over the last (vocab) dim: torch's on plain tensors; on a
    ``DTensor`` a max, then an exp-sum over each device's vocab shard, with
    one all-reduce of each, as GSPMD partitions it (DTensor would gather
    the vocab whole first)."""
    if not _sh.is_dtensor(lg):
        return torch.logsumexp(lg, dim=-1)
    m = _sh.reduce_partial(lg.amax(-1, keepdim=True))
    return (m + torch.log(_sh.reduce_partial(
        torch.exp(lg - m).sum(-1, keepdim=True))))[..., 0]


def xent_loss(lg, labels, mask=None):
    """Mean next-token cross-entropy of float32 logits ``lg`` [..., V] at
    int ``labels`` [...], over ``mask`` when given."""
    lp = torch.log_softmax(lg, dim=-1)
    ll = _picked(lp, labels.long())
    if mask is None:
        return -ll.mean()
    return -(ll * mask).sum() / torch.clamp(mask.sum(), min=1)


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------

def remat(fn, *args, enabled: bool = True):
    """``fn(*args)``, recomputed in the backward instead of keeping its
    activations (``jax.checkpoint``), while grad is enabled; a plain call
    otherwise, so serving does not change."""
    if enabled and torch.is_grad_enabled():
        # no layer draws random numbers: nothing to stash for the recompute
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


# ---------------------------------------------------------------------------
# fused vocab-chunked cross-entropy
# ---------------------------------------------------------------------------
#
# Full logits are [B, S, V] in float32 (and log_softmax, and its gradient):
# at V = 152k-256k the peak-memory term of a training step.  The fused path
# never forms them: the forward walks sequence chunks keeping only (lse,
# picked-label logit); the backward recomputes each chunk's softmax and
# contracts it at once into dx and dW.  Peak extra memory: one [B, C, V]
# chunk instead of [B, S, V].

_XENT_CHUNK = 256


def _pick_chunk(s: int, chunk: int) -> int:
    """The largest divisor of ``s`` that is at most ``chunk``."""
    chunk = min(chunk, s)
    while s % chunk:
        chunk -= 1
    return chunk


def _xent_chunk_logits(x, w, pad_mask, jb: int, chunk: int):
    """Chunk ``jb``'s float32 logits [B, C, V] (masked padding)."""
    xc = x[:, jb * chunk:(jb + 1) * chunk]
    return (xc @ w.to(xc.dtype)).float() + pad_mask


class _FusedXent(torch.autograd.Function):
    """The reference's ``fused_xent`` ``custom_vjp``: the loss of hidden
    states x [B, S, D] against w [D, V] at labels [B, S], with an additive
    float32 ``pad_mask`` [V]; saves (x, w, labels, pad_mask)."""

    @staticmethod
    def forward(ctx, x, w, labels, pad_mask, chunk):
        b, s, _ = x.shape
        chunk = _pick_chunk(s, chunk)
        total = torch.zeros((), dtype=F32, device=x.device)
        for jb in range(s // chunk):
            lg = _xent_chunk_logits(x, w, pad_mask, jb, chunk)
            lc = labels[:, jb * chunk:(jb + 1) * chunk].long()
            lse = _logsumexp(lg)
            picked = _picked(lg, lc)
            total = total + torch.sum(lse - picked)
        ctx.save_for_backward(x, w, labels, pad_mask)
        ctx.chunk = chunk
        return total / (b * s)

    @staticmethod
    def backward(ctx, g):
        x, w, labels, pad_mask = ctx.saved_tensors
        chunk = ctx.chunk
        b, s, d = x.shape
        scale = g / (b * s)
        wf = w.float()
        dw = torch.zeros((d, w.shape[1]), dtype=F32, device=x.device)
        dxs = []
        for jb in range(s // chunk):
            xc = x[:, jb * chunk:(jb + 1) * chunk]
            lc = labels[:, jb * chunk:(jb + 1) * chunk].long()
            lg = _xent_chunk_logits(x, w, pad_mask, jb, chunk)
            p = torch.exp(lg - _logsumexp(lg)[..., None]) \
                if _sh.is_dtensor(lg) else torch.softmax(lg, dim=-1)
            # - one_hot: in place on plain tensors; on a DTensor, whose
            # in-place scatter_add_ gives it a layout its shards do not
            # have, each device subtracts within its own vocab shard
            if _sh.is_dtensor(p):
                p = p - _label_hits(p, lc).to(p.dtype)
            else:
                p.scatter_add_(-1, lc[..., None], torch.full(
                    lc[..., None].shape, -1.0, device=p.device))
            dxs.append((torch.einsum("bcv,dv->bcd", p, wf) * scale)
                       .to(x.dtype))
            dw = dw + torch.einsum("bcd,bcv->dv", xc.float(), p) * scale
        return torch.cat(dxs, 1), dw.to(w.dtype), None, None, None


def fused_xent(x, w, labels, pad_mask, chunk: int = _XENT_CHUNK):
    """Mean cross-entropy of ``x @ w`` (+ ``pad_mask``) at ``labels``,
    over sequence chunks of at most ``chunk`` (a divisor of S), never
    forming the [B, S, V] logits; dW comes back in w's dtype."""
    return _FusedXent.apply(x, w, labels, pad_mask, chunk)


def fused_xent_loss(embed_params, x, tokens, cfg: ModelConfig):
    """Next-token loss from final hidden states without the full logits.
    ``x`` [B, S, D] post-final-norm; ``tokens`` [B, S].  With tied
    embeddings w is ``tok``'s transpose, and the gradient reaches ``tok``
    through it."""
    w = embed_params["tok"].T if cfg.tie_embeddings \
        else embed_params["unembed"]
    vp = cfg.vocab_padded
    idx = torch.arange(vp, device=x.device)
    pad_mask = torch.where(idx < cfg.vocab, 0.0, -1e30) \
        if vp > cfg.vocab else torch.zeros(vp, device=x.device)
    return fused_xent(x[:, :-1], w, tokens[:, 1:], pad_mask)
