"""Decoder-only dense transformer (starcoder2 / phi3 / qwen3 / qwen2 and the
LM half of internvl2).  Layers are stacked along a leading axis, as in the
reference; where the reference scans over that axis, the port loops over
the layer index.  Training (``loss_fn``, with the fused vocab-chunked
cross-entropy by default), the forward with remat per layer while grad is
enabled, and serving with the int8 KV cache.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..kernels import ops as kops
from . import layers as L
from .params import resolve_device, stack


def layer_spec(cfg: ModelConfig) -> dict:
    return {
        "ln1": L.norm_spec(cfg),
        "attn": L.attn_spec(cfg),
        "ln2": L.norm_spec(cfg),
        "mlp": L.mlp_spec(cfg),
    }


def model_spec(cfg: ModelConfig) -> dict:
    return {
        "embed": L.embed_spec(cfg),
        "layers": stack(layer_spec(cfg), cfg.n_layers),
        "ln_f": L.norm_spec(cfg),
    }


def layer_params(params, i: int, key: str = "layers") -> dict:
    """Layer ``i``'s slice of the stacked tree ``params[key]`` (views, no
    copy)."""
    def take(node):
        if isinstance(node, dict):
            return {k: take(v) for k, v in node.items()}
        return node[i]
    return take(params[key])


def unstack(node) -> list:
    """Every layer's slice of a stacked tree, as a list of trees: views
    from one ``unbind`` a leaf, whose backward stacks the layers' grads
    once (indexing a layer at a time would write a zero-filled stacked
    grad per layer)."""
    if isinstance(node, dict):
        per_key = {k: unstack(v) for k, v in node.items()}
        n = len(next(iter(per_key.values())))
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    return list(torch.unbind(node))


def _layer_fwd(cfg: ModelConfig, impl: str, x, lp, positions):
    h, kv = L.attention(lp["attn"], L.apply_norm(lp["ln1"], x, cfg), cfg,
                        positions=positions, impl=impl)
    x = x + h
    x = x + L.mlp(lp["mlp"], L.apply_norm(lp["ln2"], x, cfg), cfg)
    return x, kv


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32,
                        device=device)[None].expand(b, s)


def trunk(params, tokens, cfg: ModelConfig, impl: str = "chunked",
          remat: bool = True, positions=None):
    """tokens [B, S] -> final hidden states [B, S, D].  With ``remat``
    each layer is recomputed in the backward (only while grad is
    enabled)."""
    b, s = tokens.shape
    if positions is None:
        positions = _positions(b, s, tokens.device)
    x = L.embed(params["embed"], tokens)
    for lp in unstack(params["layers"]):
        x = L.remat(_layer_fwd, cfg, impl, x, lp, positions,
                    enabled=remat)[0]
    return L.apply_norm(params["ln_f"], x, cfg)


def forward(params, tokens, cfg: ModelConfig, impl: str = "chunked",
            remat: bool = True, positions=None):
    """tokens [B, S] -> logits [B, S, V] (training / prefill trunk)."""
    x = trunk(params, tokens, cfg, impl, remat, positions)
    return L.logits(params["embed"], x, cfg)


def loss_fn(params, batch, cfg: ModelConfig, impl: str = "chunked",
            fused: bool = True):
    """Mean next-token cross-entropy of ``batch["tokens"]`` [B, S]: fused
    over vocab chunks from the final hidden states, or (``fused=False``)
    from the full float32 logits."""
    if fused:
        x = trunk(params, batch["tokens"], cfg, impl=impl)
        return L.fused_xent_loss(params["embed"], x, batch["tokens"], cfg)
    lg = forward(params, batch["tokens"], cfg, impl=impl)
    return L.xent_loss(lg[:, :-1], batch["tokens"][:, 1:])


# -- serving ------------------------------------------------------------------

def abstract_cache(cfg: ModelConfig, batch: int, max_len: int,
                   dtype=torch.bfloat16):
    """The KV cache ``{"k", "v"}`` of [L, B, Hkv, max_len, hd] as tensors on
    the ``meta`` device (the dry-run's arguments)."""
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.hd)
    meta = torch.device("meta")
    return {"k": torch.empty(shape, dtype=dtype, device=meta),
            "v": torch.empty(shape, dtype=dtype, device=meta)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None):
    """Zeroed KV cache ``{"k", "v"}`` of [L, B, Hkv, max_len, hd] on
    ``device`` (``None``: the card).  bfloat16 whatever the parameters'
    dtype, as in the reference."""
    dev = resolve_device(device, "init_cache")
    return {k: torch.zeros(t.shape, dtype=t.dtype, device=dev)
            for k, t in abstract_cache(cfg, batch, max_len, dtype).items()}


def prefill(params, tokens, cfg: ModelConfig, max_len: int,
            impl: str = "chunked"):
    """Run the trunk over a prompt, returning (logits_last, cache, position)."""
    b, s = tokens.shape
    positions = _positions(b, s, tokens.device)
    x = L.embed(params["embed"], tokens)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        x, (k, v) = _layer_fwd(cfg, impl, x, layer_params(params, i),
                               positions)
        pad = max_len - s
        ks.append(torch.nn.functional.pad(k, (0, 0, 0, pad)))
        vs.append(torch.nn.functional.pad(v, (0, 0, 0, pad)))
    x = L.apply_norm(params["ln_f"], x, cfg)
    lg = L.logits(params["embed"], x[:, -1:], cfg)
    return (lg, {"k": torch.stack(ks), "v": torch.stack(vs)},
            torch.full((b,), s, dtype=torch.int32, device=tokens.device))


def decode_step(params, token, cache, position, cfg: ModelConfig):
    """One token for the whole batch. token [B, 1]; position [B]."""
    x = L.embed(params["embed"], token)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        h, nk, nv = L.decode_attention_step(
            lp["attn"], L.apply_norm(lp["ln1"], x, cfg), cfg,
            cache["k"][i], cache["v"][i], position)
        x = x + h
        x = x + L.mlp(lp["mlp"], L.apply_norm(lp["ln2"], x, cfg), cfg)
        ks.append(nk)
        vs.append(nv)
    x = L.apply_norm(params["ln_f"], x, cfg)
    lg = L.logits(params["embed"], x, cfg)
    return lg, {"k": torch.stack(ks), "v": torch.stack(vs)}, position + 1


# ---------------------------------------------------------------------------
# int8 KV cache (decode is bound by streaming the KV cache; int8 values with
# a per-vector bf16 scale halve the dominant memory term)
# ---------------------------------------------------------------------------

def abstract_cache_q8(cfg: ModelConfig, batch: int, max_len: int):
    """The int8 cache's shapes and dtypes, as tensors on the ``meta``
    device: ``k``/``v`` int8 [L, B, Hkv, max_len, hd], ``ks``/``vs`` bf16
    [L, B, Hkv, max_len]."""
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.hd)
    sshape = shape[:-1]
    meta = torch.device("meta")
    return {"k": torch.empty(shape, dtype=torch.int8, device=meta),
            "v": torch.empty(shape, dtype=torch.int8, device=meta),
            "ks": torch.empty(sshape, dtype=torch.bfloat16, device=meta),
            "vs": torch.empty(sshape, dtype=torch.bfloat16, device=meta)}


def init_cache_q8(cfg: ModelConfig, batch: int, max_len: int, device=None):
    """The zeroed int8 cache on ``device`` (``None``: the card)."""
    dev = resolve_device(device, "init_cache_q8")
    return {k: torch.zeros(t.shape, dtype=t.dtype, device=dev)
            for k, t in abstract_cache_q8(cfg, batch, max_len).items()}


def _quantize_vec(x):
    """x [..., hd] -> (int8 [..., hd], bf16 scale [...]): per-vector absmax
    over 127, rounded half to even (``jnp.round``'s rule and
    ``torch.round``'s)."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(-1) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale.to(torch.bfloat16)


def decode_step_q8(params, token, cache, position, cfg: ModelConfig):
    """One-token decode against the int8 cache: the new position's K/V
    vectors are quantized on write; the cache is dequantized to bf16 for
    the grouped full-softmax attention, as in the reference."""
    x = L.embed(params["embed"], token)
    b = x.shape[0]
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    new = {"k": [], "v": [], "ks": [], "vs": []}
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        h_in = L.apply_norm(lp["ln1"], x, cfg)
        q, k, v = L._project_qkv(lp["attn"], h_in, cfg, position[:, None])
        knew, ksnew = _quantize_vec(k)             # [B,H,1,hd], [B,H,1]
        vnew, vsnew = _quantize_vec(v)
        kq = L._cache_write(cache["k"][i], knew, position)
        vq = L._cache_write(cache["v"][i], vnew, position)
        ks = L._cache_write(cache["ks"][i], ksnew, position)   # [B,H,S]
        vs = L._cache_write(cache["vs"][i], vsnew, position)
        kd = kq.to(torch.bfloat16) * ks[..., None]
        vd = vq.to(torch.bfloat16) * vs[..., None]
        lengths = torch.clamp(position + 1, max=kq.shape[2])
        out = kops._grouped_ref(q.reshape(b, hkv, hq // hkv, 1, cfg.hd),
                                kd, vd, causal=False, lengths=lengths)
        out = out.reshape(b, hq, 1, cfg.hd).transpose(1, 2) \
            .reshape(b, 1, -1).to(x.dtype)
        x = x + out @ lp["attn"]["wo"]
        x = x + L.mlp(lp["mlp"], L.apply_norm(lp["ln2"], x, cfg), cfg)
        for key, t in (("k", kq), ("v", vq), ("ks", ks), ("vs", vs)):
            new[key].append(t)
    x = L.apply_norm(params["ln_f"], x, cfg)
    return (L.logits(params["embed"], x, cfg),
            {k: torch.stack(v) for k, v in new.items()}, position + 1)
