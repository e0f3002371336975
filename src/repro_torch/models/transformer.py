"""Decoder-only dense transformer (starcoder2 / phi3 / qwen3 / qwen2 and the
LM half of internvl2).  Layers are stacked along a leading axis, as in the
reference; where the reference scans over that axis, the port loops over
the layer index.  Forward and serving only: the loss, remat and the int8
KV cache come with later slices.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
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


def layer_params(params, i: int) -> dict:
    """Layer ``i``'s slice of the stacked layer tree (views, no copy)."""
    def take(node):
        if isinstance(node, dict):
            return {k: take(v) for k, v in node.items()}
        return node[i]
    return take(params["layers"])


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
          positions=None):
    """tokens [B, S] -> final hidden states [B, S, D]."""
    b, s = tokens.shape
    if positions is None:
        positions = _positions(b, s, tokens.device)
    x = L.embed(params["embed"], tokens)
    for i in range(cfg.n_layers):
        x, _ = _layer_fwd(cfg, impl, x, layer_params(params, i), positions)
    return L.apply_norm(params["ln_f"], x, cfg)


def forward(params, tokens, cfg: ModelConfig, impl: str = "chunked",
            positions=None):
    """tokens [B, S] -> logits [B, S, V] (training / prefill trunk)."""
    x = trunk(params, tokens, cfg, impl, positions)
    return L.logits(params["embed"], x, cfg)


# -- serving ------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None):
    """Zeroed KV cache ``{"k", "v"}`` of [L, B, Hkv, max_len, hd] on
    ``device`` (``None``: the card).  bfloat16 whatever the parameters'
    dtype, as in the reference."""
    dev = resolve_device(device, "init_cache")
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


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
