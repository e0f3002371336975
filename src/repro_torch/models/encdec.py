"""Encoder-decoder backbone (seamless-m4t-medium).  The speech frontend is a
stub, as in the reference: the inputs are precomputed 80-dim frame
features, and a linear adapter projects them into the encoder.

Encoder: bidirectional self-attention + MLP.  Decoder: causal
self-attention, cross-attention over the encoder output, MLP.  Layers are
stacked along a leading axis, as in the reference; where the reference
scans over that axis, the port loops over the layer index.  Training:
``loss_fn`` over the decoder tokens, with remat per encoder layer and per
decoder layer while grad is enabled.

With ``impl="kernel"`` every full-sequence attention runs the flash kernel
on a CUDA tensor: the encoder's (non-causal over the frames), the decoder's
causal self-attention, and its cross-attention in prefill (non-causal, the
prompt's queries over the encoder's keys).  Decode's cross-attention is
``decode_mha(impl="ref")``, as in the reference.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..kernels import ops as kops
from . import layers as L
from .params import P, resolve_device, stack
from .transformer import _positions, layer_params, unstack

FRAME_DIM = 80   # fbank features from the stubbed frontend


def enc_layer_spec(cfg: ModelConfig) -> dict:
    return {"ln1": L.norm_spec(cfg), "attn": L.attn_spec(cfg),
            "ln2": L.norm_spec(cfg), "mlp": L.mlp_spec(cfg)}


def dec_layer_spec(cfg: ModelConfig) -> dict:
    return {"ln1": L.norm_spec(cfg), "self": L.attn_spec(cfg),
            "ln_x": L.norm_spec(cfg), "cross": L.attn_spec(cfg),
            "ln2": L.norm_spec(cfg), "mlp": L.mlp_spec(cfg)}


def model_spec(cfg: ModelConfig) -> dict:
    return {
        "frontend": P((FRAME_DIM, cfg.d_model), (None, "embed"),
                      cfg.param_dtype),
        "embed": L.embed_spec(cfg),
        "enc": stack(enc_layer_spec(cfg), cfg.enc_layers),
        "dec": stack(dec_layer_spec(cfg), cfg.dec_layers),
        "ln_enc": L.norm_spec(cfg),
        "ln_f": L.norm_spec(cfg),
    }


def _enc_layer(cfg: ModelConfig, impl: str, x, lp, positions):
    h, _ = L.attention(lp["attn"], L.apply_norm(lp["ln1"], x, cfg), cfg,
                       positions=positions, impl=impl, causal=False)
    x = x + h
    return x + L.mlp(lp["mlp"], L.apply_norm(lp["ln2"], x, cfg), cfg)


def encode(params, frames, cfg: ModelConfig, impl: str = "chunked",
           remat: bool = True):
    """frames [B, S_enc, 80] -> encoder states [B, S_enc, D].  With
    ``remat`` each layer is recomputed in the backward (only while grad is
    enabled)."""
    b, s, _ = frames.shape
    positions = _positions(b, s, frames.device)
    x = frames.to(params["frontend"].dtype) @ params["frontend"]
    for lp in unstack(params["enc"]):
        x = L.remat(_enc_layer, cfg, impl, x, lp, positions, enabled=remat)
    return L.apply_norm(params["ln_enc"], x, cfg)


def dec_layer(cfg: ModelConfig, impl: str, x, lp, enc_out, positions):
    """One decoder layer over full sequences -> (x, (k, v), (ek, ev)): the
    self-attention's K/V and the cross-attention's encoder K/V."""
    h, kv = L.attention(lp["self"], L.apply_norm(lp["ln1"], x, cfg), cfg,
                        positions=positions, impl=impl, causal=True)
    x = x + h
    ek, ev = L.project_kv(lp["cross"], enc_out, cfg)
    h, _ = L.attention(lp["cross"], L.apply_norm(lp["ln_x"], x, cfg), cfg,
                       positions=None, impl=impl, causal=False,
                       kv_override=(ek, ev))
    x = x + h
    x = x + L.mlp(lp["mlp"], L.apply_norm(lp["ln2"], x, cfg), cfg)
    return x, kv, (ek, ev)


def trunk(params, frames, tokens, cfg: ModelConfig, impl: str = "chunked",
          remat: bool = True):
    """(frames, tokens [B, S]) -> the decoder's final hidden states."""
    enc_out = encode(params, frames, cfg, impl, remat)
    b, s = tokens.shape
    positions = _positions(b, s, tokens.device)
    x = L.embed(params["embed"], tokens)
    for lp in unstack(params["dec"]):
        x = L.remat(dec_layer, cfg, impl, x, lp, enc_out, positions,
                    enabled=remat)[0]
    return L.apply_norm(params["ln_f"], x, cfg)


def forward(params, frames, tokens, cfg: ModelConfig, impl: str = "chunked",
            remat: bool = True):
    x = trunk(params, frames, tokens, cfg, impl, remat)
    return L.logits(params["embed"], x, cfg)


def loss_fn(params, batch, cfg: ModelConfig, impl: str = "chunked",
            fused: bool = True):
    """Mean next-token cross-entropy of the decoder tokens."""
    if fused:
        x = trunk(params, batch["frames"], batch["tokens"], cfg, impl=impl)
        return L.fused_xent_loss(params["embed"], x, batch["tokens"], cfg)
    lg = forward(params, batch["frames"], batch["tokens"], cfg, impl=impl)
    return L.xent_loss(lg[:, :-1], batch["tokens"][:, 1:])


# -- serving ---------------------------------------------------------------------

def abstract_cache(cfg: ModelConfig, batch: int, max_len: int,
                   dtype=torch.bfloat16, enc_len: int = 4096):
    """The caches as tensors on the ``meta`` device: self-attention K/V
    ``{"k", "v"}`` of [L, B, Hkv, max_len, hd] and cross-attention K/V
    ``{"xk", "xv"}`` of [L, B, Hkv, enc_len, hd]."""
    kv = (cfg.dec_layers, batch, cfg.n_kv_heads, max_len, cfg.hd)
    xkv = (cfg.dec_layers, batch, cfg.n_kv_heads, enc_len, cfg.hd)
    meta = torch.device("meta")
    return {"k": torch.empty(kv, dtype=dtype, device=meta),
            "v": torch.empty(kv, dtype=dtype, device=meta),
            "xk": torch.empty(xkv, dtype=dtype, device=meta),
            "xv": torch.empty(xkv, dtype=dtype, device=meta)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, enc_len: int = 4096, device=None):
    """``abstract_cache``'s leaves zeroed on ``device`` (``None``: the
    card).  ``prefill`` returns its own, whose ``xk``/``xv`` cover its
    encoder length; decode reads the length from the cache it is given."""
    dev = resolve_device(device, "init_cache")
    return {k: torch.zeros(t.shape, dtype=t.dtype, device=dev)
            for k, t in abstract_cache(cfg, batch, max_len, dtype,
                                       enc_len).items()}


def prefill(params, frames, tokens, cfg: ModelConfig, max_len: int,
            impl: str = "chunked"):
    """Encode + run the decoder over the prompt; caches self-K/V (padded to
    ``max_len``) and cross-K/V.  -> (logits_last, cache, position)."""
    enc_out = encode(params, frames, cfg, impl)
    b, s = tokens.shape
    positions = _positions(b, s, tokens.device)
    x = L.embed(params["embed"], tokens)
    cache = {"k": [], "v": [], "xk": [], "xv": []}
    for i in range(cfg.dec_layers):
        x, (k, v), (ek, ev) = dec_layer(
            cfg, impl, x, layer_params(params, i, "dec"), enc_out, positions)
        pad = max_len - s
        cache["k"].append(L.pad_dim(k, 2, 0, pad))
        cache["v"].append(L.pad_dim(v, 2, 0, pad))
        cache["xk"].append(ek)
        cache["xv"].append(ev)
    x = L.apply_norm(params["ln_f"], x, cfg)
    return (L.logits(params["embed"], x[:, -1:], cfg),
            {k: torch.stack(v) for k, v in cache.items()},
            torch.full((b,), s, dtype=torch.int32, device=tokens.device))


def decode_step(params, token, cache, position, cfg: ModelConfig):
    """One token for the whole batch. token [B, 1]; position [B]."""
    x = L.embed(params["embed"], token)
    b = token.shape[0]
    enc_len = cache["xk"].shape[3]
    lens = torch.full((b,), enc_len, dtype=torch.int32, device=token.device)
    ks, vs = [], []
    for i in range(cfg.dec_layers):
        lp = layer_params(params, i, "dec")
        h, nk, nv = L.decode_attention_step(
            lp["self"], L.apply_norm(lp["ln1"], x, cfg), cfg,
            cache["k"][i], cache["v"][i], position)
        x = x + h
        q, _, _ = L._project_qkv(lp["cross"],
                                 L.apply_norm(lp["ln_x"], x, cfg), cfg, None)
        h = kops.decode_mha(q, cache["xk"][i], cache["xv"][i], lens,
                            impl="ref")
        x = x + h.transpose(1, 2).reshape(b, 1, -1).to(x.dtype) \
            @ lp["cross"]["wo"]
        x = x + L.mlp(lp["mlp"], L.apply_norm(lp["ln2"], x, cfg), cfg)
        ks.append(nk)
        vs.append(nv)
    new_cache = dict(cache, k=torch.stack(ks), v=torch.stack(vs))
    x = L.apply_norm(params["ln_f"], x, cfg)
    return L.logits(params["embed"], x, cfg), new_cache, position + 1
