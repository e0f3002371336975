"""VLM backbone (internvl2-1b).  The InternViT frontend is a stub, as in
the reference: the inputs are precomputed patch embeddings
[B, n_patches, vit_width]; an MLP projector maps them into the LM, and the
qwen2-style decoder attends over [patches ; text] causally.  Training:
``loss_fn`` over the text positions only, with remat per layer while grad
is enabled.

With ``impl="kernel"`` prefill runs the flash kernel (on a CUDA tensor)
over the whole [patches ; text] sequence in every layer.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from . import layers as L
from . import transformer as T
from .params import P


def model_spec(cfg: ModelConfig) -> dict:
    spec = T.model_spec(cfg)
    spec["projector"] = {
        "w1": P((cfg.vit_width, cfg.d_model), (None, "embed"),
                cfg.param_dtype),
        "w2": P((cfg.d_model, cfg.d_model), ("embed", "embed2"),
                cfg.param_dtype),
    }
    return spec


def _prefix(params, patch_embeds, tokens):
    """[projected patches ; embedded text] -> [B, P + S, D].  The
    projector's gelu (tanh form, ``jax.nn.gelu``'s default) runs in
    float32 and rounds back to the weights' dtype, as in the reference."""
    w1, w2 = params["projector"]["w1"], params["projector"]["w2"]
    h = (patch_embeds.to(w1.dtype) @ w1).float()
    proj = F.gelu(h, approximate="tanh").to(w1.dtype) @ w2
    return torch.cat([proj, L.embed(params["embed"], tokens)], dim=1)


def trunk(params, patch_embeds, tokens, cfg: ModelConfig,
          impl: str = "chunked", remat: bool = True):
    """-> final hidden states of the TEXT positions [B, S, D].  With
    ``remat`` each layer is recomputed in the backward (only while grad is
    enabled)."""
    b, s = tokens.shape
    npatch = patch_embeds.shape[1]
    x = _prefix(params, patch_embeds, tokens)
    positions = T._positions(b, npatch + s, tokens.device)
    for lp in T.unstack(params["layers"]):
        x = L.remat(T._layer_fwd, cfg, impl, x, lp, positions,
                    enabled=remat)[0]
    x = L.apply_norm(params["ln_f"], x, cfg)
    return x[:, npatch:]


def forward(params, patch_embeds, tokens, cfg: ModelConfig,
            impl: str = "chunked", remat: bool = True):
    """patch_embeds [B, P, vit_width]; tokens [B, S] -> text logits."""
    x = trunk(params, patch_embeds, tokens, cfg, impl, remat)
    return L.logits(params["embed"], x, cfg)


def loss_fn(params, batch, cfg: ModelConfig, impl: str = "chunked",
            fused: bool = True):
    """Mean next-token cross-entropy of the text tokens (the patches have
    no labels)."""
    if fused:
        x = trunk(params, batch["patch_embeds"], batch["tokens"], cfg,
                  impl=impl)
        return L.fused_xent_loss(params["embed"], x, batch["tokens"], cfg)
    lg = forward(params, batch["patch_embeds"], batch["tokens"], cfg,
                 impl=impl)
    return L.xent_loss(lg[:, :-1], batch["tokens"][:, 1:])


# -- serving: the cache covers [patches ; text] ---------------------------------

abstract_cache = T.abstract_cache
init_cache = T.init_cache


def prefill(params, patch_embeds, tokens, cfg: ModelConfig, max_len: int,
            impl: str = "chunked"):
    """``max_len`` counts patches and text (``Zoo`` passes
    ``max_len + n_patches``).  -> (logits_last, cache, position)."""
    b, s = tokens.shape
    npatch = patch_embeds.shape[1]
    x = _prefix(params, patch_embeds, tokens)
    total = npatch + s
    positions = T._positions(b, total, tokens.device)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        x, (k, v) = T._layer_fwd(cfg, impl, x, T.layer_params(params, i),
                                 positions)
        pad = max_len - total
        ks.append(L.pad_dim(k, 2, 0, pad))
        vs.append(L.pad_dim(v, 2, 0, pad))
    x = L.apply_norm(params["ln_f"], x, cfg)
    return (L.logits(params["embed"], x[:, -1:], cfg),
            {"k": torch.stack(ks), "v": torch.stack(vs)},
            torch.full((b,), total, dtype=torch.int32, device=tokens.device))


decode_step = T.decode_step
