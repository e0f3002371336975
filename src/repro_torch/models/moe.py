"""Mixture-of-Experts transformer (olmoe-1b-7b, dbrx-132b).

The FF block routes tokens to top-k experts. Two dispatch paths:

* ``revet``  — the paper's technique (DESIGN.md §2): tokens-as-threads are
  *compacted* per expert (filter), run through replicate regions (experts),
  and merge back weighted; positions-within-expert come from one cumsum (the
  hoisted allocator's pointer stream, §V-B(b)); capacity overflow = threads
  stalling on an empty free list. Memory O(A·D) — the production path.
* ``dense``  — MapReduce-style one-hot einsum dispatch [T, E, C] (what
  Spatial could express). O(T·E·C) memory; baseline for the comparison
  benchmark only.

As in the reference, the model's ``revet`` path dispatches with
``impl="scatter"``; the hand-written dispatch kernel is reached through
``ops.moe_dispatch_combine(impl="kernel")``, on a layer's own router
(:func:`route`) and experts (:func:`expert_fn`).  Layers are stacked along
a leading axis; the port loops over the layer index.  Training:
``loss_fn`` adds ``aux_weight`` times the mean load-balance loss to the
cross-entropy, with remat over each layer's (x, aux) while grad is
enabled; the gates carry the gradient into the router, the expert indices
and the load counts do not.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import tracing
from ..configs.base import ModelConfig
from ..distributed import sharding as _sh
from ..kernels import ops as kops
from . import layers as L
from .params import P, stack
from .transformer import (_positions, abstract_cache,  # noqa: F401
                          init_cache, layer_params, unstack)

F32 = torch.float32


def moe_spec(cfg: ModelConfig) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    dt = cfg.param_dtype
    # the reference shards each expert's ff dim over the data axes when
    # configured; on one device the axis names are documentation
    ff_ax = "expert_ff" if cfg.moe_2d_sharding else None
    return {
        "router": P((d, e), ("embed", None), dt),
        "wg": P((e, d, f), ("experts", "embed", ff_ax), dt),
        "wu": P((e, d, f), ("experts", "embed", ff_ax), dt),
        "wd": P((e, f, d), ("experts", ff_ax, "embed"), dt),
    }


def layer_spec(cfg: ModelConfig) -> dict:
    return {
        "ln1": L.norm_spec(cfg),
        "attn": L.attn_spec(cfg),
        "ln2": L.norm_spec(cfg),
        "moe": moe_spec(cfg),
    }


def model_spec(cfg: ModelConfig) -> dict:
    return {
        "embed": L.embed_spec(cfg),
        "layers": stack(layer_spec(cfg), cfg.n_layers),
        "ln_f": L.norm_spec(cfg),
    }


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    c = int(n_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(8, -(-c // 8) * 8)   # round up to 8 (sublane alignment)


def top_k(probs: torch.Tensor, k: int):
    """The ``k`` largest values along the last axis and their indices, the
    lower index first among equal values, as ``jax.lax.top_k`` orders them
    (``torch.topk`` promises no order among ties).  The values are
    gathered at the indices, so that the gradient is a gather's (the card's
    torch makes a sort's gradient as a plain tensor beside a DTensor)."""
    idx = torch.sort(probs, dim=-1, descending=True, stable=True)[1][..., :k]
    return torch.gather(probs, -1, idx), idx


def route(p, toks, cfg: ModelConfig):
    """The router of one layer: toks [T, D] -> (logits [T, E] float32,
    gates [T, K] normalised to sum 1, expert indices [T, K])."""
    logits = (toks @ p["router"]).to(F32)
    gates, eidx = top_k(torch.softmax(logits, -1), cfg.top_k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return logits, gates, eidx


def expert_fn(p, dtype):
    """One layer's experts as a function of the dispatch buffer [E, C, D]:
    swiglu in float32 between bf16 (param-dtype) batched products."""
    def fn(dispatched):
        h = F.silu(torch.bmm(dispatched, p["wg"]).to(F32))
        h = h * torch.bmm(dispatched, p["wu"]).to(F32)
        return torch.bmm(h.to(dtype), p["wd"])
    return fn


def moe_ff(p, x, cfg: ModelConfig, path: str = "revet"):
    """x [B, S, D] -> ([B, S, D], (router logits, expert indices))."""
    b, s, d = x.shape
    toks = _sh.grad_laid_out_as(x.reshape(b * s, d))
    logits, gates, eidx = route(p, toks, cfg)
    cap = capacity(cfg, b * s)
    if path == "dense":
        out = kops.moe_dense_einsum(toks, gates, eidx, cfg.n_experts, cap,
                                    expert_fn(p, x.dtype))
    else:
        out = kops.moe_dispatch_combine(toks, gates, eidx, cfg.n_experts,
                                        cap, expert_fn(p, x.dtype),
                                        impl="scatter")
    return out.reshape(b, s, d), (logits, eidx)


def aux_load_balance_loss(logits, eidx, cfg: ModelConfig) -> torch.Tensor:
    """Switch-style auxiliary loss: E * Σ_e f_e · p_e."""
    pe = torch.softmax(logits, -1).mean(0)

    def counts(e):
        return torch.zeros(cfg.n_experts, dtype=F32, device=e.device) \
            .index_add(0, e, torch.ones(e.numel(), dtype=F32,
                                        device=e.device))

    # on DTensors each device counts its own assignments, a pending sum
    fe = _sh.per_shard(counts, (eidx.reshape(-1),), ({0: 0},), ({},))
    fe = fe / torch.clamp(fe.sum(), min=1)
    return cfg.n_experts * torch.sum(fe * pe)


def _layer_fwd(cfg: ModelConfig, impl: str, path: str, x, lp, positions):
    """One layer over full sequences -> (x, aux loss, (k, v))."""
    h, kv = L.attention(lp["attn"], L.apply_norm(lp["ln1"], x, cfg), cfg,
                        positions=positions, impl=impl)
    x = x + h
    h, (lg, ei) = moe_ff(lp["moe"], L.apply_norm(lp["ln2"], x, cfg), cfg,
                         path=path)
    return x + h, aux_load_balance_loss(lg, ei, cfg), kv


def trunk(params, tokens, cfg: ModelConfig, impl: str = "chunked",
          remat: bool = True, path: str = "revet", positions=None):
    """tokens [B, S] -> (final hidden states [B, S, D], mean aux loss).
    With ``remat`` each layer is recomputed in the backward (only while
    grad is enabled)."""
    b, s = tokens.shape
    if positions is None:
        positions = _positions(b, s, tokens.device)
    x = L.embed(params["embed"], tokens)
    aux = torch.zeros((), dtype=F32, device=tokens.device)
    for lp in unstack(params["layers"]):
        x, a, _ = L.remat(_layer_fwd, cfg, impl, path, x, lp, positions,
                          enabled=remat)
        aux = aux + a
    return L.apply_norm(params["ln_f"], x, cfg), aux / cfg.n_layers


def forward(params, tokens, cfg: ModelConfig, impl: str = "chunked",
            remat: bool = True, path: str = "revet", positions=None):
    """tokens [B, S] -> (logits [B, S, V], mean aux loss)."""
    x, aux = trunk(params, tokens, cfg, impl, remat, path, positions)
    return L.logits(params["embed"], x, cfg), aux


def loss_fn(params, batch, cfg: ModelConfig, impl: str = "chunked",
            path: str = "revet", aux_weight: float = 0.01,
            fused: bool = True):
    """Next-token cross-entropy plus ``aux_weight`` times the mean
    load-balance loss."""
    if fused:
        x, aux = trunk(params, batch["tokens"], cfg, impl=impl, path=path)
        return L.fused_xent_loss(params["embed"], x, batch["tokens"], cfg) \
            + aux_weight * aux
    lg, aux = forward(params, batch["tokens"], cfg, impl=impl, path=path)
    return L.xent_loss(lg[:, :-1], batch["tokens"][:, 1:]) + aux_weight * aux


# -- serving (the dense family's cache) ----------------------------------------

def prefill(params, tokens, cfg: ModelConfig, max_len: int,
            impl: str = "chunked", path: str = "revet"):
    """Run the trunk over a prompt, returning (logits_last, cache, position)."""
    b, s = tokens.shape
    positions = _positions(b, s, tokens.device)
    x = L.embed(params["embed"], tokens)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        x, _, (k, v) = _layer_fwd(cfg, impl, path, x, layer_params(params, i),
                                  positions)
        ks.append(L.pad_dim(k, 2, 0, max_len - s))
        vs.append(L.pad_dim(v, 2, 0, max_len - s))
    x = L.apply_norm(params["ln_f"], x, cfg)
    lg = L.logits(params["embed"], x[:, -1:], cfg)
    return (lg, {"k": torch.stack(ks), "v": torch.stack(vs)},
            torch.full((b,), s, dtype=torch.int32, device=tokens.device))


def decode_step(params, token, cache, position, cfg: ModelConfig,
                path: str = "revet"):
    """One token for the whole batch. token [B, 1]; position [B].  Every
    slot routes, free ones too, and competes for the experts' capacity."""
    x = L.embed(params["embed"], token)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        h, nk, nv = L.decode_attention_step(
            lp["attn"], L.apply_norm(lp["ln1"], x, cfg), cfg,
            cache["k"][i], cache["v"][i], position)
        x = x + h
        h, _ = moe_ff(lp["moe"], L.apply_norm(lp["ln2"], x, cfg), cfg, path)
        x = x + h
        ks.append(nk)
        vs.append(nv)
    x = L.apply_norm(params["ln_f"], x, cfg)
    lg = L.logits(params["embed"], x, cfg)
    with tracing.span("decode.kv"):
        cache = {"k": torch.stack(ks), "v": torch.stack(vs)}
    return lg, cache, position + 1
