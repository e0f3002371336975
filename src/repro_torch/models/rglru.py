"""RecurrentGemma / Griffin hybrid (recurrentgemma-9b): repeating groups of
(attn_every-1) recurrent blocks + 1 local-attention block, each followed by a
gated MLP, then the trailing recurrent blocks (``tail``).  MQA (kv=1),
window-limited attention, so its decode state is constant in sequence
length: a [B, W] float32 state and a K-1 conv tail per recurrent block, and
a ring of ``min(window, max_len)`` K/V rows per attention block.

Recurrent block:  y = Wo( GeLU(W1·x) ⊙ RGLRU(conv1d(W2·x)) )
RG-LRU:           a = exp(-c·softplus(Λ)·sigmoid(Wa·u));
                  h = a ⊙ h + sqrt(1-a²) ⊙ (sigmoid(Wi·u) ⊙ u)

The cast points are the reference's, one for one: the gates, the scan and
the GeLU gate run in float32 (``lam`` is a float32 leaf in a bf16 model),
the conv and the projections in the parameters' dtype.

Scan implementations (``impl``) of ``_rec_block``:
  * "kernel"  — ``ops.rg_lru_scan(impl="kernel")``: the hand-written
                ``rg_lru`` kernel on a CUDA tensor (the reference's
                "pallas");
  * "naive"   — ``ops.rg_lru_assoc``;
  * "chunked" — ``ops.rg_lru_chunked`` (the default; the reference's
                default name "assoc" runs the same).
``trunk``, ``forward`` and ``prefill`` never pass ``impl`` to the recurrent
blocks, as in the reference: their ``impl`` reaches only the attention
blocks, and the scan there is always ``ops.rg_lru_chunked``, under grad
too.  Layers are a Python loop over the stacked group and sublayer axes.
Training: ``loss_fn``, with remat per group (its recurrent blocks and its
attention block) while grad is enabled, the tail blocks kept, as the
reference's ``jax.checkpoint`` around the group scan's body.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels import ops as kops
from . import layers as L
from .params import P, resolve_device, stack
from .ssm import _conv1d
from .transformer import _positions, unstack

F32 = torch.float32
_C = 8.0   # RG-LRU decay constant (paper value)
REC_IMPLS = ("kernel", "naive", "chunked")


def rec_block_spec(cfg: ModelConfig) -> dict:
    d, w, k = cfg.d_model, cfg.rnn_width, cfg.d_conv
    dt = cfg.param_dtype
    return {
        "ln": L.norm_spec(cfg),
        "w1": P((d, w), ("embed", "inner"), dt),
        "w2": P((d, w), ("embed", "inner"), dt),
        "conv_w": P((k, w), (None, "inner"), dt),
        "conv_b": P((w,), ("inner",), dt, "zeros"),
        "wa": P((w, w), ("inner", None), dt),
        "wi": P((w, w), ("inner", None), dt),
        "lam": P((w,), ("inner",), "float32", "ones"),
        "wo": P((w, d), ("inner", "embed"), dt),
        "ln_mlp": L.norm_spec(cfg),
        "mlp": L.mlp_spec(cfg),
    }


def attn_block_spec(cfg: ModelConfig) -> dict:
    return {
        "ln": L.norm_spec(cfg),
        "attn": L.attn_spec(cfg),
        "ln_mlp": L.norm_spec(cfg),
        "mlp": L.mlp_spec(cfg),
    }


def _counts(cfg: ModelConfig):
    """(recurrent blocks per group, groups, trailing recurrent blocks)."""
    n_rec_pg = cfg.attn_every - 1
    n_groups = cfg.n_layers // cfg.attn_every
    n_tail = cfg.n_layers - n_groups * cfg.attn_every
    return n_rec_pg, n_groups, n_tail


def model_spec(cfg: ModelConfig) -> dict:
    n_rec_pg, n_groups, n_tail = _counts(cfg)
    spec = {
        "embed": L.embed_spec(cfg),
        "groups": stack({
            "rec": stack(rec_block_spec(cfg), n_rec_pg, "sublayers"),
            "attn": attn_block_spec(cfg),
        }, n_groups),
        "ln_f": L.norm_spec(cfg),
    }
    if n_tail:
        spec["tail"] = stack(rec_block_spec(cfg), n_tail)
    return spec


def _take(node, *idx):
    """The slice ``node[idx]`` of every leaf of a stacked tree (views)."""
    if isinstance(node, dict):
        return {k: _take(v, *idx) for k, v in node.items()}
    return node[idx]


def blocks(params, cfg: ModelConfig):
    """The blocks in forward order, as ``(kind, params, cache key, index)``:
    per group its recurrent sublayers (``"rec"``, key ``"rec"``, index
    ``(g, j)``) then its attention block (``"attn"``, ``(g,)``), then the
    tail (``"rec"``, key ``"tail"``, ``(t,)``)."""
    n_rec_pg, n_groups, n_tail = _counts(cfg)
    for g in range(n_groups):
        for j in range(n_rec_pg):
            yield "rec", _take(params["groups"]["rec"], g, j), "rec", (g, j)
        yield "attn", _take(params["groups"]["attn"], g), "attn", (g,)
    for t in range(n_tail):
        yield "rec", _take(params["tail"], t), "tail", (t,)


def _rglru_gates(p, u):
    """u [B, S, W] -> (a, b) for h = a·h + b (precomputed gate form), both
    float32."""
    uf = u.to(F32)
    r = torch.sigmoid(uf @ p["wa"].to(F32))
    i = torch.sigmoid(uf @ p["wi"].to(F32))
    log_a = -_C * F.softplus(p["lam"]) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2 * log_a), min=1e-8)) \
        * (i * uf)
    return a, b


def _rec_block(p, x, cfg: ModelConfig, h0=None, conv0=None,
               impl: str = "chunked"):
    """One recurrent block. x [B, S, D] -> (x_out, (hT [B, W] float32,
    conv tail [B, K-1, W] in x's dtype: the last K-1 pre-conv rows, fewer
    when S < K-1, as the reference's slice))."""
    if impl not in REC_IMPLS:
        raise ValueError(f"unknown scan impl {impl!r} (have {REC_IMPLS}; "
                         "the reference's 'pallas' route is 'kernel' here)")
    b = x.shape[0]
    hn = L.apply_norm(p["ln"], x, cfg)
    gate = F.gelu((hn @ p["w1"]).to(F32), approximate="tanh")
    u = hn @ p["w2"]
    conv_tail = u[:, -(cfg.d_conv - 1):, :]
    if conv0 is not None:
        up = torch.cat([conv0.to(u.dtype), u], 1)
        u = _conv1d(up, p["conv_w"], p["conv_b"])[:, cfg.d_conv - 1:]
    else:
        u = _conv1d(u, p["conv_w"], p["conv_b"])
    a, bb = _rglru_gates(p, u)
    if h0 is None:
        h0 = torch.zeros((b, cfg.rnn_width), dtype=F32, device=x.device)
    if impl == "kernel":
        y, hT = kops.rg_lru_scan(a, bb, h0, impl="kernel")
    elif impl == "naive":
        y, hT = kops.rg_lru_assoc(a, bb, h0)
    else:
        y, hT = kops.rg_lru_chunked(a, bb, h0)
    y = (gate * y.to(F32)).to(x.dtype)
    x = x + y @ p["wo"]
    x = x + L.mlp(p["mlp"], L.apply_norm(p["ln_mlp"], x, cfg), cfg)
    return x, (hT, conv_tail)


def _attn_block(p, x, cfg: ModelConfig, positions, impl: str):
    """One local-attention block -> (x_out, (k, v) [B, Hkv, S, hd])."""
    h, kv = L.attention(p["attn"], L.apply_norm(p["ln"], x, cfg), cfg,
                        positions=positions, impl=impl, window=cfg.window)
    x = x + h
    x = x + L.mlp(p["mlp"], L.apply_norm(p["ln_mlp"], x, cfg), cfg)
    return x, kv


def _group_fwd(cfg: ModelConfig, impl: str, x, gp, positions):
    """One group: its recurrent blocks, then its attention block."""
    for rp in unstack(gp["rec"]):
        x, _ = _rec_block(rp, x, cfg)
    return _attn_block(gp["attn"], x, cfg, positions, impl)[0]


def trunk(params, tokens, cfg: ModelConfig, impl: str = "chunked",
          remat: bool = True, positions=None):
    """tokens [B, S] -> final hidden states [B, S, D].  ``impl`` is the
    attention blocks' (the recurrent blocks run their default scan).  With
    ``remat`` each group is recomputed in the backward (only while grad is
    enabled)."""
    b, s = tokens.shape
    if positions is None:
        positions = _positions(b, s, tokens.device)
    x = L.embed(params["embed"], tokens)
    for gp in unstack(params["groups"]):
        x = L.remat(_group_fwd, cfg, impl, x, gp, positions, enabled=remat)
    for rp in unstack(params["tail"]) if "tail" in params else ():
        x, _ = _rec_block(rp, x, cfg)
    return L.apply_norm(params["ln_f"], x, cfg)


def forward(params, tokens, cfg: ModelConfig, impl: str = "chunked",
            remat: bool = True, positions=None):
    """tokens [B, S] -> logits [B, S, V]."""
    x = trunk(params, tokens, cfg, impl, remat, positions)
    return L.logits(params["embed"], x, cfg)


def loss_fn(params, batch, cfg: ModelConfig, impl: str = "chunked",
            fused: bool = True):
    """Mean next-token cross-entropy of ``batch["tokens"]``."""
    if fused:
        x = trunk(params, batch["tokens"], cfg, impl=impl)
        return L.fused_xent_loss(params["embed"], x, batch["tokens"], cfg)
    lg = forward(params, batch["tokens"], cfg, impl=impl)
    return L.xent_loss(lg[:, :-1], batch["tokens"][:, 1:])


# -- serving --------------------------------------------------------------------

def abstract_cache(cfg: ModelConfig, batch: int, max_len: int,
                   dtype=torch.bfloat16):
    """The decode state as tensors on the ``meta`` device: float32
    recurrent states ``rec_h`` [G, R, B, W] (``tail_h`` [T, B, W]), conv
    tails ``rec_conv`` [G, R, B, K-1, W] (``tail_conv``) and K/V rings
    ``attn_k``/``attn_v`` [G, B, Hkv, min(window, max_len), hd] in
    ``dtype`` (bfloat16, as the reference's); the ``tail_*`` leaves only
    where the layers leave a tail."""
    n_rec_pg, n_groups, n_tail = _counts(cfg)
    w = min(cfg.window, max_len)
    shapes = {
        "rec_h": ((n_groups, n_rec_pg, batch, cfg.rnn_width), F32),
        "rec_conv": ((n_groups, n_rec_pg, batch, cfg.d_conv - 1,
                      cfg.rnn_width), dtype),
        "attn_k": ((n_groups, batch, cfg.n_kv_heads, w, cfg.hd), dtype),
        "attn_v": ((n_groups, batch, cfg.n_kv_heads, w, cfg.hd), dtype),
    }
    if n_tail:
        shapes["tail_h"] = ((n_tail, batch, cfg.rnn_width), F32)
        shapes["tail_conv"] = ((n_tail, batch, cfg.d_conv - 1,
                                cfg.rnn_width), dtype)
    meta = torch.device("meta")
    return {k: torch.empty(shape, dtype=dt, device=meta)
            for k, (shape, dt) in shapes.items()}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None):
    """``abstract_cache``'s leaves zeroed on ``device`` (``None``: the
    card)."""
    dev = resolve_device(device, "init_cache")
    return {k: torch.zeros(t.shape, dtype=t.dtype, device=dev)
            for k, t in abstract_cache(cfg, batch, max_len, dtype).items()}


def decode_rec_block(p, x, h_st, conv_st, cfg: ModelConfig):
    """One recurrent block of ``decode_step``: x [B, 1, D], state h [B, W]
    and conv window [B, K-1, W] -> (out [B, 1, D], new h, new window)."""
    hn = L.apply_norm(p["ln"], x, cfg)
    gate = F.gelu((hn @ p["w1"]).to(F32), approximate="tanh")    # [B,1,W]
    u = hn @ p["w2"]                                              # [B,1,W]
    win = torch.cat([conv_st, u], 1)          # [B,K,W], promoted as jnp
    uc = (win * p["conv_w"][None]).sum(1) + p["conv_b"]           # [B,W]
    a, bb = _rglru_gates(p, uc[:, None, :])
    h_new = a[:, 0] * h_st + bb[:, 0]
    y = (gate[:, 0] * h_new).to(x.dtype)
    x = x + (y @ p["wo"])[:, None, :]
    x = x + L.mlp(p["mlp"], L.apply_norm(p["ln_mlp"], x, cfg), cfg)
    return x, h_new, win[:, 1:]


def decode_step(params, token, cache, position, cfg: ModelConfig):
    """One token for the whole batch. token [B, 1]; position [B].  Each
    attention block writes its ring at ``position % w`` and attends over
    ``min(position + 1, w)`` rows (``decode_mha(impl="ref")``, as the
    reference)."""
    x = L.embed(params["embed"], token)
    w = cache["attn_k"].shape[3]
    new = {k: [] for k in cache}
    for kind, p, key, idx in blocks(params, cfg):
        if kind == "rec":
            x, h, conv = decode_rec_block(p, x, cache[f"{key}_h"][idx],
                                          cache[f"{key}_conv"][idx], cfg)
            new[f"{key}_h"].append(h)
            new[f"{key}_conv"].append(conv)
        else:
            h, nk, nv = L.decode_attention_step(
                p["attn"], L.apply_norm(p["ln"], x, cfg), cfg,
                cache["attn_k"][idx], cache["attn_v"][idx], position,
                window=w)
            x = x + h
            x = x + L.mlp(p["mlp"], L.apply_norm(p["ln_mlp"], x, cfg), cfg)
            new["attn_k"].append(nk)
            new["attn_v"].append(nv)
    x = L.apply_norm(params["ln_f"], x, cfg)
    return (L.logits(params["embed"], x, cfg), _restack(new, cfg),
            position + 1)


def _restack(new: dict, cfg: ModelConfig) -> dict:
    """Per-block lists (in ``blocks`` order) back into the cache layout:
    ``rec_*`` [G, R, ...], the others [n, ...]."""
    n_rec_pg, n_groups, _ = _counts(cfg)
    out = {}
    for k, v in new.items():
        t = torch.stack(v)
        out[k] = (t.reshape((n_groups, n_rec_pg) + t.shape[1:])
                  if k.startswith("rec_") else t)
    return out


def prefill(params, tokens, cfg: ModelConfig, max_len: int,
            impl: str = "chunked"):
    """Prompt pass collecting recurrent states, conv tails and the windowed
    K/V.  Returns (logits of the last position, cache, positions).  ``impl``
    is the attention blocks' (the scan is ``ops.rg_lru_chunked``, as in the
    reference).  Each attention block keeps its last ``w = min(window,
    max_len)`` K/V rows, rolled so that ring slot ``pos % w`` holds
    position ``pos`` when the prompt fills the ring; a shorter prompt keeps
    S rows, which the engine splices into the ring's leading slots."""
    b, s = tokens.shape
    positions = _positions(b, s, tokens.device)
    x = L.embed(params["embed"], tokens)
    w = min(cfg.window, max_len)
    new = {k: [] for k in ("rec_h", "rec_conv", "attn_k", "attn_v")}
    if "tail" in params:
        new.update(tail_h=[], tail_conv=[])
    for kind, p, key, idx in blocks(params, cfg):
        if kind == "rec":
            x, (hT, tail) = _rec_block(p, x, cfg)
            new[f"{key}_h"].append(hT)
            new[f"{key}_conv"].append(tail)
        else:
            x, (k, v) = _attn_block(p, x, cfg, positions, impl)
            kw, vw = k[:, :, -w:], v[:, :, -w:]
            if s >= w:
                kw = torch.roll(kw, s % w, dims=2)
                vw = torch.roll(vw, s % w, dims=2)
            new["attn_k"].append(kw)
            new["attn_v"].append(vw)
    x = L.apply_norm(params["ln_f"], x, cfg)
    return (L.logits(params["embed"], x[:, -1:], cfg), _restack(new, cfg),
            torch.full((b,), s, dtype=torch.int32, device=tokens.device))
