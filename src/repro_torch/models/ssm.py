"""Mamba-1 SSM stack (falcon-mamba-7b): attention-free, with a constant-size
recurrent state per layer.

Block: in_proj -> (x, z); causal depthwise conv1d(k) + silu; x_proj ->
(dt, B, C); selective scan; gate by silu(z); out_proj.  The cast points are
the reference's, one for one: bf16 parameters keep the conv and the
projections in bf16, and the scan runs in float32.

Scan implementations (``impl``) of ``trunk``/``forward``:
  * "kernel"  — ``ops.ssm(impl="kernel")``: the hand-written ``ssm_scan``
                kernel on a CUDA tensor (the reference's "pallas");
  * "naive"   — ``ops.ssm_assoc``;
  * "chunked" — ``ops.ssm_chunked``.
``prefill`` runs ``ops.ssm_chunked`` whatever ``impl`` is, and
``decode_step`` is the one-step recurrence in plain torch, as in the
reference.  Layers are a Python loop over the stacked layer axis; one
layer of each is its own function (``block``, ``prefill_block``,
``decode_block``: the bodies of the reference's ``lax.scan``s).  Training:
``loss_fn``, with remat per block while grad is enabled; the chunked and
naive scans are plain torch, differentiated by autograd.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..distributed import sharding as _sh
from ..kernels import ops as kops
from . import layers as L
from .params import P, resolve_device, stack
from .transformer import layer_params, unstack

F32 = torch.float32
IMPLS = ("kernel", "naive", "chunked")


def block_spec(cfg: ModelConfig) -> dict:
    d, di, n, r, k = (cfg.d_model, cfg.d_inner, cfg.d_state, cfg.dt_rank,
                      cfg.d_conv)
    dt = cfg.param_dtype
    return {
        "ln": L.norm_spec(cfg),
        "in_proj": P((d, 2 * di), ("embed", "inner"), dt),
        "conv_w": P((k, di), (None, "inner"), dt),
        "conv_b": P((di,), ("inner",), dt, "zeros"),
        "x_proj": P((di, r + 2 * n), ("inner", None), dt),
        "dt_proj": P((r, di), (None, "inner"), dt),
        "dt_bias": P((di,), ("inner",), dt, "zeros"),
        "a_log": P((di, n), ("inner", None), "float32", "zeros"),
        "d_skip": P((di,), ("inner",), "float32", "ones"),
        "out_proj": P((di, d), ("inner", "embed"), dt),
    }


def model_spec(cfg: ModelConfig) -> dict:
    return {
        "embed": L.embed_spec(cfg),
        "layers": stack(block_spec(cfg), cfg.n_layers),
        "ln_f": L.norm_spec(cfg),
    }


def _conv1d(x, w, b):
    """Causal depthwise conv. x [B, S, Di]; w [K, Di].  Each product and
    each partial sum rounds to x's dtype, as the reference's Python sum."""
    k, s = w.shape[0], x.shape[1]
    xp = L.pad_dim(x, 1, k - 1, 0)
    out = xp[:, 0:s] * w[0]
    for i in range(1, k):
        out = out + xp[:, i: i + s] * w[i]
    return out + b


def _mix(p, x, cfg: ModelConfig):
    """Norm, in_proj, conv and the x/dt/B/C projections of one block.
    Returns (xi, z, dt, bmat, cmat, a, conv tail): xi in x's dtype, dt/b/c
    float32."""
    di, n, r = cfg.d_inner, cfg.d_state, cfg.dt_rank
    xz = L.apply_norm(p["ln"], x, cfg) @ p["in_proj"]
    xi, z = xz[..., :di], xz[..., di:]
    tail = xi[:, -(cfg.d_conv - 1):, :]
    xi = F.silu(_conv1d(xi, p["conv_w"], p["conv_b"]).to(F32)).to(x.dtype)
    # x_proj contracts the sharded inner dim: its sums over the mesh are
    # reduced before the scan adds into its slices in place
    proj = _sh.reduce_partial(xi @ p["x_proj"])
    dt = F.softplus((proj[..., :r] @ p["dt_proj"] + p["dt_bias"]).to(F32))
    return (xi, z, dt, proj[..., r: r + n].to(F32),
            proj[..., r + n:].to(F32), -torch.exp(p["a_log"]), tail)


def _out(p, x, y, z):
    """Gate the scan output by silu(z) and project back onto the stream."""
    y = y.to(x.dtype) * F.silu(z.to(F32)).to(x.dtype)
    return x + y @ p["out_proj"]


def block(p, x, cfg: ModelConfig, impl: str):
    """One layer of ``trunk``: x [B, S, D] -> [B, S, D]."""
    if impl not in IMPLS:
        raise ValueError(f"unknown scan impl {impl!r} (have {IMPLS}; the "
                         "reference's 'pallas' route is 'kernel' here)")
    xi, z, dt, bmat, cmat, a, _ = _mix(p, x, cfg)
    h0 = torch.zeros((x.shape[0], cfg.d_inner, cfg.d_state), dtype=F32,
                     device=x.device)
    args = (xi.to(F32), dt, a, bmat, cmat, p["d_skip"], h0)
    if impl == "kernel":
        y, _ = kops.ssm(*args, impl="kernel")
    elif impl == "naive":
        y, _ = kops.ssm_assoc(*args)
    else:
        y, _ = kops.ssm_chunked(*args)
    return _out(p, x, y, z)


def trunk(params, tokens, cfg: ModelConfig, impl: str = "chunked",
          remat: bool = True):
    """tokens [B, S] -> final hidden states [B, S, D].  With ``remat``
    each block is recomputed in the backward (only while grad is
    enabled)."""
    x = L.embed(params["embed"], tokens)
    for lp in unstack(params["layers"]):
        x = L.remat(block, lp, x, cfg, impl, enabled=remat)
    return L.apply_norm(params["ln_f"], x, cfg)


def forward(params, tokens, cfg: ModelConfig, impl: str = "chunked",
            remat: bool = True):
    """tokens [B, S] -> logits [B, S, V]."""
    return L.logits(params["embed"], trunk(params, tokens, cfg, impl, remat),
                    cfg)


def loss_fn(params, batch, cfg: ModelConfig, impl: str = "chunked",
            fused: bool = True):
    """Mean next-token cross-entropy of ``batch["tokens"]``."""
    if fused:
        x = trunk(params, batch["tokens"], cfg, impl=impl)
        return L.fused_xent_loss(params["embed"], x, batch["tokens"], cfg)
    lg = forward(params, batch["tokens"], cfg, impl=impl)
    return L.xent_loss(lg[:, :-1], batch["tokens"][:, 1:])


# -- serving: constant-size recurrent state -----------------------------------

def abstract_cache(cfg: ModelConfig, batch: int, max_len: int,
                   dtype=torch.bfloat16):
    """The state as tensors on the ``meta`` device (the dry-run's
    arguments): ``h`` float32, ``conv`` in ``dtype`` — bfloat16 by default
    here, float32 in ``init_cache``, as in the reference."""
    del max_len  # state size is sequence-independent
    meta = torch.device("meta")
    return {
        "h": torch.empty((cfg.n_layers, batch, cfg.d_inner, cfg.d_state),
                         dtype=F32, device=meta),
        "conv": torch.empty((cfg.n_layers, batch, cfg.d_conv - 1,
                             cfg.d_inner), dtype=dtype, device=meta),
    }


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=F32,
               device=None):
    """Zeroed state ``{"h": [L, B, Di, N] f32, "conv": [L, B, K-1, Di]}`` on
    ``device`` (``None``: the card); ``max_len`` does not matter.  The conv
    window is float32 by default, as the reference's."""
    dev = resolve_device(device, "init_cache")
    return {k: torch.zeros(t.shape, dtype=t.dtype, device=dev)
            for k, t in abstract_cache(cfg, batch, max_len, dtype).items()}


def prefill_block(p, x, cfg: ModelConfig):
    """One layer of ``prefill``: x [B, S, D] -> (out [B, S, D], final state
    [B, Di, N] float32, conv tail [B, K-1, Di] in x's dtype)."""
    xi, z, dt, bmat, cmat, a, tail = _mix(p, x, cfg)
    h0 = torch.zeros((x.shape[0], cfg.d_inner, cfg.d_state), dtype=F32,
                     device=x.device)
    y, hT = kops.ssm_chunked(xi.to(F32), dt, a, bmat, cmat, p["d_skip"], h0)
    return _out(p, x, y, z), hT, tail


def prefill(params, tokens, cfg: ModelConfig, max_len: int,
            impl: str = "assoc"):
    """Prompt pass carrying out each layer's final state and conv tail (in
    the activations' dtype).  The scan is ``ops.ssm_chunked`` whatever
    ``impl`` is, as in the reference."""
    del max_len, impl
    b, s = tokens.shape
    x = L.embed(params["embed"], tokens)
    hs, tails = [], []
    for i in range(cfg.n_layers):
        x, hT, tail = prefill_block(layer_params(params, i), x, cfg)
        hs.append(hT)
        tails.append(tail)
    x = L.apply_norm(params["ln_f"], x, cfg)
    return (L.logits(params["embed"], x[:, -1:], cfg),
            {"h": torch.stack(hs), "conv": torch.stack(tails)},
            torch.full((b,), s, dtype=torch.int32, device=tokens.device))


def decode_block(p, x, h_st, conv_st, cfg: ModelConfig):
    """One layer of ``decode_step``: x [B, 1, D], state h [B, Di, N] and
    conv window [B, K-1, Di] -> (out [B, 1, D], new h, new conv window).
    The window takes the state's dtype (float32 in the engine), as the
    reference's ``concatenate`` promotes it."""
    di, n, r = cfg.d_inner, cfg.d_state, cfg.dt_rank
    xz = L.apply_norm(p["ln"], x, cfg) @ p["in_proj"]
    xi, z = xz[..., :di], xz[..., di:]             # [B, 1, Di]
    wdt = torch.promote_types(conv_st.dtype, xi.dtype)
    window = torch.cat([conv_st.to(wdt), xi.to(wdt)], 1)        # [B, K, Di]
    conv = (window * p["conv_w"][None]).sum(1) + p["conv_b"]
    xi1 = F.silu(conv.to(F32)).to(x.dtype)         # [B, Di]
    proj = _sh.reduce_partial(xi1 @ p["x_proj"])   # as in _mix
    dt = F.softplus((proj[..., :r] @ p["dt_proj"]
                     + p["dt_bias"]).to(F32))      # [B, Di]
    bmat = proj[..., r: r + n].to(F32)             # [B, N]
    cmat = proj[..., r + n:].to(F32)
    a = -torch.exp(p["a_log"])                     # [Di, N]
    da = torch.exp(dt[..., None] * a[None])        # [B, Di, N]
    h_new = da * h_st + (dt * xi1.to(F32))[..., None] * bmat[:, None, :]
    y = (h_new * cmat[:, None, :]).sum(-1) + p["d_skip"] * xi1.to(F32)
    y = y.to(x.dtype) * F.silu(z[:, 0].to(F32)).to(x.dtype)
    return x + (y @ p["out_proj"])[:, None, :], h_new, window[:, 1:]


def decode_step(params, token, cache, position, cfg: ModelConfig):
    """Single-step recurrence, O(1) in sequence length.  token [B, 1]."""
    x = L.embed(params["embed"], token)            # [B, 1, D]
    hs, convs = [], []
    for i in range(cfg.n_layers):
        x, h_new, conv = decode_block(layer_params(params, i), x,
                                      cache["h"][i], cache["conv"][i], cfg)
        hs.append(h_new)
        convs.append(conv)
    x = L.apply_norm(params["ln_f"], x, cfg)
    return (L.logits(params["embed"], x, cfg),
            {"h": torch.stack(hs), "conv": torch.stack(convs)},
            position + 1)
