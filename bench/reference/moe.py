"""Plain float32 reference of the MoE decoder (olmoe-1b-7b): the logits of a
served sequence, with the router, the capacity rule and the experts as
the configuration file declares them."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import (F32, Precision, attention_block, head_weight,
                     layer_weights, rms_norm)


def capacity(cfg: dict, n_tokens: int) -> int:
    """Slots per expert for a group of ``n_tokens``: ``int(n k f / E)``
    rounded up to a multiple, at least the minimum."""
    c = int(n_tokens * cfg["num_experts_per_tok"] * cfg["capacity_factor"]
            / cfg["num_experts"])
    m = cfg["capacity_multiple"]
    return max(cfg["capacity_min"], -(-c // m) * m)


def route(x, router, cfg: dict):
    """x [T, d] -> (gates [T, k], experts [T, k]): float32 softmax over the
    experts, the k largest (the lower index first among equals), gates
    renormalised to sum 1 when ``norm_topk_prob``."""
    probs = torch.softmax(x @ router, -1)
    idx = torch.sort(probs, dim=-1, descending=True,
                     stable=True)[1][:, :cfg["num_experts_per_tok"]]
    gates = probs.gather(1, idx)
    if cfg["norm_topk_prob"]:
        gates = gates / gates.sum(-1, keepdim=True)
    return gates, idx


def kept(idx, cfg: dict, group: int):
    """[T, k] booleans: an assignment of the first ``group`` tokens is kept
    while its expert has a free slot, slots taken in token order and then
    in k order; later tokens (each decoded alone) keep all."""
    out = torch.ones_like(idx, dtype=torch.bool)
    if group:
        flat = idx[:group].reshape(-1)
        onehot = F.one_hot(flat, cfg["num_experts"])
        pos = (torch.cumsum(onehot, 0) - onehot).gather(1, flat[:, None])[:, 0]
        out[:group] = (pos < capacity(cfg, group)).reshape(group, -1)
    return out


def moe_ff(x, lw: dict, cfg: dict, prec: Precision, group: int):
    """x [T, d] -> [T, d]: each kept assignment's expert output (SwiGLU),
    weighted by its gate and summed."""
    gates, idx = route(x, lw["moe.router"], cfg)
    gates = gates * kept(idx, cfg, group)
    y = torch.zeros_like(x)
    for e in range(cfg["num_experts"]):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        xs = x[tok]
        h = F.silu(prec.mm(xs, lw["moe.wg"][e])) * prec.mm(xs, lw["moe.wu"][e])
        y.index_add_(0, tok, prec.mm(h, lw["moe.wd"][e])
                     * gates[tok, slot][:, None])
    return y


@torch.no_grad()
def logits_at(w: dict, cfg: dict, tokens: torch.Tensor, at: torch.Tensor,
              prec: Precision = Precision(), prompt_len: int = 0):
    """float32 logits [len(at), vocab] at positions ``at`` of the sequence
    ``tokens`` [S]: the first ``prompt_len`` tokens were prefilled as one
    group (their capacity applies), each later one decoded."""
    s = tokens.shape[0]
    eps = cfg["rms_norm_eps"]
    positions = torch.arange(s, device=tokens.device)
    x = w["embed.tok"][tokens.long()].to(F32)[None]
    for i in range(cfg["num_hidden_layers"]):
        lw = layer_weights(w, i)
        x = x + attention_block(rms_norm(x, lw["ln1.w"], eps), lw, cfg,
                                positions, prec)
        x = x + moe_ff(rms_norm(x[0], lw["ln2.w"], eps), lw, cfg, prec,
                       prompt_len)[None]
    x = rms_norm(x[0, at], w["ln_f.w"].to(F32), eps)
    return prec.mm(x, head_weight(w, cfg))
