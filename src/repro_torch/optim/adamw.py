"""AdamW with a warmup + cosine schedule and global-norm clipping.

Plain functions over trees of tensors (nested dicts), as the reference's
``repro.optim.adamw``: the first and second moments are float32 trees of
the params' structure on the params' device, ``step`` an int32 scalar
there.  ``apply`` runs under ``torch.no_grad()`` and returns new trees; it
mutates nothing in place.  The reference's ``abstract_state`` (the dry-run's
sharded state) belongs to the distribution slice.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..models.params import leaves, tree_map, unflatten

F32 = torch.float32


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Learning rate at ``step`` (an int32 scalar tensor): linear warmup to
    ``lr``, then a cosine decay to 0 at ``total_steps``; float32."""
    step = step.to(F32)
    warm = cfg.lr * (step + 1) / max(cfg.warmup_steps, 1)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.lr * 0.5 * (1 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def init_state(params) -> dict:
    """Zero float32 moments of the params' shapes and ``step`` 0, on the
    params' device."""
    zeros = lambda p: torch.zeros(p.shape, dtype=F32, device=p.device)
    dev = leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares, added in
    the reference's leaf order (sorted keys)."""
    sq = [torch.sum(torch.square(g.to(F32))) for g in leaves(tree)]
    return torch.sqrt(sum(sq))


@torch.no_grad()
def apply(params, grads, state: dict, cfg: OptConfig):
    """One AdamW step.  Returns (new_params, new_state, metrics) with
    metrics ``{"lr", "grad_norm"}`` as float32 scalar tensors.  The grads
    are clipped to ``clip_norm`` by their global norm; each leaf updates in
    float32 and rounds back to its param's dtype."""
    step = state["step"]
    lr = schedule(cfg, step)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    t = step.to(F32) + 1
    bc1 = 1 - cfg.b1 ** t
    bc2 = 1 - cfg.b2 ** t

    def upd(p, g, m, v):
        # the reference's expression, operation for operation; in place
        # only on this function's own temporaries, so that a large leaf
        # holds few float32 copies at once
        g = g.to(F32) * scale
        m = cfg.b1 * m
        m += (1 - cfg.b1) * g
        gg = (1 - cfg.b2) * g
        gg *= g
        del g
        v = cfg.b2 * v
        v += gg
        del gg
        den = torch.sqrt(v / bc2)
        den += cfg.eps
        delta = m / bc1
        delta /= den
        del den
        pf = p.to(F32, copy=True)
        delta += cfg.weight_decay * pf
        delta *= lr
        pf -= delta
        return pf.to(p.dtype), m, v

    new_p, new_m, new_v = [], [], []
    for p, g, m, v in zip(leaves(params), leaves(grads),
                          leaves(state["m"]), leaves(state["v"])):
        np_, nm, nv = upd(p, g, m, v)
        new_p.append(np_)
        new_m.append(nm)
        new_v.append(nv)
    new_state = {"m": unflatten(params, new_m),
                 "v": unflatten(params, new_v), "step": step + 1}
    return (unflatten(params, new_p), new_state,
            {"lr": lr, "grad_norm": gnorm})
