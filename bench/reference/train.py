"""The reference's training steps: the family's float32 loss, its gradient
by autograd, global-norm clipping and AdamW as the workload file states
them, the parameters kept in the configuration's dtype between steps."""
from __future__ import annotations

import math

import torch

from .common import F32, Precision

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def lr_at(opt: dict, step: int) -> float:
    """Linear warm-up to ``lr`` over ``warmup_steps``, then a cosine to 0 at
    ``total_steps``."""
    if step < opt["warmup_steps"]:
        return opt["lr"] * (step + 1) / max(opt["warmup_steps"], 1)
    t = min(max((step - opt["warmup_steps"])
                / max(opt["total_steps"] - opt["warmup_steps"], 1), 0.0), 1.0)
    return opt["lr"] * 0.5 * (1 + math.cos(math.pi * t))


def follow(w0: dict, cfg: dict, batches: list, opt: dict, device,
           prec: Precision = Precision()) -> dict:
    """Run ``len(batches)`` steps from the weights ``w0`` (``{leaf: tensor}``
    as served).  Returns ``{"loss": [each step's loss], "grad": {leaf: norm
    of the first step's clipped gradient}, "grads": {leaf: that gradient,
    float32 on the host}, "change": {leaf: norm of the parameters' change
    over all steps}}``."""
    from . import dense
    keep = DTYPES[cfg["torch_dtype"]]
    p = {k: t.to(device=device, dtype=F32) for k, t in w0.items()}
    m = {k: torch.zeros_like(t) for k, t in p.items()}
    v = {k: torch.zeros_like(t) for k, t in p.items()}
    out = {"loss": [], "grad": {}, "grads": {}, "change": {}}
    b1, b2 = opt["b1"], opt["b2"]
    for step, tokens in enumerate(batches):
        leaves = {k: t.detach().requires_grad_() for k, t in p.items()}
        with torch.enable_grad():
            loss = dense.loss(leaves, cfg, tokens, prec)
            grads = dict(zip(leaves, torch.autograd.grad(
                loss, list(leaves.values()))))
        out["loss"].append(float(loss.detach()))
        del leaves, loss
        gnorm = math.sqrt(sum(float(torch.sum(g * g)) for g in grads.values()))
        scale = min(opt["clip_norm"] / max(gnorm, 1e-9), 1.0)
        lr = lr_at(opt, step)
        bc1, bc2 = 1 - b1 ** (step + 1), 1 - b2 ** (step + 1)
        with torch.no_grad():
            for k in p:
                g = grads.pop(k) * scale
                if step == 0:
                    out["grad"][k] = float(torch.linalg.vector_norm(g))
                    out["grads"][k] = g.cpu()
                m[k] = b1 * m[k] + (1 - b1) * g
                v[k] = b2 * v[k] + (1 - b2) * g * g
                delta = (m[k] / bc1) / (torch.sqrt(v[k] / bc2) + opt["eps"]) \
                    + opt["weight_decay"] * p[k]
                p[k] = (p[k] - lr * delta).to(keep).to(F32)
    with torch.no_grad():
        for k, t in p.items():
            out["change"][k] = float(torch.linalg.vector_norm(
                t - w0[k].to(device=device, dtype=F32)))
    return out
