"""The comparisons that decide ``correct``.

Serving: a sample of the requests finished in the window, drawn from the
seed with the longest among them, until it holds ``check.tokens`` served
tokens.  The reference runs once over each prompt with its served tokens;
at every served position the gap is the reference's best logit less its
logit of the served token (0 where they agree).  The numbers compared are
those the workload's ``check`` names: the widest gap, or the mean gap
over the sample (the MoE cells, whose widest gap the float8 control does
not reach three times of: a router choice that bfloat16 flips changes a
request's later positions too).

Training: the first gradient as the optimizer got it (its first moment
after one step over 1 - b1), its norm and its direction, and the change
of the parameters over the first steps, per leaf, against the
reference's; each step's loss is read beside them; see
``train_numbers``.  A workload's ``check`` names the numbers compared.
"""
from __future__ import annotations

import statistics

import numpy as np
import torch

from .reference.common import Precision


def sample(finished: list, seed: int, tokens: int, longest) -> list:
    """Indices into ``finished`` (records with ``.served``): the one
    ``longest`` picks first, then others in an order drawn from the seed
    until ``tokens`` served tokens are in."""
    if not finished:
        return []
    first = max(range(len(finished)), key=lambda i: longest(finished[i]))
    order = [i for i in np.random.default_rng([seed, 3]).permutation(
        len(finished)) if i != first]
    out, n = [first], len(finished[first].served)
    for i in order:
        if n >= tokens:
            break
        out.append(i)
        n += len(finished[i].served)
    return out


def served_logits(ref, w, cfg, prompt, served, device, prec=Precision()):
    """The reference's float32 logits [n, vocab] at the n positions that
    predict the n served tokens."""
    seq = np.concatenate([prompt, np.asarray(served[:-1], np.int64)])
    toks = torch.as_tensor(seq, dtype=torch.long, device=device)
    at = torch.arange(len(prompt) - 1, len(seq), device=device)
    return ref.logits_at(w, cfg, toks, at, prec, prompt_len=len(prompt))


def gaps(ref_logits: torch.Tensor, picked) -> torch.Tensor:
    """best - logit[picked] at each position (0 where they agree)."""
    picked = torch.as_tensor(np.asarray(picked), dtype=torch.long,
                             device=ref_logits.device)
    best = ref_logits.max(-1).values
    return best - ref_logits.gather(1, picked[:, None])[:, 0]



def leaf_gap(prog: dict, ref: dict, keys) -> tuple[float, str]:
    """The worst leaf's |prog norm - ref norm| over the larger of the
    reference's norm of that leaf and the median leaf's, and its name."""
    med = statistics.median(ref[k] for k in keys)
    worst, at = 0.0, ""
    for k in keys:
        g = abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
        if g >= worst:
            worst, at = g, k
    return worst, at


def direction(a: torch.Tensor, b: torch.Tensor) -> float:
    """1 - the cosine of two tensors, in float64."""
    a, b = a.double().flatten(), b.double().flatten()
    den = float(torch.linalg.vector_norm(a) * torch.linalg.vector_norm(b))
    return max(0.0, 1.0 - float(a @ b) / den) if den else 1.0


def train_numbers(prog: dict, ref: dict, min_grad_share: float) -> dict:
    """``prog`` / ``ref``: ``{"loss": [..], "grad": {leaf: norm},
    "grads": {leaf: first gradient}, "change": {leaf: norm}}``.  Returns
    the numbers compared: ``loss`` the largest relative gap of a step's
    loss, ``grad`` the worst leaf's gap of the first gradient's norm,
    ``direction`` the worst leaf's 1 - cosine between the two first
    gradients, ``change`` the worst leaf's gap of the change's norm,
    leaving out leaves whose reference gradient is under
    ``min_grad_share`` of the median leaf's (they move by round-off
    alone)."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["loss"], ref["loss"]))
    leaves = sorted(ref["grad"])
    grad, grad_at = leaf_gap(prog["grad"], ref["grad"], leaves)
    med = statistics.median(ref["grad"][k] for k in leaves)
    moving = [k for k in leaves if ref["grad"][k] >= min_grad_share * med]
    change, change_at = leaf_gap(prog["change"], ref["change"], moving)
    cos = {k: direction(prog["grads"][k], ref["grads"][k]) for k in leaves}
    dir_at = max(cos, key=cos.get)
    return {"loss": loss, "grad": grad, "grad_leaf": grad_at,
            "direction": cos[dir_at], "direction_leaf": dir_at,
            "change": change, "change_leaf": change_at,
            "left_out": sorted(set(leaves) - set(moving))}
