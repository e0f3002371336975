"""Plain torch oracles for the port's kernels.

Each function is the semantic ground truth the kernels and the plain paths
are held to, on any device.  Only the attention oracle is here so far; the
others come with their kernels.
"""
from __future__ import annotations

import torch


def attention_ref(q, k, v, causal: bool = True, lengths=None):
    """q [BH, Sq, D], k/v [BH, Skv, D]. Full-softmax reference in f32.

    The causal mask is bottom-right aligned (query i sees keys up to
    ``i + Skv - Sq``), as the reference oracle's; the flash kernel masks
    top-left (``k <= q``).  The two agree when Sq == Skv."""
    q, k, v = q.float(), k.float(), v.float()
    d = q.shape[-1]
    s = torch.einsum("bqd,bkd->bqk", q, k) / d ** 0.5
    sq, sk = s.shape[-2], s.shape[-1]
    if causal:
        mask = torch.ones(sq, sk, dtype=torch.bool,
                          device=s.device).tril(sk - sq)
        s = torch.where(mask[None], s, -1e30)
    if lengths is not None:
        kidx = torch.arange(sk, device=s.device)
        s = torch.where(kidx[None, None, :] < lengths[:, None, None], s,
                        -1e30)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    return torch.einsum("bqk,bkd->bqd", p, v)
