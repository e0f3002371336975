"""Plain torch oracles for the port's kernels.

Each function is the semantic ground truth the kernels and the plain paths
are held to, on any device: attention, the Mamba-1 selective scan and the
RG-LRU diagonal scan so far; the others come with their kernels.
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


# -- ssm_scan -----------------------------------------------------------------

def ssm_scan_ref(x, dt, a, b, c, d, h0):
    """Sequential reference of the Mamba-1 recurrence, in float64 (for
    stability), on the inputs' device.  x/dt [B, S, Di]; a [Di, N];
    b/c [B, S, N]; d [Di]; h0 [B, Di, N] -> (y [B, S, Di], hT [B, Di, N]),
    both float64."""
    x, dt, a, b, c, d = (t.double() for t in (x, dt, a, b, c, d))
    h = h0.double().clone()
    y = torch.zeros_like(x)
    for t in range(x.shape[1]):
        da = torch.exp(dt[:, t, :, None] * a)
        h = da * h + (dt[:, t] * x[:, t])[..., None] * b[:, t, None, :]
        y[:, t] = (h * c[:, t, None, :]).sum(-1) + d * x[:, t]
    return y, h


# -- rg_lru -------------------------------------------------------------------

def rg_lru_ref(a, b, h0):
    """Sequential reference of the diagonal gated scan ``h_t = a_t * h_{t-1}
    + b_t``, in float64, on the inputs' device.  a/b [B, S, D]; h0 [B, D]
    -> (y [B, S, D], hT [B, D]), both float64."""
    a, b = a.double(), b.double()
    h = h0.double().clone()
    y = torch.zeros_like(a)
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        y[:, t] = h
    return y, h
