"""Plain torch oracles for the port's kernels.

Each function is the semantic ground truth the kernels and the plain paths
are held to: attention, the Mamba-1 selective scan and the RG-LRU diagonal
scan in torch, on any device; the hash probe and the MoE dispatch in numpy,
one key or one row at a time, as the reference's oracles.
"""
from __future__ import annotations

import numpy as np
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


# -- hash_probe ---------------------------------------------------------------

def _mix_ref(x: int) -> int:
    x &= 0xFFFFFFFF
    x ^= x >> 16
    x = x * 0x45D9F3B & 0xFFFFFFFF
    x ^= x >> 16
    return x


def hash_probe_ref(keys, table_k, table_v, n_slots: int,
                   max_probes: int = 16):
    """Linear probing from ``_mix(key) % n_slots`` over the padded table, one
    key at a time: a slot holding the key answers, an EMPTY (0) slot or the
    end of the table stops.  Returns (values, found) as int64 arrays."""
    vals, found = [], []
    for key in np.asarray(keys):
        h = _mix_ref(int(key)) % n_slots
        v, f = 0, 0
        for p in range(max_probes):
            if h + p >= len(table_k):
                break
            ck = int(table_k[h + p])
            if ck == int(key):
                v, f = int(table_v[h + p]), 1
                break
            if ck == 0:
                break
        vals.append(v)
        found.append(f)
    return np.array(vals, np.int64), np.array(found, np.int64)


# -- moe_dispatch -------------------------------------------------------------

def moe_dispatch_ref(tokens, expert_idx, positions, n_experts: int,
                     capacity: int):
    """Row ``a`` of ``tokens`` goes to slot ``[expert_idx[a], positions[a]]``
    of a zeroed [E, C, D] buffer when both lie in range; other rows drop."""
    tokens = np.asarray(tokens)
    out = np.zeros((n_experts, capacity, tokens.shape[1]), tokens.dtype)
    for a, (e, p) in enumerate(zip(expert_idx, positions)):
        if 0 <= e < n_experts and 0 <= p < capacity:
            out[int(e), int(p)] = tokens[a]
    return out
