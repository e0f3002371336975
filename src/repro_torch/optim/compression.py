"""int8 gradient compression with error feedback (EF-SGD).

Each step adds the previous step's quantization residual back before
quantizing, so the scheme is unbiased over time.  The compressed form (an
int8 payload and a float32 scale a leaf) is what a cross-pod all-reduce
would carry, a quarter of float32's bytes; decompression follows the
all-reduce.  The train driver turns it on with ``--grad-compression int8``.

Bit for bit the reference's ``repro.optim.compression``: ``torch.round``
rounds half to even, as ``jnp.round``, and both divisions stay divisions
by a tensor on the gradient's device (a division by a Python number may
become a multiplication by its reciprocal on the card).
"""
from __future__ import annotations

import torch

from ..models.params import leaves, tree_map, unflatten

F32 = torch.float32


def init_error_state(params):
    """Zero float32 residuals of the params' shapes and devices."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=F32,
                                          device=p.device), params)


def compress(g: torch.Tensor, err: torch.Tensor):
    """Returns ((q int8, scale float32 scalar), new residual)."""
    gf = g.to(F32) + err
    d127 = torch.full((), 127.0, dtype=F32, device=gf.device)
    scale = torch.clamp(torch.max(torch.abs(gf)), min=1e-12) / d127
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    deq = q.to(F32) * scale
    return (q, scale), gf - deq


def decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(F32) * scale


@torch.no_grad()
def compress_tree(grads, err_state):
    """Returns (tree of (q, scale) pairs, new error tree)."""
    qs, new_err = [], []
    for g, e in zip(leaves(grads), leaves(err_state)):
        qe, ne = compress(g, e)
        qs.append(qe)
        new_err.append(ne)
    return unflatten(grads, qs), unflatten(grads, new_err)


@torch.no_grad()
def roundtrip_tree(grads, err_state):
    """Compress and decompress every leaf (what the wire would carry):
    returns (dequantized grads in each grad's dtype, new error tree)."""
    outs, errs = [], []
    for g, e in zip(leaves(grads), leaves(err_state)):
        (q, s), ne = compress(g, e)
        outs.append(decompress(q, s).to(g.dtype))
        errs.append(ne)
    return unflatten(grads, outs), unflatten(grads, errs)
