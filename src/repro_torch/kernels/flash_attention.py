"""flash_attention — blockwise online-softmax attention forward (the prefill
path), written by hand for Hopper.

On a CUDA tensor :func:`flash_attention` launches
``csrc/flash_attention.cu`` (which replaces the TPU kernel
``repro/kernels/flash_attention.py::_flash_kernel``); on a CPU tensor it
runs :func:`flash_attention_plain`, the same function in plain torch.
There is no fallback from one to the other.  GQA is by index: q holds
BHq flattened query heads, k/v BHkv flattened kv heads, and query row
``bh`` reads kv row ``bh // (BHq // BHkv)`` (``ops.mha`` passes its
K/V as they are, never repeated).

The causal mask is the reference kernel's, top-left: query ``i`` sees keys
``j <= i``.  Unlike the reference kernel, any Sq and Skv are taken (the
reference asserts whole 128-row blocks).

Bound: operations, ``4*BHq*Sq*Skv*D`` flops (about half when causal) at
the card's bf16 tensor-core rate (989 TFLOP/s on an H100 SXM), or the
bytes of q and out (per query row) and k and v (once per kv row) at 3.35
TB/s where that is larger.  The bfloat16 instance runs both products on
the tensor cores (``mma.sync`` m16n8k16, a ``cp.async`` ring of K/V
tiles; P as two bf16 terms, so that P V keeps the reference's float32 P);
the float32 instance stays on the CUDA cores (tensor cores would
mean TF32).  See the source for both layouts.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128, 256)     # one template instance each
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_BH = 65535                        # grid.y


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> int:
    """Validate the grouped contract; returns G = BHq // BHkv."""
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape:
        raise ValueError("flash_attention: want q [BHq, Sq, D] and k/v "
                         f"[BHkv, Skv, D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    bhq, _, d = q.shape
    bhkv = k.shape[0]
    if k.shape[2] != d or k.shape[1] < 1 or bhkv < 1:
        raise ValueError("flash_attention: k/v must be [BHkv >= 1, Skv >= 1, "
                         f"D] like q {tuple(q.shape)}, got {tuple(k.shape)}")
    if bhq % bhkv:
        raise ValueError(f"flash_attention: BHq = {bhq} is not a multiple "
                         f"of BHkv = {bhkv} (query row bh reads kv row "
                         "bh // (BHq // BHkv))")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention: q, k, v must all be float32 or all "
                        f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v on different devices")
    return bhq // bhkv


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True) -> torch.Tensor:
    """Plain torch version of the kernel, on any device: full softmax in
    float32 with the kernel's mask and its ``acc / max(l, 1e-30)``, the G
    query rows of a kv row viewed as one group (K/V never copied)."""
    g = _check(q, k, v)
    bhq, sq, d = q.shape
    bhkv, skv = k.shape[0], k.shape[1]
    qg = q.float().reshape(bhkv, g, sq, d)
    s = torch.einsum("bgqd,bkd->bgqk", qg, k.float()) * (1.0 / d ** 0.5)
    if causal:
        kidx = torch.arange(skv, device=q.device)
        qidx = torch.arange(sq, device=q.device)
        s = torch.where(kidx[None, :] <= qidx[:, None], s, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    acc = torch.einsum("bgqk,bkd->bgqd", p, v.float())
    out = acc / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return out.reshape(bhq, sq, d).to(q.dtype)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("flash_attention")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_launch.argtypes = (
        [p] * 4 + [i] * 6 + [ctypes.c_float, i, p])
    lib.flash_attention_launch.restype = ctypes.c_int
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q [BHq, Sq, D], k/v [BHkv, Skv, D] with BHq a multiple of BHkv ->
    out [BHq, Sq, D] in q's dtype.  Query row ``bh`` attends kv row
    ``bh // (BHq // BHkv)``: GQA with heads folded into the batch
    (``(b*Hq + h) // G == b*Hkv + h // G``), K/V never copied.

    A CUDA tensor launches the kernel (raising if it cannot: head dim not
    in ``HEAD_DIMS``, non-contiguous or misaligned input), a CPU tensor
    runs :func:`flash_attention_plain`."""
    _build.refuse_grad("flash_attention", q, k, v)
    g = _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    bh, sq, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} has no kernel "
                         f"instance (have {HEAD_DIMS})")
    if bh > _MAX_BH:
        raise ValueError(f"flash_attention: BH = {bh} exceeds {_MAX_BH}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be contiguous "
                             "and 16-byte aligned")
    lib = _lib()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, g,
            sq, k.shape[1], d, _DTYPES[q.dtype], 1.0 / d ** 0.5, int(causal),
            torch.cuda.current_stream().cuda_stream)
    flash_attention.launches += 1
    _build.check(lib, "flash_attention", err)
    return out


#: kernel launches so far (CUDA calls only; the plain path does not count)
flash_attention.launches = 0
