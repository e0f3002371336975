"""flash_attention — blockwise online-softmax attention forward (the prefill
path), written by hand for Hopper.

On a CUDA tensor :func:`flash_attention` launches
``csrc/flash_attention.cu`` (which replaces the TPU kernel
``repro/kernels/flash_attention.py::_flash_kernel``); on a CPU tensor it
runs :func:`flash_attention_plain`, the same function in plain torch.
There is no fallback from one to the other.  GQA is the caller's business
(``ops.mha`` matches kv heads to q heads before the call): the kernel sees
matched, flattened heads.

The causal mask is the reference kernel's, top-left: query ``i`` sees keys
``j <= i``.  Unlike the reference kernel, any Sq and Skv are taken (the
reference asserts whole 128-row blocks).

Bound: operations, ``4*BH*Sq*Skv*D`` flops (half when causal) at the
card's bf16 tensor-core rate (989 TFLOP/s on an H100 SXM), or the bytes of
q, k, v and out at 3.35 TB/s where that is larger.  The first kernel runs
scalar float32 FMAs on the CUDA cores; see the source for its layout.
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


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape:
        raise ValueError("flash_attention: want q [BH, Sq, D] and k/v "
                         f"[BH, Skv, D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    bh, _, d = q.shape
    if k.shape[0] != bh or k.shape[2] != d or k.shape[1] < 1:
        raise ValueError("flash_attention: k/v must be [BH, Skv >= 1, D] "
                         f"like q {tuple(q.shape)}, got {tuple(k.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention: q, k, v must all be float32 or all "
                        f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v on different devices")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True) -> torch.Tensor:
    """Plain torch version of the kernel, on any device: full softmax in
    float32 with the kernel's mask and its ``acc / max(l, 1e-30)``."""
    _check(q, k, v)
    sq, d = q.shape[1], q.shape[2]
    skv = k.shape[1]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * (1.0 / d ** 0.5)
    if causal:
        kidx = torch.arange(skv, device=q.device)
        qidx = torch.arange(sq, device=q.device)
        s = torch.where(kidx[None, :] <= qidx[:, None], s, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    acc = torch.einsum("bqk,bkd->bqd", p, v.float())
    return (acc / p.sum(-1, keepdim=True).clamp_min(1e-30)).to(q.dtype)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("flash_attention")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_launch.argtypes = (
        [p] * 4 + [i] * 5 + [ctypes.c_float, i, p])
    lib.flash_attention_launch.restype = ctypes.c_int
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q [BH, Sq, D], k/v [BH, Skv, D] (heads flattened and matched) ->
    out [BH, Sq, D] in q's dtype.

    A CUDA tensor launches the kernel (raising if it cannot: head dim not
    in ``HEAD_DIMS``, non-contiguous or misaligned input), a CPU tensor
    runs :func:`flash_attention_plain`."""
    _check(q, k, v)
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
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, sq,
            k.shape[1], d, _DTYPES[q.dtype], 1.0 / d ** 0.5, int(causal),
            torch.cuda.current_stream().cuda_stream)
    flash_attention.launches += 1
    _build.check(lib, "flash_attention", err)
    return out


#: kernel launches so far (CUDA calls only; the plain path does not count)
flash_attention.launches = 0
