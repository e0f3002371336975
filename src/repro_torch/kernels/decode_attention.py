"""decode_attention — one query per row over a KV cache, masked by each
row's valid length, written by hand for Hopper.

On a CUDA tensor :func:`decode_attention` launches
``csrc/decode_attention.cu`` (which replaces the TPU kernel
``repro/kernels/decode_attention.py::_decode_kernel``); on a CPU tensor it
runs :func:`decode_attention_plain`, the same function in plain torch.
There is no fallback from one to the other.  GQA is the caller's business
(``ops.decode_mha`` matches kv heads to q heads before the call).

Bound: bytes — each row's K and V up to its valid length, plus q, the
lengths and the output, at 3.35 TB/s on an H100 SXM; the kernel does
4*D flops per key.  Unlike the reference kernel, any S is taken (the
reference asserts whole 512-key blocks).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .flash_attention import HEAD_DIMS, NEG_INF, _DTYPES


def _check(q, k, v, lengths) -> None:
    if q.dim() != 3 or q.shape[1] != 1 or k.dim() != 3 or v.shape != k.shape:
        raise ValueError("decode_attention: want q [BH, 1, D] and k/v "
                         f"[BH, S, D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    bh, _, d = q.shape
    if k.shape[0] != bh or k.shape[2] != d or k.shape[1] < 1:
        raise ValueError("decode_attention: k/v must be [BH, S >= 1, D] like "
                         f"q {tuple(q.shape)}, got {tuple(k.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("decode_attention: q, k, v must all be float32 or all "
                        f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if lengths.dtype != torch.int32 or lengths.shape != (bh,):
        raise TypeError("decode_attention: lengths must be int32 [BH], got "
                        f"{lengths.dtype} {tuple(lengths.shape)}")
    if not (q.device == k.device == v.device == lengths.device):
        raise ValueError("decode_attention: inputs on different devices")


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           lengths: torch.Tensor) -> torch.Tensor:
    """Plain torch version of the kernel, on any device: full softmax in
    float32, keys at or past each row's length scored -1e30."""
    _check(q, k, v, lengths)
    d = q.shape[2]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * (1.0 / d ** 0.5)
    kidx = torch.arange(k.shape[1], device=q.device)
    s = torch.where(kidx[None, None, :] < lengths[:, None, None], s, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    acc = torch.einsum("bqk,bkd->bqd", p, v.float())
    return (acc / p.sum(-1, keepdim=True).clamp_min(1e-30)).to(q.dtype)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("decode_attention")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.decode_attention_launch.argtypes = (
        [p] * 5 + [i] * 4 + [ctypes.c_float, p])
    lib.decode_attention_launch.restype = ctypes.c_int
    return lib


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """q [BH, 1, D], k/v [BH, S, D], lengths [BH] int32 -> out [BH, 1, D]
    in q's dtype.

    A CUDA tensor launches the kernel (raising if it cannot: head dim not
    in ``HEAD_DIMS``, non-contiguous or misaligned input), a CPU tensor
    runs :func:`decode_attention_plain`."""
    _check(q, k, v, lengths)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    bh, _, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"decode_attention: head dim {d} has no kernel "
                         f"instance (have {HEAD_DIMS})")
    for name, t in (("q", q), ("k", k), ("v", v), ("lengths", lengths)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"decode_attention: {name} must be contiguous "
                             "and 16-byte aligned")
    lib = _lib()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = lib.decode_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), bh, k.shape[1], d, _DTYPES[q.dtype],
            1.0 / d ** 0.5, torch.cuda.current_stream().cuda_stream)
    decode_attention.launches += 1
    _build.check(lib, "decode_attention", err)
    return out


#: kernel launches so far (CUDA calls only; the plain path does not count)
decode_attention.launches = 0
