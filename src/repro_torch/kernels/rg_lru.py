"""rg_lru — the RG-LRU diagonal gated scan (the recurrentgemma-9b path),
written by hand for Hopper.

    h_t = a_t ⊙ h_{t-1} + b_t

with ``a``/``b`` precomputed by the layer (``a = exp(-c·softplus(Λ)·r_t)``,
``b = √(1-a²)·(i_t⊙x_t)``).  On a CUDA tensor :func:`rg_lru` launches
``csrc/rg_lru.cu`` (which replaces the TPU kernel
``repro/kernels/rg_lru.py::_rglru_kernel``); on a CPU tensor it runs
:func:`rg_lru_plain`, the same recurrence as a torch loop over t.  There is
no fallback from one to the other.  Unlike the reference kernel, any B, S
and D are taken (the reference asserts whole chunks and whole d blocks).

Bound: bytes, ``(3·B·S·D + 2·B·D)·4`` (a, b, y once each, h0 and hT) at
3.35 TB/s on an H100 SXM; 2 flops per element.  See the source for the
layout.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build


def _check(a, b, h0) -> None:
    if a.dim() != 3 or b.shape != a.shape:
        raise ValueError("rg_lru: want a and b [B, S, D], got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    bsz, _, d = a.shape
    if tuple(h0.shape) != (bsz, d):
        raise ValueError(f"rg_lru: want h0 {(bsz, d)}, got "
                         f"{tuple(h0.shape)}")
    ts = (a, b, h0)
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError("rg_lru: all inputs must be float32, got "
                        f"{sorted({str(t.dtype) for t in ts})}")
    if len({t.device for t in ts}) != 1:
        raise ValueError("rg_lru: inputs on different devices")


def rg_lru_plain(a, b, h0):
    """Plain torch version of the kernel, on any device: the recurrence as
    a loop over t, one rounded multiply and one rounded add per step (the
    kernel's order), float32."""
    _check(a, b, h0)
    h = h0.clone()
    y = torch.empty_like(a)
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        y[:, t] = h
    return y, h


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("rg_lru")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rg_lru_launch.argtypes = [p] * 5 + [i] * 3 + [p]
    lib.rg_lru_launch.restype = ctypes.c_int
    return lib


def rg_lru(a, b, h0):
    """a/b [B, S, D]; h0 [B, D], all float32 -> (y [B, S, D], hT [B, D]).

    A CUDA tensor launches the kernel (raising if it cannot: B above
    65535, non-contiguous input), a CPU tensor runs :func:`rg_lru_plain`."""
    _check(a, b, h0)
    if a.device.type == "cpu":
        return rg_lru_plain(a, b, h0)
    if a.device.type != "cuda":
        raise ValueError(f"rg_lru: unsupported device {a.device}")
    bsz, s, d = a.shape
    if bsz > 65535:
        raise ValueError(f"rg_lru: B = {bsz} exceeds 65535")
    for name, t in (("a", a), ("b", b), ("h0", h0)):
        if not t.is_contiguous():
            raise ValueError(f"rg_lru: {name} must be contiguous")
    lib = _lib()
    y = torch.empty_like(a)
    hT = torch.empty_like(h0)
    with torch.cuda.device(a.device):
        err = lib.rg_lru_launch(
            a.data_ptr(), b.data_ptr(), h0.data_ptr(), y.data_ptr(),
            hT.data_ptr(), bsz, s, d,
            torch.cuda.current_stream().cuda_stream)
    rg_lru.launches += 1
    _build.check(lib, "rg_lru", err)
    return y, hT


#: kernel launches so far (CUDA calls only; the plain path does not count)
rg_lru.launches = 0
