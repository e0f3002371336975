"""moe_dispatch — MoE dispatch into expert-capacity slots (the olmoe-1b-7b
path), written by hand for Hopper.

Dispatch is compaction by expert (DESIGN.md §2): row ``a`` of the gathered
assignment rows goes to slot ``[expert_idx[a], positions[a]]`` of a zeroed
[E, C, D] buffer; rows whose position lies at or past the capacity C drop.
On a CUDA tensor :func:`moe_dispatch` launches ``csrc/moe_dispatch.cu``
(which replaces the TPU kernel
``repro/kernels/moe_dispatch.py::_dispatch_kernel``); on a CPU tensor it runs
:func:`moe_dispatch_plain`, zeros and one ``index_put_`` of the kept rows.
There is no fallback from one to the other.  The two agree bit for bit: both
copy rows.  Unlike the reference kernel, any A is taken (the reference
asserts whole blocks of 256 rows).

Bound: bytes, the kept rows read once and the [E, C, D] buffer written
once, at 3.35 TB/s on an H100 SXM.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

_DTYPES = (torch.bfloat16, torch.float32)
_MAX_ROWS = (1 << 31) - 1            # rows and slots are int32 in the kernel


def _check(tokens, expert_idx, positions, n_experts, capacity) -> None:
    if tokens.dim() != 2:
        raise ValueError("moe_dispatch: want tokens [A, D], got "
                         f"{tuple(tokens.shape)}")
    if tokens.dtype not in _DTYPES:
        raise TypeError("moe_dispatch: tokens must be bfloat16 or float32, "
                        f"got {tokens.dtype}")
    a = tokens.shape[0]
    for name, t in (("expert_idx", expert_idx), ("positions", positions)):
        if t.dtype != torch.int32:
            raise TypeError(f"moe_dispatch: {name} must be int32, got "
                            f"{t.dtype} (convert it with .to(torch.int32))")
        if tuple(t.shape) != (a,):
            raise ValueError(f"moe_dispatch: want {name} [{a}], got "
                             f"{tuple(t.shape)}")
        if t.device != tokens.device:
            raise ValueError(f"moe_dispatch: {name} on {t.device}, tokens "
                             f"on {tokens.device}")
    if n_experts < 0 or capacity < 0:
        raise ValueError(f"moe_dispatch: n_experts {n_experts} and capacity "
                         f"{capacity} must be >= 0")
    if a > _MAX_ROWS or n_experts * capacity > _MAX_ROWS:
        raise ValueError(f"moe_dispatch: {a} rows or {n_experts} x "
                         f"{capacity} slots exceed int32")


def _kept(expert_idx, positions, n_experts, capacity) -> torch.Tensor:
    return ((expert_idx >= 0) & (expert_idx < n_experts)
            & (positions >= 0) & (positions < capacity))


def moe_dispatch_plain(tokens, expert_idx, positions, n_experts: int,
                       capacity: int) -> torch.Tensor:
    """Plain torch version of the kernel, on any device."""
    _check(tokens, expert_idx, positions, n_experts, capacity)
    out = tokens.new_zeros((n_experts, capacity, tokens.shape[1]))
    keep = _kept(expert_idx, positions, n_experts, capacity)
    out.index_put_((expert_idx[keep].long(), positions[keep].long()),
                   tokens[keep])
    return out


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("moe_dispatch")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.moe_dispatch_launch.argtypes = [p] * 5 + [i, ctypes.c_longlong, i, i,
                                                  p]
    lib.moe_dispatch_launch.restype = ctypes.c_int
    return lib


def moe_dispatch(tokens: torch.Tensor, expert_idx: torch.Tensor,
                 positions: torch.Tensor, n_experts: int,
                 capacity: int) -> torch.Tensor:
    """tokens [A, D] (bfloat16 or float32, already gathered per assignment),
    expert_idx [A] and positions [A] int32 (the running index within each
    expert) -> [E, C, D] in the tokens' dtype.

    Row ``a`` is kept when ``0 <= expert_idx[a] < E`` and ``0 <=
    positions[a] < C``; kept (expert, position) pairs must be unique.  A
    CUDA tensor launches the kernel (raising if it cannot: int64 or
    non-contiguous input), a CPU tensor runs :func:`moe_dispatch_plain`."""
    _build.refuse_grad("moe_dispatch", tokens)
    _check(tokens, expert_idx, positions, n_experts, capacity)
    if tokens.device.type == "cpu":
        return moe_dispatch_plain(tokens, expert_idx, positions, n_experts,
                                  capacity)
    if tokens.device.type != "cuda":
        raise ValueError(f"moe_dispatch: unsupported device {tokens.device}")
    for name, t in (("tokens", tokens), ("expert_idx", expert_idx),
                    ("positions", positions)):
        if not t.is_contiguous():
            raise ValueError(f"moe_dispatch: {name} must be contiguous")
    lib = _lib()
    a, d = tokens.shape
    out = torch.empty((n_experts, capacity, d), dtype=tokens.dtype,
                      device=tokens.device)
    slot_map = torch.empty(max(1, n_experts * capacity), dtype=torch.int32,
                           device=tokens.device)
    with torch.cuda.device(tokens.device):
        err = lib.moe_dispatch_launch(
            tokens.data_ptr(), expert_idx.data_ptr(), positions.data_ptr(),
            slot_map.data_ptr(), out.data_ptr(), a, d * tokens.element_size(),
            n_experts, capacity, torch.cuda.current_stream().cuda_stream)
    moe_dispatch.launches += 1
    _build.check(lib, "moe_dispatch", err)
    return out


#: kernel launches so far (CUDA calls only; the plain path does not count)
moe_dispatch.launches = 0
