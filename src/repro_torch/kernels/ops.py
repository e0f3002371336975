"""ops — the VectorVM executor entry points on torch tensors.

These are the hot loops of ``core/vector_vm.py`` behind
:class:`~repro_torch.core.backend.TorchBackend` (see DESIGN.md §3).
Contract: int64 numpy in, int64 numpy out, bit-identical to the
``NumpyBackend`` oracle.  Each call moves its window to ``device`` as int32
and brings the result back.  Element-wise windows and run selection are
plain torch ops; compaction and segmented reduction call the
``stream_compact`` and ``segment_reduce`` kernels, which launch their CUDA
kernels on a CUDA device and run their plain torch versions on the CPU.

Integer traps of torch, avoided here: integer division by zero raises on the
CPU and ``INT_MIN / -1`` kills the process, so divisors are made safe first
and the results patched; ``torch.remainder`` floors where the IR truncates
(``torch.fmod`` is right); shifts by 32 or more are not masked by torch;
there is no full uint32 arithmetic, so unsigned ops run in int64 on
``a & 0xFFFFFFFF``.
"""
from __future__ import annotations

import numpy as np
import torch

from .segment_reduce import segment_reduce
from .stream_compact import stream_compact

_INT32_MIN = -(1 << 31)
_I64 = np.int64


def _dev(a, device) -> torch.Tensor:
    """int64 numpy window (already 32-bit wrapped) -> int32 tensor."""
    return torch.from_numpy(np.asarray(a, _I64).astype(np.int32)).to(device)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().astype(_I64)


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 tensor -> int32 tensor with two's-complement wrap."""
    return (((x - _INT32_MIN) & 0xFFFFFFFF) + _INT32_MIN).to(torch.int32)


def _u32(x: torch.Tensor) -> torch.Tensor:
    return x.long() & 0xFFFFFFFF


# ---- element-wise body windows ----


def _ew(op: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IR binop on int32 tensors, 32-bit wrap semantics (== numpy oracle)."""
    i32 = torch.int32
    if op == "add":
        return _wrap32(a.long() + b.long())
    if op == "sub":
        return _wrap32(a.long() - b.long())
    if op == "mul":
        return _wrap32(a.long() * b.long())
    if op in ("sdiv", "smod"):
        # C-style truncation; b == 0 gives 0, INT_MIN / -1 gives INT_MIN
        # (and remainder 0), as wrap32 does
        trap = (a == _INT32_MIN) & (b == -1)
        bad = (b == 0) | trap
        safe = torch.where(bad, torch.ones_like(b), b)
        if op == "sdiv":
            q = torch.div(a, safe, rounding_mode="trunc")
            q = torch.where(trap, torch.full_like(q, _INT32_MIN), q)
            return torch.where(b == 0, torch.zeros_like(q), q)
        return torch.where(bad, torch.zeros_like(a), torch.fmod(a, safe))
    if op in ("udiv", "umod"):
        au, bu = _u32(a), _u32(b)
        safe = torch.where(bu == 0, torch.ones_like(bu), bu)
        r = (torch.div(au, safe, rounding_mode="floor") if op == "udiv"
             else au % safe)
        return _wrap32(torch.where(bu == 0, torch.zeros_like(r), r))
    if op == "and":
        return a & b
    if op == "or":
        return a | b
    if op == "xor":
        return a ^ b
    if op == "shl":
        return _wrap32(_u32(a) << (b.long() & 31))
    if op == "lshr":
        return _wrap32(_u32(a) >> (b.long() & 31))
    if op == "ashr":
        return torch.bitwise_right_shift(a, b & 31)
    if op == "eq":
        return (a == b).to(i32)
    if op == "ne":
        return (a != b).to(i32)
    if op == "slt":
        return (a < b).to(i32)
    if op == "sle":
        return (a <= b).to(i32)
    if op == "sgt":
        return (a > b).to(i32)
    if op == "sge":
        return (a >= b).to(i32)
    if op == "ult":
        return (_u32(a) < _u32(b)).to(i32)
    if op == "ule":
        return (_u32(a) <= _u32(b)).to(i32)
    if op == "min":
        return torch.minimum(a, b)
    if op == "max":
        return torch.maximum(a, b)
    raise NotImplementedError(op)


def vm_binop(op: str, a, b, device="cpu") -> np.ndarray:
    return _host(_ew(op, _dev(a, device), _dev(b, device)))


def vm_unop(op: str, a, device="cpu") -> np.ndarray:
    t = _dev(a, device)
    if op == "neg":
        return _host(_wrap32(-t.long()))
    if op == "not":
        return _host((t == 0).to(torch.int32))
    raise NotImplementedError(op)


def vm_select(c, a, b, device="cpu") -> np.ndarray:
    return _host(torch.where(_dev(c, device) != 0, _dev(a, device),
                             _dev(b, device)))


# ---- window compaction (filter / discard / barrier lowering) ----


def vm_compact(keep, kinds, payload, device="cpu"
               ) -> tuple[np.ndarray, np.ndarray | None]:
    """Window compaction with the kinds column riding along the payload.

    ``keep`` bool [N]; ``kinds`` int64 [N]; ``payload`` int64 [N, D] or None.
    The kinds are stacked as column 0 so one kernel pass compacts both.
    """
    n = len(kinds)
    d = 0 if payload is None else payload.shape[1]
    if n == 0:
        return (np.zeros(0, _I64),
                None if payload is None else np.zeros((0, d), _I64))
    cols = np.zeros((n, d + 1), np.int32)
    cols[:, 0] = kinds
    if d:
        cols[:, 1:] = payload
    out, cnt = stream_compact(_dev(keep, device),
                              torch.from_numpy(cols).to(device))
    # one device->host copy: the count, then the zero-padded rows
    flat = _host(torch.cat([cnt.view(1), out.view(-1)]))
    out = flat[1:].reshape(n, d + 1)[:int(flat[0])]
    return out[:, 0], (out[:, 1:] if payload is not None else None)


# ---- windowed segmented reduction ----


def vm_segment_reduce(kinds, vals, op: str, init: int, acc: int,
                      group_open: bool, device="cpu"
                      ) -> tuple[np.ndarray, np.ndarray, int, bool]:
    """Windowed segmented reduction (executor entry point): every op, any
    carry, values or none — all on ``device``, nothing on host numpy."""
    ok, ov, cnt, carry = segment_reduce(
        _dev(kinds, device), None if vals is None else _dev(vals, device),
        init=init, op=op, acc=acc, group_open=group_open)
    # one device->host copy: count, carry, then the zero-padded slots
    flat = _host(torch.cat([cnt.view(1), carry, ok, ov]))
    m, n2 = int(flat[0]), ok.shape[0]
    return (flat[3:3 + m], flat[3 + n2:3 + n2 + m], int(flat[1]),
            bool(flat[2]))


# ---- merge / zip run selection ----


def vm_data_run(kinds, device="cpu") -> int:
    """Length of the leading run of data tokens."""
    n = len(kinds)
    if n == 0:
        return 0
    bar = _dev(kinds, device) != 0
    first = torch.where(bar.any(), torch.argmax(bar.to(torch.int32)), n)
    return int(first)


def vm_first_mismatch(ref, others, device="cpu") -> int:
    """First index where any of ``others`` differs from ``ref``."""
    n = len(ref)
    if not others or n == 0:
        return n
    stack = _dev(np.stack([np.asarray(a, _I64)[:n]
                           for a in [ref] + list(others)]), device)
    mism = (stack[1:] != stack[:1]).any(0)
    first = torch.where(mism.any(), torch.argmax(mism.to(torch.int32)), n)
    return int(first)
