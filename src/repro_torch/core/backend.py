"""Executor backends — the VectorVM's lane-level primitives, made pluggable.

The vectorized VM (``vector_vm.py``) is a *scheduler* (heads, queues,
allocation back-pressure) plus a set of *hot loops* (window compaction,
windowed segmented reduction, barrier lowering, element-wise body windows,
merge/zip run selection).  The scheduler calls an :class:`ExecutorBackend`
for every lane-level operation; the backend decides where it runs.

* :class:`NumpyBackend` — bit-exact vectorized numpy, the oracle every other
  backend must match (values *and* token counts).
* :class:`TorchBackend` — dispatches through the executor entry points in
  ``kernels/ops.py`` on one torch device.  On CUDA, compaction and segmented
  reduction launch the hand-written kernels (``kernels/stream_compact``,
  ``kernels/segment_reduce``); on the CPU they take the kernels' plain torch
  versions.

All backends exchange data at a fixed boundary: int64 numpy arrays whose
values respect the 32-bit wrap discipline of the IR (``ir.wrap32``).  A
torch call moves its window to the device as int32 and brings the result
back, so cross-backend equivalence stays a strict array equality.
"""
from __future__ import annotations

import numpy as np

from . import ir

_I64 = np.int64
NOTHING = -1          # "no token" slot marker (mirrors kernels/segment_reduce)


def _w32(a: np.ndarray) -> np.ndarray:
    """Wrap an int64 array to signed 32-bit semantics."""
    return a.astype(np.uint32).astype(np.int32).astype(_I64)


_INIT_MASK = {"i8": 0xFF, "i16": 0xFFFF}


def wrap_dram_init(arr, dtype: str) -> np.ndarray:
    """Normalize raw DRAM init values to the array's storage semantics
    (i32 two's-complement wrap, i8/i16 masked) — the same rule the store
    path applies.  Every executor wraps at init time so an unwrapped
    >= 2**31 input reaches all lanes as the identical signed-32 value: the
    torch route's kernels wrap at entry (``kernels/ops`` works on int32), and
    without this the numpy oracle would see the raw int64 instead."""
    a = np.asarray(arr, dtype=_I64).ravel()
    m = _INIT_MASK.get(dtype)
    return (a & m) if m is not None else _w32(a)


# ---------------------------------------------------------------------------
# Scalar + vector op tables (shared by backends and the TokenVM-style paths)
# ---------------------------------------------------------------------------

def _vec_binop(op: str, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Vectorized IR binop with 32-bit wrap semantics (numpy ground truth)."""
    u32 = lambda x: x.astype(np.uint32)
    if op == "add":
        return _w32(a + b)
    if op == "sub":
        return _w32(a - b)
    if op == "mul":
        return _w32(a * b)
    if op == "sdiv":
        q = np.zeros_like(a)
        nz = b != 0
        q[nz] = (np.abs(a[nz]) // np.abs(b[nz]))
        sign = np.where((a < 0) != (b < 0), -1, 1)
        return _w32(q * sign)
    if op == "udiv":
        out = np.zeros_like(a)
        nz = b != 0
        out[nz] = u32(a[nz]) // u32(b[nz])
        return _w32(out)
    if op == "smod":
        r = np.zeros_like(a)
        nz = b != 0
        r[nz] = np.abs(a[nz]) % np.abs(b[nz])
        return _w32(np.where(a < 0, -r, r))
    if op == "umod":
        out = np.zeros_like(a)
        nz = b != 0
        out[nz] = u32(a[nz]) % u32(b[nz])
        return _w32(out)
    if op == "and":
        return _w32(a & b)
    if op == "or":
        return _w32(a | b)
    if op == "xor":
        return _w32(a ^ b)
    if op == "shl":
        return _w32(a << (b & 31))
    if op == "lshr":
        return _w32(u32(a) >> u32(b & 31))
    if op == "ashr":
        return _w32(a.astype(np.int32) >> (b & 31).astype(np.int32))
    if op == "eq":
        return (a == b).astype(_I64)
    if op == "ne":
        return (a != b).astype(_I64)
    if op == "slt":
        return (a < b).astype(_I64)
    if op == "sle":
        return (a <= b).astype(_I64)
    if op == "sgt":
        return (a > b).astype(_I64)
    if op == "sge":
        return (a >= b).astype(_I64)
    if op == "ult":
        return (u32(a) < u32(b)).astype(_I64)
    if op == "ule":
        return (u32(a) <= u32(b)).astype(_I64)
    if op == "min":
        return np.minimum(a, b)
    if op == "max":
        return np.maximum(a, b)
    raise NotImplementedError(op)


def _scalar_red(op: str, a: int, b: int) -> int:
    if op == "add":
        return ir.wrap32(a + b)
    if op == "min":
        return min(a, b)
    if op == "max":
        return max(a, b)
    if op == "and":
        return a & b
    if op == "or":
        return a | b
    if op == "xor":
        return ir.wrap32(a ^ b)
    raise NotImplementedError(op)


_RED_UFUNC = {
    "add": np.add,
    "min": np.minimum,
    "max": np.maximum,
    "and": np.bitwise_and,
    "or": np.bitwise_or,
    "xor": np.bitwise_xor,
}


# ---------------------------------------------------------------------------
# Windowed segmented reduction — vectorized numpy ground truth
# ---------------------------------------------------------------------------

def segment_reduce_reference(kinds: np.ndarray, vals: np.ndarray | None,
                             op: str, init: int, acc: int, group_open: bool
                             ) -> tuple[np.ndarray, np.ndarray, int, bool]:
    """The historical per-token ``_reduce_out`` loop, kept verbatim as the
    *semantic reference* for :func:`segment_reduce_window_np` (tests compare
    the vectorized form against this; benchmarks use it as the baseline).
    Do not change one without the other."""
    out_kinds, out_vals = [], []
    for i in range(len(kinds)):
        k = int(kinds[i])
        if k == 0:
            if vals is not None:
                acc = _scalar_red(op, acc, int(vals[i]))
            group_open = True
        elif k == 1:
            out_kinds.append(0)
            out_vals.append(acc)
            acc = init
            group_open = False
        else:
            if group_open:
                out_kinds.append(0)
                out_vals.append(acc)
                acc = init
                group_open = False
            out_kinds.append(k - 1)
            out_vals.append(0)
    return (np.array(out_kinds, np.int64), np.array(out_vals, np.int64),
            acc, group_open)


def segment_emit_pattern(
        kinds: np.ndarray, group_open: bool
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Token-emission pattern of one segment-reduce window — a pure function
    of ``(kinds, group_open)``, shared by :func:`segment_reduce_window_np`
    and the VectorVM's per-request attribution (the VM uses it to stamp each
    emitted token with the request id of the barrier that closed its group,
    so it must stay bit-identical across backends).

    Returns ``(emit, lower, open_, seg, is_bar)``: per input barrier (in
    order), whether it emits a data token carrying the accumulator and
    whether it re-emits as a lowered barrier Ω(n-1); ``open_`` is the
    per-segment open flag (``open_[-1]`` is the window's outgoing
    ``group_open``); ``seg``/``is_bar`` are the per-position segment ids and
    barrier mask, returned so :func:`segment_reduce_window_np` does not
    recompute them on the hot path.
    """
    kinds = np.asarray(kinds, _I64)
    is_bar = kinds > 0
    nbar = int(is_bar.sum())
    # segment id per position: barrier j closes segment j
    seg = np.cumsum(is_bar) - is_bar
    cnt = np.zeros(nbar + 1, _I64)
    np.add.at(cnt, seg[~is_bar], 1)
    open_ = cnt > 0
    open_[0] |= bool(group_open)
    bk = kinds[is_bar]                        # barrier levels, in order
    # a barrier emits iff Ω1, or its group is open; a *non*-emitting barrier
    # leaves the accumulator untouched, so a segment starts from ``init``
    # only once some earlier barrier has emitted — else the carry flows on
    emit = (bk == 1) | open_[:nbar]
    return emit, bk > 1, open_, seg, is_bar


def segment_reduce_window_np(kinds: np.ndarray, vals: np.ndarray | None,
                             op: str, init: int, acc: int, group_open: bool
                             ) -> tuple[np.ndarray, np.ndarray, int, bool]:
    """One reduce-output window, fully vectorized (no per-token Python loop).

    Semantics match ``kernels/segment_reduce`` / the historical per-token
    loop exactly: data tokens fold into the carried accumulator; Ω1 emits the
    accumulator and resets it; Ωn>1 first emits the trailing implied group
    (iff it is open) then the lowered barrier Ω(n-1).

    Returns ``(out_kinds, out_vals, new_acc, new_group_open)``.
    """
    kinds = np.asarray(kinds, _I64)
    emit, lower, open_, seg, is_bar = segment_emit_pattern(kinds, group_open)
    nbar = len(emit)
    nseg = nbar + 1
    data_idx = np.nonzero(~is_bar)[0]
    segs_d = seg[data_idx]
    bk = kinds[is_bar]                        # barrier levels, in order
    emitted_before = np.zeros(nseg, bool)
    emitted_before[1:] = np.cumsum(emit) > 0
    g = np.where(emitted_before, init, acc).astype(_I64)
    if len(data_idx) and vals is not None:
        _RED_UFUNC[op].at(g, segs_d, np.asarray(vals, _I64)[data_idx])
    g = _w32(g)

    if nbar == 0:
        out_kinds = np.zeros(0, _I64)
        out_vals = np.zeros(0, _I64)
    else:
        # two output slots per barrier: [data emission, lowered barrier]
        k2 = np.full((nbar, 2), NOTHING, _I64)
        v2 = np.zeros((nbar, 2), _I64)
        k2[:, 0] = np.where(emit, 0, NOTHING)
        v2[:, 0] = np.where(emit, g[:nbar], 0)
        k2[lower, 1] = bk[lower] - 1
        flat_k = k2.ravel()
        keep = flat_k != NOTHING
        out_kinds = flat_k[keep]
        out_vals = v2.ravel()[keep]
    return out_kinds, out_vals, int(g[-1]), bool(open_[-1])


# ---------------------------------------------------------------------------
# Backend interface
# ---------------------------------------------------------------------------

class ExecutorBackend:
    """Lane-level primitive provider for the VectorVM.

    Contract: inputs/outputs are int64 numpy arrays in 32-bit-wrapped range;
    every implementation must be bit-identical to :class:`NumpyBackend`.
    Backends are stateless and shareable across VMs (reduction carries live
    in the VM, not here).
    """

    name = "abstract"

    #: whether :meth:`compile_resident` is implemented (DESIGN.md §9):
    #: :class:`TorchBackend` has it, the numpy oracle does not
    supports_resident = False

    # -- whole-program compile ---------------------------------------------
    def compile_resident(self, result, placement=None, **kwargs):
        """Compile a whole placed program into a single resident launch.
        Backends without a resident form raise — callers fall back to the
        per-window path."""
        raise NotImplementedError(
            f"backend {self.name!r} has no resident execution path")

    # -- element-wise body windows -----------------------------------------
    def binop(self, op: str, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def neg(self, a: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def logical_not(self, a: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def select(self, c: np.ndarray, a: np.ndarray, b: np.ndarray
               ) -> np.ndarray:
        raise NotImplementedError

    # -- tail primitives ----------------------------------------------------
    def compact(self, keep: np.ndarray, kinds: np.ndarray,
                payload: np.ndarray | None
                ) -> tuple[np.ndarray, np.ndarray | None]:
        """Stream compaction: keep the lanes where ``keep`` is True."""
        raise NotImplementedError

    def lower_barriers(self, kinds: np.ndarray, payload: np.ndarray | None
                       ) -> tuple[np.ndarray, np.ndarray | None]:
        """`flatten`: drop Ω1 tokens, lower Ωn to Ω(n-1)."""
        raise NotImplementedError

    def segment_reduce(self, kinds: np.ndarray, vals: np.ndarray | None,
                       op: str, init: int, acc: int, group_open: bool
                       ) -> tuple[np.ndarray, np.ndarray, int, bool]:
        """Windowed segmented reduction with carried accumulator."""
        raise NotImplementedError

    # -- head primitives (merge/zip run selection) --------------------------
    def data_run(self, kinds: np.ndarray) -> int:
        """Length of the leading run of data tokens."""
        raise NotImplementedError

    def first_mismatch(self, ref: np.ndarray,
                       others: list[np.ndarray]) -> int:
        """Longest aligned prefix: first index where any array differs from
        ``ref`` (``len(ref)`` when none does). Used by zip heads."""
        raise NotImplementedError


class NumpyBackend(ExecutorBackend):
    """Bit-exact vectorized numpy — the oracle every backend must match."""

    name = "numpy"

    def binop(self, op, a, b):
        return _vec_binop(op, a, b)

    def neg(self, a):
        return _w32(-a)

    def logical_not(self, a):
        return (a == 0).astype(_I64)

    def select(self, c, a, b):
        return np.where(c != 0, a, b)

    def compact(self, keep, kinds, payload):
        return kinds[keep], (payload[keep] if payload is not None else None)

    def lower_barriers(self, kinds, payload):
        m = kinds != 1
        out = np.where(kinds > 1, kinds - 1, kinds)[m]
        return out, (payload[m] if payload is not None else None)

    def segment_reduce(self, kinds, vals, op, init, acc, group_open):
        return segment_reduce_window_np(kinds, vals, op, init, acc,
                                        group_open)

    def data_run(self, kinds):
        bars = np.nonzero(kinds != 0)[0]
        return int(bars[0]) if len(bars) else len(kinds)

    def first_mismatch(self, ref, others):
        n = len(ref)
        L = n
        for k in others:
            diff = np.nonzero(k[:n] != ref)[0]
            if len(diff):
                L = min(L, int(diff[0]))
        return L


class TorchBackend(ExecutorBackend):
    """Dispatch through ``kernels/ops.py`` on one torch device.

    ``device=None`` means ``"cuda"``; a host without CUDA raises instead of
    falling back to the CPU.  ``device="cpu"`` runs the kernels' plain torch
    versions (the tests use it).  ``name`` carries the device type, so the
    compile cache keeps the two apart.  :meth:`compile_resident` builds the
    resident form (``core/device_vm.py``) on the same device.
    """

    supports_resident = True

    def __init__(self, device=None):
        import torch                     # deferred: numpy backend stays light
        from ..kernels import ops as _ops
        self._ops = _ops
        dev = torch.device("cuda" if device is None else device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "TorchBackend: no CUDA device on this host (torch "
                f"{torch.__version__}); pass device='cpu' to run the plain "
                "torch path")
        self.device = dev
        self.name = f"torch[{dev.type}]"

    def compile_resident(self, result, placement=None, **kwargs):
        from .device_vm import DeviceProgram
        dfg = getattr(result, "dfg", result)
        dp = DeviceProgram(dfg, placement=placement, device=self.device,
                           **kwargs)
        dp.backend = self
        return dp

    def binop(self, op, a, b):
        return self._ops.vm_binop(op, a, b, device=self.device)

    def neg(self, a):
        return self._ops.vm_unop("neg", a, device=self.device)

    def logical_not(self, a):
        return self._ops.vm_unop("not", a, device=self.device)

    def select(self, c, a, b):
        return self._ops.vm_select(c, a, b, device=self.device)

    def compact(self, keep, kinds, payload):
        return self._ops.vm_compact(keep, kinds, payload, device=self.device)

    def lower_barriers(self, kinds, payload):
        keep = kinds != 1
        lowered = np.where(kinds > 1, kinds - 1, kinds)
        return self._ops.vm_compact(keep, lowered, payload,
                                    device=self.device)

    def segment_reduce(self, kinds, vals, op, init, acc, group_open):
        return self._ops.vm_segment_reduce(kinds, vals, op, init, acc,
                                           group_open, device=self.device)

    def data_run(self, kinds):
        return self._ops.vm_data_run(kinds, device=self.device)

    def first_mismatch(self, ref, others):
        return self._ops.vm_first_mismatch(ref, others, device=self.device)


_BACKENDS = {
    "numpy": NumpyBackend,
    "torch": TorchBackend,
}


def make_backend(spec: str | ExecutorBackend | None) -> ExecutorBackend:
    """Resolve a backend spec: an instance passes through; a name constructs
    one (``"numpy"``, ``"torch"`` — the latter on CUDA); ``None`` means
    ``TorchBackend()`` on CUDA, which raises on a host without it."""
    if spec is None:
        return TorchBackend()
    if isinstance(spec, ExecutorBackend):
        return spec
    try:
        return _BACKENDS[spec]()
    except KeyError:
        raise ValueError(
            f"unknown executor backend {spec!r}; "
            f"available: {sorted(_BACKENDS)}") from None
