"""Device-resident tick primitives — the resident loop's building blocks.

``kernels/ops.py`` exposes *per-window* executor entry points: the host
scheduler calls one of them per window and pays a host round trip per
call.  This module is the other half: fixed-shape torch functions on int32
tensors that a tick of ``core/device_vm.py`` strings together, so that the
whole superstep schedule runs on the device and a captured CUDA graph of
ticks replays with no host round trip inside it.

Every function here obeys the rules that make capture possible:

* **fixed shapes** — windows are always ``W`` lanes (invalid lanes masked),
  queues are fixed-capacity rings indexed modulo a power of two, and
  variable-length results come back as ``(buffer, count)`` pairs with the
  count a device tensor;
* **no host value** — fire/stall decisions are masked tensor ops
  (``torch.where``), never Python branches on a tensor: no ``.item()``, no
  boolean-mask indexing, no ``nonzero``;
* **no dropped index** — an index past a buffer's end is a device-side
  assert on CUDA, so every buffer that takes a masked scatter has a dump
  slot past its live part, and masked lanes write there.

Values are int32 throughout: the IR's 32-bit wrap discipline is the native
overflow of int32 add, sub, mul and shl.  The unsigned ops (``udiv``,
``umod``, ``lshr``, ``ult``, ``ule``) and the signed division run in int64
on the 32-bit patterns and wrap back, as ``backend._vec_binop`` does.

The SLTF token encoding matches ``core/sltf.py``: kind 0 = data, k>0 = Ωk.
Ring slots beyond ``tail-head`` hold stale values; every consumer masks by
the valid count.  The hidden request-id column rides as the last payload
column of every ring, as in the windowed VM.

Window compaction and the windowed segmented reduction are the two
hand-written kernels (``kernels/stream_compact.py``, and the device-carry
entry of ``kernels/segment_reduce.py``); on a CPU tensor they run their
plain torch versions.
"""
from __future__ import annotations

import torch

from .segment_reduce import segment_reduce_carry
from .stream_compact import stream_compact

_I32 = torch.int32
_U32 = 0xFFFFFFFF

# reduce ops of the resident form: the reference's device segment-reduce
# has a scatter combiner for these only, and programs using and/or/xor fall
# back to the windowed path (``device_vm.resident_unsupported``)
SCATTER_REDUCE_OPS = ("add", "min", "max")

_LANES: dict = {}


def lanes(width: int, device, dtype=_I32, start: int = 0) -> torch.Tensor:
    """``arange(start, start + width)`` on ``device``, made once and kept.
    A CUDA graph reads it by address, so it must exist before a capture
    starts: a first request inside a capture raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = (int(width), dev, dtype, int(start))
    t = _LANES.get(key)
    if t is None:
        if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"device_loop.lanes({width}) first asked for "
                               "inside a CUDA graph capture")
        t = _LANES[key] = torch.arange(start, start + width, dtype=dtype,
                                       device=dev)
    return t


# ---------------------------------------------------------------------------
# element-wise body ops (int32-native wrap semantics)
# ---------------------------------------------------------------------------

def _u(x: torch.Tensor) -> torch.Tensor:
    return x.long() & _U32


def dev_binop(op: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IR binop on int32 lanes, bit-identical to ``backend._vec_binop``
    (the numpy oracle), whose int64 intermediates wrap to signed 32 bits.
    ``sdiv``/``smod`` of ``INT32_MIN`` follow the oracle: the int64 form
    takes ``abs`` without the int32 overflow."""
    if op == "add":
        return a + b
    if op == "sub":
        return a - b
    if op == "mul":
        return a * b
    if op in ("sdiv", "smod"):
        a64, b64 = a.long(), b.long()
        m = a64.abs()
        d = torch.where(b64 == 0, 1, b64.abs())
        if op == "sdiv":
            q = torch.where(b64 == 0, 0, m // d)
            return torch.where((a64 < 0) != (b64 < 0), -q, q).int()
        r = torch.where(b64 == 0, 0, m % d)
        return torch.where(a64 < 0, -r, r).int()
    if op in ("udiv", "umod"):
        ua, ub = _u(a), _u(b)
        d = torch.where(ub == 0, 1, ub)
        q = ua // d if op == "udiv" else ua % d
        return torch.where(ub == 0, 0, q).int()
    if op == "and":
        return a & b
    if op == "or":
        return a | b
    if op == "xor":
        return a ^ b
    if op == "shl":
        return (a.long() << (b & 31).long()).int()
    if op == "lshr":
        return (_u(a) >> (b & 31).long()).int()
    if op == "ashr":
        return a >> (b & 31)
    if op == "eq":
        return (a == b).int()
    if op == "ne":
        return (a != b).int()
    if op == "slt":
        return (a < b).int()
    if op == "sle":
        return (a <= b).int()
    if op == "sgt":
        return (a > b).int()
    if op == "sge":
        return (a >= b).int()
    if op == "ult":
        return (_u(a) < _u(b)).int()
    if op == "ule":
        return (_u(a) <= _u(b)).int()
    if op == "min":
        return torch.minimum(a, b)
    if op == "max":
        return torch.maximum(a, b)
    raise NotImplementedError(op)


# ---------------------------------------------------------------------------
# fixed-capacity ring queues
# ---------------------------------------------------------------------------
# A ring is (kinds:(cap+pad,), vals:(cap+pad,nv)) plus absolute head/tail
# counters kept in shared (n_rings,) vectors; cap is a power of two so
# position = counter & (cap-1).  head==tail means empty; tail-head is the
# live length.  The trailing ``pad`` slots (2*vlen, the widest push) are
# scratch: a push sends the lanes it does not keep there, writing the pad's
# own values back, so a masked push changes nothing and no index leaves
# the buffer.  A peek or push is one gather or scatter at modular
# positions, which lands every live slot where the reference's contiguous
# slices and front re-issue put it.

def ring_peek(kinds: torch.Tensor, vals: torch.Tensor, head: torch.Tensor,
              cap: int, width: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The front ``width`` slots (stale beyond the live length — callers
    mask with their own valid count); ``width <= cap``."""
    idx = (head + lanes(width, kinds.device, torch.int64)) & (cap - 1)
    return kinds.index_select(0, idx), vals.index_select(0, idx)


def ring_push(kinds: torch.Tensor, vals: torch.Tensor, tail: torch.Tensor,
              used: torch.Tensor, cap: int, k_buf: torch.Tensor,
              v_buf: torch.Tensor, count: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Write the front ``count`` slots of ``(k_buf, v_buf)`` at the tail, in
    place.  Returns ``(overflow, written)``; on overflow nothing is written
    (the caller latches an error flag and the loop halts, so the ring is
    never corrupted by a wrapped write)."""
    width = k_buf.shape[0]
    lane = lanes(width, kinds.device, torch.int64)
    over = used + count > cap
    written = torch.where(over, 0, count)
    keep = lane < written
    idx = torch.where(keep, (tail + lane) & (cap - 1),
                      lanes(width, kinds.device, torch.int64, cap))
    kinds.index_copy_(0, idx, torch.where(keep, k_buf,
                                          kinds[cap:cap + width]))
    vals.index_copy_(0, idx, torch.where(keep[:, None], v_buf,
                                         vals[cap:cap + width]))
    return over, written


# ---------------------------------------------------------------------------
# window-level helpers
# ---------------------------------------------------------------------------

def window_compact(keep: torch.Tensor, k_in: torch.Tensor,
                   v_in: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stream compaction with a fixed output buffer: surviving lanes pack to
    the front in order, ``count`` (a 0-d device tensor) says how many, rows
    past it are zeros.  ``keep`` already folds validity.  One launch of the
    ``stream_compact`` kernel on CUDA, the kinds riding as column 0."""
    rows, count = stream_compact(
        keep.int(), torch.cat([k_in[:, None], v_in], 1))
    return rows[:, 0], rows[:, 1:], count


def leading_run(mask: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Length of the leading True-run of ``mask`` within the first ``n``
    lanes (= ``backend.data_run`` when mask = kinds==0): the running
    product of the mask is 1 exactly up to its first False."""
    run = mask.int().cumprod(0).sum(dtype=_I32)
    return torch.minimum(run, n)


def first_index(mask: torch.Tensor, default) -> torch.Tensor:
    """Index of the first True lane, else ``default``."""
    return torch.where(mask.any(), mask.int().argmax().int(), default)


def segment_reduce_window(kinds, vals, rids, n, op: str, init: int, carry):
    """One reduce-output window as one kernel launch — the fused-loop form
    of ``backend.segment_reduce_window_np`` (bit-identical emissions).

    ``kinds/vals/rids`` are ``(W,)`` with ``n`` valid lanes, ``carry`` the
    int32 ``[acc, group_open]`` of the reduce output, updated in place;
    returns ``(out_kinds, out_vals, out_rids, count)`` with ``(2W,)``
    buffers — two emission slots per input barrier: the data token
    carrying the accumulator, then the lowered barrier Ω(n-1), each with
    the barrier's request id."""
    return segment_reduce_carry(
        kinds.contiguous(), None if vals is None else vals.contiguous(),
        rids.contiguous(), n.to(_I32).reshape(()), op, init, carry)


def atomic_add_window(mem: torch.Tensor, addr: torch.Tensor,
                      delta: torch.Tensor, ok: torch.Tensor
                      ) -> torch.Tensor:
    """Vectorized fetch-and-add with sequential-within-window semantics:
    lane i observes the sum of all earlier ``ok`` lanes' deltas on its
    address (``VectorVM._atomic_add``'s stable-sort prefix form).  ``mem``
    is the array's live words plus one dump slot, updated in place;
    ``addr`` is already rebased and bounded, ``ok`` masks the participating
    lanes.  Returns ``old``, zero on lanes that are not ``ok``."""
    w = addr.shape[0]
    size = mem.shape[0] - 1                   # live words; the dump slot
    lane = lanes(w, mem.device)
    key = torch.where(ok, addr, size + 1)
    # stable sort by address (int32 keys, wrapping as the reference's):
    # ok lanes grouped by address, lane order kept
    order = torch.argsort(key * w + lane, stable=True)
    sa = addr[order]
    sd = torch.where(ok, delta, 0)[order]
    sok = ok[order]
    seg_start = torch.cat([sok[:1], (sa[1:] != sa[:-1]) & sok[1:]])
    csum = torch.cumsum(sd, 0, dtype=_I32) - sd    # exclusive global prefix
    start = torch.cummax(torch.where(seg_start, lane, -1), 0).values
    prefix = csum - csum[start.clamp(0, w - 1)]
    olds = torch.where(sok, mem[sa.clamp(0, size - 1)] + prefix, 0)
    old = torch.zeros_like(olds).scatter_(0, order, olds)
    mem.index_add_(0, torch.where(ok, addr, size), delta)
    return old
