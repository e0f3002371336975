"""segment_reduce — one SLTF reduce window (§III-B(b)), written by hand for
Hopper.

Reduces the innermost ragged dimension of a barrier-delimited stream with a
carried accumulator: data tokens fold into the open group; Ω1 emits the
group's value (``init`` for an empty group — the [[]] vs [] distinction of
§III-A); Ωn>1 emits the trailing group when it is open, then the lowered
barrier Ω(n-1).  The semantics are ``core/backend.py::
segment_reduce_window_np``'s, bit for bit, for every reduce op of the IR
(add, min, max, and, or, xor), with or without values, and for any carried
``(acc, group_open)``.

On a CUDA tensor :func:`segment_reduce` launches ``csrc/segment_reduce.cu``
(which replaces the TPU kernel ``repro/kernels/segment_reduce.py::
_segred_kernel``); on a CPU tensor it runs :func:`segment_reduce_plain`.
There is no fallback from one to the other.

The kernel is one launch, with the compaction of the emitted tokens fused
in: a window of at most :data:`TILE_ROWS` tokens (every window of the apps)
is one block; a longer one walks tiles of that many tokens, each taking its
predecessors' state (the carry so far and the tokens emitted so far) by a
decoupled look-back, after one memset of the tiles' status words.  Its
output is one int32 buffer (:func:`segment_reduce_flat`).

:func:`segment_reduce_carry` is the device-carry entry of the resident
loop (``core/device_vm.py``): one window of at most :data:`TILE_ROWS`
lanes whose valid count, carry and request ids are all device tensors, so
that a CUDA graph captures the call; the carry is written back in place.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .stream_compact import stream_compact_plain

NOTHING = -1                      # "no token" slot marker
OPS = ("add", "min", "max", "and", "or", "xor")   # kernel op codes 0..5
_I32_MIN, _I32_MAX = -(1 << 31), (1 << 31) - 1
_MAX_TOKENS = (1 << 30) - 1       # 2 slots per token, counted in int32


def _check(kinds, vals, op) -> None:
    if op not in OPS:
        raise NotImplementedError(f"segment_reduce: unknown op {op!r}")
    if kinds.dtype != torch.int32 or kinds.dim() != 1:
        raise TypeError("segment_reduce: kinds must be int32 [N], got "
                        f"{kinds.dtype} {tuple(kinds.shape)}")
    if not kinds.is_contiguous():
        raise ValueError("segment_reduce: kinds must be contiguous")
    if kinds.shape[0] > _MAX_TOKENS:
        raise ValueError(f"segment_reduce: {kinds.shape[0]} tokens exceed the "
                         f"kernel's int32 slot counts ({_MAX_TOKENS})")
    if vals is not None:
        if vals.dtype != torch.int32 or vals.shape != kinds.shape:
            raise TypeError("segment_reduce: vals must be int32 like kinds, "
                            f"got {vals.dtype} {tuple(vals.shape)}")
        if vals.device != kinds.device or not vals.is_contiguous():
            raise ValueError("segment_reduce: vals must be contiguous and "
                             "on the device of kinds")


def _fold(op: str, g: torch.Tensor, seg: torch.Tensor, v: torch.Tensor
          ) -> torch.Tensor:
    """Fold int64 values ``v`` into ``g[seg]`` with ``op`` (int64, values in
    the signed 32-bit range; the caller wraps ``add``)."""
    if op == "add":
        return g.index_add_(0, seg, v)
    if op in ("min", "max"):
        return g.scatter_reduce_(0, seg, v, "amin" if op == "min" else "amax")
    # bitwise ops: per-bit planes, since torch has no scatter and/or/xor
    shifts = torch.arange(32, device=g.device)
    gb = ((g & 0xFFFFFFFF)[:, None] >> shifts) & 1
    vb = ((v & 0xFFFFFFFF)[:, None] >> shifts) & 1
    idx = seg[:, None].expand(-1, 32)
    if op == "and":
        gb.scatter_reduce_(0, idx, vb, "amin")
    elif op == "or":
        gb.scatter_reduce_(0, idx, vb, "amax")
    else:
        gb.index_add_(0, seg, vb)
        gb &= 1
    u = (gb << shifts).sum(1)
    return torch.where(u > _I32_MAX, u - (1 << 32), u)


def segment_reduce_plain(kinds: torch.Tensor, vals: torch.Tensor | None,
                         init: int = 0, op: str = "add",
                         acc: int | None = None, group_open: bool = False):
    """Plain torch version of the kernel, on any device; same returns as
    :func:`segment_reduce`."""
    _check(kinds, vals, op)
    acc = init if acc is None else acc
    dev, n = kinds.device, kinds.shape[0]
    k = kinds.long()
    is_bar = k > 0
    seg = torch.cumsum(is_bar.long(), 0) - is_bar.long()
    nbar = int(is_bar.sum())
    data = ~is_bar
    has = torch.zeros(nbar + 1, dtype=torch.bool, device=dev)
    has[seg[data]] = True
    has[0] |= bool(group_open)
    bk = k[is_bar]                                # barrier levels, in order
    emit = (bk == 1) | has[:nbar]
    emitted_before = torch.zeros(nbar + 1, dtype=torch.bool, device=dev)
    emitted_before[1:] = torch.cumsum(emit.long(), 0) > 0
    g = torch.where(emitted_before, torch.tensor(init, device=dev),
                    torch.tensor(acc, device=dev)).long()
    if vals is not None:
        g = _fold(op, g, seg[data], vals.long()[data])
    g = ((g - _I32_MIN) & 0xFFFFFFFF) + _I32_MIN
    slot_k = torch.full((n, 2), NOTHING, dtype=torch.int64, device=dev)
    slot_v = torch.zeros((n, 2), dtype=torch.int64, device=dev)
    slot_k[:nbar, 0] = torch.where(emit, 0, NOTHING)
    slot_v[:nbar, 0] = torch.where(emit, g[:nbar], 0)
    slot_k[:nbar, 1] = torch.where(bk > 1, bk - 1, NOTHING)
    rows = torch.stack([slot_k.reshape(-1), slot_v.reshape(-1)], 1)
    out, count = stream_compact_plain(
        (rows[:, 0] != NOTHING).int(), rows.int().contiguous())
    carry = torch.stack([g[nbar], has[nbar].long()]).int()
    return out[:, 0], out[:, 1], count, carry


#: tokens per tile of the kernel (``kTile`` in ``csrc/segment_reduce.cu``,
#: checked when the library loads): a window of at most this many tokens is
#: one block with no scratch; a longer one takes tiles by a decoupled
#: look-back
TILE_ROWS = 4096


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("segment_reduce")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.segment_reduce_launch.argtypes = (
        [p, p, ctypes.c_longlong, i, i, i, i, p, p, p])
    lib.segment_reduce_launch.restype = ctypes.c_int
    lib.segment_reduce_carry_launch.argtypes = [p, p, p, p, i, i, i, p, p, p]
    lib.segment_reduce_carry_launch.restype = ctypes.c_int
    lib.segment_reduce_tile_rows.restype = ctypes.c_int
    _build.check_constant(lib.segment_reduce_tile_rows(), TILE_ROWS,
                          "segment_reduce", "TILE_ROWS")
    return lib


def _i32(x: int) -> int:
    return ((int(x) - _I32_MIN) & 0xFFFFFFFF) + _I32_MIN


def segment_reduce_flat(kinds: torch.Tensor, vals: torch.Tensor | None,
                        init: int = 0, op: str = "add",
                        acc: int | None = None, group_open: bool = False
                        ) -> torch.Tensor:
    """The result of :func:`segment_reduce` as one int32 tensor [4N + 3]:
    ``out_kinds`` [2N], ``out_vals`` [2N], ``count``, ``carry`` [2].

    One buffer, so a caller brings the whole result to the host in one copy.
    A CUDA tensor launches the kernel (raising if it cannot), a CPU tensor
    runs :func:`segment_reduce_plain`."""
    _check(kinds, vals, op)
    if kinds.device.type == "cpu":
        ok, ov, count, carry = segment_reduce_plain(kinds, vals, init, op,
                                                    acc, group_open)
        return torch.cat([ok, ov, count.view(1), carry])
    if kinds.device.type != "cuda":
        raise ValueError(f"segment_reduce: unsupported device {kinds.device}")
    lib = _lib()
    acc = init if acc is None else acc
    dev, n = kinds.device, kinds.shape[0]
    flat = torch.empty(4 * n + 3, dtype=torch.int32, device=dev)
    # per tile: a status word and two values; then the tile counter.  The
    # launch zeroes them itself
    scratch = (None if n <= TILE_ROWS else
               torch.empty(2 * -(-n // TILE_ROWS) + 1, dtype=torch.int64,
                           device=dev))
    with torch.cuda.device(dev):
        err = lib.segment_reduce_launch(
            kinds.data_ptr(), None if vals is None else vals.data_ptr(), n,
            OPS.index(op), _i32(init), _i32(acc), int(bool(group_open)),
            flat.data_ptr(), None if scratch is None else scratch.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    segment_reduce.launches += 1
    _build.check(lib, "segment_reduce", err)
    return flat


def segment_reduce(kinds: torch.Tensor, vals: torch.Tensor | None,
                   init: int = 0, op: str = "add", acc: int | None = None,
                   group_open: bool = False):
    """kinds [N] int32 (0 = data, n > 0 = Ωn), vals [N] int32 or None ->
    ``(out_kinds [2N], out_vals [2N], count, carry)``.

    The first ``count`` entries of ``out_kinds``/``out_vals`` are the emitted
    tokens, the rest zeros; ``count`` is a 0-d int32 tensor and ``carry`` an
    int32 tensor ``[acc, group_open]`` after the window, all views of
    :func:`segment_reduce_flat`'s buffer on the input's device.  ``acc``
    defaults to ``init``."""
    flat = segment_reduce_flat(kinds, vals, init, op, acc, group_open)
    n2 = 2 * kinds.shape[0]
    return flat[:n2], flat[n2:2 * n2], flat[2 * n2], flat[2 * n2 + 1:]


#: kernel launches so far, of both entries (CUDA calls only; the plain path
#: does not count; a replayed CUDA graph adds its captured launches per
#: replay: ``core/device_vm.py``)
segment_reduce.launches = 0


# ---------------------------------------------------------------------------
# the device-carry entry: one window of a resident tick loop
# ---------------------------------------------------------------------------

def _check_carry(kinds, vals, rids, n, op, carry) -> None:
    _check(kinds, vals, op)
    w = kinds.shape[0]
    if not 1 <= w <= TILE_ROWS:
        raise ValueError(f"segment_reduce_carry: a window of {w} lanes, "
                         f"want 1..{TILE_ROWS}")
    for name, t, shape in (("rids", rids, (w,)), ("n", n, ()),
                           ("carry", carry, (2,))):
        if t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise TypeError(f"segment_reduce_carry: {name} must be int32 "
                            f"{shape}, got {t.dtype} {tuple(t.shape)}")
        if t.device != kinds.device or not t.is_contiguous():
            raise ValueError(f"segment_reduce_carry: {name} must be "
                             "contiguous and on the device of kinds")


def segment_reduce_carry_plain(kinds, vals, rids, n, op, init, carry):
    """Plain torch version of the device-carry kernel: the reference's
    fixed-shape ``device_loop.segment_reduce_window`` (segments by a cumsum
    of barriers, a fold into per-segment starts, two emission slots a
    barrier, a compaction); same arguments and returns as
    :func:`segment_reduce_carry`."""
    _check_carry(kinds, vals, rids, n, op, carry)
    w, dev = kinds.shape[0], kinds.device
    lane = torch.arange(w, dtype=torch.int32, device=dev)
    valid = lane < n
    is_bar = (kinds > 0) & valid
    is_data = (kinds == 0) & valid
    bi = is_bar.int()
    csum = torch.cumsum(bi, 0, dtype=torch.int32)
    seg = csum - bi                         # barrier j closes segment j
    nbar = csum[-1:]
    # per-segment data count -> open flag; slot w + 1 takes dropped lanes
    cnt = torch.zeros(w + 2, dtype=torch.int32, device=dev)
    cnt.index_add_(0, torch.where(is_data, seg, w + 1), is_data.int())
    open_ = cnt[:w + 1] > 0
    open_[0] |= carry[1] != 0
    # barrier slots: slot j = the j-th barrier of the window (w: dropped)
    bidx = torch.where(is_bar, csum - 1, w).long()
    bk = torch.zeros(w + 1, dtype=torch.int32, device=dev).scatter_(
        0, bidx, kinds)[:w]
    brid = torch.zeros(w + 1, dtype=torch.int32, device=dev).scatter_(
        0, bidx, rids)[:w]
    live = lane < nbar
    emit = ((bk == 1) | open_[:w]) & live
    lower = (bk > 1) & live
    before = torch.zeros(w + 1, dtype=torch.bool, device=dev)
    before[1:] = torch.cumsum(emit.int(), 0) > 0
    g = torch.where(before, init, carry[0].long()).long()
    g = torch.cat([g, g.new_zeros(1)])
    if vals is not None:     # a valueless reduce folds nothing
        g = _fold(op, g, torch.where(is_data, seg, w + 1).long(),
                  vals.long())
    g = (((g - _I32_MIN) & 0xFFFFFFFF) + _I32_MIN).int()
    new_acc = g.gather(0, nbar.long())
    new_open = open_.gather(0, nbar.long()).int()
    k2 = torch.stack([torch.where(emit, 0, NOTHING),
                      torch.where(lower, bk - 1, NOTHING)], 1).reshape(-1)
    v2 = torch.stack([torch.where(emit, g[:w], 0),
                      torch.zeros_like(g[:w])], 1).reshape(-1)
    r2 = torch.stack([brid, brid], 1).reshape(-1)
    out, count = stream_compact_plain(
        (k2 != NOTHING).int(), torch.stack([k2, v2, r2], 1).int())
    carry.copy_(torch.cat([new_acc, new_open]))
    return out[:, 0], out[:, 1], out[:, 2], count


def segment_reduce_carry(kinds: torch.Tensor, vals: torch.Tensor | None,
                         rids: torch.Tensor, n: torch.Tensor, op: str,
                         init: int, carry: torch.Tensor):
    """One reduce-output window of a resident tick loop, every input on the
    device: kinds, rids [W] int32 (W <= :data:`TILE_ROWS`), vals [W] int32
    or None, n a 0-d int32 (lanes ``[0, n)`` are valid), ``carry`` int32
    ``[acc, group_open]`` -> ``(out_kinds, out_vals, out_rids [2W],
    count)``, and ``carry`` updated in place.

    Each emitted token carries the request id of the barrier that emits
    it; the first ``count`` entries are the emissions, the rest zeros.  A
    CUDA tensor launches the kernel's device-carry entry (one block, one
    launch, no host value: a CUDA graph can capture it), a CPU tensor runs
    :func:`segment_reduce_carry_plain`.  With ``n`` 0 the carry is left
    as it was."""
    if kinds.device.type == "cpu":
        return segment_reduce_carry_plain(kinds, vals, rids, n, op, init,
                                          carry)
    _check_carry(kinds, vals, rids, n, op, carry)
    if kinds.device.type != "cuda":
        raise ValueError(f"segment_reduce: unsupported device {kinds.device}")
    lib = _lib()
    w = kinds.shape[0]
    flat = torch.empty(6 * w + 1, dtype=torch.int32, device=kinds.device)
    with torch.cuda.device(kinds.device):
        err = lib.segment_reduce_carry_launch(
            kinds.data_ptr(), None if vals is None else vals.data_ptr(),
            rids.data_ptr(), n.data_ptr(), w, OPS.index(op), _i32(init),
            carry.data_ptr(), flat.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    segment_reduce.launches += 1
    _build.check(lib, "segment_reduce", err)
    w2 = 2 * w
    return flat[:w2], flat[w2:2 * w2], flat[2 * w2:3 * w2], flat[3 * w2]
