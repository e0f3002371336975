"""Device-resident execution — the whole superstep schedule on the device.

The windowed executor (``vector_vm.py``) keeps the superstep scheduler on
the host: every context firing is a separate ``vm_*`` call, so a run pays
one host round trip per window.  This module compiles a placed program's
*entire* superstep schedule into a tick of torch ops on device state:

* every inter-context queue is a fixed-capacity device ring (kinds column,
  payload block whose last column is the hidden request id, and a row in
  the shared head/tail vectors — see ``kernels/device_loop.py``);
* each context's fire/stall decision is a masked tensor computation inside
  the tick (readiness is evaluated against the tick-start head/tail
  snapshot, exactly like the host scheduler's ready-set snapshot);
* protocol state (counter expansions, loop-header wave sessions, reduce
  carries, allocator free lists) lives in small device tensors.

**On CUDA** ``ticks_per_replay`` ticks are captured once per
:class:`DeviceProgram` as one ``torch.cuda.CUDAGraph`` (window compaction
and the reduce windows are launches of the ``stream_compact`` kernel and
the device-carry entry of ``segment_reduce`` inside it); the host replays
the graph and reads ``(prog, err, tick)`` once per replay, in one small
copy, until quiescence.  A device flag ``running = prog & (err == 0) &
(tick < max_ticks)`` gates every fire, the tick counter and the ``ticks``
stat, so ticks past quiescence or past a latched error change nothing.
Nothing in the tick body syncs the host.  Each context's fire path runs
every tick with its ready flag as a mask (``form="masked"``): each path is
a value-level no-op when the flag is false.

**On the CPU** (the tests) the same tick body runs with the contexts whose
ready flag is false skipped on the host (``form="skip"``): the reference's
per-context ``lax.cond``.  Setting ``form = "masked"`` on a CPU program
runs the masked CUDA form there, ticks in blocks as the graph replays
them.

**Equivalence contract** (DESIGN.md §9): the resident path must be
bit-identical to the windowed oracle in DRAM outputs and aggregate
:data:`~repro_torch.core.vector_vm.LANE_STATS` (every data lane's body ops
and memory effects).  It need *not* replicate the host tick schedule —
every per-link stream is FIFO either way, and per-context windows partition
the same token streams, so window boundaries (and therefore ``ticks``) may
differ while every consumed value and memory effect stays the same.
Per-link token counts also match on loop-free graphs; loop headers emit
one Ω1 *wave marker* per recirculation round, and round structure is
schedule-dependent when parallel sessions overlap, so wave-marker counts
(never data tokens) may differ there.  The ``ticks`` stat reports device
loop iterations; ``launches`` is 1 (one resident program a run; the graph
replays are ``DeviceRun.replays``).

Programs using constructs the fused loop cannot express
(:func:`resident_unsupported`, the reference's list) fall back to the
per-window path; the Table III apps all run resident.
"""
from __future__ import annotations

import collections
import time
from typing import Optional

import numpy as np
import torch

from . import ir
from .dfg import (DFG, CounterHead, ForwardMergeHead, FwdBwdMergeHead,
                  SingleHead, SourceHead, ZipHead)
from .vector_vm import (LANE_STATS, RID, VLEN, VectorDeadlock,
                        loop_mixing_hazards)
from ..kernels import device_loop as dl
from ..kernels.device_loop import SCATTER_REDUCE_OPS
from ..kernels.segment_reduce import segment_reduce
from ..kernels.stream_compact import stream_compact

_I32 = torch.int32
_KERNELS = (stream_compact, segment_reduce)   # launch counters of the tick


class QueueOverflow(VectorDeadlock):
    """A fixed-capacity device queue overflowed (or would, per the host-side
    pre-check).  Names the link and its capacity instead of silently
    wrapping or dying inside an opaque device abort."""

    def __init__(self, msg: str, link: Optional[int] = None,
                 capacity: Optional[int] = None):
        super().__init__(msg)
        self.link = link
        self.capacity = capacity


# error codes latched by the device loop (state["err"]); 0 = no error.
# Overflow codes name the ring row so the host can report the link.
_ERR_OVERFLOW = 1          # 1..n_rings: overflow on ring row err-1
_ERR_ZIP = 1 << 20         # + ctx id: zip structural mismatch
_ERR_MERGE = 2 << 20       # + ctx id: merge barrier mismatch
_ERR_MERGE_ALLOC = 3 << 20  # + ctx id: alloc stall inside a merge
_ERR_FB = 4 << 20          # + ctx id: loop-header protocol violation


def _next_pow2(n: int) -> int:
    return 1 << max(1, (int(n) - 1).bit_length())


# Default launch-size buckets for resident execution: the same ladder the
# serving engine uses for batch-size bucketing (serve/dataflow.py), so one
# cached DeviceProgram capture per bucket serves every batch size in
# between (pad slots replay the last request; see api.run_fused).
RESIDENT_BUCKETS = (1, 2, 4, 8, 16, 32, 64)


def bucket_launch_size(n: int, buckets="auto") -> int:
    """Smallest configured bucket >= ``n`` (or ``n`` itself when it exceeds
    every bucket).  ``buckets`` may be ``"auto"``/``True`` for
    :data:`RESIDENT_BUCKETS` or an explicit iterable of sizes."""
    if buckets in ("auto", True):
        buckets = RESIDENT_BUCKETS
    n = int(n)
    for b in sorted(int(b) for b in buckets):
        if b >= n:
            return b
    return n


def resident_unsupported(g: DFG) -> list[str]:
    """Static reasons a DFG cannot run on the fused device loop — the
    reference's list, kept as it is.  Empty means :class:`DeviceProgram`
    supports it; otherwise the backend falls back to the per-window path
    (fallback rules, DESIGN.md §9)."""
    reasons: list[str] = []
    for c in g.contexts.values():
        for op in c.body:
            if op.op == "rr_counter":
                reasons.append(
                    f"{c.name}: rr_counter (replicate steering) has no "
                    f"fused-loop form yet")
            if op.op == "atomic_add" and \
                    g.dram[op.space].dtype != "i32":
                reasons.append(
                    f"{c.name}: atomic_add on {g.dram[op.space].dtype} "
                    f"DRAM needs a re-masking scatter")
        for o in c.outs:
            if o.kind == "reduce" and o.reduce_op not in SCATTER_REDUCE_OPS:
                reasons.append(
                    f"{c.name}: reduce op {o.reduce_op!r} has no "
                    f"scatter combiner in the fused loop (supported: "
                    f"{', '.join(SCATTER_REDUCE_OPS)})")
    return reasons


def queue_capacities(g: DFG, placement=None, vlen: int = VLEN
                     ) -> dict[int, int]:
    """Ring capacity per link for the resident executor.

    The floor is ``8*vlen`` (full windows plus protocol-emission headroom;
    the :class:`DeviceProgram` pre-check requires ``>= 4*vlen``).  When a
    placement is given, its per-context deadlock/retiming buffer
    attribution (``machine.map_graph``) scales the floor — delegated to
    :meth:`~repro_torch.core.place.Placement.queue_capacities`, so the
    budgets that size the physical FIFOs size the device rings.
    """
    if placement is not None:
        return placement.queue_capacities(g, vlen=vlen)
    base = 8 * vlen
    return {lid: min(1 << 16, _next_pow2(base)) for lid in g.links}


_DTYPE_MASK = {"i8": 0xFF, "i16": 0xFFFF, "i32": None}


def _at(t: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``t[i]`` for a 0-d index tensor, as a gather (a 0-d tensor used as a
    Python index may be read on the host)."""
    return t.index_select(0, i.reshape(1))[0]


def _set_at(t: torch.Tensor, i: torch.Tensor, v: torch.Tensor) -> None:
    """``t[i] = v`` in place for a 0-d index tensor."""
    t.index_copy_(0, i.reshape(1).long(), v.reshape(1).to(t.dtype))


#: Ticks a captured CUDA graph runs, between two host reads: past
#: quiescence a replay wastes at most this many less one masked-off ticks.
TICKS_PER_REPLAY = 8


class DeviceProgram:
    """One DFG compiled to a resident device program.

    Specialized per ``(n_requests, vlen, queue capacities, pool sizes)`` —
    the front-end caches instances per shape (``api._resident_program``),
    so a serving deployment captures once per launch shape.  ``device``
    defaults to CUDA (no CPU fallback).  ``form`` says how a tick treats
    a context that is not ready: ``"masked"`` (CUDA) issues its fire path
    with the flag as a mask, ``"skip"`` (the CPU) leaves it out on the
    host.  Setting ``form = "masked"`` on a CPU program runs the card's
    form there (the tests hold the two equal).
    """

    def __init__(self, g: DFG, *, n_requests: int = 1, vlen: int = VLEN,
                 queue_caps: dict[int, int] | None = None, placement=None,
                 pool_override: dict[str, int] | None = None,
                 max_ticks: int = 1_000_000, device=None):
        reasons = resident_unsupported(g)
        if reasons:
            raise VectorDeadlock(
                "resident execution unsupported: " + "; ".join(reasons))
        self.g = g
        self.vlen = int(vlen)
        self.n_requests = int(n_requests)
        self.max_ticks = int(max_ticks)
        self.launches = 1
        self.backend = None      # ExecutorBackend, set by compile_resident
        caps = dict(queue_capacities(g, placement, vlen))
        caps.update(queue_caps or {})
        # host-side capacity pre-check: a ready context can push up to two
        # tokens per input lane (reduce emissions) plus protocol barriers,
        # and back-pressure only gates at window granularity — 4*vlen is
        # the proven-safe floor (DESIGN.md §9)
        floor = 4 * self.vlen
        for lid, cap in caps.items():
            if cap < floor or cap & (cap - 1):
                l = g.links[lid]
                raise QueueOverflow(
                    f"link {lid} ({l.vars}): capacity {cap} below the "
                    f"resident floor {floor} (or not a power of two) — "
                    f"the fused loop could overflow mid-tick",
                    link=lid, capacity=cap)
        self.caps = caps
        dev = torch.device("cuda" if device is None else device)
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "DeviceProgram: no CUDA device on this host; pass "
                    "device='cpu' to run the resident loop on the CPU")
            if dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self.form = "masked" if dev.type == "cuda" else "skip"
        self.ticks_per_replay = TICKS_PER_REPLAY
        # ring rows: one per link plus the source queue as the last row
        self.lids = sorted(g.links)
        self.row_of = {lid: i for i, lid in enumerate(self.lids)}
        self.src_row = len(self.lids)
        self.src_cap = _next_pow2(max(64, self.n_requests + 1, 2 * vlen))
        self.source_vars = tuple(getattr(g, "source_vars", ()))
        self._dram_lim = {name: d.size for name, d in g.dram.items()}
        self._dram_mask = {name: _DTYPE_MASK[d.dtype]
                           for name, d in g.dram.items()}
        self.pool_names = sorted(g.pools)
        self.pool_row = {p: i for i, p in enumerate(self.pool_names)}
        self.pool_bufs = {
            p: (pool_override or {}).get(p, g.pools[p].n_bufs)
            for p in self.pool_names}
        self.pool_words = {p: g.pools[p].buf_words for p in self.pool_names}
        if self.n_requests > 1:
            hazards = getattr(g, "_mixing_hazards", None)
            if hazards is None:
                hazards = g._mixing_hazards = loop_mixing_hazards(g)
            self.parallel_loops = not hazards
        else:
            self.parallel_loops = False
        self.order = list(g.contexts.values())
        self.cnt_ctxs = [c.id for c in self.order
                         if isinstance(c.head, CounterHead)]
        self.cnt_row = {cid: i for i, cid in enumerate(self.cnt_ctxs)}
        self.fb_ctxs = [c.id for c in self.order
                        if isinstance(c.head, FwdBwdMergeHead)]
        self.fb_row = {cid: i for i, cid in enumerate(self.fb_ctxs)}
        self.red_keys = [(c.id, oi) for c in self.order
                         for oi, o in enumerate(c.outs) if o.kind == "reduce"]
        self.red_row = {k: i for i, k in enumerate(self.red_keys)}
        self._stat_keys = ("ticks",) + LANE_STATS
        self._stat_row = {k: i for i, k in enumerate(self._stat_keys)}
        self._ctx_alloc_pools = {
            c.id: collections.Counter(op.space for op in c.body
                                      if op.op == "alloc")
            for c in self.order}
        self._tick = None        # the tick body, built on first use
        self._consts: dict = {}
        self._st: dict | None = None     # device state (persistent on CUDA)
        self._graph = None
        #: seconds spent capturing the CUDA graph (warm-up included)
        self.capture_s = 0.0
        #: kernel launches of one replay, per counted kernel
        self.launches_per_replay: dict[str, int] = {}

    # ------------------------------------------------------------ host state
    def _init_state(self, dram_init: dict[str, np.ndarray] | None,
                    params_list: list[dict]) -> dict:
        """The initial state as CPU tensors.  Buffers that take a masked
        scatter (DRAM images, pools, free lists, the loop headers' ``got``)
        end in one dump slot."""
        from .backend import wrap_dram_init
        g = self.g
        if len(params_list) != self.n_requests:
            raise ValueError(
                f"run_batch: got {len(params_list)} parameter sets for a "
                f"device program with n_requests={self.n_requests}")
        st: dict = {}
        n_rings = len(self.lids) + 1
        pad = 2 * self.vlen           # scratch pad: widest push is 2W (reduce)
        z = lambda *shape: np.zeros(shape, np.int32)
        for lid in self.lids:
            cap = self.caps[lid]
            st[f"qk{lid}"] = z(cap + pad)
            st[f"qv{lid}"] = z(cap + pad, len(g.links[lid].vars) + 1)
        # source ring: one parameter row per request, then the closing Ω1
        sk = z(self.src_cap + pad)
        sv = z(self.src_cap + pad, len(self.source_vars) + 1)
        for r, params in enumerate(params_list):
            sv[r, : len(self.source_vars)] = [
                ir.wrap32(int(params[p])) for p in self.source_vars]
            sv[r, -1] = r
        sk[self.n_requests] = 1
        qt = z(n_rings)
        qt[self.src_row] = self.n_requests + 1
        st["qkS"], st["qvS"] = sk, sv
        st["qh"], st["qt"] = z(n_rings), qt
        st["lt"] = z(len(self.lids))
        for name, d in g.dram.items():
            a = z(d.size * self.n_requests + 1)
            if dram_init and name in dram_init:
                w = wrap_dram_init(dram_init[name], d.dtype)
                a[: w.size] = w.astype(np.int32)
            st[f"d_{name}"] = a
        n_pools = max(len(self.pool_names), 1)
        st["fh"], ft = z(n_pools), z(n_pools)
        for p in self.pool_names:
            nb, bw = self.pool_bufs[p], self.pool_words[p]
            st[f"p_{p}"] = z(nb * bw + 1)
            flcap = _next_pow2(nb)
            st[f"fr_{p}"] = np.concatenate(
                [np.resize(np.arange(nb, dtype=np.int32), flcap), z(1)])
            ft[self.pool_row[p]] = nb
        st["ft"] = ft
        n_cnt = max(len(self.cnt_ctxs), 1)
        st["cnt_act"] = np.zeros(n_cnt, bool)
        for key in ("cnt_cur", "cnt_hi", "cnt_step"):
            st[key] = z(n_cnt)
        for cid in self.cnt_ctxs:
            h = g.contexts[cid].head
            st[f"cb_{cid}"] = z(len(g.links[h.link].vars) + 1)
        nr = self.n_requests
        for cid in self.fb_ctxs:
            st[f"fb_mode_{cid}"] = z(nr)
            st[f"fb_pend_{cid}"] = z(nr)
            st[f"fb_got_{cid}"] = np.zeros(nr + 1, bool)
            st[f"fb_seq_{cid}"] = z(nr)
        st["fb_nseq"] = z(max(len(self.fb_ctxs), 1))
        red = z(max(len(self.red_keys), 1), 2)       # (acc, group_open)
        for (cid, oi), i in self.red_row.items():
            red[i, 0] = ir.wrap32(g.contexts[cid].outs[oi].reduce_init)
        st["red"] = red
        st["stats"] = z(len(self._stat_keys))
        st["prog"] = np.ones((), bool)
        st["err"] = z()
        st["tick"] = z()
        st["flags"] = z(3)        # (prog, err, tick), read once per replay
        st["fires"] = z(len(self.order))     # ticks each context was ready
        return {k: torch.from_numpy(v) for k, v in st.items()}

    def _load_state(self, init: dict) -> None:
        if self._st is None:
            self._st = {k: v.to(self.device) for k, v in init.items()}
        else:                      # a captured graph reads these addresses
            for k, v in init.items():
                self._st[k].copy_(v)

    def _const(self, shape: tuple, value, dtype=_I32) -> torch.Tensor:
        """A constant tensor, made once (before any capture) and kept;
        never written."""
        key = (shape, value, dtype)
        t = self._consts.get(key)
        if t is None:
            if self.device.type == "cuda" and \
                    torch.cuda.is_current_stream_capturing():
                raise RuntimeError(f"DeviceProgram: constant {key} first "
                                   "asked for inside a CUDA graph capture")
            t = self._consts[key] = torch.full(shape, value, dtype=dtype,
                                               device=self.device)
        return t

    # ------------------------------------------------------------ tick build
    def _build(self) -> None:
        g = self.g
        W = self.vlen
        nreq = self.n_requests
        batched = nreq > 1
        row_of, caps = self.row_of, self.caps
        dev = self.device
        I32 = _I32
        LANES = dl.lanes(W, dev)
        for w in (1, 2, W, 2 * W):          # every window width of a tick
            dl.lanes(w, dev)
            dl.lanes(w, dev, torch.int64)
            for cap in set(caps.values()) | {self.src_cap}:
                dl.lanes(w, dev, torch.int64, cap)
        TRUE = self._const((), True, torch.bool)
        const = self._const

        def ring_of(lid):
            if lid == "S":
                return "qkS", "qvS", self.src_row, self.src_cap
            return f"qk{lid}", f"qv{lid}", row_of[lid], caps[lid]

        def qlen(st, ridx):
            return st["qt"][ridx] - st["qh"][ridx]

        def peek(st, lid, width):
            kk, vk, ridx, cap = ring_of(lid)
            k, v = dl.ring_peek(st[kk], st[vk], st["qh"][ridx], cap, width)
            return k, v, qlen(st, ridx)

        def pop(st, lid, n):
            st["qh"][ring_of(lid)[2]].add_(n)

        def latch(st, cond, code):
            err = st["err"]
            err.masked_fill_(cond & (err == 0), code)

        def push(st, lid, kbuf, vbuf, count):
            kk, vk, ridx, cap = ring_of(lid)
            over, ok = dl.ring_push(st[kk], st[vk], st["qt"][ridx],
                                    qlen(st, ridx), cap, kbuf, vbuf, count)
            st["qt"][ridx].add_(ok)
            if lid != "S":
                st["lt"][row_of[lid]].add_(ok)
            latch(st, over, _ERR_OVERFLOW + ridx)

        # a context with reduce outputs can emit up to two tokens per lane,
        # so its window budget halves (back-pressure at window granularity)
        room_div = {c.id: (2 if any(o.kind == "reduce" for o in c.outs)
                           else 1) for c in self.order}

        def budget_of(st, ctx, rdy):
            """``(gate, budget)``: the context may fire, and its window."""
            r = None
            for o in ctx.outs:
                x = caps[o.link] - qlen(st, row_of[o.link])
                r = x if r is None else torch.minimum(r, x)
            if r is None:
                return rdy, rdy.int() * W
            gate = rdy & (r > 0)
            if room_div[ctx.id] > 1:
                r = r // room_div[ctx.id]
            return gate, torch.where(gate, r.clamp(0, W), 0)

        def alloc_limit(st, ctx, kinds, n):
            per_pool = self._ctx_alloc_pools[ctx.id]
            if not per_pool:
                return n
            avail = None
            for p, cnt in per_pool.items():
                pi = self.pool_row[p]
                a = (st["ft"][pi] - st["fh"][pi]) // cnt
                avail = a if avail is None else torch.minimum(avail, a)
            lanes = dl.lanes(kinds.shape[0], dev)
            data = (kinds == 0) & (lanes < n)
            exceeds = (torch.cumsum(data.int(), 0, dtype=I32) > avail) & \
                (lanes < n)
            return torch.where(exceeds.any(), torch.minimum(
                n, exceeds.int().argmax().int()), n)

        def last_wins(ok, addr):
            # keep only the last ok lane per duplicate address, so the
            # masked scatter-set is deterministic (numpy's fancy-index
            # assignment is later-lane-wins; a device scatter's order is
            # not)
            eq = (addr[None, :] == addr[:, None]) & ok[None, :] & ok[:, None]
            return ok & ~torch.triu(eq, diagonal=1).any(1)

        def exec_body(st, ctx, kinds, regs, n):
            P = kinds.shape[0]
            lanes = dl.lanes(P, dev)
            data = (lanes < n) & (kinds == 0)
            rid = regs[RID]
            pend: dict = {}      # counter bumps, one add per stat a fire

            def count(key, amount):
                pend[key] = pend[key] + amount if key in pend else amount

            for op in ctx.body:
                k = op.op
                if k == "const":
                    regs[op.dst] = const((P,), ir.wrap32(op.imm))
                elif k == "mov":
                    regs[op.dst] = regs[op.srcs[0]]
                elif k == "select":
                    c, a, b = (regs[s] for s in op.srcs)
                    regs[op.dst] = torch.where(c != 0, a, b)
                elif k == "not":
                    regs[op.dst] = (regs[op.srcs[0]] == 0).int()
                elif k == "neg":
                    regs[op.dst] = -regs[op.srcs[0]]
                elif k in ir.BINOPS:
                    regs[op.dst] = dl.dev_binop(
                        k, regs[op.srcs[0]], regs[op.srcs[1]])
                elif k in ("sram_load", "sram_store"):
                    mem = st[f"p_{op.space}"]
                    size = mem.shape[0] - 1
                    addr = regs[op.srcs[0]] * g.pools[op.space].buf_words \
                        + regs[op.srcs[1]]
                    ok = data & (addr >= 0) & (addr < size)
                    if k == "sram_load":
                        regs[op.dst] = torch.where(
                            ok, mem.index_select(0, torch.where(ok, addr, 0)),
                            0)
                        count("sram_reads", ok.sum(dtype=I32))
                        continue
                    if op.pred is not None:
                        ok = ok & (regs[op.pred] != 0)
                    okl = last_wins(ok, addr)
                    mem.index_copy_(0, torch.where(okl, addr, size).long(),
                                    regs[op.srcs[2]])
                    count("sram_writes", ok.sum(dtype=I32))
                elif k in ("dram_load", "dram_store", "atomic_add"):
                    a = st[f"d_{op.space}"]
                    lim = self._dram_lim[op.space]
                    addr = regs[op.srcs[0]]
                    ok = data & (addr >= 0) & (addr < lim)
                    if batched:
                        addr = addr + rid * lim
                    if k == "dram_load":
                        regs[op.dst] = torch.where(
                            ok, a.index_select(0, torch.where(ok, addr, 0)),
                            0)
                        count("dram_reads", ok.sum(dtype=I32))
                    elif k == "atomic_add":
                        regs[op.dst] = dl.atomic_add_window(
                            a, torch.where(ok, addr, 0), regs[op.srcs[1]], ok)
                        count("atomics", ok.sum(dtype=I32))
                    else:
                        if op.pred is not None:
                            ok = ok & (regs[op.pred] != 0)
                        val = regs[op.srcs[1]]
                        m = self._dram_mask[op.space]
                        if m is not None:
                            val = val & m
                        okl = last_wins(ok, addr)
                        a.index_copy_(
                            0, torch.where(okl, addr, a.shape[0] - 1).long(),
                            val)
                        count("dram_writes", ok.sum(dtype=I32))
                elif k in ("alloc", "free"):
                    pi = self.pool_row[op.space]
                    ring = st[f"fr_{op.space}"]
                    flcap = ring.shape[0] - 1
                    lane_idx = torch.cumsum(data.int(), 0, dtype=I32) - 1
                    cnt = data.sum(dtype=I32)
                    if k == "alloc":
                        ptr = ring.index_select(
                            0, (st["fh"][pi] + lane_idx) & (flcap - 1))
                        regs[op.dst] = torch.where(data, ptr, 0)
                        st["fh"][pi].add_(cnt)
                        count("allocs", cnt)
                    else:
                        pos = (st["ft"][pi] + lane_idx) & (flcap - 1)
                        ring.index_copy_(0, torch.where(data, pos,
                                                        flcap).long(),
                                         regs[op.srcs[0]])
                        st["ft"][pi].add_(cnt)
                        count("frees", cnt)
                else:
                    raise NotImplementedError(k)
            if ctx.body:
                count("body_ops", data.sum(dtype=I32) * len(ctx.body))
            for key, amount in pend.items():
                st["stats"][self._stat_row[key]].add_(amount)
            return regs

        def rget(regs, v, P):
            # protocol (barrier-only) windows route without running the
            # body, so body-computed value names are absent; barrier lanes
            # never read payload, zeros suffice (host pushes zeros too)
            r = regs.get(v)
            return r if r is not None else const((P,), 0)

        def route_window(st, ctx, kinds, regs, n):
            P = kinds.shape[0]
            valid = dl.lanes(P, dev) < n
            data = valid & (kinds == 0)
            rid = regs[RID]
            for oi, o in enumerate(ctx.outs):
                nv = len(g.links[o.link].vars) + 1
                if o.kind == "reduce":
                    ri = self.red_row[(ctx.id, oi)]
                    vals = regs.get(o.values[0]) if o.values else None
                    ok_, ov, orid, cnt = dl.segment_reduce_window(
                        kinds, vals, rid, n, o.reduce_op,
                        ir.wrap32(o.reduce_init), st["red"][ri])
                    cols = ([ov] if nv > 1 else []) + [orid]
                    push(st, o.link, ok_, torch.stack(cols, 1), cnt)
                    continue
                cols = [rget(regs, v, P) for v in o.values] + [rid]
                while len(cols) < nv:       # valueless outs: zero payload
                    cols.insert(0, const((P,), 0))
                if o.kind == "pass" and not o.lower_barrier:
                    # pass-through: lanes [0, n) are already contiguous, so
                    # the compaction is a no-op — push directly
                    push(st, o.link, kinds, torch.stack(cols, 1), n)
                    continue
                if o.kind == "discard":
                    keep = valid & ~data
                elif o.kind == "filter":
                    keep = valid & (~data | (rget(regs, o.pred, P) != 0))
                else:
                    keep = valid
                out_kinds = kinds
                if o.lower_barrier:
                    keep = keep & (kinds != 1)
                    out_kinds = torch.where(kinds > 1, kinds - 1, kinds)
                if P == 1:      # one lane: a push of 0 or 1 tokens as it is
                    push(st, o.link, out_kinds, torch.stack(cols, 1),
                         keep[0].int())
                    continue
                kb, vb, cnt = dl.window_compact(
                    keep, out_kinds, torch.stack(cols, 1))
                push(st, o.link, kb, vb, cnt)

        def empty_regs1(vars_, rid):
            regs = {v: const((1,), 0) for v in vars_}
            regs[RID] = rid.reshape(1).int()
            return regs

        # ------------------------------------------------- head fire bodies
        # Each mirrors the host ``_fire_*`` exactly, except that decisions
        # are masked scalars and a bounded slice of the host's per-fire
        # while-loop runs per tick (window partitioning may differ; the
        # token sequence per link cannot — DESIGN.md §9).  With ``rdy``
        # false each is a value-level no-op: the masked form relies on it.

        def fire_window(st, ctx, lid, vars_, rdy):
            kk, vk, ridx, cap = ring_of(lid)
            _, budget = budget_of(st, ctx, rdy)
            n = torch.minimum(budget, qlen(st, ridx))
            kinds, vals = dl.ring_peek(st[kk], st[vk], st["qh"][ridx], cap, W)
            n = alloc_limit(st, ctx, kinds, n)
            regs = {v: vals[:, i] for i, v in enumerate(vars_)}
            regs[RID] = vals[:, -1]
            regs = exec_body(st, ctx, kinds, regs, n)
            route_window(st, ctx, kinds, regs, n)
            st["qh"][ridx].add_(n)
            return n > 0

        def fire_zip(st, ctx, h, rdy):
            gate, budget = budget_of(st, ctx, rdy)
            peeks = [peek(st, l, W) for l in h.links]
            n = budget
            for _, _, ln in peeks:
                n = torch.minimum(n, ln)
            ref = peeks[0][0]
            mism = LANES < 0
            for ko, _, _ in peeks[1:]:
                mism = mism | (ko != ref)
            mism = mism & (LANES < n)
            L = dl.first_index(mism, n)
            latch(st, gate & (n > 0) & (L == 0), _ERR_ZIP + ctx.id)
            L = alloc_limit(st, ctx, ref, L)
            regs = {}
            for (ko, vo, _), l in zip(peeks, h.links):
                for i, v in enumerate(g.links[l].vars):
                    regs[v] = vo[:, i]
            regs[RID] = peeks[0][1][:, -1]
            regs = exec_body(st, ctx, ref, regs, L)
            route_window(st, ctx, ref, regs, L)
            for l in h.links:
                pop(st, l, L)
            return L > 0

        def fire_merge(st, ctx, h, rdy):
            nv = len(g.links[h.a].vars) + 1
            _, budget = budget_of(st, ctx, rdy)
            fired = None
            # two greedy sub-steps per tick: a-run, else b-run, else the
            # leading equal-barrier-pair run (host assembles these into one
            # window per fire; the emitted token sequence is identical)
            for _ in range(2):
                ka, va, la = peek(st, h.a, W)
                kb, vb, lb = peek(st, h.b, W)
                ca = torch.minimum(la, budget)
                cb = torch.minimum(lb, budget)
                ra = dl.leading_run(ka == 0, ca)
                rb = dl.leading_run(kb == 0, cb)
                pair = (ka > 0) & (ka == kb)
                npair = dl.leading_run(pair, torch.minimum(ca, cb))
                latch(st, (budget > 0) & (ra == 0) & (rb == 0) &
                      (npair == 0) & (la > 0) & (lb > 0),
                      _ERR_MERGE + ctx.id)
                take_a = ra > 0
                take_b = ~take_a & (rb > 0)
                take_p = ~take_a & ~take_b & (npair > 0)
                n = torch.where(take_a, ra, torch.where(
                    take_b, rb, torch.where(take_p, npair, 0)))
                kinds = torch.where(take_b, kb, ka)
                vsel = torch.where(take_b, vb, va)
                if nv > 1:     # pair barriers keep only their request id
                    prow = torch.cat([const((W, nv - 1), 0), va[:, -1:]], 1)
                else:
                    prow = va
                vsel = torch.where(take_p, prow, vsel)
                nl = alloc_limit(st, ctx, kinds, n)
                astall = nl < n
                latch(st, astall, _ERR_MERGE_ALLOC + ctx.id)
                n = torch.where(astall, 0, n)
                regs = {v: vsel[:, i]
                        for i, v in enumerate(g.links[h.a].vars)}
                regs[RID] = vsel[:, -1]
                regs = exec_body(st, ctx, kinds, regs, n)
                route_window(st, ctx, kinds, regs, n)
                pop(st, h.a, torch.where(take_a | take_p, n, 0))
                pop(st, h.b, torch.where(take_b | take_p, n, 0))
                budget = budget - n
                fired = n > 0 if fired is None else fired | (n > 0)
            return fired

        def counter_cols(ctx, h):
            vars_in = g.links[h.link].vars
            return (self.cnt_row[ctx.id], vars_in, vars_in.index(h.lo),
                    vars_in.index(h.hi), vars_in.index(h.step),
                    1 if h.add_level else 0)

        def expansion(cur, hi, step):
            # tokens left of an expansion: ceil((hi - cur) / step), >= 0.
            # Every caller masks it to step > 0; the divisor of the other
            # lanes is 1, so no lane divides INT32_MIN by -1
            return (-((cur - hi) // torch.where(step > 0, step, 1))
                    ).clamp(min=0)

        def fire_counter_vec(st, ctx, h, rdy):
            """Counter without allocations: carried-expansion prefix plus a
            vectorized multi-row intake (the replicated host path's window
            assembly, as one gather)."""
            ci, vars_in, lo_i, hi_i, st_i, add_i = counter_cols(ctx, h)
            gate, budget = budget_of(st, ctx, rdy)
            act = st["cnt_act"][ci]
            cur = st["cnt_cur"][ci]
            hi = st["cnt_hi"][ci]
            step = st["cnt_step"][ci]
            base = st[f"cb_{ctx.id}"]
            # carried expansion first (host emission order)
            rem = torch.where(act & (step > 0), expansion(cur, hi, step), 0)
            c_emit = torch.minimum(rem, budget)
            # the close barrier occupies a lane of its own: when the final
            # expansion chunk exactly fills the budget (rem == budget == W)
            # the counter must stay active one more tick to emit it
            c_complete = gate & act & (c_emit == rem) & \
                (c_emit + add_i <= budget)
            c_close = c_complete & bool(add_i)
            prefix = c_emit + c_close.int()
            # whole-row intake: take every queue row whose full emission
            # (expansion + close, or 1 for a pass-through barrier) fits
            can_intake = gate & (~act | c_complete)
            kin, vin, lin = peek(st, h.link, W)
            in_valid = LANES < lin.clamp(max=W)
            is_d = in_valid & (kin == 0)
            lo_v = vin[:, lo_i]
            hi_v = vin[:, hi_i]
            sp_v = torch.where(vin[:, st_i] == 0, 1, vin[:, st_i])
            e_i = torch.where(is_d & (sp_v > 0), expansion(lo_v, hi_v, sp_v),
                              0)
            sz = torch.where(is_d, e_i + add_i, in_valid.int())
            csz = torch.cumsum(sz, 0, dtype=I32)
            ibudget = torch.where(can_intake, (budget - prefix).clamp(min=0),
                                  0)
            # rows of an empty expansion fit even a zero budget: gate them,
            # so a context that is not ready takes nothing
            fit = in_valid & (csz <= ibudget) & gate
            rows_taken = fit.sum(dtype=I32)
            total_in = torch.where(
                rows_taken > 0, _at(csz, (rows_taken - 1).clamp(0, W - 1)), 0)
            # oversized data row (expansion wider than the window): load it
            # as the carried state without emitting — it streams out over
            # the following ticks exactly like the host's budget loop
            load_big = can_intake & (rows_taken == 0) & (lin > 0) & \
                (kin[0] == 0) & (prefix == 0)
            new_act = load_big | (act & ~c_complete)
            new_cur = torch.where(load_big, lo_v[0], cur + step * c_emit)
            new_hi = torch.where(load_big, hi_v[0], hi)
            new_step = torch.where(load_big, sp_v[0], step)
            new_base = torch.where(load_big, vin[0], base)
            pop_n = torch.where(load_big, 1, rows_taken)
            # assemble the output window: carried prefix, then intake rows
            n_win = prefix + total_in
            k_car = torch.where(LANES < c_emit, 0,
                                ((LANES == c_emit) & c_close).int())
            iv_car = cur + step * LANES
            j2 = LANES - prefix
            rowi = torch.searchsorted(csz, j2, right=True).clamp(0, W - 1)
            start = csz[rowi] - sz[rowi]
            off = j2 - start
            row_d = kin[rowi] == 0
            k_int = torch.where(row_d, (off >= e_i[rowi]).int(),
                                kin[rowi] + add_i)
            iv_int = lo_v[rowi] + sp_v[rowi] * off
            use_car = LANES < prefix
            kinds = torch.where(use_car, k_car, k_int)
            ivar = torch.where(use_car, iv_car, iv_int)
            pl = torch.where(use_car[:, None], base[None, :], vin[rowi])
            regs = {v: pl[:, i] for i, v in enumerate(vars_in)}
            regs[h.ivar] = ivar
            regs[RID] = pl[:, -1]
            regs = exec_body(st, ctx, kinds, regs, n_win)
            route_window(st, ctx, kinds, regs, n_win)
            pop(st, h.link, pop_n)
            act.copy_(new_act)
            cur.copy_(new_cur)
            hi.copy_(new_hi)
            step.copy_(new_step)
            base.copy_(new_base)
            return (n_win > 0) | (pop_n > 0)

        def fire_counter_alloc(st, ctx, h, rdy):
            """Allocating counter: one input token + one alloc-limited
            expansion chunk per tick (the host's serial budget loop,
            narrowed to a bounded slice)."""
            ci, vars_in, lo_i, hi_i, st_i, add_i = counter_cols(ctx, h)
            gate, budget = budget_of(st, ctx, rdy)
            act = st["cnt_act"][ci]
            cur = st["cnt_cur"][ci]
            hi = st["cnt_hi"][ci]
            step = st["cnt_step"][ci]
            base = st[f"cb_{ctx.id}"]
            kin, vin, lin = peek(st, h.link, 1)
            have = gate & ~act & (lin > 0)
            tok_data = have & (kin[0] == 0)
            tok_bar = have & (kin[0] > 0)
            # pass-through barrier: 1-lane route, no body
            route_window(st, ctx, kin[:1] + add_i,
                         empty_regs1(list(vars_in) + [h.ivar], vin[0, -1]),
                         tok_bar.int())
            act2 = act | tok_data
            cur2 = torch.where(tok_data, vin[0, lo_i], cur)
            hi2 = torch.where(tok_data, vin[0, hi_i], hi)
            sraw = vin[0, st_i]
            step2 = torch.where(tok_data, torch.where(sraw == 0, 1, sraw),
                                step)
            base2 = torch.where(tok_data, vin[0], base)
            pop(st, h.link, (tok_data | tok_bar).int())
            rem = torch.where(act2 & (step2 > 0) & gate,
                              expansion(cur2, hi2, step2), 0)
            emit_try = torch.minimum(rem, budget)
            emit = alloc_limit(st, ctx, const((W,), 0), emit_try)
            blocked = (emit_try > 0) & (emit == 0)
            cur3 = cur2 + step2 * emit
            # as in fire_counter_vec: the close barrier needs its own lane,
            # so a chunk that exactly fills the budget defers completion
            complete = gate & act2 & ~blocked & \
                ((cur3 >= hi2) | (step2 <= 0)) & (emit + add_i <= budget)
            close = complete & bool(add_i)
            n_win = emit + close.int()
            kinds = torch.where(LANES < emit, 0,
                                ((LANES == emit) & close).int())
            pl = base2[None, :].expand(W, -1)
            regs = {v: pl[:, i] for i, v in enumerate(vars_in)}
            regs[h.ivar] = cur2 + step2 * LANES
            regs[RID] = pl[:, -1]
            regs = exec_body(st, ctx, kinds, regs, n_win)
            route_window(st, ctx, kinds, regs, n_win)
            act.copy_(act2 & ~complete)
            cur.copy_(cur3)
            hi.copy_(hi2)
            step.copy_(step2)
            base.copy_(base2)
            return tok_data | tok_bar | (n_win > 0)

        def fire_fwdbwd(st, ctx, h, rdy):
            cid = ctx.id
            fi = self.fb_row[cid]
            vars_f = g.links[h.fwd].vars
            gate, budget = budget_of(st, ctx, rdy)
            # session state, updated in place (nothing else reads it
            # during the fire)
            mode = st[f"fb_mode_{cid}"]
            pend = st[f"fb_pend_{cid}"]
            got = st[f"fb_got_{cid}"]         # [nreq + 1]: a dump slot
            seq = st[f"fb_seq_{cid}"]
            # -- ordered release: oldest non-echo session, if it is waiting
            sess = (mode == 1) | (mode == 2)
            rid_old = torch.where(sess, seq, 1 << 30).argmin().int()
            m_old = _at(mode, rid_old)
            can_rel = gate & sess.any() & (m_old == 2)
            route_window(st, ctx, (_at(pend, rid_old) + 1).reshape(1),
                         empty_regs1(vars_f, rid_old), can_rel.int())
            _set_at(mode, rid_old, torch.where(can_rel, 3, m_old))
            # -- backedge: leading data run, then one head barrier
            kb, vb, lb = peek(st, h.back, W)
            brun = dl.leading_run(kb == 0, torch.minimum(lb, budget))
            bn = alloc_limit(st, ctx, kb, brun)
            regsb = {v: vb[:, i] for i, v in enumerate(vars_f)}
            regsb[RID] = vb[:, -1]
            regsb = exec_body(st, ctx, kb, regsb, bn)
            route_window(st, ctx, kb, regsb, bn)
            wrids = vb[:, -1].clamp(0, nreq - 1)
            wmask = (LANES < bn) & (mode[wrids] > 0)
            got.index_fill_(0, torch.where(wmask, wrids, nreq).long(), True)
            hb = gate & (brun == 0) & (lb > 0) & (kb[0] > 0)
            lvl = kb[0]
            brid = vb[0, -1].clamp(0, nreq - 1)
            m_r = _at(mode, brid)
            p_r = _at(pend, brid)
            latch(st, hb & ((m_r == 0) | (m_r == 2) |
                            ((m_r == 1) & (lvl != 1)) |
                            ((m_r == 3) & (lvl != p_r + 1))), _ERR_FB + cid)
            d_case = hb & (m_r == 1) & (lvl == 1)
            e_case = hb & (m_r == 3) & (lvl == p_r + 1)
            emit_wave = d_case & _at(got, brid)
            route_window(st, ctx, const((1,), 1),
                         empty_regs1(vars_f, brid), emit_wave.int())
            _set_at(got, brid, ~emit_wave & _at(got, brid))
            _set_at(mode, brid, torch.where(d_case & ~emit_wave, 2,
                                            torch.where(e_case, 0, m_r)))
            pop_b = bn + (d_case | e_case).int()
            pop(st, h.back, pop_b)
            # -- forward intake only once the backedge is drained (or its
            # run is alloc-stalled) — host drains qb before touching qf
            back_stalled = (brun > 0) & (bn == 0)
            allow_fwd = gate & (((lb - pop_b) == 0) | back_stalled)
            fbudget = (budget - bn - 3).clamp(0, W)
            kf, vf, lf = peek(st, h.fwd, W)
            frun = dl.leading_run(kf == 0, torch.minimum(lf, fbudget))
            frun = torch.where(allow_fwd, frun, 0)
            frids = vf[:, -1].clamp(0, nreq - 1)
            if self.parallel_loops:
                fblocked = (mode[frids] > 0) & (LANES < frun)
                admit = dl.first_index(fblocked, frun)
            else:
                admit = torch.where((mode > 0).any(), 0, frun)
            fn = alloc_limit(st, ctx, kf, admit)
            regsf = {v: vf[:, i] for i, v in enumerate(vars_f)}
            regsf[RID] = vf[:, -1]
            regsf = exec_body(st, ctx, kf, regsf, fn)
            route_window(st, ctx, kf, regsf, fn)
            # -- group barrier: open a session (serial: only when idle)
            ob = allow_fwd & (frun == 0) & (fn == 0) & (lf > 0) & (kf[0] > 0)
            frid0 = frids[0]
            if self.parallel_loops:
                can_open = ob & (_at(mode, frid0) == 0)
            else:
                can_open = ob & ~(mode > 0).any()
            route_window(st, ctx, const((1,), 1),
                         empty_regs1(vars_f, frid0), can_open.int())
            nseq = st["fb_nseq"][fi]
            _set_at(mode, frid0, torch.where(can_open, 1, _at(mode, frid0)))
            _set_at(pend, frid0, torch.where(can_open, kf[0],
                                             _at(pend, frid0)))
            _set_at(got, frid0, ~can_open & _at(got, frid0))
            _set_at(seq, frid0, torch.where(can_open, nseq, _at(seq, frid0)))
            nseq.add_(can_open.int())
            pop(st, h.fwd, fn + can_open.int())
            return can_rel | (bn > 0) | d_case | e_case | (fn > 0) | can_open

        # --------------------------------------------------------- the tick
        # the ready snapshot as gathers from one flag vector: room of each
        # ring [0, R), tokens in each ring [R, 2R), then True and False
        n_rings = len(self.lids) + 1
        t_slot, f_slot = 2 * n_rings, 2 * n_rings + 1
        ring_caps = torch.tensor([caps[lid] for lid in self.lids] +
                                 [self.src_cap], dtype=I32, device=dev)
        tf = torch.tensor([True, False], device=dev)
        outs_of, all_of, any_of, extra_of = [], [], [], []
        n_cnt = max(len(self.cnt_ctxs), 1)
        for ctx in self.order:
            outs_of.append([row_of[o.link] for o in ctx.outs])
            h, all_, any_, extra = ctx.head, [], [t_slot], f_slot
            has = lambda lid: n_rings + row_of[lid]
            if isinstance(h, SourceHead):
                all_ = [n_rings + self.src_row]
            elif isinstance(h, SingleHead):
                all_ = [has(h.link)]
            elif isinstance(h, ZipHead):
                all_ = [has(l) for l in h.links]
            elif isinstance(h, ForwardMergeHead):
                any_ = [has(h.a), has(h.b)]
            elif isinstance(h, FwdBwdMergeHead):
                any_ = [has(h.fwd), has(h.back)]
                extra = 2 * n_rings + 2 + n_cnt + self.fb_row[ctx.id]
            elif isinstance(h, CounterHead):
                any_ = [has(h.link)]
                extra = 2 * n_rings + 2 + self.cnt_row[ctx.id]
            else:
                raise TypeError(type(h))
            all_of.append(all_)
            any_of.append(any_)
            extra_of.append(extra)

        def table(rows, pad):
            width = max(1, max(len(r) for r in rows))
            return torch.tensor([r + [pad] * (width - len(r)) for r in rows],
                                dtype=torch.int64, device=dev)

        outs_idx, all_idx = table(outs_of, t_slot), table(all_of, t_slot)
        any_idx = table(any_of, f_slot)
        extra_idx = torch.tensor(extra_of, dtype=torch.int64, device=dev)

        def ready_of(st):
            """Tick-start ready snapshot, one flag a context — the device
            form of the host scheduler's ``_ready`` over a frozen head/tail
            vector."""
            lens0 = st["qt"] - st["qh"]
            flags = torch.cat(
                [lens0 < ring_caps, lens0 > 0, tf, st["cnt_act"]] +
                [(st[f"fb_mode_{cid}"] == 2).any().reshape(1)
                 for cid in self.fb_ctxs])
            room = flags[outs_idx].all(1)
            come = flags[all_idx].all(1) & \
                (flags[any_idx].any(1) | flags[extra_idx])
            return room & come

        def fire_ctx(st, ctx, f):
            h = ctx.head
            if isinstance(h, SourceHead):
                return fire_window(st, ctx, "S", self.source_vars, f)
            elif isinstance(h, SingleHead):
                return fire_window(st, ctx, h.link, g.links[h.link].vars, f)
            elif isinstance(h, ZipHead):
                return fire_zip(st, ctx, h, f)
            elif isinstance(h, ForwardMergeHead):
                return fire_merge(st, ctx, h, f)
            elif isinstance(h, FwdBwdMergeHead):
                return fire_fwdbwd(st, ctx, h, f)
            elif isinstance(h, CounterHead):
                if self._ctx_alloc_pools[ctx.id]:
                    return fire_counter_alloc(st, ctx, h, f)
                return fire_counter_vec(st, ctx, h, f)
            raise TypeError(type(h))

        ticks_row = self._stat_row["ticks"]
        n_ctx = len(self.order)

        def tick(st, form: str) -> None:
            rdy = ready_of(st)
            prog = st["prog"]
            if form == "skip":
                # contexts whose ready flag is false are skipped on the host
                st["fires"].add_(rdy.int())
                prog.fill_(False)
                for ctx, ready in zip(self.order, rdy.tolist()):
                    if ready:
                        prog |= fire_ctx(st, ctx, TRUE)
                st["tick"].add_(1)
                st["stats"][ticks_row].add_(1)
                return
            # the host loop's condition, as a device flag that gates the
            # whole tick: ticks past quiescence or an error change nothing
            running = prog & (st["err"] == 0) & (st["tick"] < self.max_ticks)
            rdy = rdy & running
            st["fires"].add_(rdy.int())
            prog.copy_(prog & ~running)
            # every context issues; its ready flag masks its effects
            for i, ctx in enumerate(self.order):
                f = rdy[i]
                prog |= fire_ctx(st, ctx, f) & f
            run = running.int()
            st["tick"].add_(run)
            st["stats"][ticks_row].add_(run)

        def block(st, form: str) -> None:
            """``ticks_per_replay`` ticks, then the flags the host reads —
            what one graph replay runs."""
            for _ in range(self.ticks_per_replay):
                tick(st, form)
            st["flags"].copy_(torch.stack(
                [st["prog"].int(), st["err"], st["tick"]]))

        self._n_ctx = n_ctx
        self._tick = tick
        self._block = block

    # ------------------------------------------------------------- host loop
    def prepare(self) -> None:
        """Build the tick body and, on CUDA, allocate the device state and
        capture the CUDA graph (once per program; ``capture_s``): a warm-up
        block of masked ticks on a side stream first, which issues every
        fire path once."""
        if self._tick is None:
            self._build()
        if self.device.type != "cuda" or self._graph is not None:
            return
        t0 = time.perf_counter()
        self._load_state(self._init_state(
            None, [dict.fromkeys(self.source_vars, 0)] * self.n_requests))
        st = self._st
        st["prog"].fill_(False)        # the warm-up ticks are masked off
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self._block(st, "masked")
        torch.cuda.current_stream(self.device).wait_stream(side)
        warm = [k.launches for k in _KERNELS]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._block(st, self.form)
        # a capture launches nothing: each replay launches what it recorded
        self.launches_per_replay = {
            k.__name__: k.launches - w for k, w in zip(_KERNELS, warm)}
        for k, w in zip(_KERNELS, warm):
            k.launches = w
        torch.cuda.synchronize(self.device)
        self._graph = graph
        self.capture_s = time.perf_counter() - t0

    def run(self, dram_init=None, **params) -> "DeviceRun":
        return self.run_batch([params], dram_init)

    def run_batch(self, params_list: list[dict],
                  dram_init=None) -> "DeviceRun":
        """One resident run: load the initial state, tick to quiescence,
        decode errors, unpack DRAM + stats."""
        self.prepare()
        self._load_state(self._init_state(dram_init, params_list))
        st = self._st
        t0 = time.perf_counter()
        replays = 0
        if self.form == "skip":
            while bool(st["prog"]) and not int(st["err"]) and \
                    int(st["tick"]) < self.max_ticks:
                self._tick(st, "skip")
        elif self._graph is None:           # the masked form on the CPU
            while True:
                self._block(st, self.form)
                replays += 1
                if self._done(st["flags"].tolist()):
                    break
        else:
            replays = self._replay(st)
        run = self._finish(st)
        run.run_s = time.perf_counter() - t0
        for k in _KERNELS:
            k.launches += self.launches_per_replay.get(k.__name__, 0) * \
                replays
        run.replays = run.host_reads = replays
        run.ticks_per_replay = 1 if self.form == "skip" \
            else self.ticks_per_replay
        run.capture_s = self.capture_s
        run.form = self.form
        run.program = self
        return run

    def _done(self, flags) -> bool:
        prog, err, tick = flags
        return not prog or err != 0 or tick >= self.max_ticks

    def _replay(self, st) -> int:
        """Replay the graph until the flags a replay left say the run is
        over; returns the replays.  Each replay's flags go to pinned host
        memory behind it, and the next replay is queued before the host
        waits for them, so the card does not idle while the host reads
        and launches: the one replay past the end runs masked off (its
        ticks change nothing) and its flags are read too, so host reads
        equal replays."""
        flags = torch.empty((2, 3), dtype=_I32, pin_memory=True)
        done = [torch.cuda.Event(), torch.cuda.Event()]

        def launch(i):
            self._graph.replay()
            flags[i % 2].copy_(st["flags"], non_blocking=True)
            done[i % 2].record()

        launch(0)
        replays = 1
        while True:
            launch(replays)
            replays += 1
            done[replays % 2].synchronize()           # replay replays - 2
            if self._done(flags[replays % 2].tolist()):
                break
        done[(replays - 1) % 2].synchronize()         # the replay past it
        if not self._done(flags[(replays - 1) % 2].tolist()):
            raise RuntimeError("resident loop: a replay after the last one "
                               "left the run going")
        return replays

    def _finish(self, st) -> "DeviceRun":
        keep = ("err", "tick", "prog", "qt", "qh", "stats", "lt", "fires")
        out = {k: v.cpu().numpy() for k, v in st.items()
               if k in keep or k.startswith("d_")}
        err = int(out["err"])
        if err:
            self._raise_err(err)
        if int(out["tick"]) >= self.max_ticks and bool(out["prog"]):
            raise VectorDeadlock("tick limit exceeded")
        lens = out["qt"] - out["qh"]
        stuck = {lid: int(lens[self.row_of[lid]]) for lid in self.lids
                 if lens[self.row_of[lid]]
                 and self.g.contexts[self.g.links[lid].dst].outs}
        if stuck:
            raise VectorDeadlock(
                f"quiescent with tokens in flight: {stuck}")
        dram = {name: out[f"d_{name}"][:-1].astype(np.int64)
                for name in self.g.dram}
        stats = collections.Counter()
        sv = out["stats"]
        for k, i in self._stat_row.items():
            if sv[i]:
                stats[k] = int(sv[i])
        lt = out["lt"]
        for lid in self.lids:
            if lt[self.row_of[lid]]:
                stats["link_tokens", lid] = int(lt[self.row_of[lid]])
        run = DeviceRun(dram=dram, stats=stats, n_requests=self.n_requests,
                        dram_lim=dict(self._dram_lim), backend=self.backend)
        run.fires = out["fires"].astype(np.int64)
        return run

    def _raise_err(self, err: int) -> None:
        n_rings = len(self.lids) + 1

        def ctx_name(code):
            return self.g.contexts[err - code].name

        if err >= _ERR_FB:
            raise VectorDeadlock(
                f"{ctx_name(_ERR_FB)}: loop-header protocol violation "
                f"(bad backedge barrier or unknown session)")
        if err >= _ERR_MERGE_ALLOC:
            raise VectorDeadlock(
                f"alloc stall inside merge {ctx_name(_ERR_MERGE_ALLOC)}; "
                f"size the pool above the merge fan-in")
        if err >= _ERR_MERGE:
            raise VectorDeadlock(
                f"merge barrier mismatch in {ctx_name(_ERR_MERGE)}")
        if err >= _ERR_ZIP:
            raise VectorDeadlock(
                f"zip structural mismatch in {ctx_name(_ERR_ZIP)}")
        if 1 <= err <= n_rings:
            row = err - 1
            if row == self.src_row:
                raise QueueOverflow(
                    f"device source queue overflow at capacity "
                    f"{self.src_cap}", capacity=self.src_cap)
            lid = self.lids[row]
            cap = self.caps[lid]
            vars_ = ", ".join(self.g.links[lid].vars)
            raise QueueOverflow(
                f"device queue overflow on link {lid} ({vars_}) at "
                f"capacity {cap}; raise queue_caps= or fall back to "
                f"windowed execution", link=lid, capacity=cap)
        raise VectorDeadlock(f"device loop error code {err}")


class _BackendTag:
    """Minimal stand-in when a DeviceProgram is built outside a backend
    (tests, benchmarks) — reports carry a name either way."""

    def __init__(self, name: str):
        self.name = name


class DeviceRun:
    """Result of one resident run — the slice of the ``VectorVM`` surface
    the serving/API layers read (DRAM image, stats, per-request views),
    plus how it ran: ``run_s`` (the tick loop, capture excluded),
    ``capture_s`` (the program's one CUDA graph capture), ``replays`` of
    ``ticks_per_replay`` ticks each, ``host_reads`` (one a replay),
    ``fires`` (ticks each context was ready), its ``form`` and
    ``program``."""

    launches = 1
    execution = "resident"
    run_s = capture_s = 0.0
    replays = host_reads = 0
    ticks_per_replay = 1
    form = program = None

    def __init__(self, dram, stats, n_requests, dram_lim, backend=None):
        self.dram = dram
        self.stats = stats
        self.n_requests = n_requests
        self._dram_lim = dram_lim
        self.backend = backend if backend is not None \
            else _BackendTag("torch[resident]")

    def estimated_cycles(self) -> int:
        """Cost-model cycles are a windowed-scheduler artifact (per-window
        occupancy); the resident loop does not reconstruct them."""
        return 0

    def lane_occupancy(self) -> float:
        return 1.0

    def request_cycles(self, rid: int) -> int:
        return 0

    def request_dram(self, rid: int) -> dict[str, np.ndarray]:
        if not 0 <= rid < self.n_requests:
            raise IndexError(f"request id {rid} out of range "
                             f"[0, {self.n_requests})")
        return {name: self.dram[name][rid * sz: (rid + 1) * sz].copy()
                for name, sz in self._dram_lim.items()}

    def request_stats(self, rid: int) -> collections.Counter:
        """Lane stats for one request.  The device loop keeps only the
        launch-aggregate counters; a single-request launch attributes them
        all to request 0, a batched launch returns an empty Counter (the
        windowed path remains the source of per-request attribution)."""
        if not 0 <= rid < self.n_requests:
            raise IndexError(f"request id {rid} out of range "
                             f"[0, {self.n_requests})")
        if self.n_requests == 1:
            return collections.Counter(
                {k: int(self.stats[k]) for k in LANE_STATS
                 if self.stats.get(k)})
        return collections.Counter()
