"""TokenVM — reference executor for the dataflow graph.

Executes one token at a time with unbounded queues: the *semantic* model of
the machine in §III. The vectorized VM (``vector_vm.py``) and the Pallas
kernels must match this executor exactly; it in turn is validated against the
golden language interpreter.

Encoding note: the VM emits *explicit* barriers (an Ω1 closes every group,
even when a higher barrier follows immediately). This is a valid SLTF stream —
the canonical implied-barrier form of §III-A is a link-bandwidth optimization,
accounted for in ``machine.py``, not a semantic requirement. Explicit form
keeps merge inputs structurally identical on both branches.

Firing rules implement §III-B/III-C:
* merge heads stall one input at a barrier until the other reaches an equal
  barrier, then forward one barrier;
* the forward-backward merge keeps per-context protocol state (mode, pending
  barrier, wave occupancy) and detects loop-body-empty by an empty wave — the
  paper's "two consecutive Ω1" signature — with no timeouts;
* reductions fire on Ω1 (emitting the accumulator even for empty groups) and
  handle the implied-Ω1 of higher barriers for non-empty trailing groups.
"""
from __future__ import annotations

import collections
from typing import Any

import numpy as np

from . import ir
from .dfg import (DFG, BodyOp, Context, CounterHead, ForwardMergeHead,
                  FwdBwdMergeHead, Output, SingleHead, SourceHead, ZipHead)
from .ir import eval_binop, wrap32
from .sltf import Tok, bar, is_bar, is_data

_DTYPE_MASK = {"i8": 0xFF, "i16": 0xFFFF, "i32": None}

_REDUCE = {
    "add": lambda a, b: wrap32(a + b),
    "min": min,
    "max": max,
    "and": lambda a, b: a & b,
    "or": lambda a, b: a | b,
    "xor": lambda a, b: wrap32(a ^ b),
}


class DataflowDeadlock(RuntimeError):
    pass


class _FwdBwdState:
    """Forward-backward merge protocol state (§III-B(d)).

    modes:
      fwd   — forwarding new threads from the forward branch;
      drain — a group barrier arrived; recirculating the backedge, emitting an
              Ω1 wave marker per non-empty wave;
      echo  — loop body found empty (an Ω1 marker returned with no data before
              it — the paper's "two consecutive Ω1"); the pending barrier was
              released *raised one level* into the loop; waiting for its echo
              on the backedge before accepting new forward threads.
    """
    __slots__ = ("mode", "pending", "got_data")

    def __init__(self):
        self.mode = "fwd"
        self.pending: int | None = None
        self.got_data = False


class _ReduceState:
    __slots__ = ("acc", "group_open")

    def __init__(self, init: int):
        self.acc = init
        self.group_open = False


class TokenVM:
    def __init__(self, g: DFG, dram_init: dict[str, np.ndarray] | None = None):
        self.g = g
        self.queues: dict[int, collections.deque] = {
            lid: collections.deque() for lid in g.links}
        self.source: collections.deque = collections.deque()
        # memory
        self.dram: dict[str, np.ndarray] = {
            name: np.zeros(decl.size, dtype=np.int64)
            for name, decl in g.dram.items()}
        if dram_init:
            from .backend import wrap_dram_init
            for name, arr in dram_init.items():
                a = wrap_dram_init(arr, g.dram[name].dtype)
                self.dram[name][: a.size] = a
        self.pools: dict[str, np.ndarray] = {}
        self.free_lists: dict[str, collections.deque] = {}
        for name, pool in g.pools.items():
            self.pools[name] = np.zeros(pool.n_bufs * pool.buf_words,
                                        dtype=np.int64)
            self.free_lists[name] = collections.deque(range(pool.n_bufs))
        # per-context state
        self._fb: dict[int, _FwdBwdState] = {}
        self._red: dict[tuple[int, int], _ReduceState] = {}
        self._rr: dict[tuple[int, int], int] = {}
        for c in g.contexts.values():
            if isinstance(c.head, FwdBwdMergeHead):
                self._fb[c.id] = _FwdBwdState()
            for oi, o in enumerate(c.outs):
                if o.kind == "reduce":
                    self._red[(c.id, oi)] = _ReduceState(o.reduce_init)
        self.stats: collections.Counter = collections.Counter()
        self.link_traffic: collections.Counter = collections.Counter()

    # -- memory helpers ---------------------------------------------------------
    def _dram_mask(self, arr: str, v: int) -> int:
        m = _DTYPE_MASK[self.g.dram[arr].dtype]
        return wrap32(v) if m is None else (v & m)

    # -- body execution -----------------------------------------------------------
    def _exec_body(self, ctx: Context, regs: dict[str, int]) -> None:
        for op in ctx.body:
            self._exec_op(ctx, op, regs)

    def _exec_op(self, ctx: Context, op: BodyOp, regs: dict[str, int]) -> None:
        self.stats["body_ops"] += 1
        k = op.op
        if k == "const":
            regs[op.dst] = op.imm
        elif k == "mov":
            regs[op.dst] = regs[op.srcs[0]]
        elif k == "select":
            c, a, b = (regs[s] for s in op.srcs)
            regs[op.dst] = a if c != 0 else b
        elif k == "not":
            regs[op.dst] = 1 if regs[op.srcs[0]] == 0 else 0
        elif k == "neg":
            regs[op.dst] = wrap32(-regs[op.srcs[0]])
        elif k in ir.BINOPS:
            regs[op.dst] = eval_binop(k, regs[op.srcs[0]], regs[op.srcs[1]])
        elif k == "sram_load":
            pool = self.g.pools[op.space]
            ptr, idx = regs[op.srcs[0]], regs[op.srcs[1]]
            addr = ptr * pool.buf_words + idx
            mem = self.pools[op.space]
            regs[op.dst] = int(mem[addr]) if 0 <= addr < mem.size else 0
            self.stats["sram_reads"] += 1
        elif k == "sram_store":
            if op.pred is not None and regs[op.pred] == 0:
                return
            pool = self.g.pools[op.space]
            ptr, idx, val = (regs[s] for s in op.srcs)
            addr = ptr * pool.buf_words + idx
            mem = self.pools[op.space]
            if 0 <= addr < mem.size:
                mem[addr] = wrap32(val)
            self.stats["sram_writes"] += 1
        elif k == "dram_load":
            a = self.dram[op.space]
            addr = regs[op.srcs[0]]
            regs[op.dst] = int(a[addr]) if 0 <= addr < a.size else 0
            self.stats["dram_reads"] += 1
        elif k == "dram_store":
            if op.pred is not None and regs[op.pred] == 0:
                return
            a = self.dram[op.space]
            addr, val = regs[op.srcs[0]], regs[op.srcs[1]]
            if 0 <= addr < a.size:
                a[addr] = self._dram_mask(op.space, val)
            self.stats["dram_writes"] += 1
        elif k == "atomic_add":
            a = self.dram[op.space]
            addr, delta = regs[op.srcs[0]], regs[op.srcs[1]]
            old = int(a[addr]) if 0 <= addr < a.size else 0
            if 0 <= addr < a.size:
                a[addr] = self._dram_mask(op.space, old + delta)
            regs[op.dst] = old
            self.stats["atomics"] += 1
        elif k == "alloc":
            fl = self.free_lists[op.space]
            if not fl:
                raise DataflowDeadlock(
                    f"SRAM pool '{op.space}' exhausted in {ctx.name} "
                    f"(size it with Prog.ensure_pool)")
            regs[op.dst] = fl.popleft()
            self.stats["allocs"] += 1
        elif k == "free":
            self.free_lists[op.space].append(regs[op.srcs[0]])
            self.stats["frees"] += 1
        elif k == "rr_counter":
            key = (ctx.id, id(op))
            v = self._rr.get(key, 0)
            regs[op.dst] = v % op.imm
            self._rr[key] = v + 1
        else:
            raise NotImplementedError(f"body op {k}")

    # -- token emission ---------------------------------------------------------
    def _emit(self, link_id: int, tok: Tok) -> None:
        self.queues[link_id].append(tok)
        self.link_traffic[(link_id, "bar" if is_bar(tok) else "data")] += 1

    def _route_data(self, ctx: Context, regs: dict[str, int],
                    body_side_only: bool = False,
                    skip_exit_side: bool = False) -> int:
        """Run body + tail for one data token. Returns # tokens sent to
        non-lower_barrier ("body side") outputs — the wave-occupancy count
        used by the forward-backward merge protocol."""
        self._exec_body(ctx, regs)
        to_body = 0
        for oi, o in enumerate(ctx.outs):
            if o.kind == "discard":
                continue
            if o.kind == "reduce":
                st = self._red[(ctx.id, oi)]
                if o.values:
                    st.acc = _REDUCE[o.reduce_op](st.acc, regs[o.values[0]])
                st.group_open = True
                continue
            if o.kind == "filter" and regs[o.pred] == 0:
                continue
            self._emit(o.link, Tok(0, tuple(regs[v] for v in o.values)))
            if not o.lower_barrier:
                to_body += 1
        return to_body

    def _route_bar(self, ctx: Context, level: int) -> None:
        """Forward a barrier through every output (non-FwdBwd contexts)."""
        for oi, o in enumerate(ctx.outs):
            if o.kind == "reduce":
                st = self._red[(ctx.id, oi)]
                if level == 1:
                    self._emit(o.link, Tok(0, (st.acc,)))
                    st.acc = o.reduce_init
                    st.group_open = False
                else:
                    if st.group_open:
                        self._emit(o.link, Tok(0, (st.acc,)))
                        st.acc = o.reduce_init
                        st.group_open = False
                    self._emit(o.link, bar(level - 1))
            elif o.lower_barrier:
                if level >= 2:
                    self._emit(o.link, bar(level - 1))
            else:
                self._emit(o.link, bar(level))

    # -- head firing ----------------------------------------------------------------
    def _fire(self, ctx: Context) -> bool:
        h = ctx.head
        if isinstance(h, SourceHead):
            return self._fire_stream(ctx, self.source,
                                     self.g.source_vars)  # type: ignore
        if isinstance(h, SingleHead):
            link = self.g.links[h.link]
            return self._fire_stream(ctx, self.queues[h.link], link.vars)
        if isinstance(h, ZipHead):
            return self._fire_zip(ctx, h)
        if isinstance(h, ForwardMergeHead):
            return self._fire_merge(ctx, h)
        if isinstance(h, FwdBwdMergeHead):
            return self._fire_fwdbwd(ctx, h)
        if isinstance(h, CounterHead):
            return self._fire_counter(ctx, h)
        raise TypeError(type(h))

    def _fire_stream(self, ctx, q, vars) -> bool:
        progress = False
        while q:
            tok = q.popleft()
            progress = True
            if is_data(tok):
                self._route_data(ctx, dict(zip(vars, tok.values)))
            else:
                self._route_bar(ctx, tok.level)
        return progress

    def _fire_zip(self, ctx, h: ZipHead) -> bool:
        qs = [self.queues[l] for l in h.links]
        links = [self.g.links[l] for l in h.links]
        progress = False
        while all(qs):
            heads = [q[0] for q in qs]
            if all(is_data(t) for t in heads):
                regs: dict[str, int] = {}
                for q, link in zip(qs, links):
                    tok = q.popleft()
                    regs.update(zip(link.vars, tok.values))
                self._route_data(ctx, regs)
            elif all(is_bar(t) for t in heads):
                lvl = heads[0].level
                if any(t.level != lvl for t in heads):
                    raise DataflowDeadlock(
                        f"zip barrier mismatch in {ctx.name}: "
                        f"{[t.level for t in heads]}")
                for q in qs:
                    q.popleft()
                self._route_bar(ctx, lvl)
            else:
                raise DataflowDeadlock(
                    f"zip structural mismatch in {ctx.name}: {heads}")
            progress = True
        return progress

    def _fire_merge(self, ctx, h: ForwardMergeHead) -> bool:
        qa, qb = self.queues[h.a], self.queues[h.b]
        vars_a = self.g.links[h.a].vars
        progress = False
        while True:
            if qa and is_data(qa[0]):
                tok = qa.popleft()
                self._route_data(ctx, dict(zip(vars_a, tok.values)))
            elif qb and is_data(qb[0]):
                tok = qb.popleft()
                self._route_data(ctx, dict(zip(vars_a, tok.values)))
            elif qa and qb:
                la, lb = qa[0].level, qb[0].level
                if la != lb:
                    raise DataflowDeadlock(
                        f"merge barrier mismatch in {ctx.name}: Ω{la} vs Ω{lb}")
                qa.popleft()
                qb.popleft()
                self._route_bar(ctx, la)
            else:
                return progress
            progress = True

    def _fire_fwdbwd(self, ctx, h: FwdBwdMergeHead) -> bool:
        st = self._fb[ctx.id]
        qf, qb = self.queues[h.fwd], self.queues[h.back]
        vars_f = self.g.links[h.fwd].vars
        progress = False
        while True:
            if st.mode == "fwd":
                # Eager interleave (§III-B(d) "interleaves incoming
                # threads"): recirculating threads on the backedge are
                # processed ahead of new forward threads — required for
                # progress under allocation back-pressure (threads must be
                # able to finish and free buffers while the group's barrier
                # is still stuck behind a stalled allocator upstream).
                if qb and is_data(qb[0]):
                    tok = qb.popleft()
                    progress = True
                    self._route_data(ctx, dict(zip(vars_f, tok.values)))
                    continue
                if not qf:
                    return progress
                tok = qf.popleft()
                progress = True
                if is_data(tok):
                    self._route_data(ctx, dict(zip(vars_f, tok.values)))
                else:
                    # group barrier: stall fwd, start draining the body.
                    # Ω1 wave marker goes into the loop (_route_bar drops it
                    # on lower_barrier exit edges, passes it into the body).
                    self._route_bar(ctx, 1)
                    st.pending = tok.level
                    st.mode = "drain"
                    st.got_data = False
            elif st.mode == "drain":
                if not qb:
                    return progress
                tok = qb.popleft()
                progress = True
                if is_data(tok):
                    self._route_data(ctx, dict(zip(vars_f, tok.values)))
                    st.got_data = True
                else:
                    if tok.level != 1:
                        raise DataflowDeadlock(
                            f"{ctx.name}: backedge barrier Ω{tok.level} != Ω1")
                    if st.got_data:
                        self._route_bar(ctx, 1)   # next wave marker
                        st.got_data = False
                    else:
                        # empty wave: release the pending barrier *raised one
                        # level* (paper: "a done token at one level higher");
                        # exit edges lower it back; the body-side copy echoes
                        # around the loop to be consumed in `echo` mode.
                        self._route_bar(ctx, st.pending + 1)
                        st.mode = "echo"
            else:  # echo
                if not qb:
                    return progress
                tok = qb.popleft()
                progress = True
                if is_data(tok) or tok.level != st.pending + 1:
                    raise DataflowDeadlock(
                        f"{ctx.name}: unexpected token {tok} while awaiting "
                        f"Ω{st.pending + 1} echo")
                st.pending = None
                st.mode = "fwd"

    def _fire_counter(self, ctx, h: CounterHead) -> bool:
        q = self.queues[h.link]
        vars_in = self.g.links[h.link].vars
        progress = False
        while q:
            tok = q.popleft()
            progress = True
            if is_data(tok):
                regs0 = dict(zip(vars_in, tok.values))
                lo, hi, step = regs0[h.lo], regs0[h.hi], regs0[h.step]
                step = step if step != 0 else 1
                for i in range(lo, hi, step):
                    regs = dict(regs0)
                    regs[h.ivar] = i
                    self._route_data(ctx, regs)
                if h.add_level:
                    self._route_bar(ctx, 1)      # close the group
            else:
                self._route_bar(ctx, tok.level + 1 if h.add_level
                                else tok.level)
        return progress

    # -- scheduler ---------------------------------------------------------------
    def run(self, max_rounds: int = 1_000_000, **params: int
            ) -> dict[str, np.ndarray]:
        fn_vars = getattr(self.g, "source_vars", ())
        self.source.append(Tok(0, tuple(wrap32(int(params[p]))
                                        for p in fn_vars)))
        self.source.append(bar(1))
        order = list(self.g.contexts.values())
        for _ in range(max_rounds):
            progress = False
            for ctx in order:
                if self._fire(ctx):
                    progress = True
            self.stats["rounds"] += 1
            if not progress:
                break
        else:
            raise DataflowDeadlock("round limit exceeded")
        stuck = {lid: len(q) for lid, q in self.queues.items() if q
                 and not self._is_sink(lid)}
        if stuck:
            desc = {f"{lid}->{self.g.contexts[self.g.links[lid].dst].name}":
                    n for lid, n in stuck.items()}
            raise DataflowDeadlock(f"quiescent with tokens in flight: {desc}")
        return self.dram

    def _is_sink(self, lid: int) -> bool:
        dst = self.g.links[lid].dst
        return dst is not None and not self.g.contexts[dst].outs
