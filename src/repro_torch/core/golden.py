"""Golden interpreter — executes the structured Revet IR directly.

This is the *language-semantics oracle*: it runs threads one at a time,
sequentially, exactly as §IV defines them (sequential statements per thread,
unordered across threads, children read parent variables, results return via
reduction or memory). The dataflow pipeline (lowering -> TokenVM -> VectorVM)
is validated against this interpreter end-to-end.

It executes both pre-lowering IR (views/iterators handled natively) and
post-lowering IR (SRAM + scalar accesses only), so each compiler pass can be
checked for semantic preservation by running the program before and after.
"""
from __future__ import annotations

import collections
from typing import Any

import numpy as np

from . import ir
from .ir import (Assign, AtomicAdd, DRAMLoad, DRAMStore, Exit, Expr, Foreach,
                 Fork, If, ItAdvance, ItDeref, ItWrite, ReadItDecl, Replicate,
                 SRAMDecl, SRAMLoad, SRAMStore, ViewDecl, ViewLoad, ViewStore,
                 While, WriteItDecl, Yield, eval_binop, eval_expr, wrap32)

_DTYPE_MASK = {"i8": 0xFF, "i16": 0xFFFF, "i32": None}

_REDUCE_OPS = {
    "add": lambda a, b: wrap32(a + b),
    "min": min,
    "max": max,
    "and": lambda a, b: a & b,
    "or": lambda a, b: a | b,
    "xor": lambda a, b: wrap32(a ^ b),
}


class _ThreadExit(Exception):
    pass


class _Env(collections.ChainMap):
    """Variable scope. Child-thread scopes shadow the parent (read-only view,
    §IV-A: threads 'have a read-only view of their parent's variables')."""


class _ReadIt:
    def __init__(self, g: "Golden", arr: str, pos: int, tile: int, peek: bool):
        self.g, self.arr, self.pos, self.tile, self.peek = g, arr, pos, tile, peek

    def deref(self, ahead: int = 0) -> int:
        return self.g._dram_read(self.arr, self.pos + ahead)

    def advance(self, n: int) -> None:
        self.pos += n


class _WriteIt:
    def __init__(self, g: "Golden", arr: str, pos: int, tile: int, manual: bool):
        self.g, self.arr, self.pos, self.tile, self.manual = g, arr, pos, tile, manual

    def write(self, v: int) -> None:
        self.g._dram_write(self.arr, self.pos, v)
        self.pos += 1


class _View:
    def __init__(self, g: "Golden", arr: str, base: int, size: int, mode: str):
        self.g, self.arr, self.base, self.size, self.mode = g, arr, base, size, mode
        if mode in ("read", "modify"):
            self.buf = [g._dram_read(arr, base + i) for i in range(size)]
            g.stats["dram_bulk_read_elems"] += size
        else:
            self.buf = [0] * size
        self.dirty = mode in ("write", "modify")

    def load(self, i: int) -> int:
        return self.buf[i]

    def store(self, i: int, v: int) -> None:
        self.buf[i] = v

    def flush(self) -> None:
        if self.dirty:
            for i, v in enumerate(self.buf):
                self.g._dram_write(self.arr, self.base + i, v)
            self.g.stats["dram_bulk_write_elems"] += self.size


class Golden:
    """Reference interpreter for a Revet :class:`~repro_torch.core.ir.Program`."""

    def __init__(self, program: ir.Program,
                 dram_init: dict[str, np.ndarray] | None = None):
        self.prog = program
        self.dram: dict[str, np.ndarray] = {}
        for name, decl in program.dram.items():
            self.dram[name] = np.zeros(decl.size, dtype=np.int64)
        if dram_init:
            from .backend import wrap_dram_init
            for name, arr in dram_init.items():
                a = wrap_dram_init(arr, program.dram[name].dtype)
                self.dram[name][: a.size] = a
        self.stats: collections.Counter = collections.Counter()
        # per-thread (stmts, loop_iters) profile — feeds the SIMT-divergence
        # comparison in benchmarks/table5 (warp lockstep cost = max over warp)
        self.thread_profile: list[tuple[int, int]] = []
        # memory-object tables (handle name -> object); names are unique
        self._objs: dict[str, Any] = {}
        # pool-backed scratchpads: SRAM pointers are first-class *values*
        # (the hierarchy-elimination rewrite uses them as DRAM addresses,
        # Fig. 9), handed out from per-pool free lists like the VMs do.
        # Unlike the VMs the oracle never deadlocks: an exhausted pool grows.
        self.pool_mem: dict[str, np.ndarray] = {}
        self.pool_free: dict[str, collections.deque] = {}
        for name, pool in program.pools.items():
            self.pool_mem[name] = np.zeros(pool.n_bufs * pool.buf_words,
                                           dtype=np.int64)
            self.pool_free[name] = collections.deque(range(pool.n_bufs))
        self._buf_pool: dict[str, str] = {}     # SRAMDecl var -> pool name
        self._buf_size: dict[str, int] = {}     # SRAMDecl var -> words

    # -- DRAM access ----------------------------------------------------------
    def _mask(self, arr: str, v: int) -> int:
        m = _DTYPE_MASK[self.prog.dram[arr].dtype]
        return wrap32(v) if m is None else (v & m)

    def _dram_read(self, arr: str, addr: int) -> int:
        a = self.dram[arr]
        self.stats["dram_read_elems"] += 1
        if 0 <= addr < a.size:
            return int(a[addr])
        return 0

    def _dram_write(self, arr: str, addr: int, v: int) -> None:
        a = self.dram[arr]
        self.stats["dram_write_elems"] += 1
        if 0 <= addr < a.size:
            a[addr] = self._mask(arr, v)

    # -- SRAM pools -----------------------------------------------------------
    def _sram_alloc(self, s: SRAMDecl) -> int:
        pool = self.prog.pools[s.pool]
        if s.size > pool.buf_words:
            # the VM would silently alias the neighboring buffer; the oracle
            # rejects the program instead (the verifier flags it too)
            raise ValueError(
                f"SRAM buffer '{s.var}' ({s.size} words) exceeds pool "
                f"'{s.pool}' buffer size ({pool.buf_words} words)")
        fl = self.pool_free[s.pool]
        if not fl:
            # grow instead of stalling: the oracle defines semantics, the
            # VMs model the finite-resource back-pressure (Fig. 14)
            mem = self.pool_mem[s.pool]
            n = mem.size // pool.buf_words
            self.pool_mem[s.pool] = np.concatenate(
                [mem, np.zeros(n * pool.buf_words, dtype=np.int64)])
            fl.extend(range(n, 2 * n))
        ptr = fl.popleft()
        self._buf_pool[s.var] = s.pool
        self._buf_size[s.var] = s.size
        base = ptr * pool.buf_words
        self.pool_mem[s.pool][base: base + pool.buf_words] = 0
        return ptr

    def _sram_addr(self, buf: str, idx: int, env: _Env) -> "int | None":
        """Pool-memory address of ``buf[idx]``, or None when out of bounds
        (loads read 0, stores drop — the historical per-buffer semantics;
        indices never alias a neighboring buffer)."""
        if not 0 <= idx < self._buf_size[buf]:
            return None
        return env[buf] * self.prog.pools[self._buf_pool[buf]].buf_words + idx

    # -- entry point ------------------------------------------------------------
    def run(self, **params: int) -> dict[str, np.ndarray]:
        fn = self.prog.main
        assert fn is not None, "program has no main()"
        missing = set(fn.params) - set(params)
        if missing:
            raise ValueError(f"missing main() params: {missing}")
        env = _Env({p: wrap32(int(params[p])) for p in fn.params})
        try:
            self._block(fn.body, env)
        except _ThreadExit:
            pass
        return self.dram

    # -- statement execution ------------------------------------------------------
    def _block(self, stmts: list[ir.Stmt], env: _Env) -> None:
        local_views: list[_View] = []
        try:
            for s in stmts:
                v = self._stmt(s, env)
                if isinstance(v, _View):
                    local_views.append(v)
        finally:
            for view in local_views:
                view.flush()

    def _stmt(self, s: ir.Stmt, env: _Env):
        self.stats["stmts"] += 1
        if isinstance(s, Assign):
            env[s.var] = eval_expr(s.expr, env)
        elif isinstance(s, SRAMDecl):
            env[s.var] = self._sram_alloc(s)
            self.stats["sram_allocs"] += 1
        elif isinstance(s, ir.SRAMFree):
            self.pool_free[self._buf_pool[s.var]].append(env[s.var])
            self.stats["sram_frees"] += 1
        elif isinstance(s, SRAMLoad):
            addr = self._sram_addr(s.buf, eval_expr(s.idx, env), env)
            env[s.var] = (int(self.pool_mem[self._buf_pool[s.buf]][addr])
                          if addr is not None else 0)
            self.stats["sram_reads"] += 1
        elif isinstance(s, SRAMStore):
            if s.pred is not None and eval_expr(s.pred, env) == 0:
                return None
            addr = self._sram_addr(s.buf, eval_expr(s.idx, env), env)
            if addr is not None:
                self.pool_mem[self._buf_pool[s.buf]][addr] = \
                    wrap32(eval_expr(s.val, env))
            self.stats["sram_writes"] += 1
        elif isinstance(s, DRAMLoad):
            env[s.var] = self._dram_read(s.arr, eval_expr(s.addr, env))
        elif isinstance(s, DRAMStore):
            if s.pred is not None and eval_expr(s.pred, env) == 0:
                return None
            self._dram_write(s.arr, eval_expr(s.addr, env),
                             eval_expr(s.val, env))
        elif isinstance(s, AtomicAdd):
            addr = eval_expr(s.addr, env)
            old = self._dram_read(s.arr, addr)
            self._dram_write(s.arr, addr, old + eval_expr(s.delta, env))
            env[s.var] = old
        elif isinstance(s, If):
            if eval_expr(s.cond, env) != 0:
                self._block(s.then, env)
            else:
                self._block(s.els, env)
        elif isinstance(s, While):
            if s.body and isinstance(s.body[-1], Fork):
                # fork at the loop-body tail: children re-enter the loop
                # (kD-tree traversal shape). Threads may only leave such a
                # loop via exit(); the forking thread itself is consumed.
                self._while_fork_worklist(s, env)
                raise _ThreadExit()
            while True:
                self._block(s.header, env)
                if eval_expr(s.cond, env) == 0:
                    break
                self._block(s.body, env)
                self.stats["loop_iters"] += 1
        elif isinstance(s, Foreach):
            self._foreach(s, env)
        elif isinstance(s, Fork):
            count = eval_expr(s.count, env)
            for i in range(count):
                child = _Env({s.ivar: i}, env)
                self.stats["threads"] += 1
                try:
                    self._block(s.body, child)
                except _ThreadExit:
                    pass
        elif isinstance(s, Replicate):
            # Pure mapping annotation: semantics are the body's (§IV-A).
            self._block(s.body, env)
        elif isinstance(s, Yield):
            acc_slot = env.get("__acc__")
            if acc_slot is None:
                raise ValueError("Yield outside a reducing foreach")
            op = _REDUCE_OPS[acc_slot[0]]
            acc_slot[1] = op(acc_slot[1], eval_expr(s.expr, env))
        elif isinstance(s, Exit):
            raise _ThreadExit()
        # -- front-end sugar (views & iterators) --------------------------------
        elif isinstance(s, ViewDecl):
            view = _View(self, s.arr, eval_expr(s.base, env), s.size, s.mode)
            self._objs[s.var] = view
            return view  # block tracks it for end-of-scope flush
        elif isinstance(s, ViewLoad):
            env[s.var] = self._objs[s.view].load(eval_expr(s.idx, env))
        elif isinstance(s, ViewStore):
            self._objs[s.view].store(eval_expr(s.idx, env),
                                     eval_expr(s.val, env))
        elif isinstance(s, ReadItDecl):
            self._objs[s.var] = _ReadIt(self, s.arr, eval_expr(s.seek, env),
                                        s.tile, s.peek)
        elif isinstance(s, ItDeref):
            env[s.var] = self._objs[s.it].deref(eval_expr(s.ahead, env))
        elif isinstance(s, ItAdvance):
            self._objs[s.it].advance(eval_expr(s.amount, env))
        elif isinstance(s, WriteItDecl):
            self._objs[s.var] = _WriteIt(self, s.arr, eval_expr(s.seek, env),
                                         s.tile, s.manual)
        elif isinstance(s, ItWrite):
            self._objs[s.it].write(eval_expr(s.val, env))
        else:
            raise NotImplementedError(f"golden: {type(s).__name__}")
        return None

    def _while_fork_worklist(self, s: While, env: _Env) -> None:
        """Execute a fork-tail loop with an explicit thread worklist — the
        language semantics of dynamic thread spawning into a circulating
        dataflow loop (§IV-A / §VI-B(c))."""
        fork: Fork = s.body[-1]  # type: ignore[assignment]
        work = [env]
        while work:
            e = work.pop()
            try:
                self._block(s.header, e)
                if eval_expr(s.cond, e) == 0:
                    raise NotImplementedError(
                        "threads must leave a fork-tail loop via exit()")
                self._block(s.body[:-1], e)
                cnt = eval_expr(fork.count, e)
                for i in range(cnt):
                    child = _Env({fork.ivar: i}, e)
                    self.stats["threads"] += 1
                    try:
                        self._block(fork.body, child)
                    except _ThreadExit:
                        continue
                    work.append(child)
            except _ThreadExit:
                continue

    def _foreach(self, s: Foreach, env: _Env) -> None:
        lo = eval_expr(s.lo, env)
        hi = eval_expr(s.hi, env)
        step = eval_expr(s.step, env) or 1
        acc_slot = None
        if s.reduce_op is not None:
            acc_slot = [s.reduce_op, s.reduce_init]
        for i in range(lo, hi, step):
            child = _Env({s.ivar: i}, env)
            if acc_slot is not None:
                child["__acc__"] = acc_slot
            self.stats["threads"] += 1
            before = (self.stats["stmts"], self.stats["loop_iters"])
            try:
                self._block(s.body, child)
            except _ThreadExit:
                pass
            self.thread_profile.append(
                (self.stats["stmts"] - before[0],
                 self.stats["loop_iters"] - before[1]))
        if acc_slot is not None and s.reduce_var:
            env[s.reduce_var] = acc_slot[1]
