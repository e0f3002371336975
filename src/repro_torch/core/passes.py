"""Compiler passes over the structured IR (§V-A, §V-B).

Pipeline order (see ``compiler.compile_program``):

1. ``lower_memory_sugar``   — views & iterators -> SRAM + control flow (§V-A(a))
2. ``eliminate_hierarchy``  — pragma'd foreach -> fork + atomic counting (Fig. 9)
3. ``if_to_select``         — branch-free ifs -> selects + predicated stores (§V-B(c))
4. ``fuse_allocations``     — one allocation per block per pool (§V-B(a))
5. ``insert_frees``         — explicit free-list discipline at scope ends/exits
6. ``hoist_allocators``     — replicate-region allocator hoisting + live-value
                              bufferization (§V-B(b))
7. ``infer_widths``         — sub-word width inference for the packing pass
                              (§V-B(d)); consumed by machine.py accounting

Each pass is semantics-preserving and is tested by running the golden
interpreter before/after.
"""
from __future__ import annotations

import dataclasses

from . import ir
from .ir import (Assign, AtomicAdd, DRAMLoad, DRAMStore, Exit, Expr, Foreach,
                 Fork, If, ItAdvance, ItDeref, ItWrite, ReadItDecl, Replicate,
                 SRAMDecl, SRAMFree, SRAMLoad, SRAMStore, ViewDecl, ViewLoad,
                 ViewStore, While, WriteItDecl, Yield, const, var)


class PassError(Exception):
    pass


class _Namer:
    def __init__(self, prefix: str):
        self.prefix = prefix
        self.n = 0

    def __call__(self, tag: str) -> str:
        self.n += 1
        return f"%{self.prefix}_{tag}{self.n}"


# ===========================================================================
# 1. View & iterator lowering (§V-A(a))
# ===========================================================================

class _SugarLowering:
    """Rewrites Table-I memory adapters into SRAM buffers + control flow.

    * Views become an SRAM buffer with a bulk-load foreach at declaration and
      (write/modify) a bulk-store foreach at scope end.
    * ``ReadIt`` becomes buffer + 'local pointer' + 'global pointer'; the
      buffer is filled *at dereference* when the local pointer overruns
      (paper: "we fill read iterators' buffers only at dereference") — the
      refill is an ``if`` containing a bulk-load ``foreach``, the exact shape
      of Fig. 5's demand-fetched path.
    * ``WriteIt`` flushes at tile-boundary increments and at deallocation;
      ``ManualWriteIt`` flushes when the ``last`` flag fires and elides the
      deallocation flush.
    """

    def __init__(self, prog: ir.Program):
        self.prog = prog
        self.nm = _Namer("sg")
        # iterator/view var -> descriptor
        self.its: dict[str, dict] = {}

    def run(self) -> None:
        if self.prog.main:
            self.prog.main.body = self.block(self.prog.main.body)

    # -- helpers --------------------------------------------------------------
    def _bulk_load(self, arr: str, base: Expr, buf: str, count: Expr,
                   buf_off: Expr | None = None) -> ir.Stmt:
        j = self.nm("j")
        t = self.nm("t")
        idx = var(j) if buf_off is None else Expr("add", (var(j), buf_off))
        return Foreach(j, const(0), count, const(1), [
            DRAMLoad(t, arr, Expr("add", (base, var(j)))),
            SRAMStore(buf, idx, var(t)),
        ])

    def _bulk_store(self, arr: str, base: Expr, buf: str, count: Expr) -> ir.Stmt:
        j = self.nm("j")
        t = self.nm("t")
        return Foreach(j, const(0), count, const(1), [
            SRAMLoad(t, buf, var(j)),
            DRAMStore(arr, Expr("add", (base, var(j))), var(t)),
        ])

    # -- recursive rewrite ------------------------------------------------------
    def block(self, stmts: list[ir.Stmt]) -> list[ir.Stmt]:
        out: list[ir.Stmt] = []
        epilogue: list[ir.Stmt] = []       # flushes owed at this scope's end
        for s in stmts:
            out.extend(self.stmt(s, epilogue))
        out.extend(epilogue)
        return out

    def stmt(self, s: ir.Stmt, epilogue: list[ir.Stmt]) -> list[ir.Stmt]:
        if isinstance(s, ViewDecl):
            return self._view_decl(s, epilogue)
        if isinstance(s, ViewLoad):
            d = self.its[s.view]
            return [SRAMLoad(s.var, d["buf"], s.idx)]
        if isinstance(s, ViewStore):
            d = self.its[s.view]
            return [SRAMStore(d["buf"], s.idx, s.val)]
        if isinstance(s, ReadItDecl):
            return self._read_it_decl(s)
        if isinstance(s, ItDeref):
            return self._deref(s)
        if isinstance(s, ItAdvance):
            d = self.its[s.it]
            # lazy: refill happens at the next dereference
            return [Assign(d["loc"], Expr("add", (var(d["loc"]), s.amount)))]
        if isinstance(s, WriteItDecl):
            return self._write_it_decl(s, epilogue)
        if isinstance(s, ItWrite):
            return self._it_write(s)
        # recurse into child blocks
        s = dataclasses.replace(s) if dataclasses.is_dataclass(s) else s
        if isinstance(s, If):
            s.then = self.block(s.then)
            s.els = self.block(s.els)
        elif isinstance(s, While):
            s.header = self.block(s.header)
            s.body = self.block(s.body)
        elif isinstance(s, (Foreach, Fork, Replicate)):
            s.body = self.block(s.body)
        return [s]

    def _view_decl(self, s: ViewDecl, epilogue: list[ir.Stmt]) -> list[ir.Stmt]:
        buf = s.var
        base = self.nm("base")
        self.its[s.var] = {"kind": "view", "buf": buf, "base": base,
                           "arr": s.arr, "size": s.size, "mode": s.mode}
        stmts: list[ir.Stmt] = [
            Assign(base, s.base),
            SRAMDecl(buf, s.size, self._pool(s.size)),
        ]
        if s.mode in ("read", "modify"):
            stmts.append(self._bulk_load(s.arr, var(base), buf, const(s.size)))
        if s.mode in ("write", "modify"):
            epilogue.append(self._bulk_store(s.arr, var(base), buf,
                                             const(s.size)))
        return stmts

    def _pool(self, words: int) -> str:
        # one pool per buffer size class; capacity tuned by the caller
        name = f"pool{max(words, 1)}"
        self.prog.ensure_pool(name, buf_words=max(words, 1), n_bufs=1024) \
            if hasattr(self.prog, "ensure_pool") else None
        if name not in self.prog.pools:
            self.prog.pool_decl(name, buf_words=max(words, 1), n_bufs=1024)
        return name

    def _read_it_decl(self, s: ReadItDecl) -> list[ir.Stmt]:
        buf, loc, glob = s.var, self.nm("loc"), self.nm("glob")
        self.its[s.var] = {"kind": "readit", "buf": buf, "loc": loc,
                           "glob": glob, "arr": s.arr, "tile": s.tile}
        return [
            SRAMDecl(buf, s.tile, self._pool(s.tile)),
            # invariant: cursor address == glob + loc. Start with an "empty"
            # buffer (loc == tile) positioned so the first refill lands the
            # cursor exactly at `seek`.
            Assign(glob, Expr("sub", (s.seek, const(s.tile)))),
            Assign(loc, const(s.tile)),      # force fill at first dereference
        ]

    def _deref(self, s: ItDeref) -> list[ir.Stmt]:
        d = self.its[s.it]
        tile = d["tile"]
        loc, glob, buf = d["loc"], d["glob"], d["buf"]
        need = Expr("sge", (Expr("add", (var(loc), s.ahead)), const(tile)))
        refill = [
            Assign(glob, Expr("add", (var(glob), var(loc)))),
            Assign(loc, const(0)),
            self._bulk_load(d["arr"], var(glob), buf, const(tile)),
        ]
        return [
            If(need, refill, []),
            SRAMLoad(s.var, buf, Expr("add", (var(loc), s.ahead))),
        ]

    def _write_it_decl(self, s: WriteItDecl,
                       epilogue: list[ir.Stmt]) -> list[ir.Stmt]:
        buf, loc, glob = s.var, self.nm("loc"), self.nm("glob")
        self.its[s.var] = {"kind": "writeit", "buf": buf, "loc": loc,
                           "glob": glob, "arr": s.arr, "tile": s.tile,
                           "manual": s.manual}
        if not s.manual:
            # deallocation flush: store the valid prefix (§V-A(a))
            epilogue.append(self._bulk_store_prefix(s.arr, glob, buf, loc))
        return [
            SRAMDecl(buf, s.tile, self._pool(s.tile)),
            Assign(glob, s.seek),
            Assign(loc, const(0)),
        ]

    def _bulk_store_prefix(self, arr: str, glob: str, buf: str,
                           loc: str) -> ir.Stmt:
        j = self.nm("j")
        t = self.nm("t")
        return Foreach(j, const(0), var(loc), const(1), [
            SRAMLoad(t, buf, var(j)),
            DRAMStore(arr, Expr("add", (var(glob), var(j))), var(t)),
        ])

    def _it_write(self, s: ItWrite) -> list[ir.Stmt]:
        d = self.its[s.it]
        tile, buf, loc, glob = d["tile"], d["buf"], d["loc"], d["glob"]
        stmts: list[ir.Stmt] = [
            SRAMStore(buf, var(loc), s.val),
            Assign(loc, Expr("add", (var(loc), const(1)))),
        ]
        full = Expr("sge", (var(loc), const(tile)))
        if d["manual"] and s.last is not None:
            full = Expr("or", (full, s.last))
        flush = [
            self._bulk_store_prefix(d["arr"], glob, buf, loc),
            Assign(glob, Expr("add", (var(glob), var(loc)))),
            Assign(loc, const(0)),
        ]
        stmts.append(If(full, flush, []))
        return stmts


def lower_memory_sugar(prog: ir.Program) -> ir.Program:
    _SugarLowering(prog).run()
    return prog


# ===========================================================================
# 2. Hierarchy elimination (§V-A(b), Fig. 9)
# ===========================================================================

_FECTR_MEM = "__fectr_mem"
_FECTR_POOL = "__fectr"


def eliminate_hierarchy(prog: ir.Program) -> ir.Program:
    """Rewrite ``pragma(eliminate_hierarchy)`` foreach loops into hierarchy-
    less forks with atomic fetch-and-decrement completion counting.

    The foreach must be in tail position of a thread body; the statements
    after it in the same block become the last child's continuation.
    """
    nm = _Namer("he")
    used = False

    def rewrite(stmts: list[ir.Stmt]) -> list[ir.Stmt]:
        nonlocal used
        for i, s in enumerate(stmts):
            if isinstance(s, Foreach) and s.eliminate_hierarchy:
                if s.reduce_op is not None:
                    raise PassError(
                        "eliminate_hierarchy: use atomics, not reduction")
                used = True
                rest = stmts[i + 1:]
                n, cell = nm("n"), nm("cell")
                ivar2, old = nm("k"), nm("old")
                trip = Expr("sdiv", (
                    Expr("sub", (Expr("add", (s.hi, Expr("sub", (s.step,
                                 const(1))))), s.lo)), s.step))
                body = [Assign(s.ivar, Expr("add", (
                    s.lo, Expr("mul", (var(ivar2), s.step)))))]
                body += s.body
                body += [
                    AtomicAdd(old, _FECTR_MEM, var(cell), const(-1)),
                    If(Expr("ne", (var(old), const(1))), [Exit()], []),
                    SRAMFree(cell, _FECTR_POOL),
                ]
                body += rest   # the last child continues the parent's tail
                return stmts[:i] + [
                    Assign(n, trip),
                    SRAMDecl(cell, 1, _FECTR_POOL),
                    DRAMStore(_FECTR_MEM, var(cell), var(n)),
                    Fork(ivar2, var(n), rewrite(body)),
                ]
        out = []
        for s in stmts:
            for blk in ir.child_blocks(s):
                blk[:] = rewrite(blk)
            out.append(s)
        return out

    if prog.main:
        prog.main.body = rewrite(prog.main.body)
    if used:
        if _FECTR_MEM not in prog.dram:
            prog.dram_decl(_FECTR_MEM, 4096)
        if _FECTR_POOL not in prog.pools:
            prog.pool_decl(_FECTR_POOL, buf_words=1, n_bufs=4096)
    return prog


# ===========================================================================
# 3. If-to-select conversion (§V-B(c))
# ===========================================================================

def _convertible(stmts: list[ir.Stmt], defined: set[str]) -> bool:
    """A branch is convertible if it is straight-line: assignments, loads
    (speculation-safe: OOB reads return 0), and stores (predicated)."""
    for s in stmts:
        if isinstance(s, Assign):
            if s.var not in defined:
                return False        # needs a pre-existing value to select from
        elif isinstance(s, (SRAMLoad, DRAMLoad)):
            if s.var not in defined:
                return False
        elif isinstance(s, (SRAMStore, DRAMStore)):
            pass
        else:
            return False
    return True


def _predicate(stmts: list[ir.Stmt], pred: Expr, nm: _Namer) -> list[ir.Stmt]:
    out: list[ir.Stmt] = []
    for s in stmts:
        if isinstance(s, Assign):
            out.append(Assign(s.var, Expr("select", (pred, s.expr,
                                                     var(s.var)))))
        elif isinstance(s, (SRAMLoad, DRAMLoad)):
            tmp = nm(f"v_{s.var.lstrip('%')}_")
            if isinstance(s, SRAMLoad):
                out.append(SRAMLoad(tmp, s.buf, s.idx))
            else:
                out.append(DRAMLoad(tmp, s.arr, s.addr))
            out.append(Assign(s.var, Expr("select", (pred, var(tmp),
                                                     var(s.var)))))
        elif isinstance(s, SRAMStore):
            out.append(dataclasses.replace(s, pred=_and_pred(s, pred)))
        elif isinstance(s, DRAMStore):
            out.append(dataclasses.replace(s, pred=_and_pred(s, pred)))
        else:
            raise AssertionError
    return out


def _and_pred(s, pred: Expr) -> Expr:
    old = getattr(s, "pred", None)
    if old is None:
        return pred
    return Expr("and", (Expr("ne", (old, const(0))), pred))


def if_to_select(prog: ir.Program) -> ir.Program:
    """Inline branch-free if statements: conditional moves + predicated
    stores. "More powerful than MLIR's default of only rewriting empty ifs"
    — we convert any straight-line branch."""
    nm = _Namer("ifc")

    def rewrite(stmts: list[ir.Stmt], defined: set[str]) -> list[ir.Stmt]:
        out: list[ir.Stmt] = []
        for s in stmts:
            uses, defs = _uses_defs_shallow(s)
            if isinstance(s, If):
                s.then = rewrite(s.then, set(defined))
                s.els = rewrite(s.els, set(defined))
                if _convertible(s.then, defined) and \
                        _convertible(s.els, defined):
                    p = nm("p")
                    out.append(Assign(p, s.cond))
                    out.extend(_predicate(s.then, var(p), nm))
                    out.extend(_predicate(s.els, Expr("not", (var(p),)), nm))
                    for b in (s.then, s.els):
                        for st in b:
                            defined |= _uses_defs_shallow(st)[1]
                    continue
            elif isinstance(s, While):
                s.header = rewrite(s.header, set(defined))
                s.body = rewrite(s.body, set(defined) | _defs_in(s.header))
            elif isinstance(s, Foreach):
                s.body = rewrite(s.body, set(defined) | {s.ivar})
            elif isinstance(s, Fork):
                s.body = rewrite(s.body, set(defined) | {s.ivar})
            elif isinstance(s, Replicate):
                s.body = rewrite(s.body, set(defined))
            defined |= defs
            out.append(s)
        return out

    def _defs_in(stmts):
        d = set()
        for st in ir.walk(stmts):
            d |= _uses_defs_shallow(st)[1]
        return d

    if prog.main:
        prog.main.body = rewrite(prog.main.body,
                                 set(prog.main.params))
    return prog


def _uses_defs_shallow(s):
    from .liveness import stmt_uses_defs
    return stmt_uses_defs(s)


# ===========================================================================
# 4. Allocation fusion (§V-B(a))
# ===========================================================================

def fuse_allocations(prog: ir.Program) -> ir.Program:
    """Fuse all SRAM allocations within one block into a single buffer.

    "Allocation fusion lowers the number of pointers that must be tracked in
    dataflow": downstream, only the fused pointer is live. Accesses to the
    k-th fused buffer become ``base_idx + offset_k``.
    """
    def rewrite(stmts: list[ir.Stmt]) -> list[ir.Stmt]:
        decls = [s for s in stmts if isinstance(s, SRAMDecl)]
        by_pool: dict[str, list[SRAMDecl]] = {}
        for d in decls:
            by_pool.setdefault(d.pool, []).append(d)
        remap: dict[str, tuple[str, int]] = {}
        sizes: dict[str, int] = {}
        repool: dict[str, str] = {}     # lead var -> fused pool name
        for pool, group in by_pool.items():
            if len(group) < 2:
                continue
            lead = group[0]
            off = lead.size
            for d in group[1:]:
                remap[d.var] = (lead.var, off)
                off += d.size
            sizes[lead.var] = off
            repool[lead.var] = f"{pool}_f{off}"
        if not remap:
            new = []
            for s in stmts:
                for blk in ir.child_blocks(s):
                    blk[:] = rewrite(blk)
                new.append(s)
            return new

        out: list[ir.Stmt] = []
        for s in stmts:
            if isinstance(s, SRAMDecl) and s.var in remap:
                continue
            if isinstance(s, SRAMDecl) and s.var in sizes:
                fused_pool = f"{s.pool}_f{sizes[s.var]}"
                if fused_pool not in prog.pools:
                    base = prog.pools[s.pool]
                    prog.pool_decl(fused_pool, buf_words=sizes[s.var],
                                   n_bufs=base.n_bufs)
                out.append(SRAMDecl(s.var, sizes[s.var], fused_pool))
                continue
            if isinstance(s, SRAMFree) and s.var in remap:
                continue
            if isinstance(s, SRAMFree) and s.var in repool:
                out.append(SRAMFree(s.var, repool[s.var]))
                continue
            if isinstance(s, SRAMLoad) and s.buf in remap:
                lead, off = remap[s.buf]
                out.append(SRAMLoad(s.var, lead,
                                    Expr("add", (s.idx, const(off)))))
                continue
            if isinstance(s, SRAMStore) and s.buf in remap:
                lead, off = remap[s.buf]
                out.append(dataclasses.replace(
                    s, buf=lead, idx=Expr("add", (s.idx, const(off)))))
                continue
            for blk in ir.child_blocks(s):
                blk[:] = _substitute(rewrite(blk), remap, repool)
            out.append(s)
        return _substitute(out, remap, repool)

    def _substitute(stmts, remap, repool):
        out = []
        for s in stmts:
            if isinstance(s, SRAMLoad) and s.buf in remap:
                lead, off = remap[s.buf]
                s = SRAMLoad(s.var, lead, Expr("add", (s.idx, const(off))))
            elif isinstance(s, SRAMStore) and s.buf in remap:
                lead, off = remap[s.buf]
                s = dataclasses.replace(s, buf=lead,
                                        idx=Expr("add", (s.idx, const(off))))
            elif isinstance(s, SRAMFree) and s.var in remap:
                continue
            elif isinstance(s, SRAMFree) and s.var in repool:
                s = SRAMFree(s.var, repool[s.var])
            else:
                for blk in ir.child_blocks(s):
                    blk[:] = _substitute(blk, remap, repool)
            out.append(s)
        return out

    if prog.main:
        prog.main.body = rewrite(prog.main.body)
    return prog


# ===========================================================================
# 5. Explicit frees (free-list discipline, §V-B(a))
# ===========================================================================

def insert_frees(prog: ir.Program) -> ir.Program:
    """Append ``SRAMFree`` at the end of each declaring block and before each
    ``Exit`` for every buffer open in the innermost thread scope. Running
    before liveness/lowering makes pointer lifetimes visible to link-payload
    sizing."""

    def rewrite(stmts: list[ir.Stmt], thread_scope: list[tuple[str, str]]
                ) -> list[ir.Stmt]:
        here: list[tuple[str, str]] = []
        out: list[ir.Stmt] = []
        freed_explicitly: set[str] = set()
        for s in stmts:
            if isinstance(s, SRAMDecl):
                here.append((s.var, s.pool))
                thread_scope.append((s.var, s.pool))
                out.append(s)
            elif isinstance(s, SRAMFree):
                freed_explicitly.add(s.var)
                out.append(s)
            elif isinstance(s, Exit):
                for v, p in reversed(thread_scope):
                    if v not in freed_explicitly:
                        out.append(SRAMFree(v, p))
                out.append(s)
            elif isinstance(s, (Foreach, Fork)):
                s.body = rewrite(s.body, [])    # fresh thread scope
                out.append(s)
            elif isinstance(s, Replicate):
                s.body = rewrite(s.body, thread_scope)
                out.append(s)
            elif isinstance(s, If):
                s.then = rewrite(s.then, thread_scope)
                s.els = rewrite(s.els, thread_scope)
                out.append(s)
            elif isinstance(s, While):
                s.header = rewrite(s.header, thread_scope)
                s.body = rewrite(s.body, thread_scope)
                out.append(s)
            else:
                out.append(s)
        tail_fork = out and isinstance(out[-1], Fork)
        frees = [SRAMFree(v, p) for v, p in reversed(here)
                 if v not in freed_explicitly]
        if tail_fork and frees:
            # a buffer may be freed *inside* the fork body (hierarchy
            # elimination frees its counter cell from the last child, Fig. 9)
            inner = {x.var for x in ir.walk(out[-1].body)
                     if isinstance(x, SRAMFree)}
            frees = [f for f in frees if f.var not in inner]
        if tail_fork and frees:
            raise PassError("scratchpad buffers may not be open across a "
                            "tail fork; free them first")
        out.extend(frees)
        for v, _ in here:
            if (v, _) in thread_scope:
                thread_scope.remove((v, _))
        return out

    if prog.main:
        prog.main.body = rewrite(prog.main.body, [])
    return prog


# ===========================================================================
# 6. Allocator hoisting + bufferization around replicate (§V-B(b))
# ===========================================================================

def hoist_allocators(prog: ir.Program) -> ir.Program:
    """If a replicate region contains exactly one allocation (after fusion),
    hoist it out: the pointer's low bits steer threads to a region
    ("native round-robin load balancing": regions only receive new threads
    after freeing buffers) and live values are bufferized around the region
    through an SRAM indexed by the hoisted pointer."""
    from .liveness import live_after_map, live_in

    if not prog.main:
        return prog
    after = live_after_map(prog.main.body, set())
    nm = _Namer("hz")

    def rewrite(stmts: list[ir.Stmt]) -> list[ir.Stmt]:
        out: list[ir.Stmt] = []
        for s in stmts:
            for blk in ir.child_blocks(s):
                blk[:] = rewrite(blk)
            if isinstance(s, Replicate) and s.hoisted_ptr is None:
                decls = [d for d in s.body if isinstance(d, SRAMDecl)]
                if len(decls) == 1:
                    out.extend(_hoist(s, decls[0]))
                    continue
            out.append(s)
        return out

    def _hoist(s: Replicate, decl: SRAMDecl) -> list[ir.Stmt]:
        # move the declaration (and its free) outside the region
        body = [x for x in s.body
                if x is not decl and not (isinstance(x, SRAMFree)
                                          and x.var == decl.var)]
        pre: list[ir.Stmt] = [decl]
        post: list[ir.Stmt] = [SRAMFree(decl.var, decl.pool)]
        s2 = dataclasses.replace(s, body=body, hoisted_ptr=decl.var)
        # bufferize values live through (not used inside) the region
        live_after = after.get(id(s), set())
        used_inside = set()
        for st in ir.walk(body):
            u, d = _uses_defs_shallow(st)
            used_inside |= u | d
        through = sorted((live_in([], live_after) - used_inside)
                         - {decl.var})
        if through:
            bz_pool = f"bufz{len(through)}"
            if bz_pool not in prog.pools:
                base = prog.pools[decl.pool]
                prog.pool_decl(bz_pool, buf_words=len(through),
                               n_bufs=base.n_bufs)
            bz = nm("bz")
            pre.append(SRAMDecl(bz, len(through), bz_pool))
            for k, v in enumerate(through):
                pre.append(SRAMStore(bz, const(k), var(v)))
            for k, v in enumerate(through):
                post.insert(0, SRAMLoad(v, bz, const(k)))
            post.append(SRAMFree(bz, bz_pool))
            s2.bufferized = tuple(through)  # type: ignore[attr-defined]
        return pre + [s2] + post

    prog.main.body = rewrite(prog.main.body)
    return prog


# ===========================================================================
# 7. Sub-word width inference (§V-B(d))
# ===========================================================================

def infer_widths(prog: ir.Program) -> dict[str, int]:
    """Infer 8/16/32-bit widths per variable from constants, masks, and i8/i16
    DRAM loads. Feeds ``machine.py``'s link-packing accounting: sub-word
    values live into/out of loops pack into shared 32-bit lanes."""
    widths: dict[str, int] = {}

    def expr_width(e: Expr) -> int:
        if e.op == "const":
            v = e.args[0]
            if 0 <= v < 256:
                return 8
            if 0 <= v < 65536:
                return 16
            return 32
        if e.op == "var":
            return widths.get(e.args[0], 32)
        if e.op == "and":
            return min(expr_width(e.args[0]), expr_width(e.args[1]))
        if e.op in ("eq", "ne", "slt", "sle", "sgt", "sge", "ult", "ule",
                    "not"):
            return 8
        if e.op in ("or", "xor", "min", "max", "select"):
            ws = [expr_width(a) for a in e.args[-2:]]
            return max(ws)
        if e.op in ("umod",):
            return expr_width(e.args[1])
        return 32

    changed = True
    iters = 0
    while changed and iters < 8 and prog.main:
        changed = False
        iters += 1
        for s in ir.walk(prog.main.body):
            if isinstance(s, Assign):
                w = min(expr_width(s.expr), s.width)
                if widths.get(s.var, 32) != w and w < widths.get(s.var, 32):
                    widths[s.var] = w
                    changed = True
            elif isinstance(s, (DRAMLoad,)):
                decl = prog.dram.get(s.arr)
                if decl and decl.dtype in ("i8", "i16"):
                    w = 8 if decl.dtype == "i8" else 16
                    if widths.get(s.var, 32) > w:
                        widths[s.var] = w
                        changed = True
    return widths
