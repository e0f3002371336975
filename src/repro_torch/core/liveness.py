"""Live-variable analysis over the structured Revet IR.

Used by CFG->dataflow lowering (§V-C(b): "when mapping a block, we start by
identifying all live-in variables") to size link payloads, and by the
optimization passes (bufferization, sub-word packing) to find values live
into/out of merges.

Memory-object handles (SRAM buffers, views, iterators) are treated as
variables: after the allocator passes they *are* pointer registers.
"""
from __future__ import annotations

from . import ir
from .ir import (Assign, AtomicAdd, DRAMLoad, DRAMStore, Exit, Foreach, Fork,
                 If, ItAdvance, ItDeref, ItWrite, ReadItDecl, Replicate,
                 SRAMDecl, SRAMLoad, SRAMStore, ViewDecl, ViewLoad, ViewStore,
                 While, WriteItDecl, Yield, expr_vars)


def stmt_uses_defs(s: ir.Stmt) -> tuple[set[str], set[str]]:
    """Shallow uses/defs (child blocks excluded)."""
    if isinstance(s, Assign):
        return expr_vars(s.expr), {s.var}
    if isinstance(s, SRAMDecl):
        return set(), {s.var}
    if isinstance(s, ir.SRAMFree):
        return {s.var}, set()
    if isinstance(s, SRAMLoad):
        return expr_vars(s.idx) | {s.buf}, {s.var}
    if isinstance(s, SRAMStore):
        return expr_vars(s.idx) | expr_vars(s.val) | {s.buf}, set()
    if isinstance(s, DRAMLoad):
        return expr_vars(s.addr), {s.var}
    if isinstance(s, DRAMStore):
        return expr_vars(s.addr) | expr_vars(s.val), set()
    if isinstance(s, AtomicAdd):
        return expr_vars(s.addr) | expr_vars(s.delta), {s.var}
    if isinstance(s, If):
        return expr_vars(s.cond), set()
    if isinstance(s, While):
        return set(), set()          # handled recursively (cond in live_in)
    if isinstance(s, Foreach):
        u = expr_vars(s.lo) | expr_vars(s.hi) | expr_vars(s.step)
        d = {s.reduce_var} if s.reduce_var else set()
        return u, d
    if isinstance(s, Fork):
        return expr_vars(s.count), set()
    if isinstance(s, Replicate):
        return set(), set()
    if isinstance(s, Yield):
        return expr_vars(s.expr), set()
    if isinstance(s, Exit):
        return set(), set()
    # front-end sugar
    if isinstance(s, ViewDecl):
        return expr_vars(s.base), {s.var}
    if isinstance(s, ViewLoad):
        return expr_vars(s.idx) | {s.view}, {s.var}
    if isinstance(s, ViewStore):
        return expr_vars(s.idx) | expr_vars(s.val) | {s.view}, set()
    if isinstance(s, ReadItDecl):
        return expr_vars(s.seek), {s.var}
    if isinstance(s, ItDeref):
        return expr_vars(s.ahead) | {s.it}, {s.var}
    if isinstance(s, ItAdvance):
        return expr_vars(s.amount) | {s.it}, {s.it}
    if isinstance(s, WriteItDecl):
        return expr_vars(s.seek), {s.var}
    if isinstance(s, ItWrite):
        u = expr_vars(s.val) | {s.it}
        if s.last is not None:
            u |= expr_vars(s.last)
        return u, {s.it}
    raise NotImplementedError(type(s).__name__)


def live_in(stmts: list[ir.Stmt], live_out: set[str]) -> set[str]:
    """Variables live on entry to ``stmts`` given ``live_out`` after them."""
    live = set(live_out)
    for s in reversed(stmts):
        live = _live_before(s, live)
    return live


def _live_before(s: ir.Stmt, live_after: set[str]) -> set[str]:
    uses, defs = stmt_uses_defs(s)
    if isinstance(s, If):
        lt = live_in(s.then, live_after)
        le = live_in(s.els, live_after)
        return uses | lt | le
    if isinstance(s, While):
        # Fixpoint: anything live after the loop, used by header/cond/body, or
        # carried around the backedge is live at the head.
        head = set(live_after)
        for _ in range(4):  # converges fast (monotone, small sets)
            body_in = live_in(s.body, head)
            new_head = live_in(s.header, expr_vars(s.cond) | body_in | live_after)
            if new_head == head:
                break
            head = new_head
        return head
    if isinstance(s, Foreach):
        body_live = live_in(s.body, set()) - {s.ivar, "__acc__"}
        return uses | body_live | (live_after - defs)
    if isinstance(s, Fork):
        body_live = live_in(s.body, set()) - {s.ivar}
        return uses | body_live | live_after
    if isinstance(s, Replicate):
        return live_in(s.body, live_after)
    if isinstance(s, Exit):
        return set()   # nothing after an exit is reachable
    return uses | (live_after - defs)


def live_after_map(stmts: list[ir.Stmt], live_out: set[str],
                   out: dict[int, set[str]] | None = None) -> dict[int, set[str]]:
    """Map id(stmt) -> live-after set, for every stmt recursively."""
    if out is None:
        out = {}
    live = set(live_out)
    for s in reversed(stmts):
        out[id(s)] = set(live)
        if isinstance(s, If):
            live_after_map(s.then, live, out)
            live_after_map(s.els, live, out)
        elif isinstance(s, While):
            head = _live_before(s, live)
            body_in = live_in(s.body, head)
            live_after_map(s.body, head, out)
            live_after_map(s.header, expr_vars(s.cond) | body_in | live, out)
        elif isinstance(s, Foreach):
            live_after_map(s.body, set(), out)
        elif isinstance(s, Fork):
            live_after_map(s.body, set(), out)
        elif isinstance(s, Replicate):
            live_after_map(s.body, live, out)
        live = _live_before(s, live)
    return out
