"""Structural IR/DFG verifier — the invariants ``lowering.py`` silently
assumes, made explicit and checkable between passes.

``verify_program`` checks the structured IR:

* **declarations** — every DRAM/pool reference resolves; SRAM buffer names
  are globally unique (lowering builds its buffer->pool map on that);
* **defined-before-use** — every variable a statement reads is definitely
  assigned on *all* paths reaching it (lowering sizes link payloads from
  liveness; a maybe-undefined live-in becomes a register the VM never wrote);
* **frees match allocations** — every ``SRAMFree`` names an in-scope buffer
  of the same pool; once the ``frees-inserted`` invariant is established,
  every allocation also has a matching free;
* **yield discipline** — ``Yield`` only inside a *reducing* ``foreach`` and
  only at its thread-tail depth (``if`` nesting is fine; crossing a
  ``while``/``fork``/inner ``foreach`` is the atomics territory of Fig. 9);
* **fork tail position** — ``Fork`` must be the last statement of a thread
  body, fork body, or while body (lowering wires children into the loop
  backedge there and nowhere else);
* **sugar absence** — once ``no-sugar`` is established, no view/iterator
  statement may remain.

``verify_dfg`` checks the lowered graph: every link has exactly one producer
output and one consumer head (the single-producer/single-consumer link
precondition), barrier-depth bookkeeping at multi-input heads (zip/merge
inputs at equal depth; a loop backedge exactly one deeper than its forward
input), and that every register a context's body or outputs read is actually
produced by its head or an earlier body op.
"""
from __future__ import annotations

from . import ir
from .dfg import (DFG, CounterHead, ForwardMergeHead, FwdBwdMergeHead,
                  SingleHead, SourceHead, ZipHead, head_links)
from .ir import (Exit, Foreach, Fork, If, ItAdvance, ItDeref, ItWrite,
                 ReadItDecl, Replicate, SRAMDecl, SRAMFree, ViewDecl,
                 ViewLoad, ViewStore, While, WriteItDecl, Yield)
from .liveness import stmt_uses_defs

_SUGAR = (ViewDecl, ViewLoad, ViewStore, ReadItDecl, ItDeref, ItAdvance,
          WriteItDecl, ItWrite)

# block kinds whose tail is a thread tail (a Fork may sit there)
_FORKABLE = ("main", "foreach", "fork", "while-body")


class VerificationError(Exception):
    """A structural invariant the lowering relies on does not hold."""


def _fail(stage: str, msg: str) -> None:
    where = f" [after {stage}]" if stage else ""
    raise VerificationError(msg + where)


def verify_program(prog: ir.Program, established: set[str] | frozenset = (),
                   stage: str = "") -> None:
    """Raise :class:`VerificationError` if ``prog`` violates an invariant.

    ``established`` names pipeline invariants already provided by earlier
    passes (``"no-sugar"``, ``"frees-inserted"``); the conditional checks
    only run once their providing pass has run.  ``stage`` tags error
    messages with the pass that just ran.
    """
    established = set(established)
    if prog.main is None:
        return
    v = _Verifier(prog, established, stage)
    v.check_decls()
    v.check_block(prog.main.body, defined=set(prog.main.params),
                  block_kind="main", reduce_frame=None)
    if "frees-inserted" in established:
        v.check_frees_complete()


class _Verifier:
    def __init__(self, prog: ir.Program, established: set[str], stage: str):
        self.prog = prog
        self.established = established
        self.stage = stage
        self.buf_pools: dict[str, str] = {}

    def fail(self, msg: str) -> None:
        _fail(self.stage, msg)

    # -- declarations -------------------------------------------------------
    def check_decls(self) -> None:
        for s in ir.walk(self.prog.main.body):
            if isinstance(s, SRAMDecl):
                if s.var in self.buf_pools:
                    self.fail(f"SRAM buffer '{s.var}' declared twice "
                              "(lowering requires globally unique names)")
                self.buf_pools[s.var] = s.pool
                if s.pool not in self.prog.pools:
                    self.fail(f"SRAMDecl '{s.var}' uses undeclared pool "
                              f"'{s.pool}'")
                elif s.size > self.prog.pools[s.pool].buf_words:
                    self.fail(
                        f"SRAM buffer '{s.var}' ({s.size} words) exceeds "
                        f"pool '{s.pool}' buffer size "
                        f"({self.prog.pools[s.pool].buf_words} words) — "
                        "accesses would alias the neighboring buffer")
            elif isinstance(s, SRAMFree):
                if s.pool not in self.prog.pools:
                    self.fail(f"SRAMFree '{s.var}' names undeclared pool "
                              f"'{s.pool}'")
            arr = getattr(s, "arr", None)
            if arr is not None and arr not in self.prog.dram:
                self.fail(f"{type(s).__name__} references undeclared DRAM "
                          f"array '{arr}'")
            if isinstance(s, _SUGAR) and "no-sugar" in self.established:
                self.fail(f"{type(s).__name__} survived sugar lowering")
            if isinstance(s, SRAMFree):
                pool = self.buf_pools.get(s.var)
                if pool is not None and pool != s.pool:
                    self.fail(f"SRAMFree '{s.var}' pool '{s.pool}' does not "
                              f"match its declaration pool '{pool}'")
            if isinstance(s, Foreach) and s.eliminate_hierarchy \
                    and s.reduce_op is not None:
                self.fail("pragma(eliminate_hierarchy) foreach cannot also "
                          "reduce — use atomics (Fig. 9)")

    # -- frees --------------------------------------------------------------
    def check_frees_complete(self) -> None:
        freed = {s.var for s in ir.walk(self.prog.main.body)
                 if isinstance(s, SRAMFree)}
        for buf in self.buf_pools:
            if buf not in freed:
                self.fail(f"SRAM buffer '{buf}' is allocated but never "
                          "freed (frees-inserted discipline)")

    # -- definite assignment + structure ------------------------------------
    def check_block(self, stmts: list[ir.Stmt], defined: set[str],
                    block_kind: str, reduce_frame: str | None
                    ) -> set[str] | None:
        """Verify one statement list.  Returns the definitely-defined set at
        the block's end, or ``None`` if the block always exits the thread."""
        for i, s in enumerate(stmts):
            uses, defs = stmt_uses_defs(s)
            missing = sorted(u for u in uses if u not in defined)
            if missing:
                self.fail(f"{type(s).__name__} reads undefined variable(s) "
                          f"{missing}")
            if isinstance(s, Exit):
                return None                      # rest of block unreachable
            if isinstance(s, If):
                dt = self.check_block(s.then, set(defined), "if",
                                      reduce_frame)
                de = self.check_block(s.els, set(defined), "if",
                                      reduce_frame)
                if dt is None and de is None:
                    return None
                defined = (dt if de is None else
                           de if dt is None else dt & de)
            elif isinstance(s, While):
                # a while raises the barrier depth: yields inside cannot
                # reach the enclosing reduction network (Fig. 9 discipline)
                dh = self.check_block(s.header, set(defined), "while-header",
                                      None)
                if dh is None:
                    self.fail("while header always exits")
                cond_missing = sorted(u for u in ir.expr_vars(s.cond)
                                      if u not in dh)
                if cond_missing:
                    self.fail("while condition reads undefined variable(s) "
                              f"{cond_missing}")
                self.check_block(s.body, set(dh), "while-body", None)
                defined = dh                     # header runs at least once
            elif isinstance(s, Foreach):
                frame = s.ivar if s.reduce_op is not None else None
                self.check_block(s.body, set(defined) | {s.ivar}, "foreach",
                                 frame)
                defined |= defs                  # reduce_var, if any
            elif isinstance(s, Fork):
                if i != len(stmts) - 1:
                    self.fail("fork must be the last statement of its block")
                if block_kind not in _FORKABLE:
                    self.fail(f"fork in a {block_kind} block is not a thread "
                              "tail (lowering cannot wire its continuation)")
                self.check_block(s.body, set(defined) | {s.ivar}, "fork",
                                 None)
            elif isinstance(s, Replicate):
                d = self.check_block(s.body, set(defined), "replicate",
                                     reduce_frame)
                if d is None:
                    return None
                defined = d
            elif isinstance(s, Yield):
                if reduce_frame is None:
                    self.fail("yield outside a reducing foreach (or across a "
                              "while/fork boundary — use atomic_add, Fig. 9)")
            else:
                defined |= defs
        return defined


# ---------------------------------------------------------------------------
# DFG-level checks (run after lowering)
# ---------------------------------------------------------------------------

def verify_dfg(g: DFG, stage: str = "lowering") -> None:
    """Single producer/consumer per link, barrier-depth bookkeeping, and
    register availability inside each context."""
    g.validate()     # no dangling producers/consumers, output arities
    producers: dict[int, int] = {}
    consumers: dict[int, int] = {}
    for c in g.contexts.values():
        for o in c.outs:
            producers[o.link] = producers.get(o.link, 0) + 1
        for lid in head_links(c.head):
            consumers[lid] = consumers.get(lid, 0) + 1
    for lid, link in g.links.items():
        if producers.get(lid, 0) > 1:
            _fail(stage, f"link {lid} ({link.vars}) has "
                         f"{producers[lid]} producers (must be single)")
        if consumers.get(lid, 0) != 1:
            _fail(stage, f"link {lid} ({link.vars}) has "
                         f"{consumers.get(lid, 0)} consumers (must be 1)")

    for c in g.contexts.values():
        h = c.head
        if isinstance(h, (ZipHead, ForwardMergeHead)):
            depths = {g.links[l].depth for l in head_links(h)}
            if len(depths) > 1:
                _fail(stage, f"ctx {c.name}: merged links at unequal "
                             f"barrier depths {sorted(depths)}")
        elif isinstance(h, FwdBwdMergeHead):
            df, db = g.links[h.fwd].depth, g.links[h.back].depth
            if db != df + 1:
                _fail(stage, f"ctx {c.name}: backedge depth {db} != "
                             f"forward depth {df} + 1")
        _check_context_regs(g, c, stage)


def _check_context_regs(g: DFG, c, stage: str) -> None:
    h = c.head
    if isinstance(h, SourceHead):
        avail = set(getattr(g, "source_vars", ()))
    else:
        avail = {v for lid in head_links(h) for v in g.links[lid].vars}
    if isinstance(h, CounterHead):
        avail.add(h.ivar)
        for r in (h.lo, h.hi, h.step):
            if r not in avail:
                _fail(stage, f"ctx {c.name}: counter bound '{r}' not on the "
                             "incoming link")
    for op in c.body:
        for r in op.srcs:
            if r not in avail:
                _fail(stage, f"ctx {c.name}: body op '{op.op}' reads "
                             f"unavailable register '{r}'")
        if op.pred is not None and op.pred not in avail:
            _fail(stage, f"ctx {c.name}: predicate '{op.pred}' unavailable")
        if op.dst is not None:
            avail.add(op.dst)
    for o in c.outs:
        for r in o.values:
            if r not in avail:
                _fail(stage, f"ctx {c.name}: output carries unavailable "
                             f"register '{r}'")
        if o.pred is not None and o.pred not in avail:
            _fail(stage, f"ctx {c.name}: filter predicate '{o.pred}' "
                         "unavailable")
