"""CFG -> dataflow lowering (§V-C).

Rewrites the structured IR into the dataflow graph of ``core/dfg.py``:
basic blocks become contexts ("infinitely large virtual CUs", later split by
``machine.py``); structured control flow becomes the streaming primitives of
§III-B:

* ``if``       -> filter outputs + ForwardMergeHead join (Fig. 3)
* ``while``    -> FwdBwdMergeHead header + filter body/exit edges (Fig. 4)
* ``foreach``  -> CounterHead expansion + reduce output + Zip re-association
                  with the around-path carrying parent live values (Fig. 2)
* ``fork``     -> expansion/flattening pair (CounterHead, add_level=False)
* ``replicate``-> split filters + K body copies + forward-merge tree (§V-C(d))
* ``exit``     -> discard output (barriers pass, the thread is dropped)

Structural constraints enforced here (see DESIGN.md):
* ``Yield`` is only lowerable at the thread-tail nesting depth of its
  reducing ``foreach`` (inside ``if`` branches is fine; inside ``while``/
  ``fork`` use atomics — exactly the discipline of the paper's
  hierarchy-elimination rewrite, Fig. 9).
* ``fork`` must be in tail position: last statement of a thread body or of a
  ``while`` body (children then continue into the next loop circulation).
* Views/iterators must already be lowered (``passes.lower_memory_sugar``)
  and scratchpad frees made explicit (``passes.insert_frees``) — use
  ``repro_torch.core.compiler.compile_program`` for the full pipeline.
"""
from __future__ import annotations

from . import ir
from .dfg import (DFG, BodyOp, Context, CounterHead, ForwardMergeHead,
                  FwdBwdMergeHead, Output, SingleHead, SourceHead, ZipHead)
from .ir import Expr, expr_vars, walk
from .liveness import live_after_map, live_in


class LoweringError(Exception):
    pass


class _ReduceFrame:
    def __init__(self, op: str | None, init: int, depth: int):
        self.op = op
        self.init = init
        self.depth = depth                 # thread-tail depth (child level)
        self.yield_links: list[int] = []   # links carrying (value,) payloads


class Lowerer:
    def __init__(self, prog: ir.Program):
        self.prog = prog
        self.g = DFG(prog.name, dram=dict(prog.dram), pools=dict(prog.pools))
        self._tmp = 0
        self._reduce_stack: list[_ReduceFrame] = []
        self.after: dict[int, set[str]] = {}
        # decl var -> pool (names are globally unique by construction)
        self._pools: dict[str, str] = {}
        if prog.main:
            for s in walk(prog.main.body):
                if isinstance(s, ir.SRAMDecl):
                    self._pools[s.var] = s.pool

    # -- small helpers ---------------------------------------------------------
    def tmp(self) -> str:
        self._tmp += 1
        return f"%t{self._tmp}"

    def emit(self, ctx: Context, op: str, dst: str | None,
             srcs: tuple[str, ...] = (), imm: int | None = None,
             space: str | None = None, width: int = 32) -> None:
        ctx.body.append(BodyOp(op, dst, srcs, imm, space, width))

    def compile_expr(self, e: Expr, ctx: Context) -> str:
        if e.op == "const":
            r = self.tmp()
            self.emit(ctx, "const", r, imm=e.args[0])
            return r
        if e.op == "var":
            return e.args[0]
        if e.op == "select":
            c = self.compile_expr(e.args[0], ctx)
            a = self.compile_expr(e.args[1], ctx)
            b = self.compile_expr(e.args[2], ctx)
            r = self.tmp()
            self.emit(ctx, "select", r, (c, a, b))
            return r
        if e.op in ir.UNOPS:
            a = self.compile_expr(e.args[0], ctx)
            r = self.tmp()
            self.emit(ctx, e.op, r, (a,))
            return r
        a = self.compile_expr(e.args[0], ctx)
        b = self.compile_expr(e.args[1], ctx)
        r = self.tmp()
        self.emit(ctx, e.op, r, (a, b))
        return r

    # -- entry point ------------------------------------------------------------
    def lower(self) -> DFG:
        fn = self.prog.main
        assert fn is not None
        self.after = live_after_map(fn.body, set())
        entry = self.g.new_context("entry", SourceHead())
        self.g.entry = entry.id
        self.g.source_vars = tuple(fn.params)  # type: ignore[attr-defined]
        out_ctx, kind = self.lower_block(fn.body, entry, depth=1, live_out=set())
        if out_ctx is not None:
            result = self.g.new_link((), 1)
            self.g.attach_out(out_ctx, Output(
                result.id, kind, () if kind != "pass" else ()))
            self.g.new_context("result", SingleHead(result.id))
            self.g.result_link = result.id
        self.g.validate()
        return self.g

    # -- statement-list lowering ---------------------------------------------------
    def lower_block(self, stmts: list[ir.Stmt], ctx: Context, depth: int,
                    live_out: set[str],
                    while_tail: tuple[int, tuple[str, ...]] | None = None,
                    ) -> tuple[Context | None, str]:
        """Lower ``stmts`` starting inside ``ctx``. Returns (continuation ctx,
        tail kind) — kind is "pass" normally, "discard" after an exit; ctx is
        None when the tail was already wired (fork at a while-body tail)."""
        for i, s in enumerate(stmts):
            last = i == len(stmts) - 1
            if isinstance(s, ir.Assign):
                r = self.compile_expr(s.expr, ctx)
                self.emit(ctx, "mov", s.var, (r,), width=s.width)
            elif isinstance(s, ir.SRAMDecl):
                self.emit(ctx, "alloc", s.var, space=s.pool)
            elif isinstance(s, ir.SRAMFree):
                self.emit(ctx, "free", None, (s.var,),
                          space=self._pools.get(s.var, s.pool))
            elif isinstance(s, ir.SRAMLoad):
                idx = self.compile_expr(s.idx, ctx)
                pool = self._pools.get(s.buf, "default")
                self.emit(ctx, "sram_load", s.var, (s.buf, idx), space=pool)
            elif isinstance(s, ir.SRAMStore):
                idx = self.compile_expr(s.idx, ctx)
                val = self.compile_expr(s.val, ctx)
                pool = self._pools.get(s.buf, "default")
                pr = self.compile_expr(s.pred, ctx) if s.pred is not None else None
                ctx.body.append(BodyOp("sram_store", None, (s.buf, idx, val),
                                       space=pool, pred=pr))
            elif isinstance(s, ir.DRAMLoad):
                addr = self.compile_expr(s.addr, ctx)
                self.emit(ctx, "dram_load", s.var, (addr,), space=s.arr)
            elif isinstance(s, ir.DRAMStore):
                addr = self.compile_expr(s.addr, ctx)
                val = self.compile_expr(s.val, ctx)
                pr = self.compile_expr(s.pred, ctx) if s.pred is not None else None
                ctx.body.append(BodyOp("dram_store", None, (addr, val),
                                       space=s.arr, pred=pr))
            elif isinstance(s, ir.AtomicAdd):
                addr = self.compile_expr(s.addr, ctx)
                delta = self.compile_expr(s.delta, ctx)
                self.emit(ctx, "atomic_add", s.var, (addr, delta), space=s.arr)
            elif isinstance(s, ir.Yield):
                self._lower_yield(s, ctx, depth)
            elif isinstance(s, ir.Exit):
                return ctx, "discard"
            elif isinstance(s, ir.If):
                ctx = self._lower_if(s, ctx, depth)
            elif isinstance(s, ir.While):
                ctx = self._lower_while(s, ctx, depth)
            elif isinstance(s, ir.Foreach):
                ctx = self._lower_foreach(s, ctx, depth)
            elif isinstance(s, ir.Fork):
                if not last:
                    raise LoweringError("fork must be in tail position")
                tail_ctx = self._lower_fork(s, ctx, depth, while_tail)
                return tail_ctx, "pass" if tail_ctx is not None else "pass"
            elif isinstance(s, ir.Replicate):
                ctx = self._lower_replicate(s, ctx, depth)
            elif isinstance(s, (ir.ViewDecl, ir.ViewLoad, ir.ViewStore,
                                ir.ReadItDecl, ir.ItDeref, ir.ItAdvance,
                                ir.WriteItDecl, ir.ItWrite)):
                raise LoweringError(
                    f"{type(s).__name__} must be lowered by passes before "
                    "dataflow lowering (run passes.lower_memory_sugar)")
            else:
                raise NotImplementedError(type(s).__name__)
        return ctx, "pass"

    # -- yield ------------------------------------------------------------------
    def _lower_yield(self, s: ir.Yield, ctx: Context, depth: int) -> None:
        if not self._reduce_stack:
            raise LoweringError("yield outside a reducing foreach")
        frame = self._reduce_stack[-1]
        if depth != frame.depth:
            raise LoweringError(
                "yield inside while/fork cannot reach the reduction network; "
                "use atomic_add (hierarchy-elimination discipline, Fig. 9)")
        r = self.compile_expr(s.expr, ctx)
        ylink = self.g.new_link((r,), depth)
        self.g.attach_out(ctx, Output(ylink.id, "pass", (r,)))
        frame.yield_links.append(ylink.id)

    # -- if ---------------------------------------------------------------------
    def _lower_if(self, s: ir.If, ctx: Context, depth: int) -> Context:
        live_after = self.after[id(s)]
        lt = live_in(s.then, live_after)
        le = live_in(s.els, live_after)
        pred = self.compile_expr(s.cond, ctx)
        npred = self.tmp()
        self.emit(ctx, "not", npred, (pred,))

        tl = self.g.new_link(tuple(sorted(lt)), depth)
        fl = self.g.new_link(tuple(sorted(le)), depth)
        self.g.attach_out(ctx, Output(tl.id, "filter", tl.vars, pred=pred))
        self.g.attach_out(ctx, Output(fl.id, "filter", fl.vars, pred=npred))

        tctx = self.g.new_context("if.then", SingleHead(tl.id), ctx.nest_depth)
        tout, tkind = self.lower_block(s.then, tctx, depth, live_after)
        fctx = self.g.new_context("if.else", SingleHead(fl.id), ctx.nest_depth)
        fout, fkind = self.lower_block(s.els, fctx, depth, live_after)

        payload = tuple(sorted(live_after))
        tl2 = self.g.new_link(payload, depth)
        fl2 = self.g.new_link(payload, depth)
        assert tout is not None and fout is not None, \
            "fork inside an if branch is not tail position"
        self.g.attach_out(
            tout, Output(tl2.id, tkind, payload if tkind == "pass" else ()))
        self.g.attach_out(
            fout, Output(fl2.id, fkind, payload if fkind == "pass" else ()))
        return self.g.new_context("if.join",
                                  ForwardMergeHead(tl2.id, fl2.id),
                                  ctx.nest_depth)

    # -- while ----------------------------------------------------------------------
    def _lower_while(self, s: ir.While, ctx: Context, depth: int) -> Context:
        live_after = self.after[id(s)]
        head_live = live_in([s], live_after)   # loop-head fixpoint liveness
        carry = tuple(sorted(head_live))

        fwd = self.g.new_link(carry, depth)
        back = self.g.new_link(carry, depth + 1)
        self.g.attach_out(ctx, Output(fwd.id, "pass", carry))

        hctx = self.g.new_context("while.head",
                                  FwdBwdMergeHead(fwd.id, back.id),
                                  ctx.nest_depth + 1)
        body_entry_live = live_in(s.body, set(carry))
        hout, hkind = self.lower_block(
            s.header, hctx, depth + 1,
            set(carry) | expr_vars(s.cond) | body_entry_live)
        if hkind != "pass" or hout is None:
            raise LoweringError("while header cannot exit/fork")
        pred = self.compile_expr(s.cond, hout)
        npred = self.tmp()
        self.emit(hout, "not", npred, (pred,))

        body_payload = tuple(sorted(body_entry_live))
        body_link = self.g.new_link(body_payload, depth + 1)
        exit_link = self.g.new_link(tuple(sorted(live_after)), depth)
        self.g.attach_out(hout, Output(body_link.id, "filter", body_payload,
                                       pred=pred))
        self.g.attach_out(hout, Output(exit_link.id, "filter",
                                       tuple(sorted(live_after)), pred=npred,
                                       lower_barrier=True))
        exit_link.kind = "scalar"   # blocks following while loops (§V-D(a))

        bctx = self.g.new_context("while.body", SingleHead(body_link.id),
                                  ctx.nest_depth + 1)
        bout, bkind = self.lower_block(s.body, bctx, depth + 1, set(carry),
                                       while_tail=(back.id, carry))
        if bout is not None:
            self.g.attach_out(bout, Output(back.id, bkind,
                                           carry if bkind == "pass" else ()))
        return self.g.new_context("while.exit", SingleHead(exit_link.id),
                                  ctx.nest_depth)

    # -- foreach ----------------------------------------------------------------------
    def _lower_foreach(self, s: ir.Foreach, ctx: Context, depth: int) -> Context:
        live_after = self.after[id(s)]
        around_vars = tuple(sorted(live_after - ({s.reduce_var} if s.reduce_var
                                                 else set())))
        body_needs = live_in(s.body, set()) - {s.ivar}

        lo = self.compile_expr(s.lo, ctx)
        hi = self.compile_expr(s.hi, ctx)
        step = self.compile_expr(s.step, ctx)
        lo_n, hi_n, st_n = self.tmp(), self.tmp(), self.tmp()
        for dst, src in ((lo_n, lo), (hi_n, hi), (st_n, step)):
            self.emit(ctx, "mov", dst, (src,))

        exp_vars = tuple(sorted(body_needs)) + (lo_n, hi_n, st_n)
        exp_link = self.g.new_link(exp_vars, depth)
        around = self.g.new_link(around_vars, depth)
        self.g.attach_out(ctx, Output(exp_link.id, "pass", exp_vars))
        self.g.attach_out(ctx, Output(around.id, "pass", around_vars))

        ectx = self.g.new_context(
            "foreach", CounterHead(exp_link.id, lo_n, hi_n, st_n, s.ivar,
                                   add_level=True), ctx.nest_depth + 1)

        frame = _ReduceFrame(s.reduce_op, s.reduce_init, depth + 1)
        self._reduce_stack.append(frame)
        bout, bkind = self.lower_block(s.body, ectx, depth + 1, set())
        self._reduce_stack.pop()

        # Thread-tail link: completion sync (void reduction, §VI-A) and the
        # guaranteed input for the reduction context. Barrier-only (discard).
        red_in_links: list[int] = list(frame.yield_links)
        if bout is not None:
            tail = self.g.new_link((), depth + 1)
            self.g.attach_out(bout, Output(tail.id, "discard", ()))
            red_in_links.append(tail.id)
        if not red_in_links:
            raise LoweringError(
                "foreach body has neither a tail nor yields; cannot sync")

        merged = self._merge_tree(red_in_links, depth + 1, ctx.nest_depth + 1)

        red_var = s.reduce_var or self.tmp()
        red_link = self.g.new_link((red_var,), depth)
        rctx = self.g.new_context("foreach.reduce", SingleHead(merged),
                                  ctx.nest_depth + 1)
        in_vars = self.g.links[merged].vars
        val = in_vars[0] if in_vars else None
        self.g.attach_out(rctx, Output(
            red_link.id, "reduce", (val,) if val else (),
            reduce_op=s.reduce_op or "add", reduce_init=s.reduce_init))

        return self.g.new_context("foreach.join",
                                  ZipHead([around.id, red_link.id]),
                                  ctx.nest_depth)

    def _merge_tree(self, links: list[int], depth: int, nest: int) -> int:
        """Forward-merge links pairwise into one stream (§V-C(d)).

        Data-carrying links must share one arity; barrier-only links (arity 0,
        written by discard outputs) merge with anything — they contribute
        synchronization barriers, never data."""
        assert links
        data_arities = {self.g.links[l].nvars for l in links
                        if self.g.links[l].nvars > 0}
        if len(data_arities) > 1:
            raise LoweringError(f"merge tree arity mismatch: {data_arities}")
        links = sorted(links, key=lambda l: -self.g.links[l].nvars)
        while len(links) > 1:
            a, b = links[0], links[1]
            la = self.g.links[a]
            m = self.g.new_context("ymerge", ForwardMergeHead(a, b), nest)
            out = self.g.new_link(la.vars, depth)
            self.g.attach_out(m, Output(out.id, "pass", la.vars))
            links = [out.id] + links[2:]
        return links[0]

    # -- fork -------------------------------------------------------------------------
    def _lower_fork(self, s: ir.Fork, ctx: Context, depth: int,
                    while_tail: tuple[int, tuple[str, ...]] | None
                    ) -> Context | None:
        carry = set(while_tail[1]) if while_tail else set()
        body_needs = (live_in(s.body, carry) - {s.ivar}) | carry
        cnt = self.compile_expr(s.count, ctx)
        lo_n, hi_n, st_n = self.tmp(), self.tmp(), self.tmp()
        self.emit(ctx, "const", lo_n, imm=0)
        self.emit(ctx, "mov", hi_n, (cnt,))
        self.emit(ctx, "const", st_n, imm=1)
        exp_vars = tuple(sorted(body_needs)) + (lo_n, hi_n, st_n)
        exp_link = self.g.new_link(exp_vars, depth)
        self.g.attach_out(ctx, Output(exp_link.id, "pass", exp_vars))
        ectx = self.g.new_context(
            "fork", CounterHead(exp_link.id, lo_n, hi_n, st_n, s.ivar,
                                add_level=False), ctx.nest_depth)
        bout, bkind = self.lower_block(s.body, ectx, depth, carry,
                                       while_tail=while_tail)
        if bout is None:
            return None
        if while_tail is not None:
            back_id, carry_t = while_tail
            self.g.attach_out(bout, Output(
                back_id, bkind, carry_t if bkind == "pass" else ()))
            return None
        # thread tail: children die here; return their tail context so the
        # enclosing construct can attach its sync link (barriers still flow).
        return bout

    # -- replicate ---------------------------------------------------------------------
    def _lower_replicate(self, s: ir.Replicate, ctx: Context,
                         depth: int) -> Context:
        live_after = self.after[id(s)]
        body_in = live_in(s.body, live_after)
        payload = tuple(sorted(body_in))
        key = self.tmp()
        if s.hoisted_ptr is not None:
            # §V-B(b): the hoisted allocation's pointer low bits steer threads
            # to a region — freeing a buffer is what admits the next thread,
            # which is the native round-robin load-balancing feedback loop.
            nc = self.tmp()
            self.emit(ctx, "const", nc, imm=s.n)
            self.emit(ctx, "umod", key, (s.hoisted_ptr, nc))
        else:
            # Work distribution baseline: round-robin counter.
            self.emit(ctx, "rr_counter", key, imm=s.n)
        out_links = []
        for r in range(s.n):
            pred = self.tmp()
            kc = self.tmp()
            self.emit(ctx, "const", kc, imm=r)
            self.emit(ctx, "eq", pred, (key, kc))
            rl = self.g.new_link(payload, depth)
            rl.kind = "scalar"        # replicate entries are scalar (§V-D(a))
            self.g.attach_out(ctx, Output(rl.id, "filter", payload, pred=pred))
            rctx = self.g.new_context(f"rep{r}", SingleHead(rl.id),
                                      ctx.nest_depth)
            n0 = self.g._next_ctx - 1
            rout, rkind = self.lower_block(list(s.body), rctx, depth,
                                           live_after)
            # tag every context of this copy (late-unrolled region, §V-C(d))
            for cid in range(n0, self.g._next_ctx):
                self.g.contexts[cid].replicate_group = id(s) & 0x7FFFFFFF
                self.g.contexts[cid].replicate_copy = r
            ol = self.g.new_link(tuple(sorted(live_after)), depth)
            ol.kind = "scalar"        # replicate exits are scalar (§V-D(a))
            assert rout is not None, "fork at replicate tail unsupported"
            self.g.attach_out(rout, Output(
                ol.id, rkind,
                tuple(sorted(live_after)) if rkind == "pass" else ()))
            out_links.append(ol.id)
        merged = self._merge_tree(out_links, depth, ctx.nest_depth)
        return self.g.new_context("rep.join", SingleHead(merged),
                                  ctx.nest_depth)


def lower(prog: ir.Program) -> DFG:
    return Lowerer(prog).lower()
