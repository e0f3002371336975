"""Constant folding over ``Expr`` trees — the in-tree *plugin* pass.

Not part of the default Fig. 8 pipeline: it registers itself through the
same :func:`repro_torch.core.pipeline.register_pass` decorator user plugins reach
via ``revet.register_pass``, and is enabled by naming it in a pipeline spec::

    @revet.program(pipeline=revet.CompileOptions().pipeline_spec()
                   + ",constant-fold")

Folding is semantics-preserving under the IR's 32-bit wrap rules because the
evaluator *is* :func:`repro_torch.core.ir.eval_binop` — the same function the
golden interpreter runs.  Besides const/const evaluation it applies the
algebraic identities that the sugar-lowering and fusion passes leave behind
(``x+0`` from zero view offsets and ``ahead=0`` iterator derefs, ``x*1``/
``x/1`` from unit strides, ``select`` on a known predicate), which shortens
context bodies and therefore the CU stage count ``machine.map_graph``
charges (§V-D(b)).
"""
from __future__ import annotations

from . import ir
from .ir import BINOPS, Expr, const, eval_binop, wrap32
from .pipeline import PassContext, register_pass

_COMMUTES = {"add", "mul", "and", "or", "xor", "min", "max"}


def _is_const(e: Expr, v: int | None = None) -> bool:
    return e.op == "const" and (v is None or e.args[0] == v)


def fold_expr(e: Expr, ctx: PassContext | None = None) -> Expr:
    """Bottom-up fold of one expression tree."""
    if e.op in ("const", "var"):
        return e
    args = tuple(fold_expr(a, ctx) for a in e.args)
    out = _fold_node(Expr(e.op, args))
    if out is not None:
        if ctx is not None:
            ctx.stat("folded")
        return out
    return Expr(e.op, args)


def _fold_node(e: Expr) -> Expr | None:
    a = e.args
    if e.op == "select":
        if _is_const(a[0]):
            return a[1] if a[0].args[0] != 0 else a[2]
        return None
    if e.op == "not":
        if _is_const(a[0]):
            return const(1 if a[0].args[0] == 0 else 0)
        return None
    if e.op == "neg":
        if _is_const(a[0]):
            return const(wrap32(-a[0].args[0]))
        return None
    if e.op not in BINOPS:
        return None
    x, y = a
    if _is_const(x) and _is_const(y):
        return const(eval_binop(e.op, x.args[0], y.args[0]))
    # identities (canonical side first for commutative ops)
    if e.op in _COMMUTES and _is_const(x) and not _is_const(y):
        x, y = y, x
    if e.op in ("add", "sub", "or", "xor", "shl", "lshr", "ashr") \
            and _is_const(y, 0):
        return x
    if e.op == "mul" and _is_const(y, 1):
        return x
    if e.op == "mul" and _is_const(y, 0):
        return const(0)
    if e.op == "and" and _is_const(y, 0):
        return const(0)
    if e.op in ("sdiv", "udiv") and _is_const(y, 1):
        return x
    return None


@register_pass("constant-fold")
def constant_fold(prog: ir.Program, ctx: PassContext) -> ir.Program:
    """Fold every expression operand in the program, plus statically-decided
    ``if``s (their taken branch is inlined)."""
    if not prog.main:
        return prog

    def fold_block(stmts: list[ir.Stmt]) -> list[ir.Stmt]:
        out: list[ir.Stmt] = []
        for s in stmts:
            ir.map_stmt_exprs(s, lambda e: fold_expr(e, ctx))
            for blk in ir.child_blocks(s):
                blk[:] = fold_block(blk)
            if isinstance(s, ir.If) and _is_const(s.cond):
                ctx.stat("ifs_decided")
                out.extend(s.then if s.cond.args[0] != 0 else s.els)
                continue
            out.append(s)
        return out

    prog.main.body = fold_block(prog.main.body)
    return prog
