"""Textual IR — a round-trip-stable printer/parser for ``ir.Program``.

The pipeline instrumentation (``PassManager(print_ir_after=...)``,
``Lowered.as_text()``) and the golden-text CI smoke need a printed form that
is *stable*: printing is a pure function of program structure, and
``parse_program(program_to_text(p))`` rebuilds a structurally equal program
whose text prints back identically.  The format is line-oriented with
``{``/``}``-delimited blocks and fully parenthesized compound expressions:

    program strlen {
      dram input 59 i8
      pool pool16 16 1024
      main(count) {
        foreach i1 0 count 1 {
          dram_load dld2 offsets i1
          let len3 0
          while {
            deref drf4 rit5 0
          } (ne drf4 0) {
            let len3 (add len3 1)
            advance rit5 1
          }
          dram_store lengths i1 len3
        }
      }
    }

Atoms are whitespace-delimited; integers parse as constants, anything else as
a variable reference (the builder never creates variable names that look like
integers — ``(var: name)`` is the escape hatch the printer uses if one ever
appears).  Expressions are ``repr``-style s-exprs: ``(op a b)``.
"""
from __future__ import annotations

import re

from . import ir
from .ir import (Assign, AtomicAdd, DRAMLoad, DRAMStore, Exit, Expr, Foreach,
                 Fork, If, ItAdvance, ItDeref, ItWrite, ReadItDecl, Replicate,
                 SRAMDecl, SRAMFree, SRAMLoad, SRAMStore, ViewDecl, ViewLoad,
                 ViewStore, While, WriteItDecl, Yield, const, var)

_INT_RE = re.compile(r"^-?\d+$")


class IRSyntaxError(ValueError):
    pass


# ---------------------------------------------------------------------------
# Printing
# ---------------------------------------------------------------------------

def expr_to_text(e: Expr) -> str:
    if e.op == "const":
        return str(e.args[0])
    if e.op == "var":
        name = e.args[0]
        # names that could be mistaken for literals print in escaped form
        return name if not _INT_RE.match(name) else f"(var: {name})"
    return f"({e.op} {' '.join(expr_to_text(a) for a in e.args)})"


def program_to_text(p: ir.Program) -> str:
    out: list[str] = [f"program {p.name} {{"]
    for d in p.dram.values():
        out.append(f"  dram {d.name} {d.size} {d.dtype}")
    for pool in p.pools.values():
        out.append(f"  pool {pool.name} {pool.buf_words} {pool.n_bufs}")
    if p.main is not None:
        out.append(f"  main({' '.join(p.main.params)}) {{")
        _print_block(p.main.body, out, indent=2)
        out.append("  }")
    out.append("}")
    return "\n".join(out) + "\n"


def _print_block(stmts: list[ir.Stmt], out: list[str], indent: int) -> None:
    pad = "  " * indent
    for s in stmts:
        for line in _stmt_lines(s):
            out.append(pad + line if line else line)


def _stmt_lines(s: ir.Stmt) -> list[str]:
    e = expr_to_text
    if isinstance(s, Assign):
        w = f" w{s.width}" if s.width != 32 else ""
        return [f"let {s.var} {e(s.expr)}{w}"]
    if isinstance(s, SRAMDecl):
        return [f"sram {s.var} {s.size} {s.pool}"]
    if isinstance(s, SRAMFree):
        return [f"sram_free {s.var} {s.pool}"]
    if isinstance(s, SRAMLoad):
        return [f"sram_load {s.var} {s.buf} {e(s.idx)}"]
    if isinstance(s, SRAMStore):
        # predicates print as "when", not "if": a trailing "if" is ambiguous
        # with an if *statement* on the next line (found by the roundtrip
        # fuzzer in tests/test_ir_text.py)
        p = f" when {e(s.pred)}" if s.pred is not None else ""
        return [f"sram_store {s.buf} {e(s.idx)} {e(s.val)}{p}"]
    if isinstance(s, DRAMLoad):
        return [f"dram_load {s.var} {s.arr} {e(s.addr)}"]
    if isinstance(s, DRAMStore):
        p = f" when {e(s.pred)}" if s.pred is not None else ""
        return [f"dram_store {s.arr} {e(s.addr)} {e(s.val)}{p}"]
    if isinstance(s, AtomicAdd):
        return [f"atomic_add {s.var} {s.arr} {e(s.addr)} {e(s.delta)}"]
    if isinstance(s, If):
        lines = [f"if {e(s.cond)} {{"] + _nested(s.then)
        if s.els:
            lines += ["} else {"] + _nested(s.els)
        return lines + ["}"]
    if isinstance(s, While):
        return (["while {"] + _nested(s.header)
                + [f"}} {e(s.cond)} {{"] + _nested(s.body) + ["}"])
    if isinstance(s, Foreach):
        red = ""
        if s.reduce_op is not None:
            red = (f" reduce {s.reduce_op} {s.reduce_init} "
                   f"{s.reduce_var if s.reduce_var is not None else '_'}")
        eh = " elimhier" if s.eliminate_hierarchy else ""
        return ([f"foreach {s.ivar} {e(s.lo)} {e(s.hi)} {e(s.step)}{red}{eh} "
                 "{"] + _nested(s.body) + ["}"])
    if isinstance(s, Yield):
        return [f"yield {e(s.expr)}"]
    if isinstance(s, Fork):
        return [f"fork {s.ivar} {e(s.count)} {{"] \
            + _nested(s.body) + ["}"]
    if isinstance(s, Exit):
        return ["exit"]
    if isinstance(s, Replicate):
        ptr = f" ptr {s.hoisted_ptr}" if s.hoisted_ptr is not None else ""
        bz = ""
        if s.bufferized:
            bz = f" bufz {len(s.bufferized)} {' '.join(s.bufferized)}"
        return [f"replicate {s.n}{ptr}{bz} {{"] \
            + _nested(s.body) + ["}"]
    if isinstance(s, ViewDecl):
        return [f"view {s.var} {s.arr} {e(s.base)} {s.size} {s.mode}"]
    if isinstance(s, ViewLoad):
        return [f"view_load {s.var} {s.view} {e(s.idx)}"]
    if isinstance(s, ViewStore):
        return [f"view_store {s.view} {e(s.idx)} {e(s.val)}"]
    if isinstance(s, ReadItDecl):
        pk = " peek" if s.peek else ""
        return [f"read_it {s.var} {s.arr} {e(s.seek)} {s.tile}{pk}"]
    if isinstance(s, ItDeref):
        return [f"deref {s.var} {s.it} {e(s.ahead)}"]
    if isinstance(s, ItAdvance):
        return [f"advance {s.it} {e(s.amount)}"]
    if isinstance(s, WriteItDecl):
        mn = " manual" if s.manual else ""
        return [f"write_it {s.var} {s.arr} {e(s.seek)} {s.tile}{mn}"]
    if isinstance(s, ItWrite):
        last = f" last {e(s.last)}" if s.last is not None else ""
        return [f"it_write {s.it} {e(s.val)}{last}"]
    raise NotImplementedError(type(s).__name__)


def _nested(stmts: list[ir.Stmt]) -> list[str]:
    out: list[str] = []
    _print_block(stmts, out, 1)
    return out


# ---------------------------------------------------------------------------
# Parsing
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(r"[{}()]|[^\s{}()]+")


class _Tokens:
    def __init__(self, text: str):
        self.toks = _TOKEN_RE.findall(text)
        self.i = 0

    def peek(self) -> str | None:
        return self.toks[self.i] if self.i < len(self.toks) else None

    def next(self) -> str:
        t = self.peek()
        if t is None:
            raise IRSyntaxError("unexpected end of input")
        self.i += 1
        return t

    def expect(self, tok: str) -> None:
        got = self.next()
        if got != tok:
            raise IRSyntaxError(f"expected {tok!r}, got {got!r}")


def _parse_expr(ts: _Tokens) -> Expr:
    t = ts.next()
    if t == "(":
        op = ts.next()
        if op == "var:":
            name = ts.next()
            ts.expect(")")
            return var(name)
        args = []
        while ts.peek() != ")":
            args.append(_parse_expr(ts))
        ts.expect(")")
        if op == "const" and len(args) == 1 and args[0].op == "const":
            return args[0]
        return Expr(op, tuple(args))
    if _INT_RE.match(t):
        return const(int(t))
    return var(t)


def _parse_block(ts: _Tokens) -> list[ir.Stmt]:
    """Parse statements until (and consuming) the closing ``}``."""
    out: list[ir.Stmt] = []
    while True:
        t = ts.next()
        if t == "}":
            return out
        out.append(_parse_stmt(t, ts))


def _opt(ts: _Tokens, flag: str) -> bool:
    if ts.peek() == flag:
        ts.next()
        return True
    return False


def _parse_stmt(kw: str, ts: _Tokens) -> ir.Stmt:
    ex = lambda: _parse_expr(ts)
    if kw == "let":
        v, e = ts.next(), ex()
        width = 32
        nxt = ts.peek()
        if nxt is not None and re.match(r"^w\d+$", nxt):
            width = int(ts.next()[1:])
        return Assign(v, e, width)
    if kw == "sram":
        return SRAMDecl(ts.next(), int(ts.next()), ts.next())
    if kw == "sram_free":
        return SRAMFree(ts.next(), ts.next())
    if kw == "sram_load":
        return SRAMLoad(ts.next(), ts.next(), ex())
    if kw == "sram_store":
        buf, idx, val = ts.next(), ex(), ex()
        pred = ex() if _opt(ts, "when") else None
        return SRAMStore(buf, idx, val, pred)
    if kw == "dram_load":
        return DRAMLoad(ts.next(), ts.next(), ex())
    if kw == "dram_store":
        arr, addr, val = ts.next(), ex(), ex()
        pred = ex() if _opt(ts, "when") else None
        return DRAMStore(arr, addr, val, pred)
    if kw == "atomic_add":
        return AtomicAdd(ts.next(), ts.next(), ex(), ex())
    if kw == "if":
        cond = ex()
        ts.expect("{")
        then = _parse_block(ts)
        els: list[ir.Stmt] = []
        if _opt(ts, "else"):
            ts.expect("{")
            els = _parse_block(ts)
        return If(cond, then, els)
    if kw == "while":
        ts.expect("{")
        header = _parse_block(ts)
        cond = ex()
        ts.expect("{")
        return While(header, cond, _parse_block(ts))
    if kw == "foreach":
        ivar, lo, hi, step = ts.next(), ex(), ex(), ex()
        red_op, red_init, red_var = None, 0, None
        if _opt(ts, "reduce"):
            red_op, red_init = ts.next(), int(ts.next())
            red_var = ts.next()
            if red_var == "_":
                red_var = None
        eh = _opt(ts, "elimhier")
        ts.expect("{")
        return Foreach(ivar, lo, hi, step, _parse_block(ts), red_op,
                       red_init, red_var, eh)
    if kw == "yield":
        return Yield(ex())
    if kw == "fork":
        ivar, count = ts.next(), ex()
        ts.expect("{")
        return Fork(ivar, count, _parse_block(ts))
    if kw == "exit":
        return Exit()
    if kw == "replicate":
        n = int(ts.next())
        ptr = ts.next() if _opt(ts, "ptr") else None
        bz: tuple = ()
        if _opt(ts, "bufz"):
            k = int(ts.next())
            bz = tuple(ts.next() for _ in range(k))
        ts.expect("{")
        return Replicate(n, _parse_block(ts), ptr, bz)
    if kw == "view":
        return ViewDecl(ts.next(), ts.next(), ex(), int(ts.next()), ts.next())
    if kw == "view_load":
        return ViewLoad(ts.next(), ts.next(), ex())
    if kw == "view_store":
        return ViewStore(ts.next(), ex(), ex())
    if kw == "read_it":
        v, arr, seek, tile = ts.next(), ts.next(), ex(), int(ts.next())
        return ReadItDecl(v, arr, seek, tile, _opt(ts, "peek"))
    if kw == "deref":
        return ItDeref(ts.next(), ts.next(), ex())
    if kw == "advance":
        return ItAdvance(ts.next(), ex())
    if kw == "write_it":
        v, arr, seek, tile = ts.next(), ts.next(), ex(), int(ts.next())
        return WriteItDecl(v, arr, seek, tile, _opt(ts, "manual"))
    if kw == "it_write":
        it, val = ts.next(), ex()
        last = ex() if _opt(ts, "last") else None
        return ItWrite(it, val, last)
    raise IRSyntaxError(f"unknown statement {kw!r}")


def parse_program(text: str) -> ir.Program:
    """Parse :func:`program_to_text` output back into an ``ir.Program``."""
    ts = _Tokens(text)
    ts.expect("program")
    p = ir.Program(ts.next())
    ts.expect("{")
    while True:
        t = ts.next()
        if t == "}":
            break
        if t == "dram":
            p.dram_decl(ts.next(), int(ts.next()), ts.next())
        elif t == "pool":
            p.pool_decl(ts.next(), int(ts.next()), int(ts.next()))
        elif t == "main":
            ts.expect("(")
            params = []
            while ts.peek() != ")":
                params.append(ts.next())
            ts.expect(")")
            ts.expect("{")
            p.main = ir.Function("main", params, _parse_block(ts))
        else:
            raise IRSyntaxError(f"unexpected top-level token {t!r}")
    if ts.peek() is not None:
        raise IRSyntaxError(f"trailing input at token {ts.peek()!r}")
    return p
