"""The Revet language front-end — a Python-embedded builder for the IR (§IV).

Programs look close to the paper's syntax (Fig. 7):

    p = Prog("strlen")
    p.dram("input", 1 << 20, "i8")
    p.dram("offsets", 1024)
    p.dram("lengths", 1024)
    with p.main("count") as (m, count):
        with m.foreach(count, step=16) as (b, outer):
            view = b.read_view("offsets", outer, 16)
            with b.foreach(16) as (t, idx):
                off = t.let(t.view_load(view, idx)) ...

(``repro_torch.api`` / ``import revet`` wraps this builder in an array-in/array-out
front-end that infers the ``dram`` declarations from real arrays.)

Expression handles overload Python operators; comparisons produce i32
predicates (1/0). Shift-right is logical via ``>>``; use ``.ashr()`` for
arithmetic. All values are 32-bit.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Iterator, Optional, Union

from . import ir
from .ir import Expr, const, var

Num = Union[int, "E"]

__all__ = ["Block", "E", "Prog", "c", "select"]


def _expr(x: Num) -> Expr:
    if isinstance(x, E):
        return x.e
    if isinstance(x, Expr):
        return x
    return const(int(x))


class E:
    """Expression handle with operator overloading."""

    __slots__ = ("e",)
    __array_priority__ = 100

    def __init__(self, e: Expr):
        self.e = e

    def _bin(self, op: str, other: Num, rev: bool = False) -> "E":
        a, b = _expr(self), _expr(other)
        if rev:
            a, b = b, a
        return E(Expr(op, (a, b)))

    def __add__(self, o): return self._bin("add", o)
    def __radd__(self, o): return self._bin("add", o, True)
    def __sub__(self, o): return self._bin("sub", o)
    def __rsub__(self, o): return self._bin("sub", o, True)
    def __mul__(self, o): return self._bin("mul", o)
    def __rmul__(self, o): return self._bin("mul", o, True)
    def __floordiv__(self, o): return self._bin("sdiv", o)
    def __mod__(self, o): return self._bin("smod", o)
    def __and__(self, o): return self._bin("and", o)
    def __rand__(self, o): return self._bin("and", o, True)
    def __or__(self, o): return self._bin("or", o)
    def __ror__(self, o): return self._bin("or", o, True)
    def __xor__(self, o): return self._bin("xor", o)
    def __rxor__(self, o): return self._bin("xor", o, True)
    def __lshift__(self, o): return self._bin("shl", o)
    def __rshift__(self, o): return self._bin("lshr", o)   # logical (u32)
    def ashr(self, o): return self._bin("ashr", o)
    def udiv(self, o): return self._bin("udiv", o)
    def umod(self, o): return self._bin("umod", o)
    def ult(self, o): return self._bin("ult", o)
    def ule(self, o): return self._bin("ule", o)
    def min_(self, o): return self._bin("min", o)
    def max_(self, o): return self._bin("max", o)
    def __eq__(self, o): return self._bin("eq", o)          # type: ignore
    def __ne__(self, o): return self._bin("ne", o)          # type: ignore
    def __lt__(self, o): return self._bin("slt", o)
    def __le__(self, o): return self._bin("sle", o)
    def __gt__(self, o): return self._bin("sgt", o)
    def __ge__(self, o): return self._bin("sge", o)
    def __neg__(self): return E(Expr("neg", (_expr(self),)))
    def logical_not(self): return E(Expr("not", (_expr(self),)))
    def __hash__(self):
        return hash(repr(self.e))


def c(v: int) -> E:
    return E(const(v))


def select(cond: Num, a: Num, b: Num) -> E:
    return E(Expr("select", (_expr(cond), _expr(a), _expr(b))))


class _Handle:
    """Named memory-object handle (view / iterator / sram buffer)."""

    def __init__(self, name: str, kind: str, builder: "Block"):
        self.name = name
        self.kind = kind
        self._b = builder


class Block:
    """Statement-list builder. Context managers produce nested blocks."""

    def __init__(self, prog: "Prog", stmts: list[ir.Stmt]):
        self._p = prog
        self.stmts = stmts

    # -- scalars ------------------------------------------------------------
    def let(self, value: Num, name: str | None = None, width: int = 32) -> E:
        name = name or self._p.fresh("t")
        self.stmts.append(ir.Assign(name, _expr(value), width=width))
        return E(var(name))

    def set(self, target: E, value: Num) -> None:
        assert target.e.op == "var", "set() target must be a variable"
        self.stmts.append(ir.Assign(target.e.args[0], _expr(value)))

    # -- scratchpad (Table I row 1) ------------------------------------------
    def sram(self, size: int, pool: str = "default", name: str | None = None) -> _Handle:
        name = name or self._p.fresh("buf")
        self._p.ensure_pool(pool)
        self.stmts.append(ir.SRAMDecl(name, size, pool))
        return _Handle(name, "sram", self)

    def sram_load(self, buf: _Handle, idx: Num, name: str | None = None) -> E:
        name = name or self._p.fresh("ld")
        self.stmts.append(ir.SRAMLoad(name, buf.name, _expr(idx)))
        return E(var(name))

    def sram_store(self, buf: _Handle, idx: Num, val: Num) -> None:
        self.stmts.append(ir.SRAMStore(buf.name, _expr(idx), _expr(val)))

    # -- DRAM (AG random access) ----------------------------------------------
    def dram_load(self, arr: str, addr: Num, name: str | None = None) -> E:
        name = name or self._p.fresh("dld")
        self.stmts.append(ir.DRAMLoad(name, arr, _expr(addr)))
        return E(var(name))

    def dram_store(self, arr: str, addr: Num, val: Num) -> None:
        self.stmts.append(ir.DRAMStore(arr, _expr(addr), _expr(val)))

    def atomic_add(self, arr: str, addr: Num, delta: Num,
                   name: str | None = None) -> E:
        name = name or self._p.fresh("old")
        self.stmts.append(ir.AtomicAdd(name, arr, _expr(addr), _expr(delta)))
        return E(var(name))

    # -- views (Table I rows 2-4) ----------------------------------------------
    def read_view(self, arr: str, base: Num, size: int,
                  name: str | None = None) -> _Handle:
        name = name or self._p.fresh("rv")
        self.stmts.append(ir.ViewDecl(name, arr, _expr(base), size, "read"))
        return _Handle(name, "view", self)

    def write_view(self, arr: str, base: Num, size: int,
                   name: str | None = None) -> _Handle:
        name = name or self._p.fresh("wv")
        self.stmts.append(ir.ViewDecl(name, arr, _expr(base), size, "write"))
        return _Handle(name, "view", self)

    def modify_view(self, arr: str, base: Num, size: int,
                    name: str | None = None) -> _Handle:
        name = name or self._p.fresh("mv")
        self.stmts.append(ir.ViewDecl(name, arr, _expr(base), size, "modify"))
        return _Handle(name, "view", self)

    def view_load(self, view: _Handle, idx: Num, name: str | None = None) -> E:
        name = name or self._p.fresh("vl")
        self.stmts.append(ir.ViewLoad(name, view.name, _expr(idx)))
        return E(var(name))

    def view_store(self, view: _Handle, idx: Num, val: Num) -> None:
        self.stmts.append(ir.ViewStore(view.name, _expr(idx), _expr(val)))

    # -- iterators (Table I rows 5-8) -------------------------------------------
    def read_it(self, arr: str, seek: Num, tile: int = 16, peek: bool = False,
                name: str | None = None) -> _Handle:
        name = name or self._p.fresh("rit")
        self.stmts.append(ir.ReadItDecl(name, arr, _expr(seek), tile, peek))
        return _Handle(name, "readit", self)

    def deref(self, it: _Handle, ahead: Num = 0, name: str | None = None) -> E:
        name = name or self._p.fresh("drf")
        self.stmts.append(ir.ItDeref(name, it.name, _expr(ahead)))
        return E(var(name))

    def advance(self, it: _Handle, amount: Num = 1) -> None:
        self.stmts.append(ir.ItAdvance(it.name, _expr(amount)))

    def write_it(self, arr: str, seek: Num, tile: int = 16,
                 manual: bool = False, name: str | None = None) -> _Handle:
        name = name or self._p.fresh("wit")
        self.stmts.append(ir.WriteItDecl(name, arr, _expr(seek), tile, manual))
        return _Handle(name, "writeit", self)

    def it_write(self, it: _Handle, val: Num, last: Num | None = None) -> None:
        self.stmts.append(ir.ItWrite(it.name, _expr(val),
                                     None if last is None else _expr(last)))

    # -- control flow ------------------------------------------------------------
    @contextlib.contextmanager
    def if_(self, cond: Num) -> Iterator["Block"]:
        s = ir.If(_expr(cond), [], [])
        self.stmts.append(s)
        yield Block(self._p, s.then)

    @contextlib.contextmanager
    def if_else(self, cond: Num) -> Iterator[tuple["Block", "Block"]]:
        s = ir.If(_expr(cond), [], [])
        self.stmts.append(s)
        yield Block(self._p, s.then), Block(self._p, s.els)

    @contextlib.contextmanager
    def while_(self, cond: Union[Num, Callable[["Block"], Num]]) -> Iterator["Block"]:
        """``cond`` may be an expression, or a callable receiving the loop
        *header* block (for conds that need memory reads, e.g. ``*it != 0``)."""
        s = ir.While([], const(0), [])
        self.stmts.append(s)
        if callable(cond) and not isinstance(cond, E):
            header = Block(self._p, s.header)
            s.cond = _expr(cond(header))
        else:
            s.cond = _expr(cond)
        yield Block(self._p, s.body)

    @contextlib.contextmanager
    def foreach(self, hi: Num, lo: Num = 0, step: Num = 1,
                reduce: Optional[tuple[str, int]] = None,
                eliminate_hierarchy: bool = False,
                ) -> Iterator[tuple["Block", E]]:
        """Parallel loop (§IV-A). ``reduce=(op, init)`` enables reduction; the
        result var is exposed as ``.result`` on the yielded block."""
        ivar = self._p.fresh("i")
        s = ir.Foreach(ivar, _expr(lo), _expr(hi), _expr(step), [],
                       eliminate_hierarchy=eliminate_hierarchy)
        if reduce is not None:
            s.reduce_op, s.reduce_init = reduce
            s.reduce_var = self._p.fresh("red")
        self.stmts.append(s)
        b = Block(self._p, s.body)
        b.result = E(var(s.reduce_var)) if reduce else None  # type: ignore
        yield b, E(var(ivar))

    def yield_(self, value: Num) -> None:
        self.stmts.append(ir.Yield(_expr(value)))

    @contextlib.contextmanager
    def fork(self, count: Num) -> Iterator[tuple["Block", E]]:
        ivar = self._p.fresh("f")
        s = ir.Fork(ivar, _expr(count), [])
        self.stmts.append(s)
        yield Block(self._p, s.body), E(var(ivar))

    @contextlib.contextmanager
    def replicate(self, n: int) -> Iterator["Block"]:
        s = ir.Replicate(n, [])
        self.stmts.append(s)
        yield Block(self._p, s.body)

    def exit_(self) -> None:
        self.stmts.append(ir.Exit())


class Prog:
    """Top-level program builder."""

    def __init__(self, name: str = "main"):
        self.ir = ir.Program(name)
        self._ctr = 0

    def fresh(self, prefix: str) -> str:
        self._ctr += 1
        return f"{prefix}{self._ctr}"

    def dram(self, name: str, size: int, dtype: str = "i32") -> str:
        self.ir.dram_decl(name, size, dtype)
        return name

    def ensure_pool(self, name: str, buf_words: int = 64,
                    n_bufs: int = 1024) -> None:
        if name not in self.ir.pools:
            self.ir.pool_decl(name, buf_words, n_bufs)

    @contextlib.contextmanager
    def main(self, *params: str):
        fn = ir.Function("main", list(params), [])
        self.ir.main = fn
        b = Block(self, fn.body)
        handles = tuple(E(var(p)) for p in params)
        if len(handles) == 1:
            yield b, handles[0]
        elif handles:
            yield (b, *handles)
        else:
            yield b
