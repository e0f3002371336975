"""Revet structured IR — the compiler's source-of-truth program representation.

Mirrors the paper's front-end pipeline (§V, Fig. 8): the language parses into a
structured (SCF-like) IR carrying Revet-specific constructs — ``foreach``,
``replicate``, ``fork``, iterators and views (Table I) — which the passes in
``passes.py`` progressively lower until only SRAM scalar accesses and
structured control flow remain; ``lowering.py`` then maps it to dataflow.

Semantics notes:
* All thread-live values are 32-bit integers (the machine's lanes are 32-bit;
  sub-word types exist for the packing pass as ``width`` annotations).
* Arithmetic wraps modulo 2^32. ``lshr`` is a logical shift; ``ashr``
  arithmetic; division is signed.
* Threads inside ``foreach``/``fork`` read parent variables but cannot write
  them (paper §IV-A); results return via associative reduction (``Yield``) or
  memory side effects.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional

# ---------------------------------------------------------------------------
# Expressions
# ---------------------------------------------------------------------------

BINOPS = {
    "add", "sub", "mul", "sdiv", "udiv", "smod", "umod",
    "and", "or", "xor", "shl", "lshr", "ashr",
    "eq", "ne", "slt", "sle", "sgt", "sge", "ult", "ule",
    "min", "max",
}
UNOPS = {"neg", "not"}

_U32 = (1 << 32) - 1


def wrap32(x: int) -> int:
    """Wrap to signed 32-bit two's complement."""
    x &= _U32
    return x - (1 << 32) if x >= (1 << 31) else x


def as_u32(x: int) -> int:
    return x & _U32


@dataclass(frozen=True)
class Expr:
    op: str                      # one of BINOPS/UNOPS or: const, var, select
    args: tuple = ()             # sub-exprs; for const: (value,); var: (name,)

    def __repr__(self):
        if self.op == "const":
            return str(self.args[0])
        if self.op == "var":
            return self.args[0]
        return f"({self.op} {' '.join(map(repr, self.args))})"


def const(v: int) -> Expr:
    return Expr("const", (wrap32(int(v)),))


def var(name: str) -> Expr:
    return Expr("var", (name,))


def eval_expr(e: Expr, env: dict[str, int]) -> int:
    """Scalar reference evaluation (used by the golden interpreter)."""
    op = e.op
    if op == "const":
        return e.args[0]
    if op == "var":
        return env[e.args[0]]
    if op == "select":
        c = eval_expr(e.args[0], env)
        return eval_expr(e.args[1] if c != 0 else e.args[2], env)
    if op in UNOPS:
        a = eval_expr(e.args[0], env)
        return wrap32(-a) if op == "neg" else (1 if a == 0 else 0)
    a = eval_expr(e.args[0], env)
    b = eval_expr(e.args[1], env)
    return eval_binop(op, a, b)


def eval_binop(op: str, a: int, b: int) -> int:
    if op == "add":
        return wrap32(a + b)
    if op == "sub":
        return wrap32(a - b)
    if op == "mul":
        return wrap32(a * b)
    if op == "sdiv":
        if b == 0:
            return 0
        q = abs(a) // abs(b)
        return wrap32(-q if (a < 0) != (b < 0) else q)
    if op == "udiv":
        return wrap32(as_u32(a) // as_u32(b)) if b != 0 else 0
    if op == "smod":
        if b == 0:
            return 0
        r = abs(a) % abs(b)
        return wrap32(-r if a < 0 else r)
    if op == "umod":
        return wrap32(as_u32(a) % as_u32(b)) if b != 0 else 0
    if op == "and":
        return wrap32(a & b)
    if op == "or":
        return wrap32(a | b)
    if op == "xor":
        return wrap32(a ^ b)
    if op == "shl":
        return wrap32(a << (b & 31))
    if op == "lshr":
        return wrap32(as_u32(a) >> (b & 31))
    if op == "ashr":
        return wrap32(a >> (b & 31))
    if op == "eq":
        return 1 if a == b else 0
    if op == "ne":
        return 1 if a != b else 0
    if op == "slt":
        return 1 if a < b else 0
    if op == "sle":
        return 1 if a <= b else 0
    if op == "sgt":
        return 1 if a > b else 0
    if op == "sge":
        return 1 if a >= b else 0
    if op == "ult":
        return 1 if as_u32(a) < as_u32(b) else 0
    if op == "ule":
        return 1 if as_u32(a) <= as_u32(b) else 0
    if op == "min":
        return min(a, b)
    if op == "max":
        return max(a, b)
    raise ValueError(f"unknown binop {op}")


def expr_vars(e: Expr, out: set[str] | None = None) -> set[str]:
    if out is None:
        out = set()
    if e.op == "var":
        out.add(e.args[0])
    elif e.op != "const":
        for a in e.args:
            expr_vars(a, out)
    return out


# ---------------------------------------------------------------------------
# Statements
# ---------------------------------------------------------------------------

@dataclass
class Stmt:
    pass


@dataclass
class Assign(Stmt):
    var: str
    expr: Expr
    width: int = 32        # sub-word annotation for the packing pass (8/16/32)


@dataclass
class SRAMDecl(Stmt):
    """Per-thread scratchpad buffer of ``size`` 32-bit words (Table I row 1).

    Lowered by the allocator passes to a pointer popped from the pool's
    free-list queue (§V-B(a)); ``var`` then holds the buffer pointer.
    """
    var: str
    size: int
    pool: str = "default"


@dataclass
class SRAMFree(Stmt):
    """Return a scratchpad buffer's pointer to its pool's free-list queue
    (§V-B(a)). Inserted at scope ends / exits by ``passes.insert_frees``."""
    var: str
    pool: str = "default"


@dataclass
class SRAMLoad(Stmt):
    var: str
    buf: str          # SRAMDecl var name
    idx: Expr


@dataclass
class SRAMStore(Stmt):
    buf: str
    idx: Expr
    val: Expr
    pred: Optional[Expr] = None   # predicated store (if-to-select, §V-B(c))


@dataclass
class DRAMLoad(Stmt):
    """Random-access DRAM read through an address generator (AG)."""
    var: str
    arr: str
    addr: Expr


@dataclass
class DRAMStore(Stmt):
    arr: str
    addr: Expr
    val: Expr
    pred: Optional[Expr] = None   # predicated store (if-to-select, §V-B(c))


@dataclass
class AtomicAdd(Stmt):
    """Atomic fetch-and-add on a DRAM cell; ``var`` receives the old value.

    Used by foreach->fork hierarchy elimination (§V-A(b)) for completion
    counting.
    """
    var: str
    arr: str
    addr: Expr
    delta: Expr


@dataclass
class If(Stmt):
    cond: Expr
    then: list[Stmt]
    els: list[Stmt] = field(default_factory=list)


@dataclass
class While(Stmt):
    """``while``: header stmts run before each cond evaluation (they form the
    loop-header context in dataflow — deref/refill logic lives there)."""
    header: list[Stmt]
    cond: Expr
    body: list[Stmt]


@dataclass
class Foreach(Stmt):
    """Explicitly-parallel loop; children are threads (§IV-A).

    ``reduce_op``/``reduce_init``/``reduce_var``: associative reduction of the
    values passed to ``Yield`` inside the body. ``eliminate_hierarchy``
    corresponds to ``pragma(eliminate_hierarchy)`` (Fig. 7/9).
    """
    ivar: str
    lo: Expr
    hi: Expr
    step: Expr
    body: list[Stmt]
    reduce_op: Optional[str] = None        # add/min/max/and/or/...
    reduce_init: int = 0
    reduce_var: Optional[str] = None       # parent var receiving the result
    eliminate_hierarchy: bool = False


@dataclass
class Yield(Stmt):
    """Accumulate ``expr`` into the enclosing foreach's reduction."""
    expr: Expr


@dataclass
class Fork(Stmt):
    """Dynamic thread spawn at the *same* hierarchy level (§IV-A)."""
    ivar: str
    count: Expr
    body: list[Stmt]


@dataclass
class Exit(Stmt):
    """Terminate this thread without contributing further to any reduction."""


@dataclass
class Replicate(Stmt):
    """Split one vector dataflow into ``n`` scalar dataflows (§IV-A)."""
    n: int
    body: list[Stmt]
    hoisted_ptr: Optional[str] = None   # set by passes.hoist_allocators
    bufferized: tuple = ()              # values bufferized around the region


# --- Front-end sugar: views & iterators (Table I), removed by passes --------

@dataclass
class ViewDecl(Stmt):
    var: str
    arr: str
    base: Expr
    size: int
    mode: str            # read / write / modify


@dataclass
class ViewLoad(Stmt):
    var: str
    view: str
    idx: Expr


@dataclass
class ViewStore(Stmt):
    view: str
    idx: Expr
    val: Expr


@dataclass
class ReadItDecl(Stmt):
    var: str
    arr: str
    seek: Expr
    tile: int
    peek: bool = False


@dataclass
class ItDeref(Stmt):
    var: str
    it: str
    # PeekReadIt: elements ahead of the cursor (must stay < tile)
    ahead: Expr = field(default_factory=lambda: const(0))


@dataclass
class ItAdvance(Stmt):
    it: str
    amount: Expr = field(default_factory=lambda: const(1))


@dataclass
class WriteItDecl(Stmt):
    var: str
    arr: str
    seek: Expr
    tile: int
    manual: bool = False


@dataclass
class ItWrite(Stmt):
    it: str
    val: Expr
    last: Optional[Expr] = None   # ManualWriteIt: flush flag (§V-A(a))


# Expression-valued fields per statement class, in declaration order.  The
# textual printer (textio.py), the verifier, and expression-rewriting passes
# (e.g. constant folding) all traverse statements through this table, so a new
# statement class only has to be added here once.
EXPR_FIELDS: dict[type, tuple[str, ...]] = {
    Assign: ("expr",),
    SRAMDecl: (),
    SRAMFree: (),
    SRAMLoad: ("idx",),
    SRAMStore: ("idx", "val", "pred"),
    DRAMLoad: ("addr",),
    DRAMStore: ("addr", "val", "pred"),
    AtomicAdd: ("addr", "delta"),
    If: ("cond",),
    While: ("cond",),
    Foreach: ("lo", "hi", "step"),
    Yield: ("expr",),
    Fork: ("count",),
    Exit: (),
    Replicate: (),
    ViewDecl: ("base",),
    ViewLoad: ("idx",),
    ViewStore: ("idx", "val"),
    ReadItDecl: ("seek",),
    ItDeref: ("ahead",),
    ItAdvance: ("amount",),
    WriteItDecl: ("seek",),
    ItWrite: ("val", "last"),
}


def stmt_exprs(s: Stmt) -> list[Expr]:
    """All (non-None) expression operands of one statement, shallow."""
    return [e for f in EXPR_FIELDS[type(s)]
            if (e := getattr(s, f)) is not None]


def map_stmt_exprs(s: Stmt, fn) -> None:
    """Rewrite every expression operand of ``s`` in place with ``fn``."""
    for f in EXPR_FIELDS[type(s)]:
        e = getattr(s, f)
        if e is not None:
            setattr(s, f, fn(e))


def expr_size(e: Expr) -> int:
    """Number of nodes in an expression tree."""
    if e.op in ("const", "var"):
        return 1
    return 1 + sum(expr_size(a) for a in e.args)


# ---------------------------------------------------------------------------
# Program container
# ---------------------------------------------------------------------------

@dataclass
class DRAMArray:
    name: str
    size: int
    dtype: str = "i32"     # i8 / i16 / i32 — element width for byte accounting


@dataclass
class SRAMPool:
    """One logical scratchpad pool (maps to >=1 MUs, §V-B(a))."""
    name: str
    buf_words: int = 64
    n_bufs: int = 1024


@dataclass
class Function:
    name: str
    params: list[str]
    body: list[Stmt]


@dataclass
class Program:
    name: str = "main"
    dram: dict[str, DRAMArray] = field(default_factory=dict)
    pools: dict[str, SRAMPool] = field(default_factory=dict)
    main: Optional[Function] = None

    def dram_decl(self, name: str, size: int, dtype: str = "i32") -> None:
        self.dram[name] = DRAMArray(name, size, dtype)

    def pool_decl(self, name: str, buf_words: int = 64, n_bufs: int = 1024) -> None:
        self.pools[name] = SRAMPool(name, buf_words, n_bufs)

    def as_text(self) -> str:
        """Round-trip-stable textual form (see :mod:`repro_torch.core.textio`):
        ``textio.parse_program(p.as_text())`` rebuilds an equal program and
        prints back to the identical text."""
        from .textio import program_to_text
        return program_to_text(self)

    def node_count(self) -> dict[str, int]:
        """IR size metrics (statements + expression nodes) — the per-pass
        delta reported by :class:`repro_torch.core.pipeline.PipelineReport`."""
        stmts = exprs = 0
        if self.main:
            for s in walk(self.main.body):
                stmts += 1
                exprs += sum(expr_size(e) for e in stmt_exprs(s))
        return {"stmts": stmts, "exprs": exprs}


# ---------------------------------------------------------------------------
# Structural helpers used by passes
# ---------------------------------------------------------------------------

def walk(stmts: list[Stmt]):
    """Yield every statement (pre-order) in a statement list, recursively."""
    for s in stmts:
        yield s
        for child in child_blocks(s):
            yield from walk(child)


def child_blocks(s: Stmt) -> list[list[Stmt]]:
    if isinstance(s, If):
        return [s.then, s.els]
    if isinstance(s, While):
        return [s.header, s.body]
    if isinstance(s, (Foreach, Fork, Replicate)):
        return [s.body]
    return []


def map_blocks(stmts: list[Stmt], fn) -> list[Stmt]:
    """Rebuild a statement list by applying ``fn`` to every nested block
    bottom-up; ``fn(list[Stmt]) -> list[Stmt]``."""
    out = []
    for s in stmts:
        s = dataclasses.replace(s) if dataclasses.is_dataclass(s) else s
        if isinstance(s, If):
            s.then = map_blocks(s.then, fn)
            s.els = map_blocks(s.els, fn)
        elif isinstance(s, While):
            s.header = map_blocks(s.header, fn)
            s.body = map_blocks(s.body, fn)
        elif isinstance(s, (Foreach, Fork, Replicate)):
            s.body = map_blocks(s.body, fn)
        out.append(s)
    return fn(out)
