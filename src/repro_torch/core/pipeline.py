"""Pass-manager API — the compiler's mid-section as first-class values.

The Fig. 8 pipeline used to be a hardcoded call chain in
``compiler.run_passes`` gated by ``CompileOptions`` booleans.  This module
makes it an MLIR-style pipeline instead:

* a :class:`Pass` protocol — ``name``, ``run(prog, ctx) -> prog``, plus
  optional dependency metadata (``requires``/``establishes``/``invalidates``)
  and per-run ``stats``;
* a module-level **registry** (:func:`register_pass`) holding every builtin
  pass from :mod:`repro_torch.core.passes` and any user plugin registered through
  ``revet.register_pass`` — both slot into the same namespace;
* a :class:`PassManager` that executes a pipeline parsed from a textual spec
  (``"lower-memory-sugar,insert-frees,...,infer-widths"``) with three
  instrumentation hooks: ``print_ir_after`` (textual IR via
  ``ir.Program.as_text()``), ``verify_each`` (the structural
  :mod:`repro_torch.core.verifier`), and ``time_each`` (per-pass wall time + IR
  node-count deltas collected into a :class:`PipelineReport`).

``CompileOptions`` is rebuilt *on top of* this: its booleans synthesize a
pipeline spec (``CompileOptions.pipeline_spec()``), and the spec — not the
flag tuple — keys the front-end compile cache.
"""
from __future__ import annotations

import copy as _copy
import inspect
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Protocol, runtime_checkable

from . import ir, passes
from .verifier import _SUGAR, verify_program

__all__ = [
    "Pass", "PassContext", "PassError", "PassManager", "PassRecord",
    "PipelineError", "PipelineReport", "available_passes", "get_pass",
    "initial_invariants", "parse_pipeline", "register_pass",
    "resolve_requirements",
]

PassError = passes.PassError


class PipelineError(ValueError):
    """Bad pipeline spec: unknown pass, duplicate registration, or a pass
    whose required invariants no earlier pass establishes."""


# ---------------------------------------------------------------------------
# Pass protocol + context
# ---------------------------------------------------------------------------

@dataclass
class PassContext:
    """Mutable state threaded through one pipeline run."""
    options: Any = None                    # the driving CompileOptions, if any
    widths: dict[str, int] = field(default_factory=dict)   # infer-widths out
    established: set[str] = field(default_factory=set)     # invariants held
    stats: dict[str, int] = field(default_factory=dict)    # current pass's

    def stat(self, key: str, value: int = 1) -> None:
        """Accumulate a counter into the running pass's record."""
        self.stats[key] = self.stats.get(key, 0) + value


@runtime_checkable
class Pass(Protocol):
    """What the :class:`PassManager` executes.  ``run`` may mutate ``prog``
    in place and return it (the builtin style) or return a replacement."""
    name: str
    requires: tuple[str, ...]      # invariants that must hold on entry
    establishes: tuple[str, ...]   # invariants guaranteed after this pass
    invalidates: tuple[str, ...]   # invariants this pass destroys

    def run(self, prog: ir.Program, ctx: PassContext) -> ir.Program: ...


@dataclass(frozen=True)
class _RegisteredPass:
    name: str
    fn: Callable
    requires: tuple[str, ...] = ()
    establishes: tuple[str, ...] = ()
    invalidates: tuple[str, ...] = ()
    wants_ctx: bool = False

    def run(self, prog: ir.Program, ctx: PassContext) -> ir.Program:
        out = self.fn(prog, ctx) if self.wants_ctx else self.fn(prog)
        return prog if out is None else out


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

PASS_REGISTRY: dict[str, _RegisteredPass] = {}


def register_pass(name: str, *, requires: tuple[str, ...] = (),
                  establishes: tuple[str, ...] = (),
                  invalidates: tuple[str, ...] = (),
                  replace: bool = False) -> Callable:
    """Decorator registering a pass function under ``name``.

    The function takes ``(prog)`` or ``(prog, ctx)`` — arity is detected —
    and returns the (possibly in-place mutated) program, or ``None`` to mean
    "mutated in place".  User plugins use the same decorator via
    ``revet.register_pass`` and become addressable from any pipeline spec::

        @revet.register_pass("constant-fold")
        def constant_fold(prog, ctx):
            ...
    """
    def deco(fn: Callable) -> Callable:
        if name in PASS_REGISTRY and not replace:
            raise PipelineError(
                f"pass {name!r} is already registered "
                "(pass replace=True to override)")
        params = [p for p in inspect.signature(fn).parameters.values()
                  if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
        PASS_REGISTRY[name] = _RegisteredPass(
            name, fn, tuple(requires), tuple(establishes),
            tuple(invalidates), wants_ctx=len(params) >= 2)
        return fn
    return deco


def get_pass(name: str) -> _RegisteredPass:
    try:
        return PASS_REGISTRY[name]
    except KeyError:
        raise PipelineError(
            f"unknown pass {name!r}; registered: {available_passes()}"
        ) from None


def available_passes() -> list[str]:
    return sorted(PASS_REGISTRY)


def parse_pipeline(spec: "str | list[str] | tuple[str, ...]"
                   ) -> list[_RegisteredPass]:
    """Parse a textual spec (comma-separated pass names, whitespace ignored)
    or a name sequence into registered passes."""
    if isinstance(spec, str):
        names = [n.strip() for n in spec.split(",")]
    else:
        names = [str(n).strip() for n in spec]
    return [get_pass(n) for n in names if n]


def normalize_spec(spec: "str | list[str] | tuple[str, ...]") -> str:
    """Canonical spec string (also validates every pass name)."""
    return ",".join(p.name for p in parse_pipeline(spec))


def resolve_requirements(names: "list[str] | tuple[str, ...]") -> list[str]:
    """Prepend providers for any invariant the named passes require but no
    earlier pass establishes — ``["hoist-allocators"]`` becomes
    ``["lower-memory-sugar", "insert-frees", "hoist-allocators"]``."""
    providers = {inv: p.name for p in PASS_REGISTRY.values()
                 for inv in p.establishes}
    out: list[str] = []
    held: set[str] = set()

    def add(name: str) -> None:
        p = get_pass(name)
        for inv in p.requires:
            if inv not in held:
                if inv not in providers:
                    raise PipelineError(
                        f"pass {name!r} requires {inv!r}, which no "
                        "registered pass establishes")
                add(providers[inv])
        if name not in out:
            out.append(name)
            held.update(p.establishes)

    for n in names:
        add(n)
    return out


# ---------------------------------------------------------------------------
# Reports
# ---------------------------------------------------------------------------

@dataclass
class PassRecord:
    """One executed pass: wall time + IR node-count deltas + pass counters."""
    name: str
    wall_s: float
    stmts_before: int
    stmts_after: int
    exprs_before: int
    exprs_after: int
    stats: dict[str, int] = field(default_factory=dict)

    @property
    def stmt_delta(self) -> int:
        return self.stmts_after - self.stmts_before

    @property
    def expr_delta(self) -> int:
        return self.exprs_after - self.exprs_before


@dataclass
class PipelineReport:
    """What one :meth:`PassManager.run` did, pass by pass."""
    spec: str
    records: list[PassRecord] = field(default_factory=list)
    total_wall_s: float = 0.0
    verified: bool = False
    widths: dict[str, int] = field(default_factory=dict)
    ir_texts: list[tuple[str, str]] = field(default_factory=list)

    def as_dict(self) -> dict:
        return {
            "spec": self.spec,
            "total_wall_s": self.total_wall_s,
            "verified": self.verified,
            "passes": [{
                "name": r.name, "wall_s": r.wall_s,
                "stmts_before": r.stmts_before, "stmts_after": r.stmts_after,
                "exprs_before": r.exprs_before, "exprs_after": r.exprs_after,
                "stats": dict(r.stats),
            } for r in self.records],
        }

    def __str__(self) -> str:
        head = f"pipeline: {self.spec}"
        if not self.records:
            return head
        w = max(len(r.name) for r in self.records)
        lines = [head]
        for r in self.records:
            extra = "".join(f"  {k}={v}" for k, v in sorted(r.stats.items()))
            lines.append(
                f"  {r.name:<{w}}  {r.wall_s * 1e3:8.2f} ms  "
                f"stmts {r.stmts_before:>5} -> {r.stmts_after:<5} "
                f"exprs {r.exprs_before:>5} -> {r.exprs_after:<5}{extra}")
        lines.append(f"  {'total':<{w}}  {self.total_wall_s * 1e3:8.2f} ms"
                     + ("  (verified)" if self.verified else ""))
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# The manager
# ---------------------------------------------------------------------------

def initial_invariants(prog: ir.Program) -> set[str]:
    """Invariants already true of the *input* program, so custom pipelines
    over pre-lowered IR don't have to re-run the providing passes."""
    held = {"no-sugar", "frees-inserted"}
    decls: set[str] = set()
    freed: set[str] = set()
    if prog.main:
        for s in ir.walk(prog.main.body):
            if isinstance(s, _SUGAR):
                held.discard("no-sugar")
            elif isinstance(s, ir.SRAMDecl):
                decls.add(s.var)
            elif isinstance(s, ir.SRAMFree):
                freed.add(s.var)
    if decls - freed or ("no-sugar" not in held):
        held.discard("frees-inserted")
    return held


class PassManager:
    """Execute a pipeline over an ``ir.Program`` with instrumentation.

    Parameters
    ----------
    spec:
        Textual pipeline (``"a,b,c"``) or sequence of registered pass names.
    verify_each:
        Run :func:`repro_torch.core.verifier.verify_program` on the input and after
        every pass (raises :class:`VerificationError` on the first breach).
    time_each:
        Collect per-pass wall time and node-count deltas (cheap; on by
        default — node counts are two tree walks).
    print_ir_after:
        ``True`` to print the IR after every pass to stdout, or a callable
        ``(pass_name, text) -> None``; either way the texts are also kept on
        ``PipelineReport.ir_texts``.
    """

    def __init__(self, spec: "str | list[str] | tuple[str, ...]", *,
                 verify_each: bool = False, time_each: bool = True,
                 print_ir_after: "bool | Callable[[str, str], None]" = False):
        self.passes = parse_pipeline(spec)
        self.spec = ",".join(p.name for p in self.passes)
        self.verify_each = verify_each
        self.time_each = time_each
        self.print_ir_after = print_ir_after

    # -- execution ----------------------------------------------------------
    def run(self, prog: ir.Program, options: Any = None, *,
            copy: bool = True) -> tuple[ir.Program, PipelineReport]:
        if copy:
            prog = _copy.deepcopy(prog)
        ctx = PassContext(options=options,
                          established=initial_invariants(prog))
        report = PipelineReport(spec=self.spec)
        t_start = time.perf_counter()
        if self.verify_each:
            verify_program(prog, ctx.established, stage="input")
            report.verified = True
        for p in self.passes:
            missing = set(p.requires) - ctx.established
            if missing:
                raise PipelineError(
                    f"pass {p.name!r} requires invariant(s) "
                    f"{sorted(missing)} not established by this pipeline "
                    f"({self.spec!r}); hint: "
                    f"{','.join(resolve_requirements([p.name]))}")
            before = prog.node_count() if self.time_each else {}
            ctx.stats = {}
            t0 = time.perf_counter()
            prog = p.run(prog, ctx)
            wall = time.perf_counter() - t0
            ctx.established -= set(p.invalidates)
            ctx.established |= set(p.establishes)
            if self.time_each:
                after = prog.node_count()
                report.records.append(PassRecord(
                    p.name, wall, before["stmts"], after["stmts"],
                    before["exprs"], after["exprs"], dict(ctx.stats)))
            if self.print_ir_after:
                text = prog.as_text()
                report.ir_texts.append((p.name, text))
                if callable(self.print_ir_after):
                    self.print_ir_after(p.name, text)
                else:
                    print(f"// ----- IR after {p.name} -----")
                    print(text)
            if self.verify_each:
                verify_program(prog, ctx.established, stage=p.name)
        report.total_wall_s = time.perf_counter() - t_start
        report.widths = dict(ctx.widths)
        return prog, report


# ---------------------------------------------------------------------------
# Builtin passes — the Fig. 8 mid-section, one registry entry each
# ---------------------------------------------------------------------------

register_pass("lower-memory-sugar", establishes=("no-sugar",))(
    passes.lower_memory_sugar)
register_pass("insert-frees", requires=("no-sugar",),
              establishes=("frees-inserted",))(passes.insert_frees)
register_pass("eliminate-hierarchy",
              requires=("no-sugar", "frees-inserted"))(
    passes.eliminate_hierarchy)
register_pass("if-to-select", requires=("no-sugar",))(passes.if_to_select)
register_pass("fuse-allocations", requires=("no-sugar",))(
    passes.fuse_allocations)
register_pass("hoist-allocators", requires=("no-sugar", "frees-inserted"))(
    passes.hoist_allocators)


@register_pass("infer-widths", requires=("no-sugar",))
def _infer_widths(prog: ir.Program, ctx: PassContext) -> ir.Program:
    """Sub-word width analysis (§V-B(d)) — writes ``ctx.widths``; the IR is
    untouched.  Present in a pipeline iff ``subword_packing`` is on."""
    ctx.widths = passes.infer_widths(prog)
    ctx.stat("packed_vars", sum(1 for w in ctx.widths.values() if w < 32))
    return prog


# the in-tree plugin example: an optimization pass registered through the
# exact same decorator user code reaches via ``revet.register_pass``
from . import constfold as _constfold  # noqa: E402,F401  (registers itself)

# the placement stage's marker pass ("place") — the actual placement runs
# post-lowering in the compiler driver; see core/place.py
from . import place as _place  # noqa: E402,F401  (registers itself)
