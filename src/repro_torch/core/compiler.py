"""Compiler driver — the full Revet pipeline of Fig. 8.

    language (lang.Prog)
      -> structured IR (ir.Program)
      -> PassManager pipeline (core/pipeline.py; default spec below)
      -> CFG->dataflow lowering (lowering.py)
      -> link analysis / machine mapping (machine.py)

The mid-section is driven by the pass-manager API: passes are registry
entries executed from a textual pipeline spec.  ``CompileOptions`` is sugar
over that spec — the Fig. 12 ablations flip the booleans, which merely
drop the corresponding pass name from the synthesized pipeline — and
``pipeline=`` overrides the spec wholesale (including user passes registered
via ``revet.register_pass``):

    DEFAULT_PIPELINE == CompileOptions().pipeline_spec()
      == "lower-memory-sugar,insert-frees,eliminate-hierarchy,if-to-select,"
         "fuse-allocations,hoist-allocators,infer-widths"

``verify_each=True`` runs the structural verifier (core/verifier.py) on the
IR after every pass and on the lowered DFG; every compile carries a
:class:`~repro_torch.core.pipeline.PipelineReport` (per-pass wall time + node
deltas) on ``CompileResult.report``.
"""
from __future__ import annotations

import dataclasses

from . import ir, lowering
from .dfg import DFG
from .pipeline import (PassManager, PipelineReport, initial_invariants,
                       normalize_spec)
from .verifier import verify_dfg, verify_program

DEFAULT_PIPELINE = ("lower-memory-sugar,insert-frees,eliminate-hierarchy,"
                    "if-to-select,fuse-allocations,hoist-allocators,"
                    "infer-widths")


@dataclasses.dataclass
class CompileOptions:
    if_to_select: bool = True        # §V-B(c)
    fuse_allocations: bool = True    # §V-B(a)
    hoist_allocators: bool = True    # §V-B(b) (+ bufferization)
    subword_packing: bool = True     # §V-B(d) — affects machine accounting
    eliminate_hierarchy: bool = True # §V-A(b) — honors pragma annotations
    backend: str = "torch"           # VectorVM executor backend (core/backend);
                                     # the port defaults to the card, "numpy"
                                     # is the host oracle
    execution: str = "windowed"      # "windowed" (per-window superstep) |
                                     # "resident" (one fused device launch,
                                     # DESIGN.md §9; jax backends only)
    pipeline: str | None = None      # explicit pipeline spec (overrides the
                                     # booleans; see pipeline_spec())
    verify_each: bool = False        # structural verifier after every pass
    place: bool = False              # run the placement stage (core/place.py)
    machine: "object | None" = None  # MachineParams for placement (default
                                     # Table II values when None)
    place_target: float = 0.7        # §VI-B(a) utilization target

    def pipeline_spec(self) -> str:
        """The pipeline this option set denotes — an explicit ``pipeline``
        verbatim (normalized), else the spec the booleans synthesize.  This
        string is what the front-end compile cache keys on."""
        if self.pipeline is not None:
            return normalize_spec(self.pipeline)
        names = ["lower-memory-sugar", "insert-frees"]
        if self.eliminate_hierarchy:
            names.append("eliminate-hierarchy")
        if self.if_to_select:
            names.append("if-to-select")
        if self.fuse_allocations:
            names.append("fuse-allocations")
        if self.hoist_allocators:
            names.append("hoist-allocators")
        if self.subword_packing:
            names.append("infer-widths")
        if self.place:
            names.append("place")
        return ",".join(names)

    def wants_place(self) -> bool:
        """Whether this compile runs the placement stage — true when the
        synthesized or explicit pipeline contains the ``place`` marker."""
        return "place" in self.pipeline_spec().split(",")

    def machine_params(self):
        """The MachineParams placement maps onto (Table II when unset)."""
        from .machine import MachineParams
        return self.machine if self.machine is not None else MachineParams()

    def placement_token(self) -> tuple | None:
        """Compile-cache key contribution of the placement stage: ``None``
        when placement is off; otherwise the machine identity + target —
        same parameters hit, different parameters miss."""
        if not self.wants_place():
            return None
        return ("place", self.machine_params().token(), self.place_target)

    def pass_manager(self, **pm_kwargs) -> PassManager:
        pm_kwargs.setdefault("verify_each", self.verify_each)
        return PassManager(self.pipeline_spec(), **pm_kwargs)


@dataclasses.dataclass
class CompileResult:
    dfg: DFG
    prog: ir.Program                 # post-pass IR (golden-executable)
    widths: dict[str, int]
    options: CompileOptions
    report: PipelineReport | None = None    # per-pass instrumentation
    placement: "object | None" = None       # core/place.py Placement, when
                                            # the pipeline ran the stage

    def as_text(self) -> str:
        """Round-trip-stable textual form of the post-pass IR."""
        return self.prog.as_text()

    def verify(self) -> "CompileResult":
        """Verify this (possibly cached) compile after the fact: structural
        checks on the post-pass IR plus the DFG-level link/register checks.
        Used by the front-end when ``verify_each=True`` hits a compile-cache
        entry that was built without verification."""
        verify_program(self.prog, initial_invariants(self.prog),
                       stage="cached-compile")
        verify_dfg(self.dfg)
        if self.report is not None:
            self.report.verified = True
        return self


def run_passes(prog: ir.Program, opts: CompileOptions | None = None,
               pm: PassManager | None = None,
               ) -> tuple[ir.Program, dict[str, int]]:
    """Run the optimization pipeline; returns (post-pass IR, widths).

    Kept as the historical two-tuple entry point; pipeline-aware callers use
    ``opts.pass_manager().run(prog)`` or :func:`compile_program` (whose
    result carries the full :class:`PipelineReport`)."""
    opts = opts or CompileOptions()
    pm = pm or opts.pass_manager()
    out, report = pm.run(prog)
    return out, report.widths


def compile_program(prog, opts: CompileOptions | None = None, *,
                    print_ir_after=False) -> CompileResult:
    """Accepts a ``lang.Prog`` or an ``ir.Program``."""
    opts = opts or CompileOptions()
    base = prog.ir if hasattr(prog, "ir") else prog
    pm = opts.pass_manager(print_ir_after=print_ir_after)
    lowered_ir, report = pm.run(base, options=opts)
    dfg = lowering.lower(lowered_ir)
    if opts.verify_each:
        verify_dfg(dfg)
    placement = None
    if opts.wants_place():
        # the "place" registry entry is an IR marker; the stage itself runs
        # here, on the lowered DFG (see core/place.py)
        from .place import place_graph
        placement = place_graph(dfg, report.widths, opts.machine_params(),
                                target=opts.place_target)
    return CompileResult(dfg, lowered_ir, report.widths, opts, report,
                         placement)
