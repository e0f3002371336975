"""``import revet`` — the user-facing namespace for the Revet front-end.

Re-exports :mod:`repro_torch.api` (the ``@revet.program`` decorator, AOT
``trace``/``lower``/``compile`` stages, compile-cache management, and the
pass-pipeline surface: ``revet.register_pass`` slots user passes into the
same registry the builtin pipeline runs from) plus the handful of
language/compiler names a program author needs.
"""
from repro_torch.api import (ArraySpec, BatchExecution, CacheInfo, CompiledProgram,
                       Execution, Lowered, PassManager, PipelineReport,
                       ProgramFn, RunReport, ShardSpec, Traced,
                       VerificationError, available_passes, cache_info,
                       clear_cache, compile, fuse_dram_images, lower,
                       program, register_pass, run_fused, spec, trace,
                       verify_program)
from repro_torch.core.compiler import DEFAULT_PIPELINE, CompileOptions
from repro_torch.core.lang import Block, E, Prog, c, select
from repro_torch.core.machine import MachineParams
from repro_torch.core.place import Placement, PlacementError, Section, place_graph
from repro_torch.core.vector_vm import ReplicatedVectorVM

__all__ = [
    "ArraySpec", "BatchExecution", "Block", "CacheInfo", "CompileOptions",
    "CompiledProgram", "DEFAULT_PIPELINE", "E", "Execution", "Lowered",
    "MachineParams", "PassManager", "PipelineReport", "Placement",
    "PlacementError", "Prog", "ProgramFn", "ReplicatedVectorVM",
    "RunReport", "Section", "ShardSpec", "Traced", "VerificationError",
    "available_passes", "c", "cache_info", "clear_cache", "compile",
    "fuse_dram_images", "lower", "place_graph", "program", "register_pass",
    "run_fused", "select", "spec", "trace", "verify_program",
]
