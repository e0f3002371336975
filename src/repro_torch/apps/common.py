"""Shared app scaffolding for the Table III workloads.

Apps are built on the ``repro_torch.api`` front-end: each module defines a
module-level ``@revet.program`` tracer, and its ``build()`` packages concrete
input arrays + reference outputs into an :class:`App`.  ``run_app`` is a thin
wrapper over the decorated function's cached call path, so repeated runs of
the same app at the same shapes reuse one
:class:`~repro_torch.api.CompiledProgram` (and its backend's jit cache).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..api import Execution, ProgramFn, RunReport
from ..core.compiler import CompileOptions, CompileResult
from ..core.lang import Prog


@dataclass
class App:
    """One benchmark application instance.

    ``fn`` is the app's ``@revet.program`` front-end and ``dram_init`` its
    concrete input arrays (keyed by array-parameter name); ``prog`` is the
    shape-specialized ``lang.Prog`` traced from them, kept so the Golden /
    TokenVM layers can run the app without going through the API.
    ``expected`` maps DRAM array name -> expected prefix values (reference
    implementation output). ``bytes_processed`` follows Table III's
    accounting (input + output bytes), used to normalize throughput to GB/s.
    """
    name: str
    prog: Prog
    dram_init: dict[str, np.ndarray]
    params: dict[str, int]
    expected: dict[str, np.ndarray]
    bytes_processed: int
    meta: dict = field(default_factory=dict)
    fn: ProgramFn | None = None
    statics: dict = field(default_factory=dict)


def make_app(fn: ProgramFn, *, name: str, inputs: dict[str, np.ndarray],
             params: dict[str, int], expected: dict[str, np.ndarray],
             bytes_processed: int, meta: dict | None = None,
             statics: dict | None = None) -> App:
    """Package a ``@revet.program`` + concrete arrays into an :class:`App`,
    tracing the shape-specialized program once for the non-API executors."""
    statics = dict(statics or {})
    traced = fn.trace(**inputs, **params, **statics)
    return App(name=name, prog=traced.prog, dram_init=inputs, params=params,
               expected=expected, bytes_processed=bytes_processed,
               meta=meta or {}, fn=fn, statics=statics)


def check_app(app: App, got: dict) -> None:
    """Assert a run's DRAM state matches the app's reference output."""
    for name, want in app.expected.items():
        got_arr = np.asarray(got[name])[: len(want)]
        np.testing.assert_array_equal(
            got_arr, want, err_msg=f"{app.name}: dram '{name}' mismatch")


@dataclass
class AppRun:
    """Result of :func:`run_app`.  Iterates as the historical
    ``(compile_result, vm, dram_out)`` triple; the structured
    :class:`~repro_torch.api.RunReport` (wall time, stats, cycles) replaces the
    old ``vm.run_wall_s`` attribute injection."""
    result: CompileResult
    vm: object
    dram: dict[str, np.ndarray]
    report: RunReport
    execution: Execution

    def __iter__(self):
        return iter((self.result, self.vm, self.dram))


def run_app(app: App, opts: CompileOptions | None = None,
            backend=None, check: bool = True, **vm_kw) -> AppRun:
    """Execute one app through the ``repro_torch.api`` cached call path.

    The executor backend comes from ``backend`` when given, else from
    ``opts.backend`` (the default, ``"torch"``, routes the hot loops through
    the CUDA kernel layer on the card — see core/backend.py).  Compilation is
    cached per (shapes, options, backend) on ``app.fn``; the report's
    ``cache_hit`` records whether this call compiled.
    """
    assert app.fn is not None, f"{app.name}: app has no @revet.program fn"
    ex = app.fn.run(**app.dram_init, **app.params, **app.statics,
                    options=opts, backend=backend,
                    vm_kwargs=vm_kw or None)
    if check:
        check_app(app, ex.dram)
    return AppRun(ex.result, ex.vm, ex.dram, ex.report, ex)


def pack_strings(strings: list[bytes]) -> tuple[np.ndarray, np.ndarray]:
    """NUL-terminate and concatenate; returns (blob u8, offsets)."""
    blob, offs = bytearray(), []
    for s in strings:
        offs.append(len(blob))
        blob += s + b"\0"
    return np.frombuffer(bytes(blob), np.uint8).copy(), np.array(offs)


def rotl32(x: int, r: int) -> int:
    x &= 0xFFFFFFFF
    return ((x << r) | (x >> (32 - r))) & 0xFFFFFFFF


def murmur3_32(words: list[int], seed: int = 0) -> int:
    """Reference murmur3_x86_32 over whole 32-bit words (no tail)."""
    c1, c2 = 0xCC9E2D51, 0x1B873593
    h = seed & 0xFFFFFFFF
    for w in words:
        k = (w & 0xFFFFFFFF) * c1 & 0xFFFFFFFF
        k = rotl32(k, 15)
        k = k * c2 & 0xFFFFFFFF
        h ^= k
        h = rotl32(h, 13)
        h = (h * 5 + 0xE6546B64) & 0xFFFFFFFF
    h ^= (len(words) * 4) & 0xFFFFFFFF
    h ^= h >> 16
    h = h * 0x85EBCA6B & 0xFFFFFFFF
    h ^= h >> 13
    h = h * 0xC2B2AE35 & 0xFFFFFFFF
    h ^= h >> 16
    return h


def to_i32(v: int) -> int:
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= (1 << 31) else v
