"""``revet.api`` — the jit-style array-in/array-out front-end.

The raw toolchain (``lang.Prog`` → DRAM size declarations →
``compiler.compile_program`` → ``vector_vm.VectorVM``) is a builder, not an
API: every caller re-wires the Fig. 8 pipeline and recompiles per run.  This
module is the one idiomatic entry point, shaped like ``jax.jit``:

    import revet

    @revet.program(outputs={"lengths": "offsets"})
    def strlen(b, input, offsets, lengths, *, count):
        with b.foreach(count) as (t, i):
            off = t.let(t.dram_load(offsets, i))
            n = t.let(0, "len")
            it = t.read_it(input, off, tile=16)
            with t.while_(lambda h: h.deref(it) != 0) as w:
                w.set(n, n + 1)
                w.advance(it)
            t.dram_store(lengths, i, n)

    lengths = strlen(blob, offs, count=n)        # arrays in, arrays out

The decorated function is a *tracer*: it receives the program's main
:class:`~repro_torch.core.lang.Block` plus one string-like handle per DRAM array
(usable anywhere the builder expects an array name), and keyword-only
parameters become ``main()`` scalar parameters (runtime values) unless listed
in ``statics=`` (trace-time Python constants, baked into the program).

At call time real numpy arrays are passed positionally (or by name); DRAM
declarations — names, sizes, dtypes — are inferred from the arguments,
output arrays are declared from the ``outputs=`` spec and returned as arrays.
Each distinct (shapes, dtypes, statics, resolved output sizes,
pipeline spec, backend) signature compiles once into a
:class:`CompiledProgram` — which holds the DFG, the post-pass IR, subword
widths, and a live :class:`~repro_torch.core.backend.ExecutorBackend` instance, so
one Pallas jit cache serves every invocation — and lands in a per-function
compile cache with ``cache_info()`` / ``clear_cache()``.

AOT staging mirrors ``jax.jit(f).lower().compile()``:

    traced   = strlen.trace(spec_or_array, offs, count=n)   # lang.Prog built
    lowered  = traced.lower(CompileOptions(...))             # passes + DFG
    compiled = lowered.compile(backend="torch")              # backend bound

``CompiledProgram.run_on(executor=...)`` is the cross-checking escape hatch:
the same arrays run through the Golden language oracle, the token-level
reference executor, or the vectorized VM (see DESIGN.md §5).
"""
from __future__ import annotations

import collections
import dataclasses
import inspect
import math
import time
import weakref
from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence, Union

import numpy as np

from .core.backend import ExecutorBackend, make_backend, wrap_dram_init
from .core.compiler import CompileOptions, CompileResult, compile_program
from .core.golden import Golden
from .core.lang import Prog
from .core.pipeline import (PassManager, PipelineReport, available_passes,
                            register_pass)
from .core.token_vm import TokenVM
from .core.vector_vm import ReplicatedVectorVM, VectorVM
from .core.verifier import VerificationError, verify_program

__all__ = [
    "ArraySpec", "BatchExecution", "CacheInfo", "CompiledProgram",
    "Execution", "Lowered", "PassManager", "PipelineReport", "ProgramFn",
    "RunReport", "ShardSpec", "Traced", "VerificationError", "WaveSession",
    "available_passes", "cache_info", "clear_cache", "compile",
    "fuse_dram_images", "lower", "program", "register_pass", "run_fused",
    "spec", "trace", "verify_program",
]

# call-time keyword names claimed by the API itself (never scalar params)
_RESERVED_KWARGS = ("options", "backend", "executor", "vm_kwargs",
                    "pipeline", "execution")

_NP_DTYPE = {1: "i8", 2: "i16"}  # itemsize -> DRAM dtype ("i32" otherwise)


# ---------------------------------------------------------------------------
# Array specs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ArraySpec:
    """Abstract array value — shape + DRAM dtype — for data-free tracing
    (the analogue of ``jax.ShapeDtypeStruct``)."""
    shape: tuple[int, ...]
    dtype: str = "i32"

    @property
    def size(self) -> int:
        return int(math.prod(self.shape))


def spec(shape: Union[int, Sequence[int]], dtype: str = "i32") -> ArraySpec:
    """Build an :class:`ArraySpec` (``revet.spec(1024)``,
    ``revet.spec((8, 16), "i8")``)."""
    if isinstance(shape, (int, np.integer)):
        shape = (int(shape),)
    return ArraySpec(tuple(int(s) for s in shape), dtype)


def _abstractify(x) -> ArraySpec:
    if isinstance(x, ArraySpec):
        return x
    arr = np.asarray(x)
    if arr.dtype.kind not in "iub":
        raise TypeError(
            f"revet programs take integer arrays, got dtype {arr.dtype}")
    return ArraySpec(arr.shape, _NP_DTYPE.get(arr.dtype.itemsize, "i32"))


class _DramHandle(str):
    """Array handle passed to the traced function.  It *is* the DRAM array
    name, so it drops into every ``Block`` builder method unchanged."""
    __slots__ = ()


_BACKEND_TOKENS: dict[str, tuple] = {}   # spec string -> resolved config


def _backend_token(backend, options: CompileOptions) -> tuple:
    """Cache-key token for a backend spec.  Backends are stateless
    (DESIGN.md §3), so both instances and name specs key by resolved
    *configuration* — ``backend="torch"`` and ``backend=TorchBackend()``
    share one compile-cache entry."""
    def config(be: ExecutorBackend) -> tuple:
        return ("backend", type(be).__qualname__, be.name,
                getattr(be, "interpret", None))

    if isinstance(backend, ExecutorBackend):
        return config(backend)
    spec = backend if backend is not None else options.backend
    tok = _BACKEND_TOKENS.get(spec)
    if tok is None:
        tok = _BACKEND_TOKENS[spec] = config(make_backend(spec))
    return tok


def _bind_call(name: str, in_names: Sequence[str], args: tuple, kwargs: dict,
               *, scalar_names: Sequence[str] = (),
               static_names: Sequence[str] = (),
               defaults: dict | None = None
               ) -> tuple[dict, dict[str, int], dict[str, Any]]:
    """Split call arguments into (input arrays, scalar params, statics) —
    shared by the decorated-function and ``CompiledProgram`` entry points."""
    defaults = defaults or {}
    if len(args) > len(in_names):
        raise TypeError(f"{name}: takes {len(in_names)} input arrays "
                        f"({', '.join(in_names)}), got {len(args)} "
                        "positional arguments")
    arrays = dict(zip(in_names, args))
    scalars: dict[str, int] = {}
    statics: dict[str, Any] = {}
    for k, v in kwargs.items():
        if k in in_names:
            if k in arrays:
                raise TypeError(f"{name}: got multiple values for input "
                                f"array '{k}'")
            arrays[k] = v
        elif k in static_names:
            statics[k] = v
        elif k in scalar_names:
            scalars[k] = v
        else:
            raise TypeError(f"{name}: unexpected keyword '{k}'")
    for n in static_names:
        if n not in statics:
            if n not in defaults:
                raise TypeError(f"{name}: missing static '{n}'")
            statics[n] = defaults[n]
    for n in scalar_names:
        if n not in scalars:
            if n not in defaults:
                raise TypeError(f"{name}: missing scalar param '{n}'")
            scalars[n] = defaults[n]
    missing = set(in_names) - set(arrays)
    if missing:
        raise TypeError(f"{name}: missing input array(s) {sorted(missing)}")
    return arrays, scalars, statics


def _verify_cached(compiled: "CompiledProgram",
                   options: CompileOptions) -> None:
    """``verify_each`` is not part of the cache key (it doesn't change the
    compiled artifact), so a hit that was compiled unverified is verified
    after the fact — once; the report then remembers it."""
    if options.verify_each:
        rep = compiled.result.report
        if rep is None or not rep.verified:
            compiled.result.verify()


# ---------------------------------------------------------------------------
# Run reports
# ---------------------------------------------------------------------------

@dataclass
class RunReport:
    """Structured account of one executed program run (replaces the historic
    ``vm.run_wall_s`` attribute injection)."""
    executor: str                       # "vector" | "token" | "golden"
    backend: Optional[str]              # executor backend name (vector only)
    wall_s: float                       # the run() call only, no compile
    stats: collections.Counter
    cycles: int                         # cost-model estimate (vector only)
    lane_occupancy: float               # useful/issued lanes (vector only)
    cache_hit: Optional[bool] = None    # compile-cache outcome of this call
    rid: Optional[int] = None           # request id within a batched launch
    execution: str = "windowed"         # "windowed" | "resident" (§9)
    queue_s: Optional[float] = None     # serving: time spent queued pre-launch
    queue_depth: Optional[int] = None   # serving: queue depth at admission

    @classmethod
    def from_vm(cls, vm, executor: str, wall_s: float,
                cache_hit: bool | None = None) -> "RunReport":
        """The one report-building path for whole-launch runs — shared by
        ``CompiledProgram.execute``, ``execute_batch``'s aggregate report,
        and the serving engine's raw-``Prog`` shim, so they cannot drift."""
        is_vec = executor == "vector"
        return cls(
            executor=executor,
            backend=vm.backend.name if is_vec else None,
            wall_s=wall_s, stats=vm.stats,
            cycles=int(vm.estimated_cycles()) if is_vec else 0,
            lane_occupancy=vm.lane_occupancy() if is_vec else 1.0,
            cache_hit=cache_hit,
            execution=getattr(vm, "execution", "windowed"))

    @classmethod
    def for_request(cls, vm, rid: int, wall_s: float) -> "RunReport":
        """Per-request view of one batched VectorVM launch: lane-attributable
        stats and cost-model cycles are de-interleaved per request
        (``vm.request_stats``/``request_cycles``); ``wall_s`` is the launch
        wall amortized over the batch (lane occupancy stays launch-wide)."""
        return cls(
            executor="vector", backend=vm.backend.name,
            wall_s=wall_s / vm.n_requests,
            stats=vm.request_stats(rid),
            cycles=vm.request_cycles(rid),
            lane_occupancy=vm.lane_occupancy(),
            cache_hit=None, rid=rid,
            execution=getattr(vm, "execution", "windowed"))


@dataclass
class Execution:
    """Everything one call produced: output arrays, the full DRAM image, the
    executor instance, and the :class:`RunReport`."""
    outputs: tuple[np.ndarray, ...]
    dram: dict[str, np.ndarray]
    report: RunReport
    vm: Any                             # VectorVM | TokenVM | Golden
    compiled: "CompiledProgram"

    @property
    def result(self) -> CompileResult:
        return self.compiled.result

    def unpacked(self):
        return self.outputs[0] if len(self.outputs) == 1 else self.outputs


@dataclass
class BatchExecution:
    """One fused batched launch: per-request :class:`Execution` views (each
    with its own de-interleaved DRAM slice and attributed :class:`RunReport`)
    plus the shared VM and the aggregate launch report. Iterates / indexes
    as the per-request executions, in request order."""
    executions: tuple[Execution, ...]
    vm: Any
    report: RunReport                   # aggregate: whole-launch wall + stats

    def __iter__(self):
        return iter(self.executions)

    def __len__(self) -> int:
        return len(self.executions)

    def __getitem__(self, i: int) -> Execution:
        return self.executions[i]


class WaveSession:
    """One **open** fused launch: requests join while the wave is running.

    ``execute_batch`` fixes a wave's membership before the first superstep;
    a session keeps the source stream open instead, so an admission
    scheduler can push a new request's thread group into lanes freed by
    earlier requests — the §III-B(d) forward/backedge merge applied *across
    requests* (the in-flight batching hook the per-rid wave sessions of
    request batching were built for).  Because the bit-identity contract is
    schedule-independent (streams are FIFO, per-request DRAM slices are
    disjoint), a request admitted mid-flight produces exactly the DRAM image
    it would produce in a closed batch or solo run.

    Protocol: :meth:`admit` up to ``capacity`` requests (each gets the next
    rid, its DRAM slice initialised and its source row pushed);
    :meth:`advance` drives supersteps cooperatively between admissions
    (returns True when the wave is idle, i.e. waiting for more work);
    :meth:`finish` seals the wave with the single Ω1 barrier, runs to
    quiescence and returns a :class:`BatchExecution` over the admitted
    requests.  Sessions run the windowed executor at R=1 — mid-flight
    admission needs the host superstep loop (a resident launch fixes its
    membership at trace time)."""

    def __init__(self, compiled: "CompiledProgram", capacity: int = 8,
                 backend: str | ExecutorBackend | None = None, **vm_kwargs):
        if capacity < 1:
            raise ValueError(f"wave capacity must be >= 1, got {capacity}")
        self.compiled = compiled
        self.capacity = int(capacity)
        result = compiled.result
        pool_override = dict(vm_kwargs.pop("pool_override", None) or {})
        for pname, pool in result.dfg.pools.items():
            # same back-pressure scaling as run_fused: a full wave must not
            # starve where `capacity` sequential runs would not
            pool_override.setdefault(pname, pool.n_bufs * self.capacity)
        self.vm = VectorVM(result.dfg, None,
                           backend=(compiled.backend if backend is None
                                    else backend),
                           n_requests=self.capacity,
                           pool_override=pool_override, **vm_kwargs)
        self._admitted: list[tuple[dict, dict]] = []
        self.wall_s = 0.0       # time spent driving the wave (advance/finish)
        self.finished = False

    @property
    def admitted(self) -> int:
        return len(self._admitted)

    @property
    def slots_free(self) -> int:
        return self.capacity - len(self._admitted)

    @property
    def closed(self) -> bool:
        return self.vm.source_closed

    @property
    def ticks(self) -> int:
        return int(self.vm.stats["ticks"])

    def admit(self, arrays: dict, scalars: dict,
              require_inputs: bool = True) -> int:
        """Join one request to the (possibly already running) wave; returns
        its rid within the launch."""
        if self.finished or self.vm.source_closed:
            raise RuntimeError(f"{self.compiled.name}: admit on a "
                               "closed wave session")
        if not self.slots_free:
            raise RuntimeError(f"{self.compiled.name}: wave full "
                               f"({self.capacity} requests)")
        arrays = dict(arrays or {})
        scalars = dict(scalars or {})
        self.compiled._check_request(arrays, scalars, require_inputs)
        dfg = self.compiled.result.dfg
        unknown = set(arrays) - set(dfg.dram)
        if unknown:
            raise KeyError(f"{self.compiled.name}: unknown DRAM array(s) "
                           f"{sorted(unknown)} (declared: "
                           f"{sorted(dfg.dram)})")
        rid = len(self._admitted)
        for name, a in arrays.items():
            d = dfg.dram[name]
            w = wrap_dram_init(np.asarray(a, np.int64).ravel(), d.dtype)
            if w.size > d.size:
                raise ValueError(
                    f"{self.compiled.name}: init for '{name}' has {w.size} "
                    f"elements, DRAM array holds {d.size}")
            self.vm.dram[name][rid * d.size: rid * d.size + w.size] = w
        self.vm.admit_request(rid, {k: int(v) for k, v in scalars.items()})
        self._admitted.append((arrays, scalars))
        return rid

    def advance(self, max_ticks: int = 32) -> bool:
        """Drive up to ``max_ticks`` supersteps. True = wave is idle (all
        admitted work done for now; with the source open that means it is
        waiting for admissions, not finished)."""
        if self.finished:
            return True
        t0 = time.perf_counter()
        idle = self.vm.advance(max_ticks)
        self.wall_s += time.perf_counter() - t0
        return idle

    def close(self) -> None:
        """Seal the wave's membership (push the Ω1 barrier) without yet
        draining it; further :meth:`admit` calls raise."""
        self.vm.close_source()

    def finish(self, max_ticks: int = 1_000_000) -> BatchExecution:
        """Seal the wave and run it to quiescence; returns per-request
        executions (de-interleaved DRAM slices + attributed reports) in
        admission order."""
        if self.finished:
            raise RuntimeError(f"{self.compiled.name}: wave session "
                               "already finished")
        self.finished = True
        vm = self.vm
        if self._admitted:
            t0 = time.perf_counter()
            vm.finish_stream(max_ticks=max_ticks)
            self.wall_s += time.perf_counter() - t0
        else:
            # nothing was admitted: don't run a barrier-only wave (reduce
            # groups would emit init values into the unowned rid-0 slice)
            vm.source_closed = True
        k = max(len(self._admitted), 1)
        executions = []
        for rid in range(len(self._admitted)):
            dram = vm.request_dram(rid)
            outputs = tuple(np.asarray(dram[n]).copy()
                            for n, _sz, _dt in self.compiled.out_info)
            rep = RunReport(
                executor="vector", backend=vm.backend.name,
                wall_s=self.wall_s / k, stats=vm.request_stats(rid),
                cycles=vm.request_cycles(rid),
                lane_occupancy=vm.lane_occupancy(), rid=rid)
            executions.append(Execution(outputs, dram, rep, vm,
                                        self.compiled))
        return BatchExecution(tuple(executions), vm,
                              RunReport.from_vm(vm, "vector", self.wall_s))


def fuse_dram_images(dfg, inits: Sequence[dict]) -> dict[str, np.ndarray]:
    """Concatenate per-request DRAM init images into one fused image:
    request ``r``'s values land at base offset ``r * size`` of each array
    (the layout :meth:`~repro_torch.core.vector_vm.VectorVM.request_dram` splits
    back apart). Requests may omit arrays — their slice stays zero, exactly
    like a single-request run without that init."""
    fused: dict[str, np.ndarray] = {}
    nreq = len(inits)
    for r, init in enumerate(inits):
        unknown = set(init) - set(dfg.dram)
        if unknown:
            # the sequential path fails loudly on unknown names (KeyError at
            # VM init); a fused launch must not silently run on zero slices
            raise KeyError(
                f"request {r}: unknown DRAM array(s) {sorted(unknown)} "
                f"(declared: {sorted(dfg.dram)})")
    for name, d in dfg.dram.items():
        if not any(name in init for init in inits):
            continue
        buf = np.zeros(d.size * nreq, np.int64)
        for r, init in enumerate(inits):
            if name not in init:
                continue
            # raw values: the VM wraps the whole fused image per-dtype once
            # at init (one pass instead of one per request)
            a = np.asarray(init[name], np.int64).ravel()
            if a.size > d.size:
                raise ValueError(
                    f"request {r}: init for '{name}' has {a.size} elements, "
                    f"DRAM array holds {d.size}")
            buf[r * d.size: r * d.size + a.size] = a
        fused[name] = buf
    return fused


def _resident_program(result: CompileResult, backend, n_requests: int,
                      pool_override: dict, placement, **dp_kwargs):
    """The per-launch-shape :class:`~repro_torch.core.device_vm.DeviceProgram`
    cache: one CUDA-graph capture per ``(device, n_requests, pools, ring
    caps)`` shape for the lifetime of the ``CompileResult`` — the resident
    analogue of the windowed path's per-window kernel cache, with one entry
    per *program*.  The capture happens here (``DeviceProgram.prepare``),
    so a run's wall excludes it (``DeviceProgram.capture_s``).
    """
    cache = getattr(result, "_resident_cache", None)
    if cache is None:
        cache = result._resident_cache = {}
    # a program lives on its backend's device: the CPU's and the card's
    # share a CompileResult but not a DeviceProgram
    key = (getattr(backend, "device", backend.name), n_requests,
           tuple(sorted(pool_override.items())),
           tuple(sorted((dp_kwargs.get("queue_caps") or {}).items())),
           dp_kwargs.get("max_ticks"))
    dp = cache.get(key)
    if dp is None:
        dp = cache[key] = backend.compile_resident(
            result, placement=placement, n_requests=n_requests,
            pool_override=pool_override,
            **{k: v for k, v in dp_kwargs.items() if v is not None})
        dp.prepare()
    return dp


def run_fused(result: CompileResult, backend, requests: Sequence[tuple],
              replicas: int = 1, placement=None,
              execution: str = "windowed",
              bucket_sizes=None,
              **vm_kwargs) -> tuple[Any, float]:
    """Low-level fused launch shared by :meth:`CompiledProgram.execute_batch`
    and the serving engine's raw-``Prog`` shim: build the fused image, scale
    SRAM pools by the batch size (allocation back-pressure stays per-launch,
    so a batch must not starve where B sequential runs would not), run one
    batched VectorVM. Returns ``(vm, launch_wall_seconds)``.

    ``replicas >= 2`` executes through the placed/replicated VM
    (:class:`~repro_torch.core.vector_vm.ReplicatedVectorVM`): requests shard
    across R graph replicas, each contributing one ``VLEN``-lane slice of
    every window — bit-identical outputs, R× issue width.

    ``execution="resident"`` runs the whole program on the device
    (DESIGN.md §9) instead of the host superstep loop: on CUDA, ticks
    captured once as a CUDA graph and replayed to quiescence.  It needs a
    resident-capable backend (``TorchBackend``) and falls back to the
    windowed path — recording the reason on ``vm.resident_fallback`` — for
    graph constructs the fused loop cannot express yet.  The resident launch
    already interleaves every request in one pipeline, so ``replicas`` does
    not apply (the placement still sizes the device rings).

    ``bucket_sizes`` (resident only, opt-in) pads the launch up to the next
    configured bucket by replaying the last request into the pad slots, so
    many batch sizes share one cached :class:`DeviceProgram` capture
    instead of capturing per exact shape — the bucketed warm-up the
    serving engine's windowed batches already have.  Pad slots do real
    (discarded) work, so the aggregate launch stats include them;
    per-request slices are unaffected.  ``"auto"`` selects
    :data:`~repro_torch.core.device_vm.RESIDENT_BUCKETS`."""
    inits = [arrays for arrays, _scalars in requests]
    params = [{k: int(v) for k, v in scalars.items()}
              for _arrays, scalars in requests]
    nreq = len(requests)
    resident_fallback = None
    resident_ok = False
    if execution not in ("windowed", "resident"):
        raise ValueError(f"unknown execution mode {execution!r} "
                         "(expected windowed|resident)")
    if execution == "resident":
        be = make_backend(backend)
        if not be.supports_resident:
            raise ValueError(
                f"execution='resident': backend {be.name!r} has no "
                "resident path (the numpy oracle stays windowed; use "
                "backend='torch')")
        from .core.device_vm import bucket_launch_size, resident_unsupported
        reasons = resident_unsupported(result.dfg)
        if not reasons:
            resident_ok = True
            if bucket_sizes:
                b = bucket_launch_size(nreq, bucket_sizes)
                if b > nreq:
                    inits = list(inits) + [inits[-1]] * (b - nreq)
                    params = list(params) + [params[-1]] * (b - nreq)
                    nreq = b
        else:
            resident_fallback = "; ".join(reasons)
    pool_override = dict(vm_kwargs.pop("pool_override", None) or {})
    for pname, pool in result.dfg.pools.items():
        pool_override.setdefault(pname, pool.n_bufs * nreq)
    fused = fuse_dram_images(result.dfg, inits)
    if resident_ok:
        vm_kwargs.pop("queue_cap", None)   # host knob; rings size
        dp = _resident_program(result, be, nreq, pool_override,
                               placement, **vm_kwargs)
        t0 = time.perf_counter()
        run = dp.run_batch(params, fused)
        return run, time.perf_counter() - t0
    if replicas and replicas > 1:
        vm = ReplicatedVectorVM(result.dfg, fused, backend=backend,
                                n_requests=nreq, n_replicas=replicas,
                                placement=placement,
                                pool_override=pool_override, **vm_kwargs)
    else:
        vm = VectorVM(result.dfg, fused, backend=backend, n_requests=nreq,
                      pool_override=pool_override, **vm_kwargs)
    vm.resident_fallback = resident_fallback
    t0 = time.perf_counter()
    vm.run_batch(params)
    return vm, time.perf_counter() - t0


@dataclass(frozen=True)
class ShardSpec:
    """How a *single large request* splits into DRAM-source element ranges
    for replicated execution (:meth:`CompiledProgram.execute_sharded`).

    ``count`` names the scalar parameter holding the outer element count;
    ``arrays`` maps each *per-element* DRAM array to its stride (elements
    per outer index — e.g. ``{"blobs": blob_words, "hashes": 1}``); arrays
    not listed are broadcast whole to every shard.  ``align`` keeps shard
    boundaries multiples of a tiling factor (e.g. strlen's ``tile``).

    The caller asserts the outer-parallel contract: iteration ``i`` touches
    only its own slice of each per-element array (plus read-only shared
    arrays) — exactly the §VI-B(a) condition under which outer parallelism
    replicates.  Every program output must be a per-element array (anything
    else cannot be reassembled from shards)."""
    count: str
    arrays: "dict[str, int] | tuple[tuple[str, int], ...]"
    align: int = 1

    def __post_init__(self):
        if isinstance(self.arrays, dict):
            object.__setattr__(self, "arrays",
                               tuple(sorted(self.arrays.items())))

    def stride(self, name: str) -> Optional[int]:
        for n, s in self.arrays:
            if n == name:
                return s
        return None


def shard_ranges(count: int, shards: int, align: int = 1
                 ) -> list[tuple[int, int]]:
    """Split ``[0, count)`` into up to ``shards`` contiguous chunks, each a
    multiple of ``align`` (except possibly the last).  Fewer chunks come
    back when ``count`` is too small to feed every shard."""
    if count <= 0:
        return [(0, count)]
    per = -(-count // shards)
    per = -(-per // align) * align if align > 1 else per
    out, lo = [], 0
    while lo < count:
        hi = min(count, lo + per)
        out.append((lo, hi))
        lo = hi
    return out


CacheInfo = collections.namedtuple("CacheInfo", "hits misses currsize")


# ---------------------------------------------------------------------------
# AOT stages
# ---------------------------------------------------------------------------

@dataclass
class Traced:
    """Stage 1: shapes bound, language traced to a ``lang.Prog``."""
    owner: "ProgramFn"
    prog: Prog
    in_specs: dict[str, ArraySpec]
    out_info: tuple[tuple[str, int, str], ...]   # (name, size, dtype)
    statics: dict[str, Any]

    def lower(self, options: CompileOptions | None = None,
              pipeline: str | None = None) -> "Lowered":
        options = self.owner._resolve_options(options, pipeline)
        return Lowered(self, options, compile_program(self.prog, options))


@dataclass
class Lowered:
    """Stage 2: optimization passes run, CFG lowered to the dataflow graph."""
    traced: Traced
    options: CompileOptions
    result: CompileResult

    def as_text(self) -> str:
        """Round-trip-stable textual form of the post-pass IR
        (``ir.Program.as_text()``) — the printed compiler mid-state."""
        return self.result.prog.as_text()

    @property
    def pipeline_report(self) -> "PipelineReport | None":
        """Per-pass wall time + IR node-count deltas of this compile."""
        return self.result.report

    def compile(self, backend: str | ExecutorBackend | None = None
                ) -> "CompiledProgram":
        """Stage 3: bind an executor backend; lands in the owner's cache so
        subsequent same-shape calls of the decorated function hit it."""
        owner = self.traced.owner
        be = backend if backend is not None else \
            (owner.backend if owner.backend is not None
             else self.options.backend)
        key = owner._make_key(self.traced.in_specs, self.traced.out_info,
                              self.traced.statics, self.options, be)
        cached = owner._cache_get(key)
        if cached is not None:
            _verify_cached(cached, self.options)
            return cached
        return owner._cache_put(key, self.result, be, self.traced.in_specs,
                                self.traced.out_info,
                                source_ir=self.traced.prog.ir)


@dataclass
class CompiledProgram:
    """A shape-specialized executable program: DFG + post-pass IR + subword
    widths (inside ``result``) and a live backend instance.  One of these per
    cache entry; construct VMs per call (VM state is per-request)."""
    name: str
    result: CompileResult
    backend: ExecutorBackend
    in_specs: dict[str, ArraySpec]
    out_info: tuple[tuple[str, int, str], ...]
    scalar_names: tuple[str, ...]
    in_names: tuple[str, ...]
    source_ir: Any = None    # pre-pass language IR (the Golden oracle input)

    @property
    def placement(self):
        """The :class:`~repro_torch.core.place.Placement` computed when the
        pipeline ran the ``place`` stage (``CompileOptions(place=True)`` /
        ``pipeline="...,place"``); ``None`` otherwise."""
        return self.result.placement

    def default_replicas(self) -> int:
        """The replication factor batched execution uses when the caller
        does not pass ``replicas=``: the placement's §VI-B(a) factor, or 1
        (the unreplicated fused path) for unplaced programs."""
        p = self.placement
        return p.replicas if p is not None else 1

    # -- execution ----------------------------------------------------------
    def _check_request(self, arrays: dict[str, np.ndarray],
                       scalars: dict[str, int],
                       require_inputs: bool = True) -> None:
        """Validate one request's arrays + scalars against the compiled
        specs (shared by ``execute`` and every row of ``execute_batch``)."""
        for n, sp in self.in_specs.items():
            if n not in arrays:
                if require_inputs:
                    raise TypeError(f"{self.name}: missing input array '{n}'")
                continue
            got = np.asarray(arrays[n])
            if got.dtype.kind not in "iub":
                raise TypeError(f"{self.name}: input '{n}' must be an "
                                f"integer array, got dtype {got.dtype}")
            if got.size != sp.size:
                raise ValueError(
                    f"{self.name}: input '{n}' has {got.size} elements, "
                    f"compiled for {sp.size} (shape-specialized — recompile "
                    f"via the decorated function)")
            if _NP_DTYPE.get(got.dtype.itemsize, "i32") != sp.dtype:
                raise ValueError(
                    f"{self.name}: input '{n}' dtype {got.dtype} does not "
                    f"match the compiled DRAM dtype {sp.dtype!r} "
                    "(shape/dtype-specialized — recompile via the decorated "
                    "function)")
        missing = set(self.scalar_names) - set(scalars)
        if missing:
            raise TypeError(f"{self.name}: missing scalar param(s) "
                            f"{sorted(missing)}")

    def execute(self, arrays: dict[str, np.ndarray], scalars: dict[str, int],
                executor: str = "vector", cache_hit: bool | None = None,
                require_inputs: bool = True,
                backend: str | ExecutorBackend | None = None,
                execution: str | None = None,
                **vm_kwargs) -> Execution:
        self._check_request(arrays, scalars, require_inputs)
        if executor != "vector" and vm_kwargs:
            raise TypeError(f"{self.name}: VM options {sorted(vm_kwargs)} "
                            f"only apply to the vector executor, not "
                            f"{executor!r}")
        mode = execution if execution is not None else \
            getattr(self.result.options, "execution", "windowed")
        dram_init = {n: np.asarray(a).ravel() for n, a in arrays.items()}
        if executor == "vector" and mode == "resident":
            # one fused device launch (DESIGN.md §9); run_fused handles the
            # windowed fallback for graphs the loop cannot express yet
            vm, wall = run_fused(
                self.result, self.backend if backend is None else backend,
                [(dram_init, scalars)], replicas=1,
                placement=self.placement, execution="resident", **vm_kwargs)
            report = RunReport.from_vm(vm, "vector", wall,
                                       cache_hit=cache_hit)
            dram = vm.request_dram(0)
            outputs = tuple(np.asarray(dram[n]).copy()
                            for n, _sz, _dt in self.out_info)
            return Execution(outputs, dram, report, vm, self)
        if executor == "vector":
            vm = VectorVM(self.result.dfg, dram_init,
                          backend=(self.backend if backend is None
                                   else backend), **vm_kwargs)
        elif executor == "token":
            vm = TokenVM(self.result.dfg, dram_init)
        elif executor == "golden":
            # the *pre-pass* language IR: an oracle independent of the
            # optimization passes, like every other Golden use in the repo
            vm = Golden(self.source_ir if self.source_ir is not None
                        else self.result.prog, dram_init)
        else:
            raise ValueError(f"unknown executor {executor!r} "
                             "(expected vector|token|golden)")
        t0 = time.perf_counter()
        dram = vm.run(**{k: int(v) for k, v in scalars.items()})
        wall = time.perf_counter() - t0
        report = RunReport.from_vm(vm, executor, wall, cache_hit=cache_hit)
        outputs = tuple(np.asarray(dram[n]).copy()
                        for n, _sz, _dt in self.out_info)
        return Execution(outputs, dram, report, vm, self)

    def execute_batch(self, requests: Sequence[tuple[dict, dict]],
                      require_inputs: bool = True,
                      backend: str | ExecutorBackend | None = None,
                      replicas: int | None = None,
                      execution: str | None = None,
                      **vm_kwargs) -> "BatchExecution":
        """Serve many requests in **one** fused VectorVM launch.

        ``requests`` is a sequence of ``(arrays, scalars)`` pairs, one per
        request (all validated against the same compiled shape; scalar
        params may diverge per request). Per-request DRAM images are
        concatenated at per-request base offsets into one fused image, one
        thread group is spawned per request (the request id rides the thread
        context), and the superstep scheduler interleaves lanes from all
        requests — then per-request DRAM slices, outputs, and
        lane-attributable stats are de-interleaved back out. Outputs are
        bit-identical to running each request through :meth:`execute`
        (DESIGN.md §7).

        ``replicas`` selects the placed/replicated execution path
        (DESIGN.md §8): ``None`` takes the compiled placement's §VI-B(a)
        factor (1 when the program was compiled without the ``place``
        stage); ``R >= 2`` shards the batch across R graph replicas, each
        contributing one ``VLEN``-lane slice of every window; ``1`` forces
        the unreplicated fused path.

        ``execution`` overrides the compiled ``CompileOptions.execution``
        mode: ``"resident"`` serves the whole batch as one fused device
        launch (DESIGN.md §9; replicas do not apply there)."""
        reqs = [(dict(a or {}), dict(s or {})) for a, s in requests]
        if not reqs:
            raise ValueError(f"{self.name}: execute_batch needs at least "
                             "one request")
        for arrays, scalars in reqs:
            self._check_request(arrays, scalars, require_inputs)
        r = self.default_replicas() if replicas is None else int(replicas)
        mode = execution if execution is not None else \
            getattr(self.result.options, "execution", "windowed")
        vm, wall = run_fused(
            self.result, self.backend if backend is None else backend,
            reqs, replicas=r, placement=self.placement, execution=mode,
            **vm_kwargs)
        executions = []
        for rid in range(len(reqs)):
            dram = vm.request_dram(rid)
            # outputs are copies (not views of dram) so in-place mutation
            # behaves exactly like the solo execute path
            outputs = tuple(np.asarray(dram[n]).copy()
                            for n, _sz, _dt in self.out_info)
            executions.append(Execution(
                outputs, dram, RunReport.for_request(vm, rid, wall),
                vm, self))
        return BatchExecution(tuple(executions), vm,
                              RunReport.from_vm(vm, "vector", wall))

    def open_session(self, capacity: int = 8,
                     backend: str | ExecutorBackend | None = None,
                     **vm_kwargs) -> "WaveSession":
        """Open an in-flight batching :class:`WaveSession`: a fused launch
        whose membership stays open, so new requests can be admitted while
        earlier ones are already executing (the async serving engine's
        substrate — see DESIGN.md §10)."""
        return WaveSession(self, capacity, backend=backend, **vm_kwargs)

    def execute_sharded(self, arrays: dict[str, np.ndarray],
                        scalars: dict[str, int], *, shard: ShardSpec,
                        replicas: int | None = None,
                        backend: str | ExecutorBackend | None = None,
                        **vm_kwargs) -> Execution:
        """Run one *large* request as R replica shards over DRAM-source
        element ranges (DESIGN.md §8).

        The outer element range ``[0, count)`` splits into R contiguous
        chunks (``shard.align``-aligned); shard ``r`` receives chunk ``r``
        of every per-element array (at offset 0 of a full-size image — the
        program is shape-specialized), the full contents of every shared
        array, and ``count = hi - lo``.  All shards run as **one**
        replicated launch (a shard is a request), and the per-element
        output slices reassemble into full arrays.  Under the ShardSpec's
        outer-parallel contract the result is bit-identical to
        :meth:`execute` on the whole request.

        The returned :class:`Execution`'s ``dram`` holds the merged
        per-element *output* arrays plus the input arrays exactly as
        passed (inputs are read-only shared state under the contract; a
        program that writes a non-output DRAM array is rejected — R shard
        copies of such an array cannot be merged back into one image)."""
        self._check_request(arrays, scalars, require_inputs=True)
        if shard.count not in scalars:
            raise TypeError(f"{self.name}: shard count parameter "
                            f"{shard.count!r} is not a scalar param")
        out_names = {n for n, _sz, _dt in self.out_info}
        unmergeable = [n for n in out_names if shard.stride(n) is None]
        if unmergeable:
            raise ValueError(
                f"{self.name}: output array(s) {sorted(unmergeable)} are "
                "not in ShardSpec.arrays — shards cannot be reassembled")
        # every *observable* DRAM array the program writes must be a
        # (per-element) output: a non-output array would end up with R
        # divergent shard copies that cannot be merged back into one
        # image, silently breaking the "bit-identical to execute()"
        # contract.  "__"-prefixed arrays are compiler-internal scratch
        # (e.g. ReadIt fetch staging) — reserved names, excluded from
        # observable state everywhere (see tests/test_dataflow.run_both)
        written = {op.space for c in self.result.dfg.contexts.values()
                   for op in c.body
                   if op.op in ("dram_store", "atomic_add")}
        unshardable = {n for n in written - out_names
                       if not n.startswith("__")}
        if unshardable:
            raise ValueError(
                f"{self.name}: program writes non-output DRAM array(s) "
                f"{sorted(unshardable)}; sharded execution cannot merge "
                "them — declare them as outputs or use execute()")
        unknown = [n for n, _s in shard.arrays
                   if n not in self.in_specs and n not in out_names]
        if unknown:
            raise KeyError(f"{self.name}: ShardSpec names unknown "
                           f"array(s) {sorted(unknown)}")
        count = int(scalars[shard.count])
        want = self.default_replicas() if replicas is None else int(replicas)
        ranges = shard_ranges(count, max(want, 1), shard.align)
        reqs = []
        for lo, hi in ranges:
            sh_arrays = {}
            for n, a in arrays.items():
                stride = shard.stride(n)
                if stride is None:
                    sh_arrays[n] = a
                else:
                    full = np.zeros(self.in_specs[n].size,
                                    np.asarray(a).dtype)
                    chunk = np.asarray(a).ravel()[lo * stride: hi * stride]
                    full[: chunk.size] = chunk
                    sh_arrays[n] = full
            reqs.append((sh_arrays, {**scalars, shard.count: hi - lo}))
        bx = self.execute_batch(reqs, backend=backend,
                                replicas=len(ranges), **vm_kwargs)
        # reassemble per-element outputs from the shards' leading slices
        merged: dict[str, np.ndarray] = {}
        for n, sz, _dt in self.out_info:
            stride = shard.stride(n)
            out = np.zeros(sz, np.int64)
            for (lo, hi), ex in zip(ranges, bx):
                chunk = np.asarray(ex.dram[n])[: (hi - lo) * stride]
                out[lo * stride: hi * stride] = chunk
            merged[n] = out
        dram = {n: np.asarray(a).ravel().copy() for n, a in arrays.items()}
        dram.update(merged)
        outputs = tuple(merged[n].copy() for n, _sz, _dt in self.out_info)
        return Execution(outputs, dram, bx.report, bx.vm, self)

    def _bind_arrays(self, args, kwargs):
        arrays, scalars, _ = _bind_call(
            self.name, self.in_names, args, kwargs,
            scalar_names=self.scalar_names)
        return arrays, scalars

    def __call__(self, *args, **kwargs):
        arrays, scalars = self._bind_arrays(args, kwargs)
        return self.execute(arrays, scalars).unpacked()

    def run_on(self, *args, executor: str = "vector", **kwargs) -> Execution:
        """Run the same arrays on a chosen executor — the Golden language
        oracle, the token-level reference VM, or the vectorized VM — for
        cross-checking (DESIGN.md §5)."""
        arrays, scalars = self._bind_arrays(args, kwargs)
        return self.execute(arrays, scalars, executor=executor)


# ---------------------------------------------------------------------------
# The decorator
# ---------------------------------------------------------------------------

_REGISTRY: "weakref.WeakSet[ProgramFn]" = weakref.WeakSet()


class ProgramFn:
    """A ``@revet.program``-decorated function: callable array-in/array-out
    with shape-specialized compile caching, plus AOT ``trace``/``lower``/
    ``compile`` stages."""

    def __init__(self, fn: Callable, *, outputs: dict,
                 statics: Sequence[str] = (), name: str | None = None,
                 pools: dict[str, dict] | None = None,
                 options: CompileOptions | None = None,
                 backend: str | ExecutorBackend | None = None,
                 pipeline: str | None = None,
                 execution: str | None = None):
        self.fn = fn
        self.name = name or fn.__name__
        self.outputs = dict(outputs)
        self.pools = dict(pools or {})
        self.options = options
        self.backend = backend
        self.pipeline = pipeline
        self.execution = execution
        self.__doc__ = fn.__doc__
        self.__name__ = self.name
        self.__wrapped__ = fn

        params = list(inspect.signature(fn).parameters.values())
        if not params:
            raise TypeError(f"{self.name}: traced function must take the "
                            "main Block as its first parameter")
        arr_kinds = (inspect.Parameter.POSITIONAL_ONLY,
                     inspect.Parameter.POSITIONAL_OR_KEYWORD)
        self.array_names = tuple(p.name for p in params[1:]
                                 if p.kind in arr_kinds)
        kwonly = [p for p in params
                  if p.kind == inspect.Parameter.KEYWORD_ONLY]
        self.static_names = tuple(statics)
        self._defaults = {p.name: p.default for p in kwonly
                          if p.default is not inspect.Parameter.empty}
        kwonly_names = {p.name for p in kwonly}
        unknown_statics = set(self.static_names) - kwonly_names
        if unknown_statics:
            raise TypeError(f"{self.name}: statics {sorted(unknown_statics)} "
                            "must be keyword-only parameters")
        self.scalar_names = tuple(p.name for p in kwonly
                                  if p.name not in self.static_names)
        bad = (set(self.scalar_names) | set(self.array_names)) \
            & set(_RESERVED_KWARGS)
        if bad:
            raise TypeError(f"{self.name}: parameter name(s) {sorted(bad)} "
                            "collide with reserved API keywords "
                            f"{_RESERVED_KWARGS}")
        unknown_outs = set(self.outputs) - set(self.array_names)
        if unknown_outs:
            raise TypeError(f"{self.name}: outputs {sorted(unknown_outs)} "
                            "are not array parameters of the function")
        self.out_names = tuple(n for n in self.array_names
                               if n in self.outputs)
        self.in_names = tuple(n for n in self.array_names
                              if n not in self.outputs)
        self._cache: dict[tuple, CompiledProgram] = {}
        self._hits = 0
        self._misses = 0
        _REGISTRY.add(self)

    def _resolve_options(self, options: CompileOptions | None = None,
                         pipeline: str | None = None) -> CompileOptions:
        """Effective compile options: per-call > per-function defaults; a
        ``pipeline=`` spec (call or decorator level) overrides the booleans'
        synthesized pass sequence."""
        opts = options or self.options or CompileOptions()
        pl = pipeline if pipeline is not None else \
            (self.pipeline if options is None or options.pipeline is None
             else None)
        if pl is not None:
            pl = pl if isinstance(pl, str) else ",".join(pl)
            opts = dataclasses.replace(opts, pipeline=pl)
        if self.execution is not None and options is None:
            opts = dataclasses.replace(opts, execution=self.execution)
        return opts

    # -- binding -------------------------------------------------------------
    def _bind(self, args: tuple, kwargs: dict
              ) -> tuple[dict, dict[str, int], dict[str, Any]]:
        """Split call arguments into (input arrays, scalar params, statics)."""
        return _bind_call(self.name, self.in_names, args, kwargs,
                          scalar_names=self.scalar_names,
                          static_names=self.static_names,
                          defaults=self._defaults)

    def _resolve_outputs(self, in_specs: dict[str, ArraySpec],
                         scalars: dict[str, int], statics: dict[str, Any]
                         ) -> tuple[tuple[str, int, str], ...]:
        """Resolve the ``outputs=`` spec to concrete (name, size, dtype).

        A spec value is ``size`` or ``(size, dtype)`` where ``size`` is an
        int, the name of an input array (same number of elements), the name
        of a scalar/static parameter (its value), or a callable receiving an
        env dict of all of those."""
        env: dict[str, Any] = {n: s.size for n, s in in_specs.items()}
        env.update(statics)
        env.update(scalars)
        out = []
        for name in self.out_names:
            sz = self.outputs[name]
            dtype = "i32"
            if isinstance(sz, tuple):
                sz, dtype = sz
            if callable(sz):
                sz = sz(env)
            elif isinstance(sz, str):
                if sz not in env:
                    raise KeyError(
                        f"{self.name}: output '{name}' sized by '{sz}', "
                        f"which is not an input array or parameter")
                sz = env[sz]
            out.append((name, int(sz), dtype))
        return tuple(out)

    def _make_key(self, in_specs, out_info, statics, options, backend):
        # the pipeline *spec* — not the CompileOptions flag tuple — keys the
        # compile: boolean sugar and an explicit pipeline= that denote the
        # same pass sequence share one entry; a custom pipeline misses.
        # when the spec contains the "place" stage, the machine parameters
        # + utilization target join the key (the Placement rides on the
        # CompiledProgram, so different machines must not share an entry)
        return (tuple((n, s.shape, s.dtype)
                      for n, s in sorted(in_specs.items())),
                out_info,
                tuple(sorted(statics.items())),
                options.pipeline_spec(),
                options.placement_token(),
                _backend_token(backend, options))

    # -- tracing -------------------------------------------------------------
    def trace(self, *args, **kwargs) -> Traced:
        """Bind shapes (arrays or :func:`revet.spec` values) and run the
        traced function once to build the ``lang.Prog``."""
        arrays, scalars, statics = self._bind(args, kwargs)
        in_specs = {n: _abstractify(a) for n, a in arrays.items()}
        out_info = self._resolve_outputs(in_specs, scalars, statics)
        return Traced(self, self._build_prog(in_specs, out_info, statics),
                      in_specs, out_info, statics)

    def _build_prog(self, in_specs: dict[str, ArraySpec],
                    out_info: tuple[tuple[str, int, str], ...],
                    statics: dict[str, Any]) -> Prog:
        p = Prog(self.name)
        out_by_name = {n: (sz, dt) for n, sz, dt in out_info}
        for n in self.array_names:
            if n in out_by_name:
                sz, dt = out_by_name[n]
                p.dram(n, sz, dt)
            else:
                s = in_specs[n]
                p.dram(n, s.size, s.dtype)
        for pool, cfg in self.pools.items():
            p.ensure_pool(pool, **cfg)
        handles = {n: _DramHandle(n) for n in self.array_names}
        with p.main(*self.scalar_names) as opened:
            if not self.scalar_names:
                block, scalar_handles = opened, ()
            else:
                block, scalar_handles = opened[0], opened[1:]
            self.fn(block, *(handles[n] for n in self.array_names),
                    **dict(zip(self.scalar_names, scalar_handles)),
                    **statics)
        return p

    # -- the cached call path -------------------------------------------------
    def _cache_get(self, key) -> Optional[CompiledProgram]:
        compiled = self._cache.get(key)
        if compiled is not None:
            self._hits += 1
        return compiled

    def _cache_put(self, key, result: CompileResult, backend,
                   in_specs: dict[str, ArraySpec],
                   out_info: tuple[tuple[str, int, str], ...],
                   source_ir=None) -> CompiledProgram:
        """The single cache-insertion path, shared by the jit-style call and
        AOT ``Lowered.compile``."""
        self._misses += 1
        compiled = CompiledProgram(
            name=self.name, result=result,
            backend=make_backend(backend if backend is not None
                                 else result.options.backend),
            in_specs=dict(in_specs), out_info=out_info,
            scalar_names=tuple(self.scalar_names),
            in_names=tuple(self.in_names),
            source_ir=source_ir)
        self._cache[key] = compiled
        return compiled

    def _get_compiled(self, in_specs, scalars, statics,
                      options: CompileOptions | None,
                      backend, pipeline: str | None = None
                      ) -> tuple[CompiledProgram, bool]:
        options = self._resolve_options(options, pipeline)
        out_info = self._resolve_outputs(in_specs, scalars, statics)
        be = backend if backend is not None else self.backend
        key = self._make_key(in_specs, out_info, statics, options, be)
        compiled = self._cache_get(key)
        if compiled is not None:
            _verify_cached(compiled, options)
            return compiled, True
        prog = self._build_prog(in_specs, out_info, statics)
        result = compile_program(prog, options)
        return self._cache_put(key, result, be, in_specs, out_info,
                               source_ir=prog.ir), False

    def run(self, *args, options: CompileOptions | None = None,
            backend: str | ExecutorBackend | None = None,
            executor: str = "vector", pipeline: str | None = None,
            execution: str | None = None,
            vm_kwargs: dict | None = None, **kwargs) -> Execution:
        """Full call path returning the :class:`Execution` (outputs + DRAM +
        VM + :class:`RunReport`); ``__call__`` is this, unpacked."""
        if executor != "vector":
            # golden/token never touch a backend or VM knobs; reject rather
            # than silently compile-and-ignore
            if backend is not None:
                raise TypeError(f"{self.name}: backend= only applies to the "
                                f"vector executor, not {executor!r}")
            if vm_kwargs:
                raise TypeError(f"{self.name}: vm_kwargs only apply to the "
                                f"vector executor, not {executor!r}")
        arrays, scalars, statics = self._bind(args, kwargs)
        in_specs = {n: _abstractify(a) for n, a in arrays.items()}
        compiled, hit = self._get_compiled(in_specs, scalars, statics,
                                           options, backend, pipeline)
        # config-keyed cache: on a hit, still honor the *caller's* backend
        # instance rather than the one bound at insertion time
        be_override = backend if isinstance(backend, ExecutorBackend) else None
        return compiled.execute(arrays, scalars, executor=executor,
                                cache_hit=hit, backend=be_override,
                                execution=execution, **(vm_kwargs or {}))

    def __call__(self, *args, **kwargs):
        return self.run(*args, **kwargs).unpacked()

    def run_on(self, *args, executor: str = "vector", **kwargs) -> Execution:
        """Cross-checking escape hatch: run through the compile cache, then
        execute on ``golden`` / ``token`` / ``vector``."""
        return self.run(*args, executor=executor, **kwargs)

    def lower(self, *args, options: CompileOptions | None = None,
              pipeline: str | None = None, **kwargs) -> Lowered:
        return self.trace(*args, **kwargs).lower(options, pipeline)

    # -- cache management ------------------------------------------------------
    def cache_info(self) -> CacheInfo:
        return CacheInfo(self._hits, self._misses, len(self._cache))

    def clear_cache(self) -> None:
        self._cache.clear()
        self._hits = 0
        self._misses = 0

    def __repr__(self) -> str:
        return (f"<revet.program {self.name}("
                f"{', '.join(self.in_names)}) -> "
                f"({', '.join(self.out_names)})>")


def program(fn: Callable | None = None, *, outputs: dict,
            statics: Sequence[str] = (), name: str | None = None,
            pools: dict[str, dict] | None = None,
            options: CompileOptions | None = None,
            backend: str | ExecutorBackend | None = None,
            pipeline: str | None = None,
            execution: str | None = None):
    """Decorate a tracer function into an array-in/array-out
    :class:`ProgramFn`.

    ``outputs`` maps output-array parameter names to size specs (see
    :meth:`ProgramFn._resolve_outputs`); ``statics`` names keyword-only
    parameters that are trace-time constants; ``pools`` pre-declares SRAM
    pools (``{"default": dict(buf_words=64, n_bufs=2048)}``); ``options``,
    ``backend``, and ``pipeline`` (a textual pass-pipeline spec, see
    DESIGN.md §6) set per-function defaults, overridable per call;
    ``execution="resident"`` makes every run of the program take the
    resident device path (DESIGN.md §9, ``TorchBackend``).
    """
    def wrap(f: Callable) -> ProgramFn:
        return ProgramFn(f, outputs=outputs, statics=statics, name=name,
                         pools=pools, options=options, backend=backend,
                         pipeline=pipeline, execution=execution)
    return wrap(fn) if fn is not None else wrap


# ---------------------------------------------------------------------------
# Functional AOT stages + module-level cache management
# ---------------------------------------------------------------------------

def _as_program_fn(fn) -> ProgramFn:
    if not isinstance(fn, ProgramFn):
        raise TypeError("expected a @revet.program-decorated function; "
                        "wrap plain tracers with revet.program(outputs=...)")
    return fn


def trace(fn: ProgramFn, *args, **kwargs) -> Traced:
    """Functional form of ``fn.trace(...)``."""
    return _as_program_fn(fn).trace(*args, **kwargs)


def lower(fn: ProgramFn, *args, options: CompileOptions | None = None,
          **kwargs) -> Lowered:
    """Functional form of ``fn.trace(...).lower(options)``."""
    return _as_program_fn(fn).lower(*args, options=options, **kwargs)


def compile(fn: ProgramFn, *args, options: CompileOptions | None = None,
            backend: str | ExecutorBackend | None = None,
            **kwargs) -> CompiledProgram:
    """Functional form of ``fn.trace(...).lower(options).compile(backend)``;
    the result lands in ``fn``'s cache, so subsequent same-shape calls hit."""
    return _as_program_fn(fn).lower(*args, options=options,
                                    **kwargs).compile(backend)


def cache_info() -> CacheInfo:
    """Aggregate compile-cache counters across every live ProgramFn."""
    hits = misses = size = 0
    for pf in list(_REGISTRY):
        ci = pf.cache_info()
        hits += ci.hits
        misses += ci.misses
        size += ci.currsize
    return CacheInfo(hits, misses, size)


def clear_cache() -> None:
    """Drop every live ProgramFn's compiled programs and reset counters."""
    for pf in list(_REGISTRY):
        pf.clear_cache()
