"""Dataflow-program serving — compiled Revet programs behind a request queue.

``engine.py`` serves LLM token streams; this module serves *dataflow
programs*: each request is one ``main()`` invocation of a compiled program
(its own parameter tuple + DRAM image), and the engine drains the queue
through a VectorVM whose lane-level hot loops run on a pluggable executor
backend (core/backend.py, DESIGN.md §3).

The engine takes a :class:`repro_torch.api.CompiledProgram` — the unit the
front-end's compile cache hands out — so a serving deployment compiles once
per program *shape*, not once per engine: many engines (or engine restarts)
share one DFG and one backend instance, and because backends are stateless
one Pallas jit cache serves every queue.  Only the VM (queues, DRAM, pools)
is per-request state.  Passing a raw ``lang.Prog`` still works as a shim and
compiles on the spot, exactly as before the ``repro_torch.api`` redesign.

``step()`` serves one request per VectorVM launch; ``step_batch(max_batch=)``
fuses whatever the queue holds (arrival order, partial batches fine) into a
*single* launch whose superstep scheduler interleaves lanes from every
request — the Revet move (§III: threads are lanes) applied across requests,
and the same continuous-batching shape ``serve/engine.py`` uses for LLM
decode. Responses are bit-identical either way; batched responses carry
per-request lane-attributable stats (DESIGN.md §7).
"""
from __future__ import annotations

import collections
import time
from dataclasses import dataclass, field
from typing import Optional, Union

import numpy as np

from ..api import CompiledProgram, RunReport, run_fused
from ..core.backend import ExecutorBackend, make_backend
from ..core.compiler import CompileOptions, CompileResult, compile_program
from ..core.vector_vm import VectorVM


@dataclass
class DataflowRequest:
    rid: int
    params: dict[str, int]
    dram_init: Optional[dict[str, np.ndarray]] = None
    submit_t: Optional[float] = None    # stamped by Engine.submit (monotonic)


@dataclass
class DataflowResponse:
    rid: int
    dram: dict[str, np.ndarray]
    report: RunReport

    # historical field names, kept as views over the report
    @property
    def stats(self) -> collections.Counter:
        return self.report.stats

    @property
    def cycles(self) -> int:
        return self.report.cycles

    @property
    def wall_s(self) -> float:
        return self.report.wall_s


class DataflowEngine:
    """Drain a request queue through one compiled dataflow program.

    ``prog`` may be a :class:`repro_torch.api.CompiledProgram` (preferred — no
    compilation happens here, and the backend instance rides along) or a
    ``lang.Prog``/``ir.Program`` (legacy shim — compiled once with ``opts``).
    ``backend`` overrides the compiled/``opts`` backend when given.

    ``replicas`` sets the replication factor fused launches shard across
    (``None`` follows the compiled placement — see DESIGN.md §8; ``1``
    forces the unreplicated fused path).

    ``execution`` selects the execution mode for every launch this engine
    makes: ``"resident"`` serves each batch as one fused device launch
    (DESIGN.md §9 — backends with ``supports_resident``; replicas do not
    apply there), ``None`` follows the compiled
    ``CompileOptions.execution``.

    ``bucket_sizes`` pads each fused launch up to a small fixed set of
    ``n_requests`` sizes so a jit-compiling backend sees a *bounded* set of
    launch shapes instead of one per queue length: ``"auto"`` uses powers
    of two on a backend with a resident path (``supports_resident``, whose
    fused launch compiles per shape) and no padding otherwise (numpy and
    today's windowed ``TorchBackend`` have no compile cache to thrash); an
    explicit tuple pins the buckets; ``None`` disables padding.  Pad slots
    replay the batch's last request and their responses are dropped — the
    padding *work* is real (and lands in ``agg``), the recompiles it
    prevents cost more (the BENCH_serve hash_table jax batch=4 regression
    was exactly this).
    """

    def __init__(self, prog: Union[CompiledProgram, object],
                 opts: CompileOptions | None = None,
                 backend: str | ExecutorBackend | None = None,
                 queue_cap: int = 1 << 16,
                 replicas: int | None = None,
                 bucket_sizes: "str | tuple[int, ...] | None" = "auto",
                 execution: str | None = None):
        if isinstance(prog, CompiledProgram):
            if opts is not None:
                raise TypeError(
                    "DataflowEngine: opts= has no effect on an "
                    "already-compiled program; pass them to the front-end "
                    "compile (revet.compile(fn, ..., options=opts)) instead")
            self.compiled: Optional[CompiledProgram] = prog
            self.result: CompileResult = prog.result
            self.backend = (make_backend(backend) if backend is not None
                            else prog.backend)
        else:
            self.compiled = None
            self.result = compile_program(prog, opts)
            self.backend = make_backend(
                backend if backend is not None else self.result.options.backend)
        self.replicas = replicas
        self.execution = execution
        if bucket_sizes == "auto":
            bucket_sizes = ((1, 2, 4, 8, 16, 32, 64)
                            if self.backend.supports_resident else None)
        self.bucket_sizes = tuple(sorted(bucket_sizes)) if bucket_sizes \
            else None
        self.queue_cap = queue_cap
        self.queue: collections.deque[DataflowRequest] = collections.deque()
        self.done: list[DataflowResponse] = []
        self.agg: collections.Counter = collections.Counter()
        # serving observability (surfaced by stats() and on each response's
        # RunReport.queue_s/queue_depth): queue-depth watermark, total time
        # requests spent queued, and launches by (padded) launch size
        self.queue_depth_peak = 0
        self.queue_s_total = 0.0
        self.launch_counts: collections.Counter = collections.Counter()
        self.warmup_launches = 0

    def _effective_replicas(self) -> int | None:
        if self.replicas is not None:
            return self.replicas
        if self.compiled is not None:
            return None          # execute_batch follows the placement
        placement = getattr(self.result, "placement", None)
        return placement.replicas if placement is not None else 1

    def _bucket(self, n: int) -> int:
        """Launch size for an ``n``-request batch: the smallest configured
        bucket >= n (n itself beyond the largest bucket)."""
        if self.bucket_sizes:
            for b in self.bucket_sizes:
                if b >= n:
                    return b
        return n

    def _launch(self, reqs: list[tuple], replicas: int | None):
        """The one fused-launch path (compiled or raw-``Prog`` shim) —
        shared by :meth:`step_batch` and :meth:`warmup` so warmup always
        pre-compiles exactly the code path serving will take."""
        if self.compiled is not None:
            return self.compiled.execute_batch(
                reqs, require_inputs=False, backend=self.backend,
                replicas=replicas, execution=self.execution,
                queue_cap=self.queue_cap)
        return run_fused(self.result, self.backend, reqs,
                         replicas=replicas or 1, queue_cap=self.queue_cap,
                         execution=self.execution or "windowed")

    def submit(self, req: DataflowRequest) -> None:
        if req.submit_t is None:
            req.submit_t = time.monotonic()
        self.queue.append(req)
        self.queue_depth_peak = max(self.queue_depth_peak, len(self.queue))

    def _note_dequeued(self, reqs: "list[DataflowRequest]") -> float:
        """Account time-in-queue for requests just popped for a launch;
        returns the mean queue_s of the group (stamped on their reports)."""
        now = time.monotonic()
        waits = [now - r.submit_t for r in reqs if r.submit_t is not None]
        self.queue_s_total += sum(waits)
        return sum(waits) / len(waits) if waits else 0.0

    def step(self) -> Optional[DataflowResponse]:
        """Serve one queued request (one full program run)."""
        if not self.queue:
            return None
        req = self.queue.popleft()
        queue_s = self._note_dequeued([req])
        depth = len(self.queue)
        if self.compiled is not None:
            ex = self.compiled.execute(
                dict(req.dram_init or {}), req.params,
                require_inputs=False, backend=self.backend,
                execution=self.execution, queue_cap=self.queue_cap)
            dram, report = ex.dram, ex.report
        else:
            vm = VectorVM(self.result.dfg, req.dram_init,
                          queue_cap=self.queue_cap, backend=self.backend)
            t0 = time.perf_counter()
            dram = vm.run(**req.params)
            report = RunReport.from_vm(vm, "vector",
                                       time.perf_counter() - t0)
        report.queue_s = queue_s
        report.queue_depth = depth
        self.launch_counts[1] += 1
        resp = DataflowResponse(req.rid, dram, report)
        self.agg.update(report.stats)
        self.done.append(resp)
        return resp

    def step_batch(self, max_batch: int = 8) -> list[DataflowResponse]:
        """Serve up to ``max_batch`` queued requests in **one** fused
        VectorVM launch (continuous admission: whatever the queue holds, in
        arrival order — partial batches included; an empty queue serves
        nothing). Each response carries its de-interleaved DRAM slice and a
        per-request :class:`~repro_torch.api.RunReport`; the DRAM contents are
        bit-identical to serving the same requests through :meth:`step`."""
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        batch = [self.queue.popleft()
                 for _ in range(min(max_batch, len(self.queue)))]
        if not batch:
            return []
        now = time.monotonic()
        waits = [now - r.submit_t if r.submit_t is not None else None
                 for r in batch]
        self.queue_s_total += sum(w for w in waits if w is not None)
        depth = len(self.queue)
        reqs = [(dict(r.dram_init or {}), r.params) for r in batch]
        # bucket padding: replay the last request into the pad slots so the
        # backend sees one of a bounded set of launch shapes; pad responses
        # are dropped below
        n_real = len(reqs)
        reqs = reqs + [reqs[-1]] * (self._bucket(n_real) - n_real)
        out = self._launch(reqs, self._effective_replicas())
        if self.compiled is not None:
            bx = out
            responses = [DataflowResponse(req.rid, ex.dram, ex.report)
                         for req, ex in zip(batch, bx)]
            launch_stats = bx.report.stats
        else:
            # raw-Prog shim: same fused launch, one layer lower
            vm, wall = out
            responses = [
                DataflowResponse(req.rid, vm.request_dram(rid),
                                 RunReport.for_request(vm, rid, wall))
                for rid, req in enumerate(batch)]
            launch_stats = vm.stats
        for resp, wait in zip(responses, waits):
            resp.report.queue_s = wait
            resp.report.queue_depth = depth
        self.launch_counts[len(reqs)] += 1
        # aggregate the *launch* stats once — on a padded launch this
        # includes the pad slots' replayed work, so agg records work done,
        # not just work returned (it exceeds the sum over the responses)
        self.agg.update(launch_stats)
        self.done.extend(responses)
        return responses

    def warmup(self, request: DataflowRequest | None = None,
               buckets: "tuple[int, ...] | None" = None) -> list[int]:
        """Pre-compile every launch shape a serving deployment will see.

        Replays ``request`` (or the queue's head, without consuming it) at
        each configured bucket size — after this, steady-state
        ``step_batch`` launches hit only warm jit caches regardless of
        queue length.  Responses are discarded and nothing lands in
        ``done``/``agg``.  Returns the bucket sizes warmed (empty when no
        buckets are configured and ``buckets`` is not given)."""
        if request is None:
            if not self.queue:
                raise ValueError("warmup: no request given and queue empty")
            request = self.queue[0]
        sizes = tuple(buckets) if buckets is not None \
            else (self.bucket_sizes or ())
        replicas = self._effective_replicas()
        for b in sizes:
            self._launch([(dict(request.dram_init or {}),
                           request.params)] * b, replicas)
        self.warmup_launches += len(sizes)
        return list(sizes)

    def drain(self, max_batch: int = 8) -> list[DataflowResponse]:
        """Serve until the queue is empty, in fused batches of up to
        ``max_batch`` (the same default as :meth:`step_batch`, so draining
        does not silently serialize requests; pass ``max_batch=1`` for the
        sequential one-launch-per-request path)."""
        while self.queue:
            if max_batch > 1:
                self.step_batch(max_batch)
            else:
                self.step()
        return self.done

    def stats(self) -> dict:
        served = len(self.done)
        return {"served": served,
                "backend": self.backend.name,
                "total_wall_s": sum(r.wall_s for r in self.done),
                "queue_depth": len(self.queue),
                "queue_depth_peak": self.queue_depth_peak,
                "time_in_queue_s": self.queue_s_total,
                "time_in_queue_mean_s": (self.queue_s_total / served
                                         if served else 0.0),
                "launches": sum(self.launch_counts.values()),
                "launches_by_bucket": dict(sorted(
                    self.launch_counts.items())),
                "warmup_launches": self.warmup_launches,
                **{f"agg_{k}": v for k, v in self.agg.items()
                   if isinstance(k, str)}}
