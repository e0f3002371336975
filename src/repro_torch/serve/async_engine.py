"""Async continuous-batching serving for compiled dataflow programs.

``serve/dataflow.py``'s :class:`DataflowEngine` drains its queue in fixed
closed-loop batches: a launch's membership is decided before its first
superstep, and requests arriving one tick later wait for the whole batch to
drain.  Production traffic is open-loop — arrivals don't wait for
departures — so this module adds the serving layer the paper's execution
model was built for (§III-B(d): the forward/backedge merge admits a new
thread whenever a lane frees):

* **Admission queue** with per-tenant round-robin fairness and in-tenant
  priority ordering, bounded by ``queue_cap`` with lowest-priority-first
  load shedding (backpressure instead of unbounded latency).
* **In-flight batching**: on windowed backends, requests join an *open*
  :class:`~repro_torch.api.WaveSession` while it is already executing —
  a new rid opens its per-rid wave session mid-launch (the request-batched
  VectorVM's ``_FBState`` machinery) instead of waiting for the wave to
  drain.  Bit-identity per request is unchanged (the contract is
  schedule-independent).
* **Bucketed warm pools** across both execution modes:
  ``warmup()`` pre-compiles the bounded set of launch shapes serving will
  see — bucketed resident
  :class:`~repro_torch.core.device_vm.DeviceProgram` CUDA-graph captures
  (``bucket_sizes``) and the windowed wave path.
* **Deadline/SLO accounting** per request (``slo_s``), surfaced as
  ``met_slo`` on every response and as goodput in :meth:`stats`.
* **Robustness**: every launch runs under a
  :class:`~repro_torch.distributed.fault_tolerance.LaunchSupervisor` —
  per-launch timeout, verbatim replay on failure (launches are pure
  functions of their batch, so a retry is bit-identical), straggler
  detection, and degraded-mode fallback from resident to windowed
  execution after repeated resident failures.

The engine is cooperatively scheduled and single-threaded: ``submit()``
enqueues, ``pump()`` runs one scheduling quantum (admit + advance the open
wave a bounded number of supersteps, or serve one resident launch) and
returns whatever completed, ``run_until_idle()`` pumps until the system
drains.  ``tools/torch_serve_bench.py`` drives it on the card under
open-loop Poisson arrivals against the closed-loop ``step_batch``
baseline.  See DESIGN.md §10.
"""
from __future__ import annotations

import collections
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np

from ..api import CompiledProgram, RunReport, WaveSession
from ..core.backend import ExecutorBackend, make_backend
from ..core.device_vm import bucket_launch_size
from ..distributed.fault_tolerance import LaunchSupervisor


@dataclass
class AsyncRequest:
    """One ``main()`` invocation plus its serving metadata.  ``tenant`` /
    ``priority`` / ``slo_s`` are caller-owned; everything below the line is
    stamped by the engine (clock values come from the engine's injected
    clock, so tests can run on virtual time)."""
    params: dict = field(default_factory=dict)
    dram_init: Optional[dict] = None
    tenant: str = "default"
    priority: int = 0                   # higher = more important
    slo_s: Optional[float] = None       # per-request latency SLO
    # --- engine-stamped ---
    id: int = -1
    submit_t: float = 0.0
    admit_t: Optional[float] = None     # when popped into a launch
    done_t: Optional[float] = None
    queue_depth: Optional[int] = None   # depth behind it at admission
    status: str = "new"                 # queued|in-flight|ok|shed|failed
    retries: int = 0


@dataclass
class AsyncResponse:
    request: AsyncRequest
    dram: Optional[dict]
    report: Optional[RunReport]
    status: str                         # ok | shed | failed
    latency_s: Optional[float]          # submit -> done (engine clock)
    queue_s: Optional[float]            # submit -> admission
    met_slo: Optional[bool]             # None when no SLO applies
    error: Optional[str] = None

    @property
    def ok(self) -> bool:
        return self.status == "ok"


class AsyncServeEngine:
    """Open-loop serving engine over one :class:`CompiledProgram`.

    ``max_wave`` bounds a launch's membership (the wave capacity / resident
    batch size); ``queue_cap`` bounds the admission queue (beyond it the
    lowest-priority request — incoming included — is shed);
    ``advance_ticks`` is the superstep quantum one ``pump()`` drives the
    open wave, which bounds how long admission decisions are deferred;
    ``execution`` picks the launch mode (``None`` follows the compiled
    options; resident silently falls back to windowed on backends without
    a resident path and under supervisor degradation); ``clock`` injects a
    monotonic time source (tests run on virtual time).  ``fault_hook``
    (``hook(attempt, mode, requests)``) is the chaos-engineering seam: it
    runs before every launch attempt and may raise to simulate failures.
    """

    def __init__(self, compiled: CompiledProgram, *,
                 backend: "str | ExecutorBackend | None" = None,
                 max_wave: int = 8,
                 queue_cap: int = 64,
                 execution: Optional[str] = None,
                 bucket_sizes="auto",
                 slo_s: Optional[float] = None,
                 launch_timeout_s: Optional[float] = None,
                 max_retries: int = 2,
                 degrade_after: int = 2,
                 advance_ticks: int = 64,
                 max_wave_ticks: int = 1_000_000,
                 supervisor: Optional[LaunchSupervisor] = None,
                 clock: Callable[[], float] = time.monotonic,
                 fault_hook: Optional[Callable] = None,
                 **vm_kwargs):
        if max_wave < 1:
            raise ValueError(f"max_wave must be >= 1, got {max_wave}")
        if queue_cap < 1:
            raise ValueError(f"queue_cap must be >= 1, got {queue_cap}")
        self.compiled = compiled
        self.backend = (make_backend(backend) if backend is not None
                        else compiled.backend)
        self.max_wave = int(max_wave)
        self.queue_cap = int(queue_cap)
        self.bucket_sizes = bucket_sizes
        self.slo_s = slo_s
        self.launch_timeout_s = launch_timeout_s
        self.max_retries = int(max_retries)
        self.advance_ticks = int(advance_ticks)
        self.max_wave_ticks = int(max_wave_ticks)
        self.supervisor = supervisor if supervisor is not None else \
            LaunchSupervisor(max_retries=max_retries,
                             degrade_after=degrade_after,
                             timeout_s=launch_timeout_s)
        self._clock = clock
        self.fault_hook = fault_hook
        self._vm_kwargs = vm_kwargs
        requested = execution if execution is not None else \
            getattr(compiled.result.options, "execution", "windowed")
        if requested not in ("windowed", "resident"):
            raise ValueError(f"unknown execution mode {requested!r}")
        if requested == "resident" and not self.backend.supports_resident:
            requested = "windowed"
        self._execution = requested
        # per-tenant FIFO queues, round-robin cursor in first-seen order
        self._queues: dict[str, list[AsyncRequest]] = {}
        self._tenant_order: list[str] = []
        self._rr = 0
        self._next_id = 0
        # the open wave (windowed mode only)
        self._wave: Optional[WaveSession] = None
        self._wave_reqs: list[AsyncRequest] = []
        self._wave_opened_t = 0.0
        self._wave_advanced = False
        # observability
        self.done: list[AsyncResponse] = []
        self.counters: collections.Counter = collections.Counter()
        self.launch_counts: collections.Counter = collections.Counter()
        self.tenant_served: collections.Counter = collections.Counter()
        self.queue_depth_peak = 0
        self.queue_s_total = 0.0
        self.warmup_launches = 0

    # ------------------------------------------------------------ admission
    @property
    def queue_depth(self) -> int:
        return sum(len(q) for q in self._queues.values())

    @property
    def in_flight(self) -> int:
        return len(self._wave_reqs)

    @property
    def pending(self) -> int:
        """Requests not yet resolved: queued plus in-flight."""
        return self.queue_depth + self.in_flight

    def mode(self) -> str:
        """The launch mode the next pump will use (resident degrades to
        windowed once the supervisor latches)."""
        if self._execution == "resident" and not self.supervisor.degraded:
            return "resident"
        return "windowed"

    def submit(self, request: AsyncRequest) -> AsyncRequest:
        """Enqueue one request (stamping id/submit time).  On a full queue
        the lowest-priority request in the system sheds — the incoming one
        when it *is* the strict minimum (ties shed the youngest, so waiting
        requests keep their admission order).  The stamped request's
        ``status`` tells the caller whether it was queued or shed."""
        req = request
        req.id = self._next_id
        self._next_id += 1
        req.submit_t = self._clock()
        req.status = "queued"
        self.counters["submitted"] += 1
        if self.queue_depth >= self.queue_cap:
            victim = self._shed_victim(req)
            if victim is not req:
                self._remove_queued(victim)
                self._enqueue(req)
            self._resolve_shed(victim)
        else:
            self._enqueue(req)
        return req

    def _enqueue(self, req: AsyncRequest) -> None:
        if req.tenant not in self._queues:
            self._queues[req.tenant] = []
            self._tenant_order.append(req.tenant)
        self._queues[req.tenant].append(req)
        self.queue_depth_peak = max(self.queue_depth_peak, self.queue_depth)

    def _requeue_front(self, reqs: list[AsyncRequest]) -> None:
        """Put launch-evicted requests back at the *front* of their tenant
        queues (they already waited once), preserving relative order."""
        for req in reversed(reqs):
            req.status = "queued"
            if req.tenant not in self._queues:
                self._queues[req.tenant] = []
                self._tenant_order.append(req.tenant)
            self._queues[req.tenant].insert(0, req)
        self.queue_depth_peak = max(self.queue_depth_peak, self.queue_depth)

    def _remove_queued(self, req: AsyncRequest) -> None:
        self._queues[req.tenant].remove(req)

    def _shed_victim(self, incoming: AsyncRequest) -> AsyncRequest:
        """Pick who sheds when the queue is full: strictly lowest priority
        first; within a priority the youngest submission (so the incoming
        request sheds on priority ties — FIFO admission is preserved)."""
        candidates = [incoming]
        for q in self._queues.values():
            candidates.extend(q)
        return min(candidates, key=lambda r: (r.priority, -r.submit_t,
                                              -r.id))

    def _next_request(self) -> Optional[AsyncRequest]:
        """Fairness policy: round-robin across tenants with queued work (in
        first-seen order), highest priority first within the tenant, FIFO
        within a priority."""
        active = [t for t in self._tenant_order if self._queues.get(t)]
        if not active:
            return None
        tenant = active[self._rr % len(active)]
        self._rr += 1
        q = self._queues[tenant]
        i = min(range(len(q)), key=lambda j: (-q[j].priority, q[j].id))
        return q.pop(i)

    def _admit_pop(self) -> Optional[AsyncRequest]:
        req = self._next_request()
        if req is None:
            return None
        req.admit_t = self._clock()
        req.queue_depth = self.queue_depth
        req.status = "in-flight"
        self.queue_s_total += req.admit_t - req.submit_t
        return req

    # ----------------------------------------------------------- resolution
    def _resolve_shed(self, req: AsyncRequest) -> AsyncResponse:
        req.status = "shed"
        req.done_t = self._clock()
        self.counters["shed"] += 1
        resp = AsyncResponse(request=req, dram=None, report=None,
                             status="shed", latency_s=None, queue_s=None,
                             met_slo=False)
        self.done.append(resp)
        return resp

    def _resolve_failed(self, req: AsyncRequest, err: Exception
                        ) -> AsyncResponse:
        req.status = "failed"
        req.done_t = self._clock()
        self.counters["failed"] += 1
        resp = AsyncResponse(request=req, dram=None, report=None,
                             status="failed", latency_s=None,
                             queue_s=(req.admit_t - req.submit_t
                                      if req.admit_t is not None else None),
                             met_slo=False, error=repr(err))
        self.done.append(resp)
        return resp

    def _resolve_ok(self, req: AsyncRequest, ex) -> AsyncResponse:
        req.status = "ok"
        req.done_t = self._clock()
        latency = req.done_t - req.submit_t
        queue_s = (req.admit_t - req.submit_t
                   if req.admit_t is not None else None)
        report = ex.report
        report.queue_s = queue_s
        report.queue_depth = req.queue_depth
        slo = req.slo_s if req.slo_s is not None else self.slo_s
        met = (latency <= slo) if slo is not None else None
        self.counters["served"] += 1
        if met is True:
            self.counters["slo_met"] += 1
        elif met is False:
            self.counters["slo_missed"] += 1
        self.tenant_served[req.tenant] += 1
        resp = AsyncResponse(request=req, dram=ex.dram, report=report,
                             status="ok", latency_s=latency,
                             queue_s=queue_s, met_slo=met)
        self.done.append(resp)
        return resp

    # -------------------------------------------------------------- serving
    def pump(self) -> list[AsyncResponse]:
        """One cooperative scheduling quantum.  Windowed mode: admit every
        queued request that fits into the open wave (opening one if
        needed), drive it ``advance_ticks`` supersteps, and close it the
        moment it goes idle (nothing more to admit or the wave is full) or
        overruns its timeout.  Resident mode: serve one closed bucketed
        launch.  Returns the responses that completed this quantum."""
        if self.mode() == "resident":
            return self._pump_resident()
        return self._pump_windowed()

    def run_until_idle(self, max_wall_s: Optional[float] = None,
                       ) -> list[AsyncResponse]:
        """Pump until no work is queued or in flight (or the wall budget
        runs out); returns the responses completed during the call."""
        out: list[AsyncResponse] = []
        t0 = self._clock()
        while self.pending:
            out.extend(self.pump())
            if max_wall_s is not None and self._clock() - t0 > max_wall_s:
                break
        return out

    # windowed: the open-wave path ------------------------------------------
    def _open_wave(self) -> None:
        self._wave = self.compiled.open_session(
            self.max_wave, backend=self.backend, **self._vm_kwargs)
        self._wave_reqs = []
        self._wave_opened_t = self._clock()
        self._wave_advanced = False
        self.counters["waves"] += 1

    def _pump_windowed(self) -> list[AsyncResponse]:
        out: list[AsyncResponse] = []
        if self._wave is None:
            if not self.queue_depth:
                return out
            self._open_wave()
        wave = self._wave
        while wave.slots_free and self.queue_depth:
            req = self._admit_pop()
            try:
                wave.admit(req.dram_init or {}, req.params,
                           require_inputs=False)
            except Exception as e:       # noqa: BLE001 — bad request
                out.append(self._resolve_failed(req, e))
                continue
            if self._wave_advanced:
                self.counters["mid_wave_admissions"] += 1
            self._wave_reqs.append(req)
        if not self._wave_reqs:
            # every admission failed validation; drop the empty wave
            self._wave = None
            return out
        idle = wave.advance(self.advance_ticks)
        self._wave_advanced = True
        if not idle and self.launch_timeout_s is not None and \
                self._clock() - self._wave_opened_t > self.launch_timeout_s:
            out.extend(self._abort_wave())
            return out
        if idle:
            # idle means: all admitted work is done *and* either the queue
            # is empty (close now for latency) or the wave is full (the
            # admission loop above would have filled any free slot)
            out.extend(self._finish_wave())
        return out

    def _abort_wave(self) -> list[AsyncResponse]:
        """Cooperative per-launch timeout: discard the overrunning VM,
        strike the windowed mode, and replay the wave's requests — back to
        the queue front, or failed once they exhaust their retries."""
        reqs = self._wave_reqs
        self._wave = None
        self._wave_reqs = []
        self.supervisor.strike(
            "windowed", f"wave overran launch_timeout_s="
                        f"{self.launch_timeout_s} with {len(reqs)} requests")
        self.counters["wave_timeouts"] += 1
        out: list[AsyncResponse] = []
        retry: list[AsyncRequest] = []
        for req in reqs:
            req.retries += 1
            if req.retries > self.max_retries:
                out.append(self._resolve_failed(
                    req, TimeoutError(f"wave timeout after {req.retries} "
                                      "attempts")))
            else:
                retry.append(req)
        self._requeue_front(retry)
        return out

    def _finish_wave(self) -> list[AsyncResponse]:
        wave, reqs = self._wave, self._wave_reqs
        self._wave, self._wave_reqs = None, []

        def attempt(k: int):
            if self.fault_hook is not None:
                self.fault_hook(k, "windowed", reqs)
            if k == 0:
                return wave.finish(max_ticks=self.max_wave_ticks)
            # replay: launches are pure functions of their batch, so a
            # fresh closed session over the same requests is bit-identical
            s = self.compiled.open_session(len(reqs), backend=self.backend,
                                           **self._vm_kwargs)
            for r in reqs:
                s.admit(r.dram_init or {}, r.params, require_inputs=False)
            return s.finish(max_ticks=self.max_wave_ticks)

        try:
            bx = self.supervisor.run(attempt, mode="windowed")
        except Exception as e:           # noqa: BLE001 — retries exhausted
            return [self._resolve_failed(r, e) for r in reqs]
        self.launch_counts[len(reqs)] += 1
        return [self._resolve_ok(r, ex) for r, ex in zip(reqs, bx)]

    # resident: closed bucketed launches ------------------------------------
    def _pump_resident(self) -> list[AsyncResponse]:
        if not self.queue_depth:
            return []
        batch: list[AsyncRequest] = []
        while len(batch) < self.max_wave and self.queue_depth:
            batch.append(self._admit_pop())
        reqs = [(dict(r.dram_init or {}), r.params) for r in batch]

        def attempt(k: int):
            if self.fault_hook is not None:
                self.fault_hook(k, "resident", batch)
            return self.compiled.execute_batch(
                reqs, require_inputs=False, backend=self.backend,
                execution="resident", bucket_sizes=self.bucket_sizes,
                **self._vm_kwargs)

        try:
            bx = self.supervisor.run(attempt, mode="resident")
        except Exception as e:           # noqa: BLE001 — retries exhausted
            # resident gave up on this batch: replay it on the windowed
            # path (degraded mode if the supervisor latched; either way
            # these requests don't die with the resident pipeline)
            self.counters["resident_fallbacks"] += 1
            out: list[AsyncResponse] = []
            retry: list[AsyncRequest] = []
            for req in batch:
                req.retries += 1
                if req.retries > self.max_retries and \
                        self.supervisor.degraded:
                    out.append(self._resolve_failed(req, e))
                else:
                    retry.append(req)
            self._requeue_front(retry)
            if not self.supervisor.degraded:
                self.supervisor.strike(
                    "resident", "launch retries exhausted; degrading")
                self.supervisor.degraded = True
            return out
        size = len(reqs) if not self.bucket_sizes else \
            bucket_launch_size(len(reqs), self.bucket_sizes)
        self.launch_counts[size] += 1
        return [self._resolve_ok(r, ex) for r, ex in zip(batch, bx)]

    # --------------------------------------------------------------- warmup
    def warmup(self, arrays: Optional[dict] = None,
               scalars: Optional[dict] = None,
               buckets: Optional[tuple] = None) -> dict:
        """Pre-compile every launch shape steady-state serving will see, in
        every mode this engine can reach: the bucketed resident
        ``DeviceProgram`` ladder up to ``max_wave`` (when resident-capable
        — these stay warm in ``CompileResult._resident_cache``), plus one
        full-capacity windowed wave (the degraded-mode path, and the only
        path on windowed backends).  Results are discarded; nothing lands
        in ``done`` or the serving counters.  Returns the shapes warmed
        per mode."""
        arrays = dict(arrays or {})
        scalars = dict(scalars or {})
        warmed: dict[str, list[int]] = {"windowed": [], "resident": []}
        if buckets is None:
            sizes = sorted({bucket_launch_size(n, self.bucket_sizes or ())
                            for n in range(1, self.max_wave + 1)})
        else:
            sizes = sorted(set(int(b) for b in buckets))
        if self._execution == "resident":
            for b in sizes:
                self.compiled.execute_batch(
                    [(dict(arrays), scalars)] * b, require_inputs=False,
                    backend=self.backend, execution="resident",
                    bucket_sizes=self.bucket_sizes, **self._vm_kwargs)
                self.warmup_launches += 1
                warmed["resident"].append(b)
        # the windowed wave path serves degraded mode (and is the only
        # mode on non-resident backends): one full wave warms the
        # backend's window-shaped kernel caches
        s = self.compiled.open_session(self.max_wave, backend=self.backend,
                                       **self._vm_kwargs)
        for _ in range(self.max_wave):
            s.admit(dict(arrays), scalars, require_inputs=False)
        s.finish(max_ticks=self.max_wave_ticks)
        self.warmup_launches += 1
        warmed["windowed"].append(self.max_wave)
        return warmed

    # ---------------------------------------------------------------- stats
    def stats(self) -> dict:
        served = int(self.counters["served"])
        return {
            "backend": self.backend.name,
            "execution": self._execution,
            "mode": self.mode(),
            "degraded": self.supervisor.degraded,
            "submitted": int(self.counters["submitted"]),
            "served": served,
            "shed": int(self.counters["shed"]),
            "failed": int(self.counters["failed"]),
            "waves": int(self.counters["waves"]),
            "wave_timeouts": int(self.counters["wave_timeouts"]),
            "mid_wave_admissions": int(
                self.counters["mid_wave_admissions"]),
            "resident_fallbacks": int(self.counters["resident_fallbacks"]),
            "slo_met": int(self.counters["slo_met"]),
            "slo_missed": int(self.counters["slo_missed"]),
            "queue_depth": self.queue_depth,
            "queue_depth_peak": self.queue_depth_peak,
            "time_in_queue_s": self.queue_s_total,
            "time_in_queue_mean_s": (self.queue_s_total / served
                                     if served else 0.0),
            "launches": sum(self.launch_counts.values()),
            "launches_by_bucket": dict(sorted(self.launch_counts.items())),
            "warmup_launches": self.warmup_launches,
            "tenant_served": dict(sorted(self.tenant_served.items())),
            "supervisor_retries": self.supervisor.retries,
            "supervisor_failures": self.supervisor.failures,
            "stragglers": len(self.supervisor.monitor.flagged),
        }
