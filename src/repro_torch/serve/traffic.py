"""Measuring the executor's serving path: benchmark-scale app instances,
equality with the numpy oracle, and open-loop Poisson traffic through the
closed-loop ``DataflowEngine.step_batch(8)`` baseline and through
``AsyncServeEngine`` (windowed or resident).

``chip_smoke.py`` and ``tools/torch_serve_bench.py`` drive the card with
these; nothing in the package imports this module.  Every failed check
raises ``AssertionError``.
"""
from __future__ import annotations

import math
import time

import numpy as np

# benchmark-scale app instances (the dict of benchmarks/common.py)
BENCH_SIZES = {
    "isipv4": dict(n_strings=256),
    "ip2int": dict(n_strings=256),
    "murmur3": dict(n_blobs=128),
    "hash_table": dict(n_lookups=256, n_slots=1024),
    "search": dict(n_chunks=32, chunk=256),
    "huff_dec": dict(n_threads=16, syms_per_thread=128),
    "huff_enc": dict(n_threads=16, syms_per_thread=128),
    "kdtree": dict(n_points=2048, n_queries=64),
    "strlen": dict(n_strings=128, avg_len=32),
}
HASH_TABLE_16X = dict(n_lookups=4096, n_slots=16384)

SERVE_BATCH = 8            # the async engine's max_wave, the baseline's batch
SERVE_SLO_MULT = 4.0       # the SLO: this many warm batch-8 launch walls
SERVE_TENANTS = ("a", "b")


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def executor_launches() -> dict:
    """The executor kernels' launch counters."""
    from repro_torch.kernels.segment_reduce import segment_reduce
    from repro_torch.kernels.stream_compact import stream_compact
    return {"stream_compact": stream_compact.launches,
            "segment_reduce": segment_reduce.launches}


def reset_executor_launches() -> None:
    from repro_torch.kernels.segment_reduce import segment_reduce
    from repro_torch.kernels.stream_compact import stream_compact
    stream_compact.launches = 0
    segment_reduce.launches = 0


def same_run(name, ex_np, ex_t) -> None:
    """A windowed run's DRAM and ``vm.stats`` equal the oracle's."""
    for arr in ex_np.dram:
        _require(ex_np.dram[arr].shape == ex_t.dram[arr].shape and
                 (ex_np.dram[arr] == ex_t.dram[arr]).all(),
                 f"{name}: dram '{arr}' differs from the numpy oracle")
    _require(ex_np.vm.stats == ex_t.vm.stats,
             f"{name}: stats differ from the numpy oracle")


def same_resident(name, got, want) -> None:
    """DRAM (of each request of a batch) and the aggregate lane stats of a
    resident run equal the oracle's."""
    from repro_torch.core.vector_vm import LANE_STATS
    _require(got.report.execution == "resident",
             f"{name}: the resident run fell back to windowed "
             f"({getattr(got.vm, 'resident_fallback', None)})")
    pairs = (list(zip(got, want)) if hasattr(got, "executions")
             else [(got, want)])
    for rid, (g, w) in enumerate(pairs):
        for arr in w.dram:
            _require(w.dram[arr].shape == g.dram[arr].shape and
                     (w.dram[arr] == g.dram[arr]).all(),
                     f"{name} rid={rid}: resident dram '{arr}' differs "
                     "from the oracle")
    lane = lambda st: {k: int(st.get(k, 0)) for k in LANE_STATS}
    _require(lane(got.report.stats) == lane(want.report.stats),
             f"{name}: resident lane stats differ from the oracle")


def pad_inputs(apps) -> None:
    """Zero-pad each input array to its longest length across ``apps``, so
    that instances built from different seeds share one compiled shape (a
    string blob's trailing zeros are never read)."""
    for arr in apps[0].dram_init:
        width = max(len(a.dram_init[arr]) for a in apps)
        for a in apps:
            v = np.asarray(a.dram_init[arr])
            a.dram_init[arr] = np.concatenate(
                [v, np.zeros(width - len(v), v.dtype)])


def serve_instances(name, size):
    """SERVE_BATCH instances of app ``name`` at ``size`` from seeds 0, 1,
    ..., their inputs padded to one shape; the lowered program; and each
    instance's solo run on the numpy oracle."""
    from repro_torch.apps import ALL_APPS
    apps = [ALL_APPS[name](**size, seed=s) for s in range(SERVE_BATCH)]
    pad_inputs(apps)
    app = apps[0]
    lowered = app.fn.lower(**app.dram_init, **app.params, **app.statics)
    oracle = lowered.compile("numpy")
    solos = [oracle.execute(dict(a.dram_init), dict(a.params)) for a in apps]
    return apps, lowered, solos


def batch8_wall(compiled, apps) -> float:
    """Wall seconds of one closed-loop ``DataflowEngine.step_batch(8)`` over
    the instances, the best of three (the first warms): the service time
    that the offered rates and the SLO derive from."""
    from repro_torch.serve.dataflow import DataflowEngine, DataflowRequest
    best = math.inf
    for _ in range(3):
        eng = DataflowEngine(compiled)
        for rid, a in enumerate(apps):
            eng.submit(DataflowRequest(rid, dict(a.params),
                                       dict(a.dram_init)))
        t0 = time.perf_counter()
        eng.step_batch(max_batch=SERVE_BATCH)
        best = min(best, time.perf_counter() - t0)
    return best


def poisson(n: int, rate: float, seed: int) -> list:
    """Arrival offsets (seconds) of an open-loop Poisson process."""
    rng = np.random.default_rng(seed)
    return list(np.cumsum(rng.exponential(1.0 / rate, size=n)))


def _same_solo(what, dram, solo) -> None:
    for arr in solo.dram:
        _require((dram[arr] == solo.dram[arr]).all(),
                 f"{what}: '{arr}' differs from the oracle's solo run")


def drive_closed(compiled, apps, solos, sched) -> dict:
    """The closed-loop baseline under the open-loop schedule: due arrivals
    are submitted, then whatever is queued launches as one
    ``step_batch(8)``; the queue is unbounded.  Request ``i`` is instance
    ``i % SERVE_BATCH``; latency runs from its scheduled arrival."""
    from repro_torch.serve.dataflow import DataflowEngine, DataflowRequest
    eng = DataflowEngine(compiled)
    n, i, done_at = len(sched), 0, {}
    t0 = time.monotonic()
    while i < n or eng.queue:
        now = time.monotonic() - t0
        while i < n and sched[i] <= now:
            a = apps[i % len(apps)]
            eng.submit(DataflowRequest(i, dict(a.params), dict(a.dram_init)))
            i += 1
        if eng.queue:
            for r in eng.step_batch(max_batch=SERVE_BATCH):
                done_at[r.rid] = time.monotonic() - t0
                _same_solo(f"closed loop rid {r.rid}", r.dram,
                           solos[r.rid % len(apps)])
        elif i < n:
            time.sleep(min(max(sched[i] - (time.monotonic() - t0), 0.0),
                           1e-3))
    return {"latencies": [done_at[r] - sched[r] for r in range(n)],
            "elapsed_s": time.monotonic() - t0, "completed": len(done_at)}


def drive_async(compiled, apps, solos, sched, slo_s, execution,
                fault_hook=None) -> dict:
    """``AsyncServeEngine`` (max_wave SERVE_BATCH, an SLO-sized queue)
    under the schedule, after ``warmup()``: request ``i`` is instance
    ``i % SERVE_BATCH`` of tenant ``SERVE_TENANTS[i % 2]``; every served
    response is held to its instance's solo run.  ``launches`` are the
    executor kernels' launches of the serving window alone (the counters
    set to 0 after ``warmup()`` and read when the last request is done);
    ``new_programs`` counts the resident programs built (captured) while
    serving."""
    from repro_torch.serve.async_engine import AsyncRequest, AsyncServeEngine
    eng = AsyncServeEngine(compiled, max_wave=SERVE_BATCH,
                           queue_cap=max(2 * SERVE_BATCH, math.ceil(
                               SERVE_SLO_MULT * SERVE_BATCH)),
                           slo_s=slo_s, execution=execution,
                           fault_hook=fault_hook)
    t1 = time.perf_counter()
    warmed = eng.warmup(dict(apps[0].dram_init), dict(apps[0].params))
    warmup_s = time.perf_counter() - t1
    programs = len(getattr(compiled.result, "_resident_cache", {}))
    n, i = len(sched), 0
    reset_executor_launches()
    t0 = time.monotonic()
    while i < n or eng.pending:
        now = time.monotonic() - t0
        while i < n and sched[i] <= now:
            a = apps[i % len(apps)]
            req = AsyncRequest(params=dict(a.params),
                               dram_init=dict(a.dram_init),
                               tenant=SERVE_TENANTS[i % 2])
            req.sched_t = t0 + sched[i]
            eng.submit(req)
            i += 1
        eng.pump()
        if not eng.pending and i < n:
            time.sleep(min(max(sched[i] - (time.monotonic() - t0), 0.0),
                           1e-3))
    elapsed = time.monotonic() - t0
    launches = executor_launches()
    for r in eng.done:
        if r.ok:
            _same_solo(f"async {execution} request {r.request.id}", r.dram,
                       solos[r.request.id % len(apps)])
    st = eng.stats()
    _require(st["served"] + st["shed"] == st["submitted"] == n
             and st["failed"] == 0,
             f"async {execution}: requests lost or failed: {st}")
    return {"latencies": [r.request.done_t - r.request.sched_t
                          for r in eng.done if r.ok],
            "elapsed_s": elapsed, "completed": st["served"], "stats": st,
            "executions": sorted({r.report.execution for r in eng.done
                                  if r.ok}),
            "launches": launches, "warmed": warmed, "warmup_s": warmup_s,
            "new_programs": len(getattr(compiled.result, "_resident_cache",
                                        {})) - programs}


def rate_cell(drive: dict, slo_s: float, offered: float, n: int) -> dict:
    """p50/p99 latency and goodput at the SLO: the share of the offered
    requests completed within the SLO, times the offered rate (shed and
    unfinished requests count against it)."""
    lats = drive["latencies"]
    met = sum(1 for x in lats if x <= slo_s)
    pct = (lambda q: float(np.percentile(lats, q))) if lats else \
        (lambda q: None)
    return {"offered_rps": offered, "requests": n,
            "completed": drive["completed"], "p50_s": pct(50),
            "p99_s": pct(99), "met_slo": met,
            "goodput_rps": offered * met / max(n, 1),
            "goodput_share": met / max(n, 1), "elapsed_s": drive["elapsed_s"]}


def async_summary(d: dict) -> dict:
    st = d["stats"]
    return {k: st[k] for k in ("mode", "served", "shed", "failed", "waves",
                               "mid_wave_admissions", "launches_by_bucket",
                               "queue_depth_peak", "degraded",
                               "resident_fallbacks", "supervisor_retries",
                               "supervisor_failures", "stragglers")}


def require_clean(name: str, d: dict, execution: str) -> None:
    """An async run served in the mode it was asked for, with no failure,
    degradation or fallback to windowed; resident: every response resident
    and no program captured while serving."""
    st = d["stats"]
    _require(st["mode"] == execution and not st["degraded"]
             and st["resident_fallbacks"] == 0
             and st["supervisor_failures"] == 0,
             f"{name} async {execution}: {async_summary(d)}")
    if execution == "resident":
        _require(d["executions"] == ["resident"],
                 f"{name}: a response ran {d['executions']}")
        _require(d["new_programs"] == 0,
                 f"{name}: {d['new_programs']} resident programs captured "
                 "while serving (warmup missed a bucket)")
