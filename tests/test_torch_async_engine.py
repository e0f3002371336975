"""The port's open-loop serving (``repro_torch.serve.async_engine``) and its
launch supervisor, on the CPU.

Twins of the 17 tests of ``tests/test_async_engine.py``: every windowed
test runs on the port's ``"numpy"`` backend and on ``TorchBackend("cpu")``
(the kernels' plain versions); the two resident tests run on
``TorchBackend("cpu")`` (the resident loop on the host) and hold every
response to the numpy oracle's solo run.  One cross-package test serves the
same request stream under a virtual clock through the reference's engine
(numpy) and the port's: equal ``stats()`` but for ``backend``, equal
statuses, equal DRAM.
"""
import numpy as np
import pytest

from repro.apps import ALL_APPS as REF_APPS
from repro.serve.async_engine import AsyncRequest as RefRequest
from repro.serve.async_engine import AsyncServeEngine as RefEngine
from repro_torch.apps import ALL_APPS
from repro_torch.core.backend import TorchBackend
from repro_torch.core.device_vm import RESIDENT_BUCKETS, bucket_launch_size
from repro_torch.distributed.fault_tolerance import SimulatedFault
from repro_torch.serve.async_engine import AsyncRequest, AsyncServeEngine
from repro_torch.serve.dataflow import DataflowEngine, DataflowRequest

CPU = TorchBackend("cpu")
BACKENDS = [pytest.param("numpy", id="numpy"),
            pytest.param(CPU, id="torch-cpu")]


def _compiled(app, backend):
    return app.fn.lower(**app.dram_init, **app.params,
                        **app.statics).compile(backend)


def _req(app, **kw):
    return AsyncRequest(params=dict(app.params),
                        dram_init=dict(app.dram_init), **kw)


def _assert_matches_solo(resp, compiled, app):
    """The response equals a solo run on the numpy oracle."""
    solo = compiled.execute(dict(app.dram_init), resp.request.params,
                            require_inputs=False, backend="numpy")
    for arr in solo.dram:
        np.testing.assert_array_equal(
            resp.dram[arr], solo.dram[arr],
            err_msg=f"req {resp.request.id}: '{arr}'")


class FakeClock:
    """Injectable monotonic time — tests control latency deterministically."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


# ---------------------------------------------------------------------------
# bucketed launch shapes (core/device_vm.py)
# ---------------------------------------------------------------------------

def test_bucket_launch_size():
    assert bucket_launch_size(1) == 1
    assert bucket_launch_size(3) == 4
    assert bucket_launch_size(8) == 8
    assert bucket_launch_size(9, "auto") == 16
    assert bucket_launch_size(max(RESIDENT_BUCKETS) + 1) == \
        max(RESIDENT_BUCKETS) + 1            # beyond the ladder: exact size
    assert bucket_launch_size(3, (5,)) == 5
    assert bucket_launch_size(7, (5,)) == 7


# ---------------------------------------------------------------------------
# admission queue: bounded shedding + tenant fairness
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_shed_lowest_priority_first(backend):
    app = ALL_APPS["ip2int"]()
    eng = AsyncServeEngine(_compiled(app, backend), max_wave=2, queue_cap=3)
    reqs = [eng.submit(_req(app, priority=p)) for p in (5, 1, 3, 0, 9)]
    assert [r.status for r in reqs] == \
        ["queued", "shed", "queued", "shed", "queued"]
    shed = [r for r in eng.done if r.status == "shed"]
    assert sorted(r.request.priority for r in shed) == [0, 1]
    assert all(r.met_slo is False and r.dram is None for r in shed)
    served = eng.run_until_idle()
    assert sorted(r.request.priority for r in served) == [3, 5, 9]
    for r in served:
        _assert_matches_solo(r, eng.compiled, app)
    st = eng.stats()
    assert st["submitted"] == 5 and st["served"] == 3 and st["shed"] == 2
    assert st["submitted"] == st["served"] + st["shed"] + st["failed"]


@pytest.mark.parametrize("backend", BACKENDS)
def test_tenant_fairness_10_to_1_skew(backend):
    app = ALL_APPS["ip2int"](n_strings=16)     # 22 requests: keep them small
    eng = AsyncServeEngine(_compiled(app, backend), max_wave=4, queue_cap=64)
    for _ in range(20):
        eng.submit(_req(app, tenant="big"))
    small = [eng.submit(_req(app, tenant="small")) for _ in range(2)]
    done = eng.run_until_idle()
    assert len(done) == 22
    first_wave = {r.request.id for r in done[:4]}
    assert {s.id for s in small} <= first_wave
    assert eng.stats()["tenant_served"] == {"big": 20, "small": 2}
    for r in done:
        _assert_matches_solo(r, eng.compiled, app)


@pytest.mark.parametrize("backend", BACKENDS)
def test_priority_order_within_tenant(backend):
    app = ALL_APPS["ip2int"]()
    eng = AsyncServeEngine(_compiled(app, backend), max_wave=8, queue_cap=16)
    order = [eng.submit(_req(app, priority=p)).id for p in (0, 7, 3, 7)]
    done = eng.run_until_idle()
    assert [r.request.id for r in done] == \
        [order[1], order[3], order[2], order[0]]


# ---------------------------------------------------------------------------
# robustness: retry, timeout, degraded mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_retried_launch_bit_identical(backend):
    app = ALL_APPS["hash_table"]()
    compiled = _compiled(app, backend)

    def chaos(attempt, mode, reqs):
        if attempt == 0:
            raise SimulatedFault(f"{mode} launch of {len(reqs)} lost")

    eng = AsyncServeEngine(compiled, max_wave=4, queue_cap=16,
                           max_retries=2, fault_hook=chaos)
    counts = [64, 17, 1, 40, 64, 9]
    for n in counts:
        eng.submit(AsyncRequest(params={"count": n},
                                dram_init=dict(app.dram_init)))
    done = eng.run_until_idle()
    assert [r.status for r in done] == ["ok"] * len(counts)
    for r in done:
        solo = compiled.execute(dict(app.dram_init), r.request.params,
                                backend="numpy")
        for arr in solo.dram:
            np.testing.assert_array_equal(r.dram[arr], solo.dram[arr])
        assert r.report.stats == solo.vm.request_stats(0)
    assert eng.supervisor.retries == 2          # one per wave (6 reqs / 4)
    assert eng.stats()["supervisor_failures"] == 2


@pytest.mark.parametrize("backend", BACKENDS)
def test_retries_exhausted_fail_the_wave(backend):
    app = ALL_APPS["ip2int"]()

    def chaos(attempt, mode, reqs):
        raise SimulatedFault("always down")

    eng = AsyncServeEngine(_compiled(app, backend), max_wave=4, queue_cap=8,
                           max_retries=1, fault_hook=chaos)
    for _ in range(3):
        eng.submit(_req(app))
    done = eng.run_until_idle()
    assert [r.status for r in done] == ["failed"] * 3
    assert all("SimulatedFault" in r.error for r in done)
    st = eng.stats()
    assert st["failed"] == 3 and st["served"] == 0
    assert st["submitted"] == st["served"] + st["shed"] + st["failed"]


@pytest.mark.parametrize("backend", BACKENDS)
def test_wave_timeout_requeues_then_serves(backend):
    app = ALL_APPS["hash_table"]()
    clock = FakeClock()
    eng = AsyncServeEngine(_compiled(app, backend), max_wave=2, queue_cap=8,
                           launch_timeout_s=5.0, max_retries=2,
                           advance_ticks=1, clock=clock)
    for _ in range(2):
        eng.submit(_req(app))
    eng.pump()                      # opens the wave at t=0, one superstep
    clock.t = 100.0                 # overrun: next pump aborts the wave
    done = eng.pump()
    assert done == [] and eng.queue_depth == 2   # requeued, not failed
    assert eng.counters["wave_timeouts"] == 1
    done = eng.run_until_idle()     # clock frozen now -> no more timeouts
    assert [r.status for r in done] == ["ok", "ok"]
    assert all(r.request.retries == 1 for r in done)
    for r in done:
        _assert_matches_solo(r, eng.compiled, app)


@pytest.mark.parametrize("backend", BACKENDS)
def test_wave_timeout_exhausts_to_failure(backend):
    app = ALL_APPS["hash_table"]()
    clock = FakeClock()
    eng = AsyncServeEngine(_compiled(app, backend), max_wave=2, queue_cap=8,
                           launch_timeout_s=5.0, max_retries=0,
                           advance_ticks=1, clock=clock)
    eng.submit(_req(app))
    eng.pump()
    clock.t = 100.0
    done = eng.pump()               # retries (0) exhausted -> failed
    assert [r.status for r in done] == ["failed"]
    assert "TimeoutError" in done[0].error or "timeout" in done[0].error


@pytest.mark.parametrize("backend", BACKENDS)
def test_slo_accounting_virtual_clock(backend):
    app = ALL_APPS["ip2int"]()
    clock = FakeClock()
    eng = AsyncServeEngine(_compiled(app, backend), max_wave=4, queue_cap=8,
                           slo_s=5.0, clock=clock)
    fast = eng.submit(_req(app))
    done = eng.run_until_idle()     # clock never moves -> latency 0
    clock.t = 50.0
    slow = eng.submit(_req(app))
    clock.t = 100.0                 # 50s in system before the wave closes
    done += eng.run_until_idle()
    by_id = {r.request.id: r for r in done}
    assert by_id[fast.id].met_slo is True
    assert by_id[slow.id].met_slo is False
    st = eng.stats()
    assert st["slo_met"] == 1 and st["slo_missed"] == 1
    clock.t = 200.0                 # a per-request SLO overrides the default
    req = eng.submit(_req(app, slo_s=1000.0))
    clock.t = 300.0
    (r,) = eng.run_until_idle()
    assert r.request.id == req.id and r.met_slo is True


# ---------------------------------------------------------------------------
# in-flight batching: open waves admit mid-launch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_mid_wave_admission_counter_and_identity(backend):
    app = ALL_APPS["hash_table"]()
    eng = AsyncServeEngine(_compiled(app, backend), max_wave=4, queue_cap=8,
                           advance_ticks=1)
    eng.submit(AsyncRequest(params={"count": 64},
                            dram_init=dict(app.dram_init)))
    eng.pump()                      # wave open + advanced one superstep
    assert eng.in_flight == 1
    for n in (17, 40):
        eng.submit(AsyncRequest(params={"count": n},
                                dram_init=dict(app.dram_init)))
    done = eng.run_until_idle()
    assert eng.counters["mid_wave_admissions"] == 2
    assert eng.stats()["waves"] == 1            # all three shared one wave
    assert [r.status for r in done] == ["ok"] * 3
    for r in done:
        _assert_matches_solo(r, eng.compiled, app)


@pytest.mark.parametrize("backend", BACKENDS)
def test_wave_session_mid_flight_bit_identity(backend):
    app = ALL_APPS["hash_table"]()
    compiled = _compiled(app, backend)
    counts = [64, 17, 1, 40, 9]
    wave = compiled.open_session(capacity=len(counts))
    for n in counts[:2]:
        wave.admit(dict(app.dram_init), {"count": n})
    while not wave.advance(max_ticks=16):
        pass                        # first two requests fully drained
    for n in counts[2:]:
        wave.admit(dict(app.dram_init), {"count": n})
    bx = wave.finish()
    assert len(bx) == len(counts) and wave.closed
    for ex, n in zip(bx, counts):
        solo = compiled.execute(dict(app.dram_init), {"count": n},
                                backend="numpy")
        for arr in solo.dram:
            np.testing.assert_array_equal(ex.dram[arr], solo.dram[arr],
                                          err_msg=f"count={n}: '{arr}'")
        assert ex.report.stats == solo.vm.request_stats(0)


@pytest.mark.parametrize("backend", BACKENDS)
def test_wave_session_guards(backend):
    app = ALL_APPS["ip2int"]()
    compiled = _compiled(app, backend)
    wave = compiled.open_session(capacity=1)
    wave.admit(dict(app.dram_init), dict(app.params))
    with pytest.raises(RuntimeError, match="wave full"):
        wave.admit(dict(app.dram_init), dict(app.params))
    wave.close()
    with pytest.raises(RuntimeError, match="closed"):
        wave.admit(dict(app.dram_init), dict(app.params))
    assert len(wave.finish()) == 1
    empty = compiled.open_session(capacity=2)
    assert len(empty.finish()) == 0


# ---------------------------------------------------------------------------
# DataflowEngine: drain default + queue/launch stats
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_engine_drain_default_batches(backend):
    app = ALL_APPS["ip2int"]()
    eng = DataflowEngine(_compiled(app, backend))
    for rid in range(3):
        eng.submit(DataflowRequest(rid, dict(app.params),
                                   dict(app.dram_init)))
    eng.drain()
    st = eng.stats()
    assert st["launches"] == 1                  # not 3
    # "auto" pads to a power of two where the backend has a resident path
    padded = 4 if eng.backend.supports_resident else 3
    assert st["launches_by_bucket"] == {padded: 1}
    assert st["queue_depth"] == 0 and st["queue_depth_peak"] == 3
    assert st["time_in_queue_s"] >= 0.0
    assert st["time_in_queue_mean_s"] >= 0.0
    for resp in eng.done:
        assert resp.report.queue_s is not None
        assert resp.report.queue_depth is not None


@pytest.mark.parametrize("backend", BACKENDS)
def test_engine_warmup_counter(backend):
    app = ALL_APPS["ip2int"]()
    eng = DataflowEngine(_compiled(app, backend))
    before = eng.stats()["warmup_launches"]
    warmed = eng.warmup(DataflowRequest(0, dict(app.params),
                                        dict(app.dram_init)),
                        buckets=(1, 2))
    assert warmed == [1, 2]
    assert eng.stats()["warmup_launches"] == before + 2
    assert not eng.done                      # warmup results are discarded


@pytest.mark.parametrize("backend", BACKENDS)
def test_async_stats_keys_complete(backend):
    app = ALL_APPS["ip2int"]()
    eng = AsyncServeEngine(_compiled(app, backend), max_wave=2, queue_cap=4)
    eng.submit(_req(app))
    eng.run_until_idle()
    st = eng.stats()
    for key in ("backend", "execution", "mode", "degraded", "submitted",
                "served", "shed", "failed", "waves", "wave_timeouts",
                "mid_wave_admissions", "resident_fallbacks", "slo_met",
                "slo_missed", "queue_depth", "queue_depth_peak",
                "time_in_queue_s", "time_in_queue_mean_s", "launches",
                "launches_by_bucket", "warmup_launches", "tenant_served",
                "supervisor_retries", "supervisor_failures", "stragglers"):
        assert key in st, key
    assert st["mode"] == "windowed" and st["launches_by_bucket"] == {1: 1}


# ---------------------------------------------------------------------------
# resident mode on the CPU's resident loop: bucketed launches + degradation
# (on hash_table: the reference's ip2int takes 253 ticks of more contexts,
# about 17 s of the host's resident loop against hash_table's 3 s)
# ---------------------------------------------------------------------------

def test_resident_async_bucketed_launches():
    app = ALL_APPS["hash_table"]()
    compiled = _compiled(app, CPU)
    eng = AsyncServeEngine(compiled, backend=CPU, execution="resident",
                           max_wave=2, queue_cap=8)
    assert eng.mode() == "resident"
    warmed = eng.warmup(dict(app.dram_init), dict(app.params))
    assert warmed["resident"] == [1, 2]
    programs = len(compiled.result._resident_cache)
    for _ in range(3):
        eng.submit(_req(app))
    done = eng.run_until_idle()
    assert [r.status for r in done] == ["ok"] * 3
    for r in done:
        assert r.report.execution == "resident"
        _assert_matches_solo(r, compiled, app)
    st = eng.stats()
    assert st["launches_by_bucket"] == {1: 1, 2: 1}   # 3 reqs -> 2 + pad(1)
    # warmup built every program serving used: no new one while serving
    assert len(compiled.result._resident_cache) == programs


def test_resident_degrades_to_windowed():
    app = ALL_APPS["hash_table"]()
    compiled = _compiled(app, CPU)

    def chaos(attempt, mode, reqs):
        if mode == "resident":
            raise SimulatedFault("resident pipeline down")

    eng = AsyncServeEngine(compiled, backend=CPU, execution="resident",
                           max_wave=4, queue_cap=8, max_retries=1,
                           degrade_after=2, fault_hook=chaos)
    for _ in range(4):
        eng.submit(_req(app))
    done = eng.run_until_idle()
    assert eng.supervisor.degraded and eng.mode() == "windowed"
    st = eng.stats()
    assert st["resident_fallbacks"] >= 1 and st["degraded"]
    assert [r.status for r in done] == ["ok"] * 4
    for r in done:
        _assert_matches_solo(r, compiled, app)


# ---------------------------------------------------------------------------
# the two packages' engines on one request stream
# ---------------------------------------------------------------------------

# (clock, [(tenant, priority, count)] submitted, pumps) per step: sheds on
# a full queue, two tenants, priorities, mid-wave admissions, idle pumps
_SCRIPT = [
    (0.0, [("a", 0, 64)], 1),
    (1.5, [("b", 1, 17), ("a", 2, 1)], 1),
    (2.0, [("b", 0, 40), ("a", 0, 9), ("a", 5, 64), ("b", 0, 3),
           ("b", 0, 12), ("a", 1, 33), ("b", 0, 5)], 2),
    (4.25, [], 3),
    (6.0, [("a", 0, 50), ("b", 3, 8)], 1),
    (9.0, [], 0),
]


def _serve_script(engine, make_request, app):
    clock = FakeClock()
    eng = engine(clock)
    for t, subs, pumps in _SCRIPT:
        clock.t = t
        for tenant, prio, count in subs:
            eng.submit(make_request(
                params={"count": count}, dram_init=dict(app.dram_init),
                tenant=tenant, priority=prio))
        for _ in range(pumps):
            eng.pump()
    clock.t = 12.0
    eng.run_until_idle()
    return eng


@pytest.mark.parametrize("backend", BACKENDS)
def test_engine_matches_reference_engine(backend):
    """Fewer than 8 launches, so neither straggler monitor (which reads the
    host's clock) can flag one."""
    ref_app, app = REF_APPS["hash_table"](), ALL_APPS["hash_table"]()
    kw = dict(max_wave=3, queue_cap=5, slo_s=3.0, advance_ticks=32)
    want = _serve_script(
        lambda clock: RefEngine(_compiled(ref_app, "numpy"), clock=clock,
                                **kw), RefRequest, ref_app)
    got = _serve_script(
        lambda clock: AsyncServeEngine(_compiled(app, backend), clock=clock,
                                       **kw), AsyncRequest, app)
    st, ref_st = got.stats(), want.stats()
    assert st.pop("backend") == got.backend.name
    assert ref_st.pop("backend") == "numpy"
    assert st == ref_st
    assert st["shed"] > 0 and st["mid_wave_admissions"] > 0
    assert st["slo_met"] > 0 and st["slo_missed"] > 0
    assert st["launches"] < 8
    assert [(r.request.id, r.status, r.met_slo, r.latency_s)
            for r in got.done] == \
        [(r.request.id, r.status, r.met_slo, r.latency_s) for r in want.done]
    for r, w in zip(got.done, want.done):
        assert (r.dram is None) == (w.dram is None)
        for arr in (w.dram or {}):
            np.testing.assert_array_equal(r.dram[arr], w.dram[arr])
