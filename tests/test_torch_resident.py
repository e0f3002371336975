"""The resident loop (``repro_torch.core.device_vm``) on the CPU port
against the numpy oracle and the reference.

Twins of ``tests/test_differential.py::test_resident_matches_oracle`` for
the Table III apps (a single request, a fused batch of 3, and the
replicated windowed triangle; DRAM and ``LANE_STATS``), the masked form
that CUDA runs held to the form that skips unready contexts (ticks
included), and twins of the reference's fallback and refusal tests
(``tests/test_device_vm.py``).  huff_dec and search, the apps with the most
ticks, run in ``test_torch_resident_huff_dec.py`` and
``test_torch_resident_search.py``; the reference's own ``DeviceProgram`` in
``test_torch_resident_reference.py``.
"""
import numpy as np
import pytest

from repro.apps import ALL_APPS as REF_APPS
from repro_torch import revet
from repro_torch.api import run_fused
from repro_torch.apps import ALL_APPS
from repro_torch.core.backend import TorchBackend
from repro_torch.core.compiler import compile_program
from repro_torch.core.device_vm import DeviceProgram, DeviceRun
from repro_torch.core.vector_vm import LANE_STATS, VectorVM

CPU = TorchBackend("cpu")
LONG = ("huff_dec", "search")          # each in a file of its own
# the seeds of tests/test_differential.py
_SEEDS = {name: 1000 + i for i, name in enumerate(sorted(REF_APPS))}


def _lane_stats(stats) -> dict:
    return {k: int(stats.get(k, 0)) for k in LANE_STATS}


def _compiled(name):
    """The reference's instance of ``name`` (its seeded DRAM images) traced
    by the port's program and compiled for ``TorchBackend("cpu")``."""
    app = REF_APPS[name](seed=_SEEDS[name])
    fn = ALL_APPS[name]().fn
    compiled = revet.lower(fn, **app.dram_init, **app.params,
                           **app.statics).compile(CPU)
    return app, compiled


def check_single(name):
    app, compiled = _compiled(name)
    ref = compiled.execute(dict(app.dram_init), app.params, backend="numpy")
    res = compiled.execute(dict(app.dram_init), app.params,
                           execution="resident")
    assert res.report.execution == "resident", \
        f"{name}: resident fell back " \
        f"({getattr(res.vm, 'resident_fallback', None)})"
    assert isinstance(res.vm, DeviceRun) and res.vm.launches == 1
    for arr in ref.dram:
        np.testing.assert_array_equal(
            res.dram[arr], ref.dram[arr],
            err_msg=f"{name}: '{arr}' resident vs windowed oracle")
    assert _lane_stats(res.report.stats) == _lane_stats(ref.vm.stats), \
        f"{name}: resident lane stats"
    assert res.report.stats["ticks"] > 0


def check_batch(name):
    """A fused batch of 3 de-interleaves to the windowed batch's images,
    with the same aggregate lane stats; the replicated windowed executor
    closes the triangle."""
    app, compiled = _compiled(name)
    reqs = [(app.dram_init, app.params)] * 3
    bw = compiled.execute_batch(reqs, backend="numpy", replicas=1)
    br = compiled.execute_batch(reqs, execution="resident")
    assert br.report.execution == "resident" and br.vm.launches == 1
    for rid, (ew, er) in enumerate(zip(bw, br)):
        for arr in ew.dram:
            np.testing.assert_array_equal(
                er.dram[arr], ew.dram[arr],
                err_msg=f"{name}: request {rid} '{arr}' resident batch")
    assert _lane_stats(br.report.stats) == _lane_stats(bw.report.stats), \
        f"{name}: resident batch aggregate lane stats"
    rw = compiled.execute_batch(reqs, backend="numpy", replicas=2)
    for rid, (ew, er) in enumerate(zip(rw, br)):
        for arr in ew.dram:
            np.testing.assert_array_equal(
                er.dram[arr], ew.dram[arr],
                err_msg=f"{name}: request {rid} '{arr}' resident vs "
                        f"replicated")


SHORT = sorted(set(REF_APPS) - set(LONG))


@pytest.mark.parametrize("name", SHORT)
def test_resident_single_matches_oracle(name):
    check_single(name)


@pytest.mark.parametrize("name", SHORT)
def test_resident_batch_matches_oracle(name):
    check_batch(name)


@pytest.mark.parametrize("name", ["murmur3", "hash_table"])
def test_masked_form_matches_skipping_form(name):
    """The form CUDA runs (every context issues every tick, its ready flag
    a mask; blocks of ticks with one flag read each) equals the form that
    skips unready contexts: DRAM and every stat, ticks included."""
    app = ALL_APPS[name]()
    g = compile_program(app.prog).dfg
    skip = DeviceProgram(g, device="cpu").run(app.dram_init, **app.params)
    masked_dp = DeviceProgram(g, device="cpu")
    masked_dp.form = "masked"
    masked = masked_dp.run(app.dram_init, **app.params)
    assert skip.replays == 0
    assert masked.replays == -(-masked.stats["ticks"] // 8)
    assert masked.host_reads == masked.replays
    for arr in skip.dram:
        np.testing.assert_array_equal(masked.dram[arr], skip.dram[arr],
                                      err_msg=f"{name}: '{arr}'")
    assert masked.stats == skip.stats


def test_bucketed_resident_batch_pads_and_matches():
    """``bucket_sizes="auto"`` pads a resident batch of 3 to 4 (the last
    request replayed) and still de-interleaves per request."""
    app, compiled = _compiled("murmur3")
    reqs = [(app.dram_init, app.params)] * 3
    vm, _ = run_fused(compiled.result, CPU, reqs, execution="resident",
                      bucket_sizes="auto")
    assert isinstance(vm, DeviceRun) and vm.n_requests == 4
    want = compiled.execute(dict(app.dram_init), app.params,
                            backend="numpy")
    for rid in range(4):
        for arr in want.dram:
            np.testing.assert_array_equal(vm.request_dram(rid)[arr],
                                          want.dram[arr])


def test_resident_programs_are_cached_per_device():
    """One compiled program run resident on two devices keeps a
    ``DeviceProgram`` for each (they share the ``CompileResult``)."""
    import torch
    from repro_torch.api import _resident_program
    app, compiled = _compiled("murmur3")
    other = TorchBackend("cpu")
    other.device = torch.device("meta")      # a second device, no data
    pools = {p: b.n_bufs for p, b in compiled.result.dfg.pools.items()}
    a = _resident_program(compiled.result, CPU, 1, pools, None)
    assert _resident_program(compiled.result, CPU, 1, pools, None) is a
    b = _resident_program(compiled.result, other, 1, pools, None)
    assert b is not a and b.device.type == "meta"


def test_dataflow_engine_serves_resident_batches():
    from repro_torch.serve.dataflow import DataflowEngine, DataflowRequest
    apps = [REF_APPS["strlen"](seed=s) for s in range(3)]
    for arr in apps[0].dram_init:
        width = max(len(a.dram_init[arr]) for a in apps)
        for a in apps:
            v = np.asarray(a.dram_init[arr])
            a.dram_init[arr] = np.concatenate(
                [v, np.zeros(width - len(v), v.dtype)])
    a0 = apps[0]
    compiled = revet.lower(ALL_APPS["strlen"]().fn, **a0.dram_init,
                           **a0.params, **a0.statics).compile(CPU)
    eng = DataflowEngine(compiled, execution="resident")
    seq = DataflowEngine(compiled, backend="numpy")
    for rid, a in enumerate(apps):
        for e in (eng, seq):
            e.submit(DataflowRequest(rid, dict(a.params), dict(a.dram_init)))
    got = eng.step_batch(max_batch=3)
    want = seq.drain(max_batch=1)
    assert [r.rid for r in got] == [0, 1, 2]
    for g, w in zip(got, want):
        assert g.report.execution == "resident"
        for arr in w.dram:
            np.testing.assert_array_equal(g.dram[arr], w.dram[arr])


def test_unsupported_reduce_falls_back_to_windowed():
    app = ALL_APPS["strlen"]()
    res = compile_program(app.prog)
    red_outs = [o for c in res.dfg.contexts.values() for o in c.outs
                if o.kind == "reduce"]
    assert red_outs, "strlen should carry a reduce output"
    orig = red_outs[0].reduce_op
    red_outs[0].reduce_op = "xor"
    try:
        with pytest.raises(Exception, match="xor"):
            DeviceProgram(res.dfg, device="cpu")
        vm, _wall = run_fused(res, CPU, [(dict(app.dram_init),
                                          dict(app.params))],
                              execution="resident")
        assert isinstance(vm, VectorVM), "fallback must be the windowed VM"
        assert vm.resident_fallback and "xor" in vm.resident_fallback
    finally:
        red_outs[0].reduce_op = orig


def test_resident_on_numpy_backend_raises():
    app = ALL_APPS["murmur3"]()
    res = compile_program(app.prog)
    with pytest.raises(ValueError, match="resident") as err:
        run_fused(res, "numpy", [(dict(app.dram_init), dict(app.params))],
                  execution="resident")
    assert "jax" not in str(err.value)


def test_resident_program_needs_a_card_unless_told_cpu(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = compile_program(ALL_APPS["murmur3"]().prog).dfg
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceProgram(g)
    assert DeviceProgram(g, device="cpu").form == "skip"
