"""The nine Table III apps through the PyTorch port, held against the JAX
reference.

Each app is built once by the reference (its DRAM images are numpy arrays
made from the builder's seed) and run by the reference's numpy oracle; the
same images then run through ``repro_torch.revet`` on ``TorchBackend("cpu")``.
DRAM outputs and ``stats`` must be equal.  Batched, replicated and served
launches are held to their sequential counterparts the same way.
"""
import numpy as np
import pytest

import repro.api as ref_api
from repro.apps import ALL_APPS as REF_APPS
from repro.core.backend import JaxBackend
from repro.core.compiler import CompileOptions as RefOptions
from repro.serve.dataflow import DataflowEngine as RefEngine
from repro.serve.dataflow import DataflowRequest as RefRequest
from repro_torch import revet
from repro_torch.apps import ALL_APPS as PORT_APPS
from repro_torch.core.backend import TorchBackend
from repro_torch.core.vector_vm import VLEN, ReplicatedVectorVM
from repro_torch.serve.dataflow import DataflowEngine, DataflowRequest

CPU = TorchBackend("cpu")


def _port_lowered(name, ref_app, **opt):
    """The port's program for ``name``, traced on the reference's images."""
    fn = PORT_APPS[name]().fn
    return revet.lower(fn, **ref_app.dram_init, **ref_app.params,
                       **ref_app.statics,
                       options=revet.CompileOptions(**opt) if opt else None)


def _ref_lowered(ref_app, **opt):
    return ref_api.lower(ref_app.fn, **ref_app.dram_init, **ref_app.params,
                         **ref_app.statics,
                         options=RefOptions(**opt) if opt else None)


def _seeded_requests(name, n):
    """``n`` reference instances of ``name`` built from distinct seeds, their
    inputs zero-padded to one shape (a string blob's trailing zeros are never
    read), and their ``(dram_init, params)`` requests.  Distinct inputs make
    a request routed to the wrong rid, lane or DRAM slice show."""
    apps = [REF_APPS[name](seed=s) for s in range(n)]
    for arr in apps[0].dram_init:
        width = max(len(a.dram_init[arr]) for a in apps)
        for a in apps:
            v = np.asarray(a.dram_init[arr])
            a.dram_init[arr] = np.concatenate(
                [v, np.zeros(width - len(v), v.dtype)])
    assert len({b"".join(v.tobytes() for v in a.dram_init.values())
                for a in apps}) == n
    return apps, [(dict(a.dram_init), dict(a.params)) for a in apps]


def _check_expected(app, dram, what):
    for arr, exp in app.expected.items():
        np.testing.assert_array_equal(dram[arr][:len(exp)], exp,
                                      err_msg=f"{what}: dram '{arr}'")


def _same_dram(got, want, what):
    assert set(got) == set(want), what
    for arr in want:
        np.testing.assert_array_equal(got[arr], want[arr],
                                      err_msg=f"{what}: dram '{arr}'")


@pytest.mark.parametrize("name", sorted(REF_APPS))
def test_app_matches_reference(name):
    ref_app = REF_APPS[name]()
    want = _ref_lowered(ref_app).compile("numpy").execute(
        dict(ref_app.dram_init), ref_app.params)
    got = _port_lowered(name, ref_app).compile(CPU).execute(
        dict(ref_app.dram_init), ref_app.params)
    assert got.report.backend == "torch[cpu]"
    _same_dram(got.dram, want.dram, name)
    assert got.vm.stats == want.vm.stats, f"{name}: stats differ"
    _check_expected(ref_app, got.dram, name)


@pytest.mark.parametrize("name", ["hash_table", "murmur3"])
def test_app_matches_reference_pallas(name):
    """The reference's Pallas-kernel route (interpret mode) on the two
    cheapest apps, as the reference's own backend tests run it."""
    ref_app = REF_APPS[name]()
    want = _ref_lowered(ref_app).compile(
        JaxBackend(route="pallas", interpret=True)).execute(
        dict(ref_app.dram_init), ref_app.params)
    got = _port_lowered(name, ref_app).compile(CPU).execute(
        dict(ref_app.dram_init), ref_app.params)
    _same_dram(got.dram, want.dram, name)
    assert got.vm.stats == want.vm.stats


@pytest.mark.parametrize("name", ["murmur3", "hash_table"])
@pytest.mark.parametrize("batch", [2, 5])
def test_execute_batch_matches_reference(name, batch):
    apps, reqs = _seeded_requests(name, batch)
    want = _ref_lowered(apps[0]).compile("numpy").execute_batch(reqs)
    got = _port_lowered(name, apps[0]).compile(CPU).execute_batch(reqs)
    assert len(got) == batch
    for rid, (g, w, a) in enumerate(zip(got, want, apps)):
        _same_dram(g.dram, w.dram, f"{name} b={batch} rid={rid}")
        _check_expected(a, g.dram, f"{name} b={batch} rid={rid}")
        assert g.report.stats == w.report.stats
    assert got.vm.stats == want.vm.stats


def test_replicated_launch_matches_reference():
    apps, reqs = _seeded_requests("murmur3", 4)
    want = _ref_lowered(apps[0], place=True).compile("numpy").execute_batch(
        reqs, replicas=3)
    got = _port_lowered("murmur3", apps[0], place=True).compile(
        CPU).execute_batch(reqs, replicas=3)
    assert isinstance(got.vm, ReplicatedVectorVM)
    assert got.vm.vlen == 3 * VLEN
    for rid, (g, w, a) in enumerate(zip(got, want, apps)):
        _same_dram(g.dram, w.dram, f"replicated rid={rid}")
        _check_expected(a, g.dram, f"replicated rid={rid}")
        assert got.vm.request_stats(rid) == want.vm.request_stats(rid)


def test_step_batch_matches_sequential_reference():
    apps, reqs = _seeded_requests("strlen", 4)
    port = DataflowEngine(_port_lowered("strlen", apps[0]).compile(CPU))
    ref = RefEngine(_ref_lowered(apps[0]).compile("numpy"))
    for rid, (dram, params) in enumerate(reqs):
        port.submit(DataflowRequest(rid, dict(params), dict(dram)))
        ref.submit(RefRequest(rid, dict(params), dict(dram)))
    got = port.step_batch(max_batch=8)
    want = ref.drain(max_batch=1)
    assert [r.rid for r in got] == [r.rid for r in want] == [0, 1, 2, 3]
    for g, w, a in zip(got, want, apps):
        _same_dram(g.dram, w.dram, f"served rid={g.rid}")
        _check_expected(a, g.dram, f"served rid={g.rid}")
