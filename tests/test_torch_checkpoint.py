"""The port's checkpoint (``repro_torch.checkpoint.ckpt``) and training
supervisor (``repro_torch.distributed.fault_tolerance``), on the CPU.

Twins of ``tests/test_distributed.py``'s checkpoint and fault-tolerance
tests (round trip, retention, restart from a checkpoint, preemption,
straggler detection) on trees of torch tensors, and checkpoints crossing
between the two packages in both directions: a tree of float32, int32 and
bfloat16 leaves in nested dicts, lists and tuples, with equal leaf paths
and bit-equal values.
"""
import json
import os

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as ref_ckpt
from repro_torch.checkpoint import ckpt
from repro_torch.distributed.fault_tolerance import (
    LaunchSupervisor, PreemptionGuard, SimulatedFault, StragglerMonitor,
    Supervisor)


def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(12.0).reshape(3, 4),
            "b": {"c": torch.ones(5, dtype=torch.int32)}}
    ckpt.save(str(tmp_path), 7, tree)
    assert ckpt.latest_step(str(tmp_path)) == 7
    out = ckpt.restore(str(tmp_path), 7, tree, "cpu")
    assert torch.equal(out["a"], tree["a"])
    assert torch.equal(out["b"]["c"], tree["b"]["c"])
    assert out["b"]["c"].dtype == torch.int32


def test_checkpoint_retention(tmp_path):
    tree = {"a": torch.zeros(2)}
    for s in (1, 2, 3, 4, 5):
        ckpt.save(str(tmp_path), s, tree, keep=2)
    kept = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert kept == ["step_00000004", "step_00000005"]
    assert not [d for d in os.listdir(tmp_path) if d.startswith(".tmp_")]


def test_restore_checks_leaves_and_shapes(tmp_path):
    ckpt.save(str(tmp_path), 1, {"a": torch.zeros(2)})
    with pytest.raises(KeyError, match="missing leaf 'b'"):
        ckpt.restore(str(tmp_path), 1, {"b": torch.zeros(2)}, "cpu")
    with pytest.raises(ValueError, match="leaf 'a'"):
        ckpt.restore(str(tmp_path), 1, {"a": torch.zeros(3)}, "cpu")


def test_restore_defaults_to_the_card(tmp_path, monkeypatch):
    ckpt.save(str(tmp_path), 1, {"a": torch.zeros(2)})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ckpt.restore(str(tmp_path), 1, {"a": torch.zeros(2)})
    # a tree of devices places leaf by leaf
    out = ckpt.restore(str(tmp_path), 1, {"a": torch.zeros(2)},
                       {"a": "cpu"})
    assert out["a"].device.type == "cpu"


def _step_fn(fault_at=None):
    def step_fn(state, step):
        if fault_at is not None and step == fault_at and not step_fn.fired:
            step_fn.fired = True
            raise SimulatedFault("chaos")
        return {"x": state["x"] + step}
    step_fn.fired = False
    return step_fn


def test_supervisor_restarts_from_checkpoint(tmp_path):
    """A fault mid-run replays from the last checkpoint and converges to
    the fault-free run's state (exactly-once semantics)."""
    clean = Supervisor(str(tmp_path / "clean"), ckpt_every=5)
    s_clean, _ = clean.run({"x": torch.zeros(())}, _step_fn(None), 20,
                           devices="cpu")
    faulty = Supervisor(str(tmp_path / "faulty"), ckpt_every=5)
    s_faulty, _ = faulty.run({"x": torch.zeros(())}, _step_fn(13), 20,
                             devices="cpu")
    assert faulty.restarts == 1
    assert float(s_faulty["x"]) == float(s_clean["x"]) == float(sum(range(20)))
    assert any("fault at step 13" in m for m in faulty.log)


def test_supervisor_resumes_a_later_checkpoint(tmp_path):
    first = Supervisor(str(tmp_path), ckpt_every=4)
    first.run({"x": torch.zeros(())}, _step_fn(None), 8, devices="cpu")
    again = Supervisor(str(tmp_path), ckpt_every=4)
    state, step = again.run({"x": torch.zeros(())}, _step_fn(None), 12,
                            devices="cpu")
    assert again.log[0] == "resumed from step 8" and step == 12
    assert float(state["x"]) == float(sum(range(12)))


def test_preemption_guard(tmp_path):
    flag = tmp_path / "preempt.flag"
    sup = Supervisor(str(tmp_path / "ck"), ckpt_every=100,
                     preemption=PreemptionGuard(str(flag)))

    def step_fn(state, step):
        if step == 3:
            flag.write_text("drain")
        return {"x": state["x"] + 1}

    state, stopped_at = sup.run({"x": torch.zeros(())}, step_fn, 100,
                                devices="cpu")
    assert stopped_at == 4                      # stopped early
    assert ckpt.latest_step(str(tmp_path / "ck")) == 4


def test_straggler_monitor():
    mon = StragglerMonitor(window=20, threshold=4.0)
    for i in range(20):
        assert not mon.record(i, 0.10 + 0.001 * (i % 3))
    assert mon.record(21, 0.50)                 # 5x median -> flagged
    assert mon.flagged and mon.flagged[0][0] == 21


def test_launch_supervisor_replays_and_degrades():
    sup = LaunchSupervisor(max_retries=1, degrade_after=2)

    def flaky(attempt):
        if attempt == 0:
            raise SimulatedFault("lost")
        return attempt

    assert sup.run(flaky, mode="resident") == 1
    assert (sup.retries, sup.failures, sup.degraded) == (1, 1, False)
    with pytest.raises(SimulatedFault):
        sup.run(lambda attempt: (_ for _ in ()).throw(SimulatedFault("x")),
                mode="resident")
    assert sup.degraded and sup.mode_failures == {"resident": 3}


# ---------------------------------------------------------------------------
# checkpoints cross between the packages
# ---------------------------------------------------------------------------

def _tree_np(seed=0):
    """Nested dicts, lists and a tuple of float32, int32 and bfloat16."""
    rng = np.random.default_rng(seed)
    bf = rng.standard_normal((3, 5)).astype(ml_dtypes.bfloat16)
    return {
        "w": rng.standard_normal((4, 6)).astype(np.float32),
        "layers": [{"k": rng.integers(-9, 9, (2, 3)).astype(np.int32),
                    "scale": bf},
                   {"k": rng.integers(-9, 9, (2, 3)).astype(np.int32),
                    "scale": bf[::-1].copy()}],
        "opt": ({"m": rng.standard_normal(7).astype(np.float32)},
                np.asarray(rng.standard_normal(()), np.float32)),
        "b10": rng.standard_normal(2).astype(np.float32),
    }


def _to_torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _bits(x) -> np.ndarray:
    """Raw bits of a torch tensor or a (jax/numpy) array, as numpy."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype == ml_dtypes.bfloat16 else a


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _manifest_paths(path):
    with open(os.path.join(path, "manifest.json")) as f:
        return [(e["path"], e["dtype"], e["shape"])
                for e in json.load(f)["leaves"]]


def test_reference_checkpoint_restores_in_port(tmp_path):
    tree = _tree_np()
    ref_tree = _map(jnp.asarray, tree)
    d = ref_ckpt.save(str(tmp_path), 3, ref_tree)
    port_tree = _map(_to_torch, tree)
    paths, leaves = ckpt._flatten_with_paths(port_tree)
    assert [p for p, _, _ in _manifest_paths(d)] == paths
    assert "layers/1/scale" in paths and "opt/1" in paths
    like = _map(torch.zeros_like, port_tree)
    out = ckpt.restore(str(tmp_path), 3, like, "cpu")
    assert ckpt._flatten_with_paths(out)[0] == paths
    for got, want in zip(ckpt._flatten_with_paths(out)[1], leaves):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(_bits(got), _bits(want))
    assert isinstance(out["opt"], tuple)


def test_port_checkpoint_restores_in_reference(tmp_path):
    tree = _tree_np(1)
    d = ckpt.save(str(tmp_path), 5, _map(_to_torch, tree))
    ref_tree = _map(jnp.asarray, tree)
    ref_paths = ref_ckpt._flatten_with_paths(ref_tree)[0]
    assert [p for p, _, _ in _manifest_paths(d)] == ref_paths
    assert {dt for _, dt, _ in _manifest_paths(d)} == \
        {"float32", "int32", "bfloat16"}
    like = _map(jnp.zeros_like, ref_tree)
    out = ref_ckpt.restore(str(tmp_path), 5, like)
    got = ref_ckpt._flatten_with_paths(out)[1]
    want = ref_ckpt._flatten_with_paths(ref_tree)[1]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(_bits(g), _bits(w))


def test_bfloat16_restores_into_float32(tmp_path):
    """``restore`` casts to the ``like`` leaf's dtype, as the reference's
    ``astype`` does."""
    bf = np.array([1.5, -2.25, 3.0], ml_dtypes.bfloat16)
    ref_ckpt.save(str(tmp_path), 1, {"a": jnp.asarray(bf)})
    out = ckpt.restore(str(tmp_path), 1, {"a": torch.zeros(3)}, "cpu")
    assert out["a"].dtype == torch.float32
    assert out["a"].tolist() == [1.5, -2.25, 3.0]
