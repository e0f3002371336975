"""The port's training stack against the JAX reference, on the CPU: AdamW,
int8 gradient compression, the data pipeline and the train driver.

Same inputs (numpy, from a seed) through the reference and the port.
AdamW agrees within 1e-6 relative: the metrics, and every leaf within 1e-6
of its largest magnitude (float32 element-wise in another order of
evaluation, which XLA contracts into FMAs; an update that cancels to near
zero keeps only the absolute error); compression's payload, scale and error state, and the
pipeline's batches, bit for bit.  Then the twins of the reference's own
tests (``tests/test_distributed.py``'s optimizer, compression and data
tests, ``tests/test_launch.py``'s driver tests) on ``device="cpu"``, and a
checkpoint of the port's driver read by the reference's ``ckpt.restore``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as ref_ckpt
from repro.configs import get_reduced as ref_get_reduced
from repro.data import pipeline as ref_pipeline
from repro.models.zoo import get_model as ref_get_model
from repro.optim import adamw as ref_adamw
from repro.optim import compression as ref_compression
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.pipeline import DataConfig, Pipeline
from repro_torch.launch import train
from repro_torch.models.params import from_numpy, leaves
from repro_torch.models.zoo import get_model
from repro_torch.optim import adamw, compression

ADAMW_RTOL = 1e-6


def _tree_np(rng, dtype=np.float32):
    """A nested tree of random arrays: stacked and flat leaves."""
    return {"layers": {"w": rng.standard_normal((3, 8, 5)).astype(dtype),
                       "b": rng.standard_normal((3, 5)).astype(dtype)},
            "embed": {"tok": rng.standard_normal((11, 8)).astype(dtype)},
            "ln_f": {"w": (1 + rng.standard_normal(8) / 10).astype(dtype)}}


def _bits(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    a = t.numpy()
    return a.view(f"u{a.itemsize}") if a.dtype.kind == "f" else a


def _ref_bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(f"u{a.itemsize}") if a.dtype.kind == "f" or \
        a.dtype.name == "bfloat16" else a


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def test_adamw_matches_reference():
    """Five steps of ``apply`` on one random float32 tree with random
    grads (the third clipped), the schedule across warmup and decay, and
    ``global_norm``: within 1e-6 relative of the reference's (each leaf:
    1e-6 of its largest magnitude)."""
    rng = np.random.default_rng(0)
    params = _tree_np(rng)
    cfg = adamw.OptConfig(lr=3e-2, warmup_steps=2, total_steps=5,
                          weight_decay=0.1, clip_norm=5.0)
    rcfg = ref_adamw.OptConfig(**dataclasses.asdict(cfg))
    tp = from_numpy(params, "cpu")
    rp = jax.tree.map(jnp.asarray, params)
    ts, rs = adamw.init_state(tp), ref_adamw.init_state(rp)
    assert ts["step"].dtype == torch.int32 and ts["step"].shape == ()
    assert all(m.dtype == torch.float32 for m in leaves(ts["m"]))
    for i in range(5):
        g = jax.tree.map(lambda a: a * (10.0 if i == 2 else 0.5),
                         _tree_np(rng))
        want_n = ref_adamw.global_norm(g)
        got_n = adamw.global_norm(from_numpy(g, "cpu"))
        np.testing.assert_allclose(float(got_n), float(want_n),
                                   rtol=ADAMW_RTOL)
        rp, rs, rmet = ref_adamw.apply(rp, jax.tree.map(jnp.asarray, g), rs,
                                       rcfg)
        tp, ts, tmet = adamw.apply(tp, from_numpy(g, "cpu"), ts, cfg)
        for key in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(tmet[key]), float(rmet[key]),
                                       rtol=ADAMW_RTOL)
        for got, want in zip(leaves(tp) + leaves(ts["m"]) + leaves(ts["v"]),
                             jax.tree.leaves(rp) + jax.tree.leaves(rs["m"])
                             + jax.tree.leaves(rs["v"])):
            want = np.asarray(want)
            np.testing.assert_allclose(
                got.numpy(), want, rtol=0,
                atol=ADAMW_RTOL * float(np.abs(want).max()))
        assert int(ts["step"]) == int(rs["step"]) == i + 1
    for step in range(7):
        s = np.int32(step)
        np.testing.assert_allclose(
            float(adamw.schedule(cfg, torch.tensor(s))),
            float(ref_adamw.schedule(rcfg, jnp.asarray(s))), rtol=ADAMW_RTOL)


def test_adamw_keeps_dtypes_and_mutates_nothing():
    """bf16 params stay bf16; the inputs of ``apply`` are unchanged."""
    rng = np.random.default_rng(1)
    tp = {k: v.to(torch.bfloat16) for k, v in
          from_numpy({"a": rng.standard_normal((4, 4)).astype(np.float32),
                      "b": rng.standard_normal(4).astype(np.float32)},
                     "cpu").items()}
    g = {k: torch.ones_like(v) for k, v in tp.items()}
    st = adamw.init_state(tp)
    copies = [t.clone() for t in leaves(tp) + leaves(g) + leaves(st["m"])]
    new, st2, _ = adamw.apply(tp, g, st, adamw.OptConfig(lr=0.1,
                                                         warmup_steps=1))
    assert all(n.dtype == torch.bfloat16 for n in leaves(new))
    assert all(torch.equal(a, b) for a, b in
               zip(copies, leaves(tp) + leaves(g) + leaves(st["m"])))
    assert int(st["step"]) == 0 and int(st2["step"]) == 1
    assert not torch.equal(new["a"], tp["a"])


def test_adamw_converges_quadratic():
    """Twin of ``tests/test_distributed.py::test_adamw_converges_quadratic``."""
    params = {"w": torch.ones(8)}
    cfg = adamw.OptConfig(lr=0.1, warmup_steps=5, total_steps=200,
                          weight_decay=0.0)
    state = adamw.init_state(params)

    def loss(p):
        return torch.sum((p["w"] - 3.0) ** 2)

    for _ in range(200):
        w = params["w"].detach().requires_grad_()
        (g,) = torch.autograd.grad(loss({"w": w}), [w])
        params, state, _ = adamw.apply(params, {"w": g}, state, cfg)
    assert float(loss(params)) < 1e-2


def test_adamw_trains_tiny_model():
    """Twin of ``tests/test_distributed.py::test_adamw_trains_tiny_model``:
    reduced qwen2-0.5b (bf16), one batch, 15 steps on the naive route."""
    zoo = get_model(get_reduced("qwen2-0.5b"))
    params = zoo.init_params(0, device="cpu")
    batch = zoo.make_batch(ShapeConfig("s", 16, 2, "train"), seed=0,
                           device="cpu")
    ocfg = adamw.OptConfig(lr=5e-3, warmup_steps=2, total_steps=30)
    state = adamw.init_state(params)
    losses = []
    for _ in range(15):
        l, g = train.loss_and_grads(zoo, params, batch, "naive")
        params, state, _ = adamw.apply(params, g, state, ocfg)
        losses.append(float(l))
    assert losses[-1] < losses[0], f"no learning: {losses[0]} -> {losses[-1]}"


# ---------------------------------------------------------------------------
# int8 compression
# ---------------------------------------------------------------------------

def test_compression_matches_reference_bit_for_bit():
    """Six steps of error feedback over a tree of float32 and bf16 grads
    (one leaf of zeros, one of a single outlier): ``compress``'s payload
    and scale, ``roundtrip_tree``'s dequantized grads and error state, bit
    for bit, every step."""
    rng = np.random.default_rng(2)
    g32 = _tree_np(rng)
    g32["embed"]["zero"] = np.zeros((4, 3), np.float32)
    g32["ln_f"]["spike"] = np.where(np.arange(16) == 5, 1e3,
                                    rng.standard_normal(16)).astype(
        np.float32)
    rg = jax.tree.map(jnp.asarray, g32)
    rg["layers"]["w"] = rg["layers"]["w"].astype(jnp.bfloat16)
    tg = from_numpy(jax.tree.map(np.asarray, rg), "cpu")
    assert tg["layers"]["w"].dtype == torch.bfloat16
    rerr, terr = ref_compression.init_error_state(rg), \
        compression.init_error_state(tg)
    rerr2, terr2 = rerr, terr
    for step in range(6):
        rq, rerr = ref_compression.compress_tree(rg, rerr)
        tq, terr = compression.compress_tree(tg, terr)
        rflat = jax.tree.leaves(rq)          # payload, scale, payload, ...
        tflat = [x for pair in leaves(tq) for x in pair]
        assert len(rflat) == len(tflat)
        for got, want in zip(tflat, rflat):
            assert got.dtype in (torch.int8, torch.float32)
            np.testing.assert_array_equal(_bits(got), _ref_bits(want))
        for got, want in zip(leaves(terr), jax.tree.leaves(rerr)):
            np.testing.assert_array_equal(_bits(got), _ref_bits(want))
        rdq, rerr2 = ref_compression.roundtrip_tree(rg, rerr2)
        tdq, terr2 = compression.roundtrip_tree(tg, terr2)
        for got, want in zip(leaves(tdq) + leaves(terr2),
                             jax.tree.leaves(rdq) + jax.tree.leaves(rerr2)):
            np.testing.assert_array_equal(_bits(got), _ref_bits(want))
        # the next step's grads: new numbers, same tree
        rg = jax.tree.map(lambda a: (a * 0.7 + 0.01 * step).astype(a.dtype),
                          rg)
        tg = from_numpy(jax.tree.map(np.asarray, rg), "cpu")


def test_int8_error_feedback_is_unbiased_over_time():
    """Twin of the reference's test of the same name."""
    rng = np.random.default_rng(0)
    g_true = {"w": torch.from_numpy(rng.standard_normal(64).astype(
        np.float32))}
    err = compression.init_error_state(g_true)
    acc = np.zeros(64)
    n = 200
    for _ in range(n):
        deq, err = compression.roundtrip_tree(g_true, err)
        acc += deq["w"].numpy()
    np.testing.assert_allclose(acc / n, g_true["w"].numpy(), atol=2e-2)


def test_int8_compression_ratio():
    """Twin of ``test_int8_compression_ratio``: the payload is int8."""
    g = {"w": torch.ones((256, 256))}
    q, _ = compression.compress_tree(g, compression.init_error_state(g))
    payload, scale = q["w"]
    assert payload.dtype == torch.int8 and scale.dtype == torch.float32
    assert payload.element_size() * 4 == g["w"].element_size()


# ---------------------------------------------------------------------------
# the data pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_hosts,seq,mean_doc", [(1, 128, 512), (4, 64, 16)])
def test_pipeline_matches_reference(n_hosts, seq, mean_doc):
    """Every host's batch of several steps, and the global batch, equal to
    the reference's; ``batch`` puts the same int32 tokens on the device."""
    kw = dict(vocab=1000, seq_len=seq, global_batch=8, n_hosts=n_hosts,
              mean_doc_len=mean_doc)
    for host in range(n_hosts):
        p = Pipeline(DataConfig(**kw), host_id=host)
        r = ref_pipeline.Pipeline(ref_pipeline.DataConfig(**kw),
                                  host_id=host)
        for step in (0, 3, 17):
            want = r.local_batch_np(step)
            got = p.local_batch_np(step)
            assert got.dtype == want.dtype == np.int32
            np.testing.assert_array_equal(got, want)
            t = p.batch(step, device="cpu")["tokens"]
            assert t.dtype == torch.int32
            np.testing.assert_array_equal(t.numpy(),
                                          np.asarray(r.batch(step)["tokens"]))
    np.testing.assert_array_equal(p.global_batch_np(5), r.global_batch_np(5))


def test_data_determinism_and_host_disjointness():
    """Twin of ``tests/test_distributed.py`` (data determinism)."""
    cfg = DataConfig(vocab=1000, seq_len=64, global_batch=8, n_hosts=4)
    p0 = Pipeline(cfg, host_id=0)
    p0b = Pipeline(cfg, host_id=0)
    p1 = Pipeline(cfg, host_id=1)
    np.testing.assert_array_equal(p0.local_batch_np(3), p0b.local_batch_np(3))
    assert not np.array_equal(p0.local_batch_np(3), p1.local_batch_np(3))
    assert not np.array_equal(p0.local_batch_np(3), p0.local_batch_np(4))
    assert p0.global_batch_np(0).shape == (8, 64)


# ---------------------------------------------------------------------------
# the train driver
# ---------------------------------------------------------------------------

def test_train_driver_with_compression(tmp_path, capsys):
    """Twin of ``tests/test_launch.py::test_train_driver_with_compression``
    on the CPU, and its print lines."""
    out = train.main([
        "--arch", "qwen2-0.5b", "--preset", "reduced", "--steps", "8",
        "--batch", "2", "--seq", "32", "--grad-compression", "int8",
        "--ckpt-dir", str(tmp_path), "--log-every", "4"], device="cpu")
    assert len(out["losses"]) == 8
    assert all(np.isfinite(l) for l in out["losses"])
    assert set(out) == {"losses", "restarts", "stopped", "tok_s"}
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[1] for ln in lines if ln.startswith("step")] == \
        ["0", "4"]
    assert any(ln.startswith("done: 8 steps") for ln in lines)


def test_train_driver_fault_restart(tmp_path):
    """Twin of ``tests/test_launch.py::test_train_driver_fault_restart`` on
    the CPU, and more: the steps replayed after the restart give the losses
    of an uninterrupted run, bit for bit."""
    argv = ["--arch", "qwen2-0.5b", "--preset", "reduced", "--steps", "10",
            "--batch", "2", "--seq", "32", "--ckpt-every", "4",
            "--log-every", "100"]
    out = train.main(argv + ["--ckpt-dir", str(tmp_path / "a"),
                             "--simulate-fault", "6"], device="cpu")
    assert out["restarts"] == 1
    assert out["stopped"] == 10
    clean = train.main(argv + ["--ckpt-dir", str(tmp_path / "b")],
                       device="cpu")
    assert len(out["losses"]) == 12 and len(clean["losses"]) == 10
    assert out["losses"][:6] == clean["losses"][:6]
    assert out["losses"][6:] == clean["losses"][4:]


def test_port_checkpoint_restores_in_reference(tmp_path):
    """The driver's last checkpoint (params, AdamW state and the error
    state, bf16 included) loads in the reference's ``ckpt.restore`` into
    the reference's own state tree, equal to the port's restore."""
    train.main(["--arch", "qwen2-0.5b", "--preset", "reduced", "--steps",
                "3", "--batch", "2", "--seq", "16", "--grad-compression",
                "int8", "--ckpt-dir", str(tmp_path), "--log-every", "100"],
               device="cpu")
    step = ckpt.latest_step(str(tmp_path))
    assert step == 3 and ref_ckpt.latest_step(str(tmp_path)) == 3
    rp = ref_get_model(ref_get_reduced("qwen2-0.5b")).init_params(0)
    like = {"params": rp, "opt": ref_adamw.init_state(rp),
            "err": ref_compression.init_error_state(rp)}
    want = ref_ckpt.restore(str(tmp_path), step, like)
    tp = get_model(get_reduced("qwen2-0.5b")).init_params(0, device="cpu")
    tlike = {"params": tp, "opt": adamw.init_state(tp),
             "err": compression.init_error_state(tp)}
    got = ckpt.restore(str(tmp_path), step, tlike, "cpu")
    assert int(want["opt"]["step"]) == int(got["opt"]["step"]) == 3
    wl, gl = jax.tree.leaves(want), leaves(got["err"]) + leaves(
        got["opt"]["m"]) + [got["opt"]["step"]] + leaves(
        got["opt"]["v"]) + leaves(got["params"])
    assert len(wl) == len(gl)
    for w, g in zip(wl, gl):
        assert np.asarray(w).dtype == (ml_dtypes.bfloat16 if g.dtype ==
                                       torch.bfloat16 else
                                       g.numpy().dtype)
        np.testing.assert_array_equal(_bits(g), _ref_bits(w))
    # the trained params moved off their init
    assert not torch.equal(got["params"]["layers"]["mlp"]["wd"],
                           tp["layers"]["mlp"]["wd"])
