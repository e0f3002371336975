"""The port's dense-LM serving path against the JAX reference, on the CPU.

Same inputs (numpy, from a seed) through the reference function and its
port; the reference's Pallas kernels run as the reference's own tests run
them here (interpret mode).  Sizes: reduced qwen2-0.5b (2 layers, d 64,
head dim 16, vocab 512); the float32 logits also on reduced
starcoder2-7b and phi3-mini-3.8b.

Tolerances: float32 2e-5 and bfloat16 2e-2 for the attention kernels (the
reference's kernel tests, ``tests/test_kernels.py``: the sums run in
another order, and bfloat16 rounds the output); float32 model logits 1e-4
(two layers of float32 matmuls in another order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import get_reduced as ref_get_reduced
from repro.kernels import decode_attention as ref_dec
from repro.kernels import flash_attention as ref_fa
from repro.kernels import ops as ref_ops
from repro.launch import serve as ref_launch_serve
from repro.models import layers as ref_layers
from repro.models import transformer as ref_tf
from repro.models.zoo import get_model as ref_get_model
from repro.serve import engine as ref_engine
from repro_torch.configs import get_config, get_reduced
from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.launch import serve as launch_serve
from repro_torch.models import layers, params as tparams, transformer
from repro_torch.models.zoo import get_model
from repro_torch.serve import engine

ARCH = "qwen2-0.5b"
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# bf16 model logits: every matmul output is rounded to bfloat16 (8 bits),
# and the two frameworks sum in other orders, so a hidden value can land
# one rounding step (2^-8 relative) apart and carry through two layers; the
# logits are |x| <= ~2 here, so 3e-2 is a few bf16 steps.
BF16_LOGIT_TOL = 3e-2


def _np(x) -> np.ndarray:
    return np.asarray(x, np.float32)


def _t(a: np.ndarray, dtype: str = "float32") -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(TORCH[dtype])


def _j(a: np.ndarray, dtype: str = "float32"):
    return jnp.asarray(np.asarray(a, np.float32), JNP[dtype])


def _close(got: torch.Tensor, want, tol: float) -> None:
    np.testing.assert_allclose(got.float().numpy(), _np(want), atol=tol,
                               rtol=tol)


@pytest.fixture(scope="module")
def reduced():
    """(port cfg, reference cfg, port params, reference params), bf16."""
    cfg, rcfg = get_reduced(ARCH), ref_get_reduced(ARCH)
    rp = ref_get_model(rcfg).init_params(0)
    return cfg, rcfg, get_model(cfg).init_params(0, device="cpu"), rp


def _reduced32(arch):
    cfg = dataclasses.replace(get_reduced(arch), param_dtype="float32")
    rcfg = dataclasses.replace(ref_get_reduced(arch), param_dtype="float32")
    rp = ref_get_model(rcfg).init_params(0)
    return cfg, rcfg, get_model(cfg).init_params(0, device="cpu"), rp


@pytest.fixture(scope="module")
def reduced32():
    return _reduced32(ARCH)


@pytest.fixture(scope="module")
def dense32(request):
    """``reduced32`` of the dense config ``request.param``."""
    return _reduced32(request.param)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def test_params_bit_identical_to_reference(reduced):
    cfg, _, tp, rp = reduced
    got, want = tparams.leaves(tp), jax.tree.leaves(rp)
    assert len(got) == len(want) == 14
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape and g.dtype == torch.bfloat16
        np.testing.assert_array_equal(g.view(torch.int16).numpy(),
                                      w.view(np.int16))


def test_from_numpy_carries_reference_params(reduced):
    _, _, tp, rp = reduced
    moved = tparams.from_numpy(jax.tree.map(np.asarray, rp), device="cpu")
    for g, w in zip(tparams.leaves(moved), tparams.leaves(tp)):
        assert g.dtype == w.dtype and torch.equal(g, w)
    f32 = tparams.from_numpy({"a": np.arange(6, dtype=np.float32)}, "cpu")
    assert f32["a"].dtype == torch.float32
    bf = np.array([1.5, -2.0], dtype=ml_dtypes.bfloat16)
    assert tparams.from_numpy({"a": bf}, "cpu")["a"].tolist() == [1.5, -2.0]


def test_n_params_full_config():
    port = get_model(get_config(ARCH)).n_params()
    assert port == ref_get_model(ref_get_config(ARCH)).n_params() == 494147456


def test_entry_points_default_to_the_card(monkeypatch, reduced):
    cfg, _, tp, _ = reduced
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    zoo = get_model(cfg)
    for make in (lambda: zoo.init_params(0),
                 lambda: zoo.init_cache(2, 8),
                 lambda: tparams.from_numpy({"a": np.zeros(2)}),
                 lambda: engine.DecodeEngine(zoo, tp, 2, 8),
                 lambda: launch_serve.main(["--requests", "1"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


# ---------------------------------------------------------------------------
# attention kernels: plain versions against the reference kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bh,s,d", [(2, 128, 64), (1, 256, 128), (4, 128, 32)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_reference_kernel(bh, s, d, causal, dtype):
    rng = np.random.default_rng(bh * s + d)
    q, k, v = (rng.standard_normal((bh, s, d)) for _ in range(3))
    want = ref_fa.flash_attention(_j(q, dtype), _j(k, dtype), _j(v, dtype),
                                  causal=causal, block_q=64, block_k=64)
    got = fa.flash_attention(_t(q, dtype), _t(k, dtype), _t(v, dtype),
                             causal=causal)
    assert got.dtype == TORCH[dtype]
    _close(got, want, TOL[dtype])


def test_flash_plain_matches_reference_kernel_sq_ne_skv():
    """Sq != Skv, causal: both mask top-left (k <= q), unlike the oracle."""
    rng = np.random.default_rng(7)
    q = rng.standard_normal((2, 64, 32))
    k, v = (rng.standard_normal((2, 192, 32)) for _ in range(2))
    want = ref_fa.flash_attention(_j(q), _j(k), _j(v), causal=True,
                                  block_q=64, block_k=64)
    _close(fa.flash_attention(_t(q), _t(k), _t(v)), want, TOL["float32"])
    # the bottom-right oracle differs here, and the port's oracle with it
    oracle = ref.attention_ref(_t(q), _t(k), _t(v), causal=True)
    assert not np.allclose(oracle.numpy(), _np(want), atol=1e-3)


@pytest.mark.parametrize("bh,s,d", [(2, 256, 64), (3, 512, 32)])
def test_decode_plain_matches_reference_kernel(bh, s, d):
    rng = np.random.default_rng(9)
    q = rng.standard_normal((bh, 1, d))
    k, v = (rng.standard_normal((bh, s, d)) for _ in range(2))
    lengths = rng.integers(1, s, bh)
    want = ref_dec.decode_attention(_j(q), _j(k), _j(v), jnp.asarray(lengths),
                                    block_k=128)
    got = dec.decode_attention(_t(q), _t(k), _t(v),
                               torch.from_numpy(lengths.astype(np.int32)))
    _close(got, want, TOL["float32"])


def test_decode_plain_masks_every_key_like_the_reference():
    """A length of 0 scores every key -1e30: uniform weights over S."""
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 1, 16))
    k, v = (rng.standard_normal((2, 128, 16)) for _ in range(2))
    lengths = np.array([0, 300])
    want = ref_dec.decode_attention(_j(q), _j(k), _j(v), jnp.asarray(lengths),
                                    block_k=128)
    got = dec.decode_attention(_t(q), _t(k), _t(v),
                               torch.from_numpy(lengths.astype(np.int32)))
    _close(got, want, TOL["float32"])


def test_attention_ref_matches_reference_oracle():
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 32, 16))
    k, v = (rng.standard_normal((2, 48, 16)) for _ in range(2))
    lengths = np.array([10, 48])
    for causal in (True, False):
        for ln in (None, lengths):
            want = ref_ops._ref.attention_ref(
                _j(q), _j(k), _j(v), causal=causal,
                lengths=None if ln is None else jnp.asarray(ln))
            got = ref.attention_ref(
                _t(q), _t(k), _t(v), causal=causal,
                lengths=None if ln is None else torch.from_numpy(ln))
            _close(got, want, 2e-5)


# ---------------------------------------------------------------------------
# ops.mha / ops.decode_mha on every port impl
# ---------------------------------------------------------------------------

MHA_SHAPES = [((2, 8, 64, 32), (2, 2, 64, 32)),      # GQA, 4 q heads per kv
              ((1, 4, 48, 16), (1, 4, 48, 16))]      # MHA, ragged block


_REF_OUT: dict = {}     # reference outputs, computed once per input


def _ref_once(key, fn):
    if key not in _REF_OUT:
        _REF_OUT[key] = _np(fn())
    return _REF_OUT[key]


@pytest.mark.parametrize("impl", ["kernel", "chunked", "ref"])
@pytest.mark.parametrize("shape", [0, 1])
@pytest.mark.parametrize("causal", [True, False])
def test_mha_matches_reference(impl, shape, causal):
    qs, ks = MHA_SHAPES[shape]
    rng = np.random.default_rng(3)
    q = rng.standard_normal(qs)
    k, v = rng.standard_normal(ks), rng.standard_normal(ks)
    got = ops.mha(_t(q), _t(k), _t(v), causal=causal, impl=impl)
    for ref_impl in ("ref", "chunked", "pallas"):
        if ref_impl == "pallas" and qs[2] % 64:
            continue        # the reference kernel takes whole blocks only
        want = _ref_once(("mha", shape, causal, ref_impl), lambda: ref_ops.mha(
            _j(q), _j(k), _j(v), causal=causal, impl=ref_impl))
        _close(got, want, 2e-5)


@pytest.mark.parametrize("impl", ["kernel", "chunked", "ref"])
def test_decode_mha_matches_reference(impl):
    rng = np.random.default_rng(8)
    q = rng.standard_normal((2, 8, 1, 32))
    k, v = (rng.standard_normal((2, 2, 512, 32)) for _ in range(2))
    lengths = np.array([5, 512])
    got = ops.decode_mha(_t(q), _t(k), _t(v), torch.from_numpy(lengths),
                         impl=impl)
    for ref_impl in ("ref", "pallas"):
        want = _ref_once(("decode", ref_impl), lambda: ref_ops.decode_mha(
            _j(q), _j(k), _j(v), jnp.asarray(lengths), impl=ref_impl))
        _close(got, want, 2e-5)


def test_chunked_attention_matches_reference():
    rng = np.random.default_rng(0)
    q = rng.standard_normal((2, 64, 32))
    k, v = (rng.standard_normal((2, 256, 32)) for _ in range(2))
    want = ref_ops.chunked_attention(_j(q), _j(k), _j(v), True, 64)
    _close(ops.chunked_attention(_t(q), _t(k), _t(v), True, 64), want, 2e-5)


def test_unknown_attention_impl_raises():
    x = torch.zeros(1, 2, 4, 16)
    with pytest.raises(ValueError, match="'kernel' here"):
        ops.mha(x, x, x, impl="pallas")


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_layers_match_reference(reduced32):
    cfg, rcfg, tp, rp = reduced32
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 12, cfg.d_model))
    w = rng.standard_normal(cfg.d_model)
    _close(layers.rms_norm(_t(x), _t(w)), ref_layers.rms_norm(_j(x), _j(w)),
           1e-5)
    xr = rng.standard_normal((2, 3, 12, cfg.hd))
    pos = rng.integers(0, 1000, (2, 12))
    _close(layers.rope(_t(xr), torch.from_numpy(pos), cfg.rope_theta),
           ref_layers.rope(_j(xr), jnp.asarray(pos), rcfg.rope_theta), 1e-4)
    lp = transformer.layer_params(tp, 1)
    rlp = jax.tree.map(lambda a: a[1], rp["layers"])
    positions = np.tile(np.arange(12), (2, 1))
    for impl, rimpl in (("kernel", "pallas"), ("chunked", "chunked"),
                        ("naive", "naive")):
        got, (gk, gv) = layers.attention(lp["attn"], _t(x), cfg,
                                         torch.from_numpy(positions), impl)
        want, (wk, wv) = ref_layers.attention(
            rlp["attn"], _j(x), rcfg, jnp.asarray(positions), rimpl)
        _close(got, want, 1e-4)
        _close(gk, wk, 1e-5)
        _close(gv, wv, 1e-5)
    _close(layers.mlp(lp["mlp"], _t(x), cfg),
           ref_layers.mlp(rlp["mlp"], _j(x), rcfg), 1e-4)
    # a window shorter than S: the banded path, whatever the impl
    for impl, rimpl in (("kernel", "pallas"), ("naive", "naive")):
        got, _ = layers.attention(lp["attn"], _t(x), cfg,
                                  torch.from_numpy(positions), impl,
                                  window=4)
        want, _ = ref_layers.attention(rlp["attn"], _j(x), rcfg,
                                       jnp.asarray(positions), rimpl,
                                       window=4)
        _close(got, want, 1e-4)


# ---------------------------------------------------------------------------
# model: prefill and decode_step logits
# ---------------------------------------------------------------------------

def _prefill_decode(cfg, rcfg, tp, rp, impl, rimpl, tol):
    rng = np.random.default_rng(6)
    toks = rng.integers(1, cfg.vocab, (2, 9)).astype(np.int32)
    lg, cache, pos = transformer.prefill(tp, torch.from_numpy(toks), cfg, 16,
                                         impl=impl)
    rlg, rcache, rpos = ref_tf.prefill(rp, jnp.asarray(toks), rcfg, 16,
                                       impl=rimpl)
    _close(lg, rlg, tol)
    assert pos.tolist() == np.asarray(rpos).tolist()
    tok = rng.integers(1, cfg.vocab, (2, 1)).astype(np.int32)
    for _ in range(3):
        lg, cache, pos = transformer.decode_step(
            tp, torch.from_numpy(tok), cache, pos, cfg)
        rlg, rcache, rpos = ref_tf.decode_step(rp, jnp.asarray(tok), rcache,
                                               rpos, rcfg)
        _close(lg, rlg, tol)
        tok = np.asarray(np.argmax(_np(rlg)[:, -1], -1)[:, None], np.int32)
    _close(cache["k"], rcache["k"], tol)
    assert pos.tolist() == np.asarray(rpos).tolist()


@pytest.mark.parametrize("dense32", [ARCH, "starcoder2-7b", "phi3-mini-3.8b"],
                         indirect=True)
@pytest.mark.parametrize("impl,rimpl", [("kernel", "pallas"),
                                        ("chunked", "chunked"),
                                        ("naive", "naive")])
def test_prefill_decode_float32_match_reference(dense32, impl, rimpl):
    _prefill_decode(*dense32, impl, rimpl, 1e-4)


def test_prefill_decode_bfloat16_match_reference(reduced):
    _prefill_decode(*reduced, "kernel", "pallas", BF16_LOGIT_TOL)


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------

def _requests(cls, vocab):
    rng = np.random.default_rng(0)
    return [cls(rid=i, prompt=rng.integers(
        1, vocab, size=int(rng.integers(4, 17))).astype(np.int32), max_new=6)
        for i in range(5)]


def test_decode_engine_tokens_identical_to_reference(reduced):
    cfg, rcfg, tp, rp = reduced
    want = _requests(ref_engine.Request, cfg.vocab)
    reng = ref_engine.DecodeEngine(ref_get_model(rcfg), rp, batch_slots=3,
                                   max_len=32, impl="pallas")
    got = _requests(engine.Request, cfg.vocab)
    eng = engine.DecodeEngine(get_model(cfg), tp, batch_slots=3, max_len=32,
                              impl="kernel", device="cpu")
    for e, reqs in ((reng, want), (eng, got)):
        for r in reqs:
            e.submit(r)
        assert e.run_until_drained() == []
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert all(r.done for r in got)
    assert eng.stats() == reng.stats()
    assert eng.stats()["steps"] == 10


def test_launch_serve_matches_reference(capsys):
    argv = ["--requests", "3", "--slots", "2", "--max-new", "5"]
    got = launch_serve.main(argv, device="cpu")
    out = capsys.readouterr().out
    assert "served 3 requests" in out and "decode steps" in out
    want = ref_launch_serve.main(argv)
    assert {k: got[k] for k in ("tokens", "steps", "mean_occupancy",
                                "peak_occupancy")} == \
        {k: want[k] for k in ("tokens", "steps", "mean_occupancy",
                              "peak_occupancy")}
