"""The port's hybrid path (RG-LRU + local attention, recurrentgemma-9b)
against the JAX reference, on the CPU.

Same inputs (numpy, from a seed) through the reference function and its
port; the reference's Pallas scan runs in interpret mode, as
``tests/test_kernels.py`` runs it.  Sizes: reduced recurrentgemma-9b (3
layers = one group of 2 recurrent blocks + 1 attention block; d 64, rnn
width 64, 4/1 heads of 16, window 32, vocab 512) and a 5-layer variant of
it whose last 2 recurrent blocks are the ``tail``.

Tolerances: the scans 1e-5 (float32, values below 1: the associative
scans sum in another order); float32 attention 1e-5 and model logits 1e-4
(float32 matmuls in another order); bf16 model logits ``BF16_STEPS`` bf16
steps at the largest |logit|.  The port rounds every bf16 op as the
reference's code is written; compiled, XLA keeps float32 across a fused
chain of bf16 ops (``xla_allow_excess_precision``, on by default), which
moves this model's logits by up to 5 bf16 steps (4 when both run op by
op, from matmul sums in another order).  For the same reason the engine's
greedy tokens are held to the reference engine run with that option off.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import get_reduced as ref_get_reduced
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_oracle
from repro.kernels import rg_lru as ref_rg
from repro.launch import serve as ref_launch_serve
from repro.models import layers as ref_layers
from repro.models import rglru as ref_rglru
from repro.models.zoo import get_model as ref_get_model
from repro.serve import engine as ref_engine
from repro_torch.configs import get_config, get_reduced
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rg_lru as rg
from repro_torch.launch import serve as launch_serve
from repro_torch.models import layers, params as tparams, rglru
from repro_torch.models.zoo import get_model
from repro_torch.serve import engine

ARCH = "recurrentgemma-9b"
SCAN_TOL, TOL = 1e-5, 1e-4
BF16_STEPS = 8
ROOT = Path(__file__).resolve().parents[1]


def _np(x) -> np.ndarray:
    return np.asarray(x, np.float32)


def _close(got: torch.Tensor, want, tol: float) -> None:
    np.testing.assert_allclose(got.float().numpy(), _np(want), atol=tol,
                               rtol=tol)


def _scan_inputs(seed, bsz, s, d, zero_h0=False):
    """a in [0, 0.9), b ~ 0.1 N(0, 1), h0 ~ 0.1 N(0, 1) (the reference's
    kernel test)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return ((rng.random((bsz, s, d)) * 0.9).astype(f),
            (rng.standard_normal((bsz, s, d)) * 0.1).astype(f),
            (np.zeros((bsz, d)) if zero_h0
             else rng.standard_normal((bsz, d)) * 0.1).astype(f))


def _port(inputs):
    return [torch.from_numpy(a) for a in inputs]


PORT_SCANS = {
    "kernel": lambda *a: ops.rg_lru_scan(*a, impl="kernel"),
    "assoc": ops.rg_lru_assoc,
    "chunked": lambda *a: ops.rg_lru_chunked(*a, chunk=32),
    "chunked256": ops.rg_lru_chunked,
}


@pytest.mark.parametrize("impl", sorted(PORT_SCANS))
@pytest.mark.parametrize("b,s,d", [(2, 64, 128), (1, 256, 512)])
def test_rg_lru_ops_match_reference(impl, b, s, d):
    """The sweep of ``tests/test_kernels.py::test_rg_lru``: the reference
    kernel (interpret mode), its jnp scans and the float64 oracle."""
    inputs = _scan_inputs(d, b, s, d)
    y, h = PORT_SCANS[impl](*_port(inputs))
    assert y.dtype == h.dtype == torch.float32
    j = [jnp.asarray(a) for a in inputs]
    for want in (ref_rg.rg_lru(*j, chunk=32, block_d=64, interpret=True),
                 ref_ops.rg_lru_assoc(*j), ref_ops.rg_lru_chunked(*j)):
        _close(y, want[0], SCAN_TOL)
        _close(h, want[1], SCAN_TOL)
    wy, wh = ref_oracle.rg_lru_ref(*inputs)
    _close(y, wy, SCAN_TOL)
    _close(h, wh, SCAN_TOL)


@pytest.mark.parametrize("impl", sorted(PORT_SCANS))
@pytest.mark.parametrize("s", [1, 77, 300])
def test_rg_lru_ops_ragged_length(impl, s):
    """S of no whole chunk (the reference's chunked scan and kernel assert
    whole chunks): the float64 oracle is the yardstick."""
    inputs = _scan_inputs(s, 2, s, 48, zero_h0=s == 1)
    y, h = PORT_SCANS[impl](*_port(inputs))
    wy, wh = ref.rg_lru_ref(*_port(inputs))
    _close(y, wy, SCAN_TOL)
    _close(h, wh, SCAN_TOL)


def test_rg_lru_ref_matches_reference_oracle():
    inputs = _scan_inputs(3, 2, 40, 24)
    got = ref.rg_lru_ref(*_port(inputs))
    want = ref_oracle.rg_lru_ref(*inputs)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-12, atol=1e-12)


def test_rg_lru_plain_is_the_kernel_order_and_honours_h0():
    """On a CPU tensor ``rg_lru`` is its plain loop (no launch); a nonzero
    h0 moves the output; the first step is the recurrence by hand."""
    a, b, h0 = _port(_scan_inputs(5, 2, 9, 16))
    before = rg.rg_lru.launches
    y, h = rg.rg_lru(a, b, h0)
    assert rg.rg_lru.launches == before
    py, ph = rg.rg_lru_plain(a, b, h0)
    assert torch.equal(y, py) and torch.equal(h, ph)
    assert torch.equal(h, y[:, -1])
    assert not torch.allclose(rg.rg_lru(a, b, torch.zeros_like(h0))[0], y)
    torch.testing.assert_close(y[:, 0], a[:, 0] * h0 + b[:, 0], rtol=0,
                               atol=0)
    empty = rg.rg_lru(a[:, :0], b[:, :0], h0)
    assert empty[0].shape == (2, 0, 16) and torch.equal(empty[1], h0)


def test_rg_lru_refuses_what_it_cannot_take():
    a, b, h0 = _port(_scan_inputs(1, 1, 4, 8))
    with pytest.raises(TypeError, match="float32"):
        rg.rg_lru(a.bfloat16(), b, h0)
    with pytest.raises(ValueError, match="h0"):
        rg.rg_lru(a, b, h0[:, :4])
    with pytest.raises(ValueError, match="a and b"):
        rg.rg_lru(a, b[:, :2], h0)


def test_rg_lru_other_impls_run_assoc():
    inputs = _port(_scan_inputs(2, 1, 16, 8))
    want = ops.rg_lru_assoc(*inputs)
    for impl in ("naive", "pallas"):
        got = ops.rg_lru_scan(*inputs, impl=impl)
        assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_rg_lru_chunked_keeps_the_cast_points():
    """y in a's dtype, hT float32 (the reference's ``rg_lru_chunked``)."""
    a, b, h0 = _port(_scan_inputs(4, 1, 40, 8))
    y, h = ops.rg_lru_chunked(a.bfloat16(), b, h0, chunk=16)
    wy, wh = ref_ops.rg_lru_chunked(jnp.asarray(a, jnp.bfloat16),
                                    jnp.asarray(b), jnp.asarray(h0),
                                    chunk=8)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    assert np.asarray(wy).dtype == jnp.bfloat16
    _close(y, wy, 1e-2)
    _close(h, wh, 1e-5)


# ---------------------------------------------------------------------------
# windowed attention
# ---------------------------------------------------------------------------

def _band_oracle(q, k, window):
    """Softmax weights of the banded causal mask (query i sees keys
    i - window < j <= i), float64, MQA: q [B, H, S, D], k [B, 1, S, D]."""
    s, d = q.shape[2], q.shape[3]
    sc = np.einsum("bhqd,bkd->bhqk", q.astype(np.float64),
                   k[:, 0].astype(np.float64)) / np.sqrt(d)
    i, j = np.arange(s)[:, None], np.arange(s)[None, :]
    sc = np.where((j <= i) & (j > i - window), sc, -np.inf)
    p = np.exp(sc - sc.max(-1, keepdims=True))
    return p / p.sum(-1, keepdims=True)


def _qkv(seed, b, hq, s, d):
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.standard_normal((b, hq, s, d)).astype(f),
            rng.standard_normal((b, 1, s, d)).astype(f),
            rng.standard_normal((b, 1, s, d)).astype(f))


@pytest.mark.parametrize("n_windows", [2, 4])
def test_windowed_attention_matches_reference(n_windows):
    window = 16
    q, k, v = _qkv(n_windows, 2, 4, n_windows * window, 16)
    got = layers._windowed_attention(*_port((q, k, v)), window)
    want = ref_layers._windowed_attention(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), window)
    assert got.shape == q.shape
    _close(got, want, 1e-5)
    oracle = np.einsum("bhqk,bkd->bhqd", _band_oracle(q, k, window), v[:, 0])
    _close(got, oracle, 1e-5)


@pytest.mark.parametrize("s", [1, 5, 17, 45])
def test_windowed_attention_takes_any_length(s):
    """S of no whole window (the reference reshapes S into windows): the
    padded last block matches the banded oracle."""
    window = 16
    q, k, v = _qkv(s, 1, 4, s, 16)
    got = layers._windowed_attention(*_port((q, k, v)), window)
    oracle = np.einsum("bhqk,bkd->bhqd", _band_oracle(q, k, window), v[:, 0])
    assert got.shape == q.shape
    _close(got, oracle, 1e-5)


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

def _cfgs(n_layers=None, dtype=None):
    cfg, rcfg = get_reduced(ARCH), ref_get_reduced(ARCH)
    kw = {}
    if n_layers:
        kw["n_layers"] = n_layers
    if dtype:
        kw["param_dtype"] = dtype
    return dataclasses.replace(cfg, **kw), dataclasses.replace(rcfg, **kw)


def _fixture(n_layers=None, dtype=None):
    """(port cfg, reference cfg, port params, reference params)."""
    cfg, rcfg = _cfgs(n_layers, dtype)
    rp = ref_get_model(rcfg).init_params(0)
    return cfg, rcfg, get_model(cfg).init_params(0, device="cpu"), rp


@pytest.fixture(scope="module")
def reduced():
    return _fixture()


@pytest.fixture(scope="module")
def tail5():
    """5 layers: one group, then a tail of 2 recurrent blocks; bf16."""
    return _fixture(5)


@pytest.fixture(scope="module")
def tail5_32():
    return _fixture(5, "float32")


def _tokens(cfg, seed, shape):
    return np.random.default_rng(seed).integers(1, cfg.vocab, shape) \
        .astype(np.int32)


@pytest.mark.parametrize("which,n_leaves", [("reduced", 25), ("tail5", 38)])
def test_params_bit_identical_to_reference(request, which, n_leaves):
    """embed 2; groups: 13 recurrent leaves (stacked [G, R]) and 9 of the
    attention block; ln_f 1; tail 13."""
    cfg, _, tp, rp = request.getfixturevalue(which)
    got, want = tparams.leaves(tp), jax.tree.leaves(rp)
    assert len(got) == len(want) == n_leaves
    assert ("tail" in tp) == ("tail" in rp) == (which == "tail5")
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        if w.dtype == np.float32:                 # lam
            assert g.dtype == torch.float32
            np.testing.assert_array_equal(g.numpy(), w)
        else:
            assert g.dtype == torch.bfloat16
            np.testing.assert_array_equal(g.view(torch.int16).numpy(),
                                          w.view(np.int16))
    moved = tparams.from_numpy(jax.tree.map(np.asarray, rp), device="cpu")
    for g, w in zip(tparams.leaves(moved), got):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_n_params_full_config():
    port = get_model(get_config(ARCH)).n_params()
    assert port == ref_get_model(ref_get_config(ARCH)).n_params() \
        == 10444771328


def test_init_cache_matches_the_reference(tail5):
    cfg, rcfg, _, _ = tail5
    for max_len in (20, 99):
        got = get_model(cfg).init_cache(3, max_len, device="cpu")
        want = ref_get_model(rcfg).init_cache(3, max_len)
        assert sorted(got) == sorted(want)
        for k in got:
            assert tuple(got[k].shape) == want[k].shape
            assert str(got[k].dtype).split(".")[1] == \
                np.asarray(want[k]).dtype.name
            assert not got[k].any()


REC_IMPLS = [("kernel", "pallas"), ("naive", "naive"), ("chunked", "assoc")]


@pytest.mark.parametrize("impl,rimpl", REC_IMPLS)
def test_rec_block_matches_reference(tail5_32, impl, rimpl):
    """One recurrent block, with and without a carried state and conv
    window, on every scan route."""
    cfg, rcfg, tp, rp = tail5_32
    p = rglru._take(tp["tail"], 1)
    rpp = jax.tree.map(lambda a: a[1], rp["tail"])
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    h0 = (rng.standard_normal((2, cfg.rnn_width)) * 0.5).astype(np.float32)
    c0 = rng.standard_normal((2, cfg.d_conv - 1, cfg.rnn_width)) \
        .astype(np.float32)
    for carry in (False, True):
        kw = dict(h0=torch.from_numpy(h0), conv0=torch.from_numpy(c0)) \
            if carry else {}
        rkw = dict(h0=jnp.asarray(h0), conv0=jnp.asarray(c0)) if carry else {}
        out, (hT, tail) = rglru._rec_block(p, torch.from_numpy(x), cfg,
                                           impl=impl, **kw)
        rout, (rhT, rtail) = ref_rglru._rec_block(rpp, jnp.asarray(x), rcfg,
                                                  impl=rimpl, **rkw)
        _close(out, rout, TOL)
        _close(hT, rhT, TOL)
        _close(tail, rtail, 1e-6)
        assert hT.dtype == torch.float32


def test_rec_block_unknown_impl_raises(tail5_32):
    cfg, _, tp, _ = tail5_32
    with pytest.raises(ValueError, match="'kernel' here"):
        rglru._rec_block(rglru._take(tp["tail"], 0),
                         torch.zeros((1, 4, cfg.d_model)), cfg,
                         impl="pallas")


FORWARD_IMPLS = [("kernel", "pallas"), ("naive", "naive"),
                 ("chunked", "chunked")]


@pytest.mark.parametrize("s", [20, 64])
@pytest.mark.parametrize("impl,rimpl", FORWARD_IMPLS)
def test_forward_float32_matches_reference(tail5_32, impl, rimpl, s):
    """S = 20 runs the attention route itself, S = 64 (2 windows) the
    banded path."""
    cfg, rcfg, tp, rp = tail5_32
    toks = _tokens(cfg, s, (2, s))
    want = ref_rglru.forward(rp, jnp.asarray(toks), rcfg, impl=rimpl)
    got = rglru.forward(tp, torch.from_numpy(toks), cfg, impl=impl)
    assert got.shape == want.shape and got.dtype == torch.float32
    _close(got, want, TOL)


@pytest.mark.parametrize("impl,rimpl", FORWARD_IMPLS)
def test_forward_bfloat16_matches_reference(reduced, impl, rimpl):
    cfg, rcfg, tp, rp = reduced
    toks = _tokens(cfg, 2, (2, 64))
    want = _np(ref_rglru.forward(rp, jnp.asarray(toks), rcfg, impl=rimpl))
    got = rglru.forward(tp, torch.from_numpy(toks), cfg, impl=impl)
    step = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=BF16_STEPS * step)


@pytest.mark.parametrize("s,max_len", [(12, 48), (30, 24), (64, 80)])
def test_prefill_and_decode_match_reference(tail5_32, s, max_len):
    """Prefill caches (a prompt shorter than the ring; a non-zero ring roll:
    max_len 24 < window 32 with a 30-token prompt; a 2-window prompt), then
    the engine's splice into a zeroed cache and four decode steps, whose
    ring writes wrap past the end in the second case."""
    cfg, rcfg, tp, rp = tail5_32
    toks = _tokens(cfg, s, (1, s))
    lg, cache, pos = rglru.prefill(tp, torch.from_numpy(toks), cfg, max_len,
                                   impl="kernel")
    rlg, rcache, rpos = ref_rglru.prefill(rp, jnp.asarray(toks), rcfg,
                                          max_len, impl="pallas")
    _close(lg, rlg, TOL)
    assert sorted(cache) == sorted(rcache)
    for k in cache:
        assert tuple(cache[k].shape) == rcache[k].shape, k
        _close(cache[k], rcache[k], TOL)
    assert cache["attn_k"].shape[3] == min(s, cfg.window, max_len)
    assert pos.tolist() == np.asarray(rpos).tolist()
    c = engine._splice_cache(rglru.init_cache(cfg, 1, max_len, torch.float32,
                                              device="cpu"), cache, 0)
    rc = ref_engine._splice_cache(ref_rglru.init_cache(rcfg, 1, max_len,
                                                       jnp.float32),
                                  rcache, 0)
    tok = _tokens(cfg, 7, (1, 1))
    for _ in range(4):
        lg, c, pos = rglru.decode_step(tp, torch.from_numpy(tok), c, pos,
                                       cfg)
        rlg, rc, rpos = ref_rglru.decode_step(rp, jnp.asarray(tok), rc, rpos,
                                              rcfg)
        _close(lg, rlg, TOL)
        tok = np.asarray(np.argmax(_np(rlg)[:, -1], -1)[:, None], np.int32)
    for k in c:
        _close(c[k], rc[k], TOL)
    assert pos.tolist() == np.asarray(rpos).tolist()


def test_prefill_takes_a_ragged_prompt(tail5_32):
    """A 300-token prompt (the reference's ``rg_lru_chunked`` asserts whole
    256-step chunks and its ``_windowed_attention`` whole windows): the
    port's prefill equals its own forward at the last position."""
    cfg, _, tp, _ = tail5_32
    toks = torch.from_numpy(_tokens(cfg, 8, (1, 300)))
    lg, cache, _ = rglru.prefill(tp, toks, cfg, 512)
    full = rglru.forward(tp, toks, cfg)
    _close(lg[:, 0], full[:, -1].numpy(), TOL)
    assert tuple(cache["attn_k"].shape) == (1, 1, 1, cfg.window, cfg.hd)


# ---------------------------------------------------------------------------
# engine and entry point
# ---------------------------------------------------------------------------

def test_splice_cache_takes_a_shorter_source_like_the_reference():
    """A source shorter than the slot along another axis fills the leading
    sub-block, as ``lax.dynamic_update_slice_in_dim`` does; a longer one
    raises."""
    rng = np.random.default_rng(3)
    batch = rng.standard_normal((2, 1, 3, 8, 4)).astype(np.float32)
    for slot, shape in ((1, (2, 1, 1, 5, 4)), (0, (2, 1, 1, 8, 3)),
                        (2, (2, 1, 1, 8, 4))):
        src = rng.standard_normal(shape).astype(np.float32)
        got = engine._splice_cache({"rec_conv": torch.from_numpy(batch)},
                                   {"rec_conv": torch.from_numpy(src)}, slot)
        want = jax.lax.dynamic_update_slice_in_dim(
            jnp.asarray(batch), jnp.asarray(src), slot, axis=2)
        np.testing.assert_array_equal(got["rec_conv"].numpy(),
                                      np.asarray(want))
    assert not torch.equal(got["rec_conv"], torch.from_numpy(batch))
    for shape in ((2, 1, 1, 9, 4), (2, 2, 1, 8, 4), (3, 1, 1, 8, 4),
                  (2, 1, 2, 8, 4)):
        with pytest.raises(ValueError, match="does not fit"):
            engine._splice_cache(
                {"rec_conv": torch.from_numpy(batch)},
                {"rec_conv": torch.zeros(shape)}, 0)


_REF_ENGINE = textwrap.dedent("""
    import dataclasses, json
    import numpy as np
    from repro.configs import get_reduced
    from repro.models.zoo import get_model
    from repro.serve.engine import DecodeEngine, Request
    cfg = dataclasses.replace(get_reduced({arch!r}), n_layers=5)
    zoo = get_model(cfg)
    eng = DecodeEngine(zoo, zoo.init_params(0), batch_slots=3, max_len=96,
                       impl="pallas")
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(1, cfg.vocab, size=n)
                    .astype(np.int32), max_new=6)
            for i, n in enumerate({lens!r})]
    for r in reqs:
        eng.submit(r)
    assert eng.run_until_drained() == []
    print(json.dumps({{"tokens": [r.tokens for r in reqs],
                      "done": [r.done for r in reqs], "stats": eng.stats(),
                      "cache": {{k: list(v.shape)
                                for k, v in eng.cache.items()}}}}))
""")
PROMPT_LENS = (9, 2, 64, 17, 30)


def _requests(cls, vocab):
    """Prompts shorter than the window (one of 2 tokens, shorter than the
    conv tail) and one of exactly 2 windows."""
    rng = np.random.default_rng(0)
    return [cls(rid=i, prompt=rng.integers(1, vocab, size=n).astype(
        np.int32), max_new=6) for i, n in enumerate(PROMPT_LENS)]


def test_decode_engine_tokens_identical_to_reference(tail5):
    """The reference engine runs in its own process with XLA's excess
    precision off, so that each bf16 op rounds as written (see the module
    docstring); with it on, the 2-token prompt's first token, a near tie
    (margin 0.047), flips."""
    cfg, _, tp, _ = tail5
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "") +
                          " --xla_allow_excess_precision=false").strip())
    out = subprocess.run(
        [sys.executable, "-c", _REF_ENGINE.format(arch=ARCH,
                                                  lens=PROMPT_LENS)],
        env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    want = json.loads(out.stdout.strip().splitlines()[-1])
    got = _requests(engine.Request, cfg.vocab)
    eng = engine.DecodeEngine(get_model(cfg), tp, batch_slots=3, max_len=96,
                              device="cpu")
    assert eng.impl == "kernel"
    for r in got:
        eng.submit(r)
    assert eng.run_until_drained() == []
    assert [r.tokens for r in got] == want["tokens"]
    assert all(r.done for r in got) and all(want["done"])
    assert eng.stats() == want["stats"]
    assert {k: list(v.shape) for k, v in eng.cache.items()} == want["cache"]
    assert eng.cache["attn_k"].shape[3] == cfg.window


def test_launch_serve_matches_reference(capsys):
    argv = ["--arch", ARCH, "--requests", "3", "--slots", "2",
            "--max-new", "5"]
    got = launch_serve.main(argv, device="cpu")
    out = capsys.readouterr().out
    assert "served 3 requests" in out and "decode steps" in out
    want = ref_launch_serve.main(argv)
    keys = ("tokens", "steps", "mean_occupancy", "peak_occupancy")
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
