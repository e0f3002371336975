"""The port's SSM path (Mamba-1, falcon-mamba-7b) against the JAX reference,
on the CPU.

Same inputs (numpy, from a seed) through the reference function and its
port; the reference's Pallas scan runs in interpret mode, as
``tests/test_kernels.py`` runs it.  Sizes: reduced falcon-mamba-7b (2
layers, d 64, d_inner 128, d_state 8, dt_rank 8, vocab 512).

Tolerances: float32 1e-4 against the jnp functions (sums over the state
and along the associative scan in another order) and 1e-3 against the
float64 oracle; float32 model logits 1e-4; bf16 model logits
``BF16_LOGIT_TOL`` of ``tests/test_torch_lm.py`` (every product and partial
sum of the conv and every projection rounds to bf16, and XLA on the CPU
keeps some float32 intermediates that torch rounds).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import get_reduced as ref_get_reduced
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_oracle
from repro.kernels import ssm_scan as ref_scan
from repro.launch import serve as ref_launch_serve
from repro.models import ssm as ref_ssm
from repro.models.zoo import get_model as ref_get_model
from repro.serve import engine as ref_engine
from repro_torch.configs import get_config, get_reduced
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssm_scan as scan
from repro_torch.launch import serve as launch_serve
from repro_torch.models import params as tparams, ssm
from repro_torch.models.zoo import get_model
from repro_torch.serve import engine

from test_torch_lm import BF16_LOGIT_TOL

ARCH = "falcon-mamba-7b"
TOL, ORACLE_TOL = 1e-4, 1e-3


def _np(x) -> np.ndarray:
    return np.asarray(x, np.float32)


def _close(got: torch.Tensor, want, tol: float) -> None:
    np.testing.assert_allclose(got.float().numpy(), _np(want), atol=tol,
                               rtol=tol)


def _scan_inputs(seed, bsz, s, di, n, h0=True):
    """x, dt (softplus-like, > 0), a (< 0, as -exp(a_log)), b, c, d, h0."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.standard_normal((bsz, s, di)).astype(f),
            np.log1p(np.exp(rng.standard_normal((bsz, s, di)))).astype(f),
            -np.exp(0.5 * rng.standard_normal((di, n))).astype(f),
            rng.standard_normal((bsz, s, n)).astype(f),
            rng.standard_normal((bsz, s, n)).astype(f),
            rng.standard_normal(di).astype(f),
            (rng.standard_normal((bsz, di, n)) if h0
             else np.zeros((bsz, di, n))).astype(f))


def _port(inputs):
    return [torch.from_numpy(a) for a in inputs]


PORT_SCANS = {
    "kernel": lambda *a: ops.ssm(*a, impl="kernel"),
    "assoc": ops.ssm_assoc,
    "chunked": lambda *a: ops.ssm_chunked(*a, chunk=32),
    "chunked128": ops.ssm_chunked,
}
SCAN_SHAPES = [(2, 64, 128, 8, True), (1, 96, 64, 16, False),
               (2, 32, 64, 32, True)]


@pytest.mark.parametrize("impl", sorted(PORT_SCANS))
@pytest.mark.parametrize("shape", range(len(SCAN_SHAPES)))
def test_ssm_ops_match_reference(impl, shape):
    inputs = _scan_inputs(shape, *SCAN_SHAPES[shape])
    y, h = PORT_SCANS[impl](*_port(inputs))
    assert y.dtype == h.dtype == torch.float32
    j = [jnp.asarray(a) for a in inputs]
    for want in (ref_scan.ssm_scan(*j, chunk=32, block_d=64),
                 ref_ops.ssm_assoc(*j), ref_ops.ssm_chunked(*j)):
        _close(y, want[0], TOL)
        _close(h, want[1], TOL)
    wy, wh = ref.ssm_scan_ref(*_port(inputs))
    _close(y, wy, ORACLE_TOL)
    _close(h, wh, ORACLE_TOL)


@pytest.mark.parametrize("impl", sorted(PORT_SCANS))
def test_ssm_ops_ragged_length(impl):
    """S = 200 is no multiple of any chunk: the port takes it; the
    reference's ``ssm_assoc`` (no chunk assert) is the yardstick."""
    inputs = _scan_inputs(7, 2, 200, 96, 16)
    y, h = PORT_SCANS[impl](*_port(inputs))
    wy, wh = ref_ops.ssm_assoc(*[jnp.asarray(a) for a in inputs])
    _close(y, wy, TOL)
    _close(h, wh, TOL)


def test_ssm_scan_ref_matches_reference_oracle():
    inputs = _scan_inputs(3, 2, 40, 24, 4)
    got = ref.ssm_scan_ref(*_port(inputs))
    want = ref_oracle.ssm_scan_ref(*inputs)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-12, atol=1e-12)


def test_ssm_scan_plain_is_the_kernel_order_and_honours_h0():
    """On a CPU tensor ``ssm_scan`` is its plain loop (no launch); a
    nonzero h0 moves the output; one step of it is the recurrence by
    hand."""
    inputs = _port(_scan_inputs(5, 1, 9, 16, 8))
    before = scan.ssm_scan.launches
    y, h = scan.ssm_scan(*inputs)
    assert scan.ssm_scan.launches == before
    py, ph = scan.ssm_scan_plain(*inputs)
    assert torch.equal(y, py) and torch.equal(h, ph)
    zero = inputs[:6] + [torch.zeros_like(inputs[6])]
    assert not torch.allclose(scan.ssm_scan(*zero)[0], y)
    x, dt, a, b, c, d, h0 = inputs
    h1 = torch.exp(dt[:, 0, :, None] * a) * h0 \
        + (dt[:, 0, :, None] * x[:, 0, :, None]) * b[:, 0, None, :]
    y1 = (h1 * c[:, 0, None, :]).sum(-1) + d * x[:, 0]
    torch.testing.assert_close(y[:, 0], y1, rtol=0, atol=0)
    one = scan.ssm_scan(x[:, :1], dt[:, :1], a, b[:, :1], c[:, :1], d, h0)
    torch.testing.assert_close(one[1], h1, rtol=0, atol=0)


def test_ssm_scan_refuses_what_it_cannot_take():
    x, dt, a, b, c, d, h0 = _port(_scan_inputs(1, 1, 4, 8, 4))
    with pytest.raises(TypeError, match="float32"):
        scan.ssm_scan(x.bfloat16(), dt, a, b, c, d, h0)
    with pytest.raises(ValueError, match="h0"):
        scan.ssm_scan(x, dt, a, b, c, d, h0[:, :4])
    with pytest.raises(ValueError, match="a \\[Di=8"):
        scan.ssm_scan(x, dt, a[:4], b, c, d, h0)


def test_ssm_other_impls_run_assoc():
    inputs = _port(_scan_inputs(2, 1, 16, 8, 4))
    want = ops.ssm_assoc(*inputs)
    for impl in ("naive", "pallas"):
        got = ops.ssm(*inputs, impl=impl)
        assert all(torch.equal(g, w) for g, w in zip(got, want))


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reduced():
    """(port cfg, reference cfg, port params, reference params), bf16."""
    cfg, rcfg = get_reduced(ARCH), ref_get_reduced(ARCH)
    rp = ref_get_model(rcfg).init_params(0)
    return cfg, rcfg, get_model(cfg).init_params(0, device="cpu"), rp


@pytest.fixture(scope="module")
def reduced32():
    cfg = dataclasses.replace(get_reduced(ARCH), param_dtype="float32")
    rcfg = dataclasses.replace(ref_get_reduced(ARCH), param_dtype="float32")
    rp = ref_get_model(rcfg).init_params(0)
    return cfg, rcfg, get_model(cfg).init_params(0, device="cpu"), rp


def test_params_bit_identical_to_reference(reduced):
    cfg, _, tp, rp = reduced
    got, want = tparams.leaves(tp), jax.tree.leaves(rp)
    assert len(got) == len(want) == 13        # embed 2, layers 10, ln_f 1
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        if w.dtype == np.float32:                 # a_log, d_skip
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
        == 7272665088


def test_init_cache_is_float32_like_the_reference(reduced):
    cfg, rcfg, _, _ = reduced
    got = get_model(cfg).init_cache(3, 99, device="cpu")
    want = ref_get_model(rcfg).init_cache(3, 99)
    for k in ("h", "conv"):
        assert tuple(got[k].shape) == want[k].shape
        assert got[k].dtype == torch.float32
        assert np.asarray(want[k]).dtype == np.float32
        assert not got[k].any()


FORWARD_IMPLS = [("kernel", "pallas"), ("naive", "naive"),
                 ("chunked", "chunked")]


def _tokens(cfg, seed, shape):
    return np.random.default_rng(seed).integers(1, cfg.vocab, shape) \
        .astype(np.int32)


@pytest.mark.parametrize("impl,rimpl", FORWARD_IMPLS)
def test_forward_float32_matches_reference(reduced32, impl, rimpl):
    cfg, rcfg, tp, rp = reduced32
    toks = _tokens(cfg, 1, (2, 32))
    want = ref_ssm.forward(rp, jnp.asarray(toks), rcfg, impl=rimpl)
    got = ssm.forward(tp, torch.from_numpy(toks), cfg, impl=impl)
    assert got.shape == want.shape and got.dtype == torch.float32
    _close(got, want, TOL)


@pytest.mark.parametrize("impl,rimpl", FORWARD_IMPLS)
def test_forward_bfloat16_matches_reference(reduced, impl, rimpl):
    cfg, rcfg, tp, rp = reduced
    toks = _tokens(cfg, 2, (2, 32))
    want = ref_ssm.forward(rp, jnp.asarray(toks), rcfg, impl=rimpl)
    _close(ssm.forward(tp, torch.from_numpy(toks), cfg, impl=impl), want,
           BF16_LOGIT_TOL)


def test_unknown_scan_impl_raises(reduced32):
    cfg, _, tp, _ = reduced32
    with pytest.raises(ValueError, match="'kernel' here"):
        ssm.forward(tp, torch.ones((1, 4), dtype=torch.int32), cfg,
                    impl="pallas")


def _prefill_decode(cfg, rcfg, tp, rp, tol, s=12):
    """Prefill, then three decode steps from the engine's float32 cache
    (the prefill's conv tail spliced in, as ``_splice_cache`` does)."""
    toks = _tokens(cfg, 6, (2, s))
    lg, cache, pos = ssm.prefill(tp, torch.from_numpy(toks), cfg, 16,
                                 impl="kernel")
    rlg, rcache, rpos = ref_ssm.prefill(rp, jnp.asarray(toks), rcfg, 16)
    _close(lg, rlg, tol)
    _close(cache["h"], rcache["h"], tol)
    _close(cache["conv"], rcache["conv"], tol)
    assert cache["conv"].dtype == tparams._DTYPES[cfg.param_dtype]
    assert pos.tolist() == np.asarray(rpos).tolist()
    c32 = ssm.init_cache(cfg, 2, 16, device="cpu")
    cache = {k: cache[k].to(c32[k].dtype) for k in c32}
    rc32 = ref_ssm.init_cache(rcfg, 2, 16)
    rcache = {k: rcache[k].astype(rc32[k].dtype) for k in rc32}
    tok = _tokens(cfg, 7, (2, 1))
    for _ in range(3):
        lg, cache, pos = ssm.decode_step(tp, torch.from_numpy(tok), cache,
                                         pos, cfg)
        rlg, rcache, rpos = ref_ssm.decode_step(rp, jnp.asarray(tok), rcache,
                                                rpos, rcfg)
        _close(lg, rlg, tol)
        tok = np.asarray(np.argmax(_np(rlg)[:, -1], -1)[:, None], np.int32)
    assert cache["conv"].dtype == torch.float32
    _close(cache["h"], rcache["h"], tol)
    _close(cache["conv"], rcache["conv"], tol)
    assert pos.tolist() == np.asarray(rpos).tolist()


def test_prefill_decode_float32_match_reference(reduced32):
    _prefill_decode(*reduced32, TOL)


def test_prefill_decode_bfloat16_match_reference(reduced):
    _prefill_decode(*reduced, BF16_LOGIT_TOL)


def test_prefill_takes_a_ragged_prompt(reduced32):
    """A 200-token prompt (the reference's ``ssm_chunked`` asserts whole
    128-step chunks): the port's prefill equals its own kernel-route
    forward at the last position."""
    cfg, _, tp, _ = reduced32
    toks = torch.from_numpy(_tokens(cfg, 8, (1, 200)))
    lg, cache, _ = ssm.prefill(tp, toks, cfg, 256)
    full = ssm.forward(tp, toks, cfg, impl="kernel")
    _close(lg[:, 0], full[:, -1].numpy(), TOL)
    assert tuple(cache["h"].shape) == (cfg.n_layers, 1, cfg.d_inner,
                                       cfg.d_state)


# ---------------------------------------------------------------------------
# engine and entry point
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
                              device="cpu")
    assert eng.impl == "kernel"
    for e, reqs in ((reng, want), (eng, got)):
        for r in reqs:
            e.submit(r)
        assert e.run_until_drained() == []
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert all(r.done for r in got)
    assert eng.stats() == reng.stats()
    assert eng.cache["conv"].dtype == eng.cache["h"].dtype == torch.float32


def test_launch_serve_matches_reference(capsys):
    argv = ["--arch", ARCH, "--requests", "3", "--slots", "2",
            "--max-new", "5"]
    got = launch_serve.main(argv, device="cpu")
    out = capsys.readouterr().out
    assert "served 3 requests" in out and "decode steps" in out
    want = ref_launch_serve.main(argv)
    keys = ("tokens", "steps", "mean_occupancy", "peak_occupancy")
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
