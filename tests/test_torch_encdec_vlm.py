"""The port's last two LM families (``models/encdec.py``, seamless-m4t-medium;
``models/vlm.py``, internvl2-1b) and the int8 KV cache
(``transformer.decode_step_q8``) against the JAX reference, on the CPU.

Reduced configs (2 + 2 or 2 layers, d 64, head dim 16) with the shapes of
``tests/test_models.py::test_smoke_prefill_decode`` (batch 2, 16 prompt
tokens), plus an encoder longer than the prompt (cross-attention with
Sq != Skv).  Tolerances: float32 logits 1e-4 (a few layers of float32
matmuls summed in another order); the int8 cache bit for bit (``jnp.round``
and ``torch.round`` both round half to even).  The reference's
``decode_step_q8`` runs under ``jax.disable_jit()`` there: compiled, XLA
keeps the bf16 dequantization product in float32 (excess precision), where
both packages as written round it to bf16.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as ref_get_reduced
from repro.configs.base import ShapeConfig as RefShape
from repro.models import transformer as ref_tf
from repro.models.zoo import get_model as ref_get_model
from repro_torch.configs import get_reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.models import encdec, params as tparams, transformer, vlm
from repro_torch.models.zoo import get_model

ARCHS = ("seamless-m4t-medium", "internvl2-1b")
TOL = 1e-4


def _np(x) -> np.ndarray:
    return np.asarray(x, np.float32)


def _close(got: torch.Tensor, want, tol: float = TOL) -> None:
    np.testing.assert_allclose(got.float().numpy(), _np(want), atol=tol,
                               rtol=tol)


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x) \
            .numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@pytest.fixture(scope="module", params=ARCHS)
def reduced32(request):
    """(port zoo, reference zoo, port params, reference params), float32."""
    name = request.param
    cfg = dataclasses.replace(get_reduced(name), param_dtype="float32")
    rcfg = dataclasses.replace(ref_get_reduced(name), param_dtype="float32")
    zoo, rzoo = get_model(cfg), ref_get_model(rcfg)
    return zoo, rzoo, zoo.init_params(0, device="cpu"), rzoo.init_params(0)


@pytest.mark.parametrize("name", ARCHS)
def test_params_and_batch_bit_identical_to_reference(name):
    """``init_params`` and ``make_batch`` draw the reference's numbers, the
    frontend, encoder, decoder and projector leaves included, and
    ``from_numpy`` carries the reference's tree across."""
    zoo, rzoo = get_model(get_reduced(name)), ref_get_model(
        ref_get_reduced(name))
    tp, rp = zoo.init_params(0, device="cpu"), rzoo.init_params(0)
    got, want = tparams.leaves(tp), jax.tree.leaves(rp)
    assert len(got) == len(want)
    assert zoo.n_params() == rzoo.n_params()
    for g, w in zip(got, want):
        assert tuple(g.shape) == np.asarray(w).shape
        np.testing.assert_array_equal(_bits(g), _bits(w))
    moved = tparams.from_numpy(jax.tree.map(np.asarray, rp), device="cpu")
    for g, w in zip(tparams.leaves(moved), got):
        assert g.dtype == w.dtype and torch.equal(g, w)
    keys = {"encdec": {"frontend", "enc", "dec", "ln_enc"},
            "vlm": {"projector"}}[zoo.cfg.family]
    assert keys <= set(tp)
    shape = ShapeConfig("smoke", seq_len=16, global_batch=2, kind="prefill")
    batch = zoo.make_batch(shape, seed=3, device="cpu")
    rbatch = rzoo.make_batch(RefShape("smoke", 16, 2, "prefill"), seed=3)
    assert list(batch) == list(rbatch)
    for k in batch:
        assert tuple(batch[k].shape) == rbatch[k].shape
        np.testing.assert_array_equal(_bits(batch[k]), _bits(rbatch[k]))
    specs = zoo.batch_specs(shape)
    assert {k: v[0] for k, v in specs.items()} == \
        {k: v.shape for k, v in rzoo.batch_specs(
            RefShape("smoke", 16, 2, "prefill")).items()}


def _batches(zoo, rzoo, enc_len):
    """The smoke batch (seed 3); ``enc_len`` replaces the encoder's frames
    by that many (encdec only)."""
    shape = ShapeConfig("smoke", seq_len=16, global_batch=2, kind="prefill")
    batch = zoo.make_batch(shape, seed=3, device="cpu")
    rbatch = rzoo.make_batch(RefShape("smoke", 16, 2, "prefill"), seed=3)
    if enc_len is not None:
        frames = np.random.default_rng(4).standard_normal(
            (2, enc_len, encdec.FRAME_DIM)).astype(np.float32)
        batch["frames"] = torch.from_numpy(frames)
        rbatch["frames"] = jnp.asarray(frames)
    return batch, rbatch


def _enc_lens(zoo):
    return (None, 40) if zoo.cfg.family == "encdec" else (None,)


@pytest.mark.parametrize("impl", ["naive", "chunked"])
def test_prefill_decode_float32_match_reference(reduced32, impl):
    zoo, rzoo, tp, rp = reduced32
    max_len = 32 if zoo.cfg.family != "vlm" else 32 + zoo.cfg.n_patches
    for enc_len in _enc_lens(zoo):
        batch, rbatch = _batches(zoo, rzoo, enc_len)
        lg, cache, pos = zoo.prefill(tp, batch, max_len, impl=impl)
        rlg, rcache, rpos = rzoo.prefill(rp, rbatch, max_len, impl=impl)
        assert lg.shape == rlg.shape == (2, 1, zoo.cfg.vocab_padded)
        _close(lg, rlg)
        assert pos.tolist() == np.asarray(rpos).tolist()
        assert set(cache) == set(rcache)
        for k in cache:
            assert tuple(cache[k].shape) == rcache[k].shape
        tok = np.asarray(np.argmax(_np(rlg)[:, -1], -1)[:, None], np.int32)
        for _ in range(3):
            lg, cache, pos = zoo.decode_step(tp, torch.from_numpy(tok),
                                             cache, pos)
            rlg, rcache, rpos = rzoo.decode_step(rp, jnp.asarray(tok),
                                                 rcache, rpos)
            _close(lg, rlg)
            tok = np.asarray(np.argmax(_np(rlg)[:, -1], -1)[:, None],
                             np.int32)
        for k in cache:
            _close(cache[k], rcache[k])
        assert pos.tolist() == np.asarray(rpos).tolist()


def test_kernel_route_matches_chunked(reduced32):
    """``impl="kernel"`` on the CPU runs the flash kernel's plain version:
    the encoder (non-causal), the decoder's causal self-attention and its
    cross-attention (non-causal, Sq != Skv with a longer encoder)."""
    zoo, rzoo, tp, _ = reduced32
    max_len = 32 if zoo.cfg.family != "vlm" else 32 + zoo.cfg.n_patches
    for enc_len in _enc_lens(zoo):
        batch, _ = _batches(zoo, rzoo, enc_len)
        lg, cache, _ = zoo.prefill(tp, batch, max_len, impl="kernel")
        want, wcache, _ = zoo.prefill(tp, batch, max_len, impl="chunked")
        np.testing.assert_allclose(lg.numpy(), want.numpy(), atol=TOL,
                                   rtol=TOL)
        for k in cache:
            np.testing.assert_allclose(cache[k].numpy(), wcache[k].numpy(),
                                       atol=TOL, rtol=TOL)


def test_forward_matches_reference(reduced32):
    zoo, rzoo, tp, rp = reduced32
    batch, rbatch = _batches(zoo, rzoo, None)
    if zoo.cfg.family == "encdec":
        got = encdec.forward(tp, batch["frames"], batch["tokens"], zoo.cfg)
        want = rzoo.mod.forward(rp, rbatch["frames"], rbatch["tokens"],
                                rzoo.cfg, remat=False)
    else:
        got = vlm.forward(tp, batch["patch_embeds"], batch["tokens"],
                          zoo.cfg)
        want = rzoo.mod.forward(rp, rbatch["patch_embeds"],
                                rbatch["tokens"], rzoo.cfg, remat=False)
    assert got.shape == want.shape == (2, 16, zoo.cfg.vocab_padded)
    _close(got, want)


@pytest.mark.parametrize("name", ARCHS)
def test_init_cache_shapes_match_reference(name):
    zoo, rzoo = get_model(get_reduced(name)), ref_get_model(
        ref_get_reduced(name))
    cache = zoo.init_cache(2, 32, device="cpu")
    want = rzoo.init_cache(2, 32)
    assert {k: tuple(v.shape) for k, v in cache.items()} == \
        {k: v.shape for k, v in want.items()}
    assert all(v.dtype == torch.bfloat16 and not v.any()
               for v in cache.values())


# ---------------------------------------------------------------------------
# the int8 KV cache
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def qwen2():
    """Reduced qwen2-0.5b: (cfg, rcfg, port params, reference params) in
    float32 and in bfloat16."""
    out = {}
    for dt in ("float32", "bfloat16"):
        cfg = dataclasses.replace(get_reduced("qwen2-0.5b"), param_dtype=dt)
        rcfg = dataclasses.replace(ref_get_reduced("qwen2-0.5b"),
                                   param_dtype=dt)
        out[dt] = (cfg, rcfg, get_model(cfg).init_params(0, device="cpu"),
                   ref_get_model(rcfg).init_params(0))
    return out


def test_quantize_vec_bit_identical():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 4, 5, 16)).astype(np.float32)
    x[0, 0, 0] = 0.0                                     # the 1e-8 floor
    x[1, 1, 1] = np.arange(16) - 7.5                     # halves to round
    q, s = transformer._quantize_vec(torch.from_numpy(x))
    rq, rs = ref_tf._quantize_vec(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.bfloat16
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(_bits(s), _bits(rs))


def test_decode_step_q8_cache_bit_identical(qwen2):
    """Nine decode steps into an empty int8 cache: int8 values and bf16
    scales bit for bit, logits within 1e-4, on float32 parameters."""
    cfg, rcfg, tp, rp = qwen2["float32"]
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 9)) \
        .astype(np.int32)
    c8 = transformer.init_cache_q8(cfg, 2, 16, device="cpu")
    rc8 = ref_tf.init_cache_q8(rcfg, 2, 16)
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in c8.items()} == \
        {k: (v.shape, str(v.dtype)) for k, v in rc8.items()}
    abstract = transformer.abstract_cache_q8(cfg, 2, 16)
    assert all(v.is_meta for v in abstract.values())
    p8 = torch.zeros(2, dtype=torch.int32)
    rp8 = jnp.zeros((2,), jnp.int32)
    for t in range(9):
        lg, c8, p8 = transformer.decode_step_q8(
            tp, torch.from_numpy(toks[:, t:t + 1]), c8, p8, cfg)
        with jax.disable_jit():     # bf16 ops rounded as written
            rlg, rc8, rp8 = ref_tf.decode_step_q8(
                rp, jnp.asarray(toks[:, t:t + 1]), rc8, rp8, rcfg)
        _close(lg, rlg)
    for k in ("k", "v", "ks", "vs"):
        np.testing.assert_array_equal(_bits(c8[k]), _bits(rc8[k]),
                                      err_msg=k)
    assert c8["k"][:, :, :, 9:].abs().sum() == 0       # unwritten rows
    assert p8.tolist() == np.asarray(rp8).tolist() == [9, 9]


def test_int8_kv_decode_matches_bf16_argmax(qwen2):
    """Quantized-cache decode keeps the bf16 path's token choices (twin of
    ``test_int8_kv_decode_matches_bf16_argmax`` in
    ``tests/test_perf_features.py``)."""
    cfg, _, tp, _ = qwen2["bfloat16"]
    zoo = get_model(cfg)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 9)).astype(np.int32))
    _, cache, pos = zoo.prefill(tp, {"tokens": toks[:, :-1]}, 16,
                                impl="naive")
    lg_bf, _, _ = zoo.decode_step(tp, toks[:, -1:], cache, pos)
    c8 = transformer.init_cache_q8(cfg, 2, 16, device="cpu")
    p8 = torch.zeros(2, dtype=torch.int32)
    for t in range(9):
        lg8, c8, p8 = transformer.decode_step_q8(tp, toks[:, t:t + 1], c8,
                                                 p8, cfg)
    assert torch.equal(lg8[:, 0].argmax(-1), lg_bf[:, 0].argmax(-1))
    assert float((lg8[:, 0] - lg_bf[:, 0]).abs().max()) < 0.1
