"""The port's gradients against the JAX reference's, on the CPU.

Same inputs (numpy, from a seed) through ``jax.vjp`` / ``jax.grad`` of the
reference and the port's ``torch.autograd``: the flash backwards of
``chunked_attention`` and ``grouped_chunked_attention`` (the reference's
``custom_vjp``s), the fused vocab-chunked cross-entropy, and each of the
six families' ``loss_fn`` with remat, reduced and in float32, on the
``chunked`` and ``naive`` routes.  Then the twins of
``tests/test_models.py``'s forward-loss and train-step smoke tests, and the
kernel entry points' refusal to run under grad.

Tolerances: attention 2e-5 (the reference's float32 kernel tests: sums in
another order); the cross-entropy 1e-5 on the loss and 2e-5 of the largest
|gradient|; model losses 1e-4 absolute and every gradient leaf 1e-4 x
max(1, max |g|) of the reference's leaf (a few layers of float32 matmuls
and scans in another order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import get_reduced as ref_get_reduced
from repro.configs.base import ShapeConfig as RefShape
from repro.kernels import ops as ref_ops
from repro.models import layers as ref_layers
from repro.models.zoo import get_model as ref_get_model
from repro_torch.configs import ARCHS, get_reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.moe_dispatch import moe_dispatch
from repro_torch.kernels.rg_lru import rg_lru
from repro_torch.kernels.ssm_scan import ssm_scan
from repro_torch.launch.train import loss_and_grads
from repro_torch.models import layers
from repro_torch.models.params import leaves, unflatten
from repro_torch.models.zoo import get_model

ATTN_TOL = 2e-5
MODEL_TOL = 1e-4
FAMILY_ARCH = {"dense": "qwen2-0.5b", "moe": "olmoe-1b-7b",
               "ssm": "falcon-mamba-7b", "hybrid": "recurrentgemma-9b",
               "encdec": "seamless-m4t-medium", "vlm": "internvl2-1b"}
SMOKE_SHAPE = (32, 2)          # seq_len, global_batch of test_models.py


def _np(x) -> np.ndarray:
    return np.asarray(x, np.float32)


def _rel_close(got: torch.Tensor, want, tol: float, what: str) -> None:
    want = _np(want)
    err = np.abs(got.detach().float().numpy() - want).max() if want.size \
        else 0.0
    assert err <= tol * max(1.0, float(np.abs(want).max(initial=0.0))), \
        (what, float(err))


# ---------------------------------------------------------------------------
# the flash backwards
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,skv", [(64, 64), (40, 64)])
@pytest.mark.parametrize("grouped", [False, True])
def test_chunked_attention_vjp_matches_reference(causal, sq, skv, grouped):
    """Four KV blocks of 16; bottom-right causal mask when Sq < Skv; GQA
    (3 query heads a kv head) on the grouped path."""
    rng = np.random.default_rng(1)
    d, block_k = 16, 16
    if grouped:
        qs, ks = (2, 2, 3, sq, d), (2, 2, skv, d)
        ref_fn, port_fn = (ref_ops.grouped_chunked_attention,
                           ops.grouped_chunked_attention)
    else:
        qs, ks = (3, sq, d), (3, skv, d)
        ref_fn, port_fn = ref_ops.chunked_attention, ops.chunked_attention
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in (qs, ks, ks))
    dout = rng.standard_normal(qs).astype(np.float32)
    want, vjp = jax.vjp(lambda a, b, c: ref_fn(a, b, c, causal, block_k),
                        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    wants = vjp(jnp.asarray(dout))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = port_fn(tq, tk, tv, causal=causal, block_k=block_k)
    # the tape holds the Function's five saved tensors, not its loop
    saved = out.grad_fn.saved_tensors
    assert [tuple(t.shape) for t in saved] == [qs, ks, ks, qs,
                                               qs[:-1] + (1,)]
    out.backward(torch.from_numpy(dout))
    _rel_close(out, want, ATTN_TOL, "out")
    for name, t, w in zip("qkv", (tq, tk, tv), wants):
        _rel_close(t.grad, w, ATTN_TOL, f"d{name}")


@pytest.mark.parametrize("tied", [True, False])
@pytest.mark.parametrize("chunk", [8, 256])
def test_fused_xent_vjp_matches_reference(tied, chunk):
    """Vocab 500 padded to 512 (the padding masked); with tied embeddings
    the gradient reaches ``tok`` through its transpose; chunks of 8 (four)
    and of the whole sequence."""
    rng = np.random.default_rng(2)
    cfg = dataclasses.replace(get_reduced("qwen2-0.5b"), vocab=500,
                              param_dtype="float32", tie_embeddings=tied)
    rcfg = dataclasses.replace(ref_get_reduced("qwen2-0.5b"), vocab=500,
                               param_dtype="float32", tie_embeddings=tied)
    assert cfg.vocab_padded == 512
    b, s, d = 2, 33, 16
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    emb = {"tok": rng.standard_normal((512, d)).astype(np.float32) / 4}
    if not tied:
        emb["unembed"] = rng.standard_normal((d, 512)).astype(np.float32) / 4
    toks = rng.integers(0, 500, (b, s)).astype(np.int32)

    def ref_loss(e, xx):
        w = e["tok"].T if tied else e["unembed"]
        pad = jnp.where(jnp.arange(512) < 500, 0.0, -1e30)
        return ref_layers.fused_xent(xx[:, :-1], w, jnp.asarray(toks)[:, 1:],
                                     pad, chunk)

    want, (ge, gx) = jax.value_and_grad(ref_loss, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, emb), jnp.asarray(x))
    if chunk == 256:        # the model's entry point, the reference's too
        np.testing.assert_allclose(float(ref_layers.fused_xent_loss(
            jax.tree.map(jnp.asarray, emb), jnp.asarray(x),
            jnp.asarray(toks), rcfg)), float(want), rtol=1e-6)
    te = {k: torch.from_numpy(v).requires_grad_() for k, v in emb.items()}
    tx = torch.from_numpy(x).requires_grad_()
    if chunk == 256:
        got = layers.fused_xent_loss(te, tx, torch.from_numpy(toks), cfg)
    else:
        w = te["tok"].T if tied else te["unembed"]
        pad = torch.where(torch.arange(512) < 500, 0.0, -1e30)
        got = layers.fused_xent(tx[:, :-1], w, torch.from_numpy(toks)[:, 1:],
                                pad, chunk)
    got.backward()
    assert abs(float(got.detach()) - float(want)) <= 1e-5
    # against the full logits' cross-entropy too
    lg = layers.logits({k: v.detach() for k, v in te.items()}, tx.detach(),
                       cfg)
    full = layers.xent_loss(lg[:, :-1], torch.from_numpy(toks)[:, 1:].long())
    assert abs(float(full) - float(got.detach())) <= 1e-5
    _rel_close(tx.grad, gx, ATTN_TOL, "dx")
    for k in emb:
        if te[k].grad is None:          # untied: the loss never reads tok
            assert not tied and k == "tok" and not np.abs(ge[k]).max()
            continue
        _rel_close(te[k].grad, ge[k], ATTN_TOL, f"d{k}")


# ---------------------------------------------------------------------------
# every family's loss and gradients
# ---------------------------------------------------------------------------

def _pair(arch, dtype="float32"):
    cfg = dataclasses.replace(get_reduced(arch), param_dtype=dtype)
    rcfg = dataclasses.replace(ref_get_reduced(arch), param_dtype=dtype)
    return get_model(cfg), ref_get_model(rcfg)


@pytest.mark.parametrize("impl", ["chunked", "naive"])
@pytest.mark.parametrize("family", sorted(FAMILY_ARCH))
def test_family_loss_and_grads_match_reference(family, impl):
    """The reduced model in float32 (the hybrid at 64 tokens, two windows:
    the banded local attention), seed-0 weights (bit for bit the
    reference's), the reference's batch of seed 1."""
    zoo, rzoo = _pair(FAMILY_ARCH[family])
    seq = 64 if family == "hybrid" else 32
    rb = rzoo.make_batch(RefShape("t", seq, 2, "train"), seed=1)
    tb = zoo.make_batch(ShapeConfig("t", seq, 2, "train"), seed=1,
                        device="cpu")
    want, wg = jax.jit(jax.value_and_grad(
        lambda p: rzoo.loss_fn(p, rb, impl=impl)))(rzoo.init_params(0))
    loss, grads = loss_and_grads(zoo, zoo.init_params(0, device="cpu"), tb,
                                 impl)
    assert abs(float(loss) - float(want)) <= MODEL_TOL
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(wg)[0]]
    got, ref = leaves(grads), jax.tree.leaves(wg)
    assert len(got) == len(ref) == len(paths)
    for path, g, w in zip(paths, got, ref):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, path
        _rel_close(g, w, MODEL_TOL, path)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_smoke_forward_loss(name):
    """Twin of ``tests/test_models.py::test_smoke_forward_loss``."""
    assert sorted(ARCHS) == sorted(REF_ARCHS)
    zoo = get_model(get_reduced(name))
    params = zoo.init_params(0, device="cpu")
    batch = zoo.make_batch(ShapeConfig("smoke", *SMOKE_SHAPE, "train"),
                           seed=1, device="cpu")
    loss = zoo.loss_fn(params, batch, impl="naive")
    assert np.isfinite(float(loss)), f"{name}: loss not finite"
    assert float(loss) > 0


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_smoke_train_step(name):
    """Twin of ``tests/test_models.py::test_smoke_train_step``: grads
    finite, params update, loss recomputable."""
    zoo = get_model(get_reduced(name))
    params = zoo.init_params(0, device="cpu")
    batch = zoo.make_batch(ShapeConfig("smoke", *SMOKE_SHAPE, "train"),
                           seed=2, device="cpu")
    l0, grads = loss_and_grads(zoo, params, batch, "naive")
    assert np.isfinite(float(l0))
    flat = leaves(grads)
    assert all(torch.isfinite(g.float()).all() for g in flat), \
        f"{name}: non-finite grads"
    assert any(g.abs().sum() > 0 for g in flat)
    new = [(p.float() - 0.1 * g.float()).to(p.dtype)
           for p, g in zip(leaves(params), flat)]
    with torch.no_grad():
        l1 = zoo.loss_fn(unflatten(params, new), batch, impl="naive")
    assert np.isfinite(float(l1))


def test_remat_changes_no_value():
    """remat recomputes, it does not change a number: the loss and every
    gradient with and without it are equal bit for bit, and with grad off
    the trunk is a plain call."""
    from repro_torch.models import transformer
    zoo, _ = _pair("qwen2-0.5b")
    params = zoo.init_params(0, device="cpu")
    toks = zoo.make_batch(ShapeConfig("t", 32, 2, "train"), seed=3,
                          device="cpu")["tokens"]
    outs = []
    for remat in (True, False):
        flat = [p.detach().requires_grad_() for p in leaves(params)]
        x = transformer.trunk(unflatten(params, flat), toks, zoo.cfg,
                              remat=remat)
        assert x.grad_fn is not None
        outs.append((x.detach(), torch.autograd.grad(x.sum(), flat)))
    assert torch.equal(outs[0][0], outs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(outs[0][1], outs[1][1]))
    with torch.no_grad():
        assert torch.equal(transformer.trunk(params, toks, zoo.cfg),
                           outs[0][0])


# ---------------------------------------------------------------------------
# the kernels refuse to run under grad
# ---------------------------------------------------------------------------

def _kernel_call(name):
    g = torch.Generator().manual_seed(4)
    r = lambda *s: torch.randn(*s, generator=g)
    if name == "flash_attention":
        ins = [r(4, 8, 16), r(2, 8, 16), r(2, 8, 16)]
        return ins, lambda a: flash_attention(*a)
    if name == "decode_attention":
        ins = [r(4, 1, 16), r(2, 8, 16), r(2, 8, 16)]
        lens = torch.full((2,), 8, dtype=torch.int32)
        return ins, lambda a: decode_attention(*a, lens)
    if name == "ssm_scan":
        ins = [r(1, 4, 8), torch.rand(1, 4, 8, generator=g), -torch.rand(
            8, 4, generator=g), r(1, 4, 4), r(1, 4, 4), r(8), r(1, 8, 4)]
        return ins, lambda a: ssm_scan(*a)
    if name == "rg_lru":
        ins = [torch.rand(2, 5, 8, generator=g), r(2, 5, 8), r(2, 8)]
        return ins, lambda a: rg_lru(*a)
    ins = [r(6, 16)]
    e = torch.tensor([0, 1, 0, 1, 2, 2], dtype=torch.int32)
    pos = torch.tensor([0, 0, 1, 1, 0, 1], dtype=torch.int32)
    return ins, lambda a: moe_dispatch(a[0], e, pos, 3, 2)


@pytest.mark.parametrize("name", ["flash_attention", "decode_attention",
                                  "ssm_scan", "rg_lru", "moe_dispatch"])
def test_kernel_entry_points_refuse_grad(name):
    """On inputs that require grad, with grad enabled, each kernel entry
    point raises (on the card it could not differentiate, so the CPU
    refuses too); under ``no_grad``, or on inputs that need no gradient,
    it runs as before."""
    ins, call = _kernel_call(name)
    want = call(ins)
    live = [t.clone().requires_grad_() for t in ins]
    with pytest.raises(RuntimeError, match=f"{name}: .*no backward"):
        call(live)
    with torch.no_grad():
        got = call(live)
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("family", ["dense", "ssm"])
def test_kernel_route_refuses_training(family):
    """A training step on the kernel route raises rather than drop the
    attention's or the scan's gradient."""
    zoo, _ = _pair(FAMILY_ARCH[family])
    params = zoo.init_params(0, device="cpu")
    batch = zoo.make_batch(ShapeConfig("t", 16, 1, "train"), seed=5,
                           device="cpu")
    with pytest.raises(RuntimeError, match="no backward"):
        loss_and_grads(zoo, params, batch, "kernel")
    with torch.no_grad():
        assert np.isfinite(float(zoo.loss_fn(params, batch, impl="kernel")))
