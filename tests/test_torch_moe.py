"""The port's MoE path (olmoe-1b-7b: the dispatch kernel's plain version,
``ops.moe_dispatch_combine``, ``models.moe``, serving) and the qk_norm
projection against the JAX reference, on the CPU.

Same inputs (numpy, from a seed) through the reference function and its
port; the reference's Pallas dispatch runs in interpret mode, as
``tests/test_kernels.py`` runs it.  Sizes: reduced olmoe-1b-7b (2 layers,
d 64, 4/4 heads of 16 with qk_norm, 8 experts top-2, d_ff 64, vocab 512) and
reduced qwen3-32b (qk_norm with GQA: 4/2 heads of 32).

Tolerances: the dispatch is a copy, so exact; the combine 1e-5 in float32
(the expert products in another order) and ``BF16_STEPS`` bf16 steps at
the largest |value| in bfloat16; float32 model logits 1e-4.  bf16 model
results are held to the reference run with XLA's excess precision off, in
a subprocess: compiled, XLA keeps float32 across fused bf16 chains, which
moves a hidden value by a bf16 step here and there, and a router logit a
step apart can pick another expert; on reduced olmoe that moved logits by
0.69 (about 20 bf16 steps) where, with the option off, the two agree
within 1e-5.
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
from repro.kernels import moe_dispatch as ref_md
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_oracle
from repro.models import layers as ref_layers
from repro.models import moe as ref_moe
from repro.models.zoo import get_model as ref_get_model
from repro_torch.configs import get_config, get_reduced
from repro_torch.kernels import moe_dispatch as md
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve as launch_serve
from repro_torch.models import layers, moe, params as tparams
from repro_torch.models.transformer import layer_params
from repro_torch.models.zoo import get_model
from repro_torch.serve import engine

ARCH = "olmoe-1b-7b"
TOL = 1e-5
MODEL_TOL = 1e-4
BF16_STEPS = 2
ROOT = Path(__file__).resolve().parents[1]
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _np(x) -> np.ndarray:
    return np.asarray(x, np.float32)


def _bf16_tol(want) -> float:
    """BF16_STEPS spacings of bfloat16 (8 significant bits) at the largest
    |value| of ``want``."""
    m = float(np.abs(_np(want)).max())
    return BF16_STEPS * 2.0 ** (np.floor(np.log2(m)) - 7)


# ---------------------------------------------------------------------------
# moe_dispatch: the kernel's plain version against the reference kernel
# ---------------------------------------------------------------------------

def _assignments(rng, t, e, k):
    """Top-k style expert choices (k distinct experts per token) and their
    running positions within each expert, as ``ops.moe_dispatch_combine``
    computes them."""
    eidx = np.argsort(rng.random((t, e)), 1)[:, :k]
    flat_e = eidx.reshape(-1)
    onehot = np.eye(e, dtype=np.int64)[flat_e]
    pos = (np.cumsum(onehot, 0) - onehot)[np.arange(len(flat_e)), flat_e]
    return eidx, flat_e, pos


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,dm,e,k,cap", [(64, 32, 8, 2, 32),
                                          (128, 64, 16, 4, 64),
                                          (37, 20, 8, 3, 8)])
def test_moe_dispatch_matches_reference_kernel(dtype, t, dm, e, k, cap):
    """``tests/test_kernels.py``'s cases, then A = 111 (no multiple of 8 or
    of a 256-row block) with a capacity that drops rows."""
    rng = np.random.default_rng(e + t)
    tokens = rng.standard_normal((t * k, dm)).astype(np.float32)
    _, flat_e, pos = _assignments(rng, t, e, k)
    want = ref_md.moe_dispatch(jnp.asarray(tokens, JNP[dtype]),
                               jnp.asarray(flat_e), jnp.asarray(pos), e, cap)
    got = md.moe_dispatch(torch.from_numpy(tokens).to(TORCH[dtype]),
                          torch.from_numpy(flat_e.astype(np.int32)),
                          torch.from_numpy(pos.astype(np.int32)), e, cap)
    assert got.dtype == TORCH[dtype] and got.shape == (e, cap, dm)
    np.testing.assert_array_equal(got.float().numpy(), _np(want))
    if (pos >= cap).any():
        assert got.float().abs().sum() < np.abs(tokens).sum()


def test_moe_dispatch_any_row_count_matches_the_oracle():
    """A = 300 is no multiple of the reference kernel's 256-row block (it
    asserts whole blocks), so the port is held to the numpy oracles; out of
    range experts and negative positions drop, as the reference kernel's
    one-hot drops them."""
    rng = np.random.default_rng(3)
    a, d, e, cap = 300, 10, 8, 24
    tokens = rng.standard_normal((a, d)).astype(np.float32)
    flat_e = rng.integers(-1, e + 1, a)
    pos = rng.integers(-2, cap + 5, a)
    flat_e[:e], pos[:e] = np.arange(e), 0           # unique kept slots
    _, idx = np.unique(flat_e * 1000 + pos, return_index=True)
    tokens, flat_e, pos = tokens[idx], flat_e[idx], pos[idx]
    got = md.moe_dispatch(torch.from_numpy(tokens),
                          torch.from_numpy(flat_e.astype(np.int32)),
                          torch.from_numpy(pos.astype(np.int32)), e, cap)
    want = ref.moe_dispatch_ref(tokens, flat_e, pos, e, cap)
    np.testing.assert_array_equal(got.numpy(), want)
    in_range = (flat_e >= 0) & (flat_e < e) & (pos >= 0) & (pos < cap)
    np.testing.assert_array_equal(
        want, ref_oracle.moe_dispatch_ref(tokens[in_range], flat_e[in_range],
                                          pos[in_range], e, cap))


def test_moe_dispatch_refuses_what_it_cannot_take():
    tok = torch.zeros(4, 8)
    e32 = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        md.moe_dispatch(tok, e32.long(), e32, 2, 4)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        md.moe_dispatch(tok.double(), e32, e32, 2, 4)
    with pytest.raises(ValueError, match=r"positions \[4\]"):
        md.moe_dispatch(tok, e32, e32[:3], 2, 4)


# ---------------------------------------------------------------------------
# ops.moe_dispatch_combine and moe_dense_einsum
# ---------------------------------------------------------------------------

def _router(rng, t, e, k):
    logits = rng.standard_normal((t, e)).astype(np.float32)
    gates, eidx = jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits)), k)
    return np.array(gates), np.array(eidx)


def _expert_fn(lib):
    """The reference test's expert: elementwise, zero rows stay zero, in the
    buffer's dtype (JAX's ``1.0 * mask`` is weakly typed, torch's is not)."""
    if lib == "jax":
        return lambda d: d * 2.0 + 1.0 * (d != 0)
    return lambda d: d * 2.0 + (d != 0).to(d.dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cap", [32, 8])
def test_moe_dispatch_combine_matches_reference(dtype, cap):
    """Both port routes against both reference routes; capacity 8 drops
    about half the assignments."""
    rng = np.random.default_rng(5)
    t, dm, e, k = 64, 32, 8, 2
    tokens = rng.standard_normal((t, dm)).astype(np.float32)
    gates, eidx = _router(rng, t, e, k)
    jt = jnp.asarray(tokens, JNP[dtype])
    tt = torch.from_numpy(tokens).to(TORCH[dtype])
    tg, te = torch.from_numpy(gates), torch.from_numpy(eidx.astype(np.int64))
    want = {impl: ref_ops.moe_dispatch_combine(
        jt, jnp.asarray(gates), jnp.asarray(eidx), e, cap, _expert_fn("jax"),
        impl=impl) for impl in ("pallas", "scatter")}
    np.testing.assert_array_equal(_np(want["pallas"]), _np(want["scatter"]))
    for impl in ("kernel", "scatter"):
        got = ops.moe_dispatch_combine(tt, tg, te, e, cap,
                                       _expert_fn("torch"), impl=impl)
        assert got.dtype == TORCH[dtype]
        tol = TOL if dtype == "float32" else _bf16_tol(want["pallas"])
        np.testing.assert_allclose(got.float().numpy(), _np(want["pallas"]),
                                   atol=tol, rtol=0)


def test_moe_paths_agree():
    """The revet compaction route == the dense einsum (MapReduce) route, as
    the reference's ``test_moe_paths_agree``, with and without drops."""
    rng = np.random.default_rng(5)
    t, dm, e, k = 64, 32, 8, 2
    tokens = torch.from_numpy(rng.standard_normal((t, dm)).astype(np.float32))
    gates, eidx = _router(rng, t, e, k)
    tg, te = torch.from_numpy(gates), torch.from_numpy(eidx.astype(np.int64))
    for cap in (32, 8):
        got = ops.moe_dispatch_combine(tokens, tg, te, e, cap,
                                       _expert_fn("torch"))
        want = ops.moe_dense_einsum(tokens, tg, te, e, cap,
                                    _expert_fn("torch"))
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL,
                                   rtol=TOL)


def test_moe_combine_unknown_impl_raises():
    with pytest.raises(ValueError, match="'pallas' route is 'kernel'"):
        ops.moe_dispatch_combine(torch.zeros(2, 4), torch.ones(2, 1),
                                 torch.zeros(2, 1, dtype=torch.long), 2, 8,
                                 lambda d: d, impl="pallas")


# ---------------------------------------------------------------------------
# the router's top-k under ties
# ---------------------------------------------------------------------------

def test_top_k_orders_ties_as_lax_top_k():
    """Ties at the k-th place and inside the top k: the lower index first,
    as ``jax.lax.top_k``."""
    probs = np.array([[0.1, 0.3, 0.3, 0.1, 0.2, 0.3, 0.1, 0.1],
                      [0.2, 0.1, 0.2, 0.2, 0.1, 0.2, 0.0, 0.0],
                      [0.5] * 8,
                      [0.0, 0.4, 0.1, 0.4, 0.1, 0.0, 0.1, 0.4]], np.float32)
    for k in (1, 2, 3, 4, 8):
        wv, wi = jax.lax.top_k(jnp.asarray(probs), k)
        gv, gi = moe.top_k(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


def test_route_matches_reference_with_tied_router_columns():
    """Experts 2 and 5 share a router column and expert 7 copies expert 0's,
    so their bf16 logits tie on every token; the gates and choices equal
    the reference's ``moe_ff`` router."""
    cfg = get_reduced(ARCH)
    rng = np.random.default_rng(11)
    w = rng.standard_normal((cfg.d_model, cfg.n_experts)).astype(np.float32)
    w[:, 5], w[:, 7] = w[:, 2], w[:, 0]
    x = rng.standard_normal((40, cfg.d_model)).astype(np.float32)
    for dtype in ("bfloat16", "float32"):
        jw, jx = jnp.asarray(w, JNP[dtype]), jnp.asarray(x, JNP[dtype])
        logits = (jx @ jw).astype(jnp.float32)
        wg, wi = jax.lax.top_k(jax.nn.softmax(logits, -1), cfg.top_k)
        wg = wg / jnp.maximum(wg.sum(-1, keepdims=True), 1e-9)
        _, gg, gi = moe.route({"router": torch.from_numpy(w).to(
            TORCH[dtype])}, torch.from_numpy(x).to(TORCH[dtype]), cfg)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_allclose(gg.numpy(), np.asarray(wg), atol=1e-6,
                                   rtol=0)


# ---------------------------------------------------------------------------
# reduced olmoe-1b-7b
# ---------------------------------------------------------------------------

def _cfgs(dtype=None):
    cfg, rcfg = get_reduced(ARCH), ref_get_reduced(ARCH)
    if dtype:
        cfg = dataclasses.replace(cfg, param_dtype=dtype)
        rcfg = dataclasses.replace(rcfg, param_dtype=dtype)
    return cfg, rcfg


@pytest.fixture(scope="module")
def reduced():
    """(port cfg, reference cfg, port params, reference params), bf16."""
    cfg, rcfg = _cfgs()
    return (cfg, rcfg, get_model(cfg).init_params(0, device="cpu"),
            ref_get_model(rcfg).init_params(0))


@pytest.fixture(scope="module")
def reduced32():
    cfg, rcfg = _cfgs("float32")
    return (cfg, rcfg, get_model(cfg).init_params(0, device="cpu"),
            ref_get_model(rcfg).init_params(0))


def _tokens(cfg, seed, shape):
    return np.random.default_rng(seed).integers(1, cfg.vocab, shape).astype(
        np.int32)


@pytest.mark.parametrize("which", ["reduced", "reduced32"])
def test_params_bit_identical_to_reference(request, which):
    cfg, _, tp, rp = request.getfixturevalue(which)
    got, want = tparams.leaves(tp), jax.tree.leaves(rp)
    assert len(got) == len(want) == 15
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        if g.dtype == torch.bfloat16:
            np.testing.assert_array_equal(g.view(torch.int16).numpy(),
                                          w.view(np.int16))
        else:
            np.testing.assert_array_equal(g.numpy(), w)


def test_n_params_full_config():
    port = get_model(get_config(ARCH)).n_params()
    assert port == ref_get_model(ref_get_config(ARCH)).n_params() \
        == 6919624704


def test_capacity_matches_reference():
    for arch in (ARCH, "dbrx-132b"):
        cfg, rcfg = get_config(arch), ref_get_config(arch)
        for n in (1, 4, 7, 24, 512, 4096):
            assert moe.capacity(cfg, n) == ref_moe.capacity(rcfg, n)
    assert moe.capacity(get_config(ARCH), 512) == 80
    assert moe.capacity(get_config(ARCH), 4) == 8


@pytest.mark.parametrize("path", ["revet", "dense"])
@pytest.mark.parametrize("impl,rimpl", [("kernel", "pallas"),
                                        ("naive", "naive")])
def test_forward_float32_matches_reference(reduced32, path, impl, rimpl):
    cfg, rcfg, tp, rp = reduced32
    toks = _tokens(cfg, 1, (2, 24))
    want, waux = ref_moe.forward(rp, jnp.asarray(toks), rcfg, impl=rimpl,
                                 remat=False, path=path)
    got, gaux = moe.forward(tp, torch.from_numpy(toks), cfg, impl=impl,
                            path=path)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=MODEL_TOL,
                               rtol=MODEL_TOL)
    np.testing.assert_allclose(float(gaux), float(waux), rtol=MODEL_TOL)


def test_model_paths_agree(reduced32):
    """revet and dense dispatch give the same logits (the reference's
    ``test_moe_paths_agree_in_model``), here with a prompt long enough that
    the capacity drops assignments."""
    cfg, _, tp, _ = reduced32
    toks = torch.from_numpy(_tokens(cfg, 2, (1, 128)))
    x = layers.embed(tp["embed"], toks).reshape(128, -1)
    lp = layer_params(tp, 0)
    _, _, eidx = moe.route(lp["moe"], layers.apply_norm(lp["ln2"], x, cfg),
                           cfg)
    counts = np.bincount(eidx.reshape(-1).numpy(), minlength=cfg.n_experts)
    assert counts.max() > moe.capacity(cfg, 128)    # some rows drop
    a, _ = moe.forward(tp, toks, cfg, path="revet")
    b, _ = moe.forward(tp, toks, cfg, path="dense")
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=MODEL_TOL,
                               rtol=MODEL_TOL)


@pytest.mark.parametrize("s,max_len", [(24, 40), (7, 16)])
def test_prefill_and_decode_match_reference(reduced32, s, max_len):
    cfg, rcfg, tp, rp = reduced32
    toks = _tokens(cfg, 3, (2, s))
    wl, wc, wp = ref_moe.prefill(rp, jnp.asarray(toks), rcfg, max_len,
                                 impl="naive")
    gl, gc, gp = moe.prefill(tp, torch.from_numpy(toks), cfg, max_len,
                             impl="kernel")
    np.testing.assert_allclose(gl.numpy(), _np(wl), atol=MODEL_TOL,
                               rtol=MODEL_TOL)
    for key in ("k", "v"):
        assert tuple(gc[key].shape) == wc[key].shape
        np.testing.assert_allclose(gc[key].numpy(), _np(wc[key]),
                                   atol=MODEL_TOL, rtol=MODEL_TOL)
    assert gp.tolist() == np.asarray(wp).tolist()
    nxt = _tokens(cfg, 4, (2, 3))
    for j in range(3):
        wl, wc, wp = ref_moe.decode_step(rp, jnp.asarray(nxt[:, j:j + 1]),
                                         wc, wp, rcfg)
        gl, gc, gp = moe.decode_step(tp, torch.from_numpy(nxt[:, j:j + 1]),
                                     gc, gp, cfg)
        np.testing.assert_allclose(gl.numpy(), _np(wl), atol=MODEL_TOL,
                                   rtol=MODEL_TOL)
    assert gp.tolist() == np.asarray(wp).tolist()


def test_init_cache_is_the_dense_layout(reduced):
    cfg, rcfg, _, _ = reduced
    got = get_model(cfg).init_cache(3, 20, device="cpu")
    want = ref_get_model(rcfg).init_cache(3, 20)
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}
    assert all(v.dtype == torch.bfloat16 for v in got.values())


# -- bfloat16, against the reference with XLA's excess precision off ----------

_REF_BF16 = textwrap.dedent("""
    import json, sys
    import jax.numpy as jnp
    import numpy as np
    from repro.configs import get_reduced
    from repro.models import moe
    from repro.models.zoo import get_model
    from repro.serve.engine import DecodeEngine, Request
    cfg = get_reduced({arch!r})
    zoo = get_model(cfg)
    params = zoo.init_params(0)
    toks = np.load({toks!r})
    out = {{}}
    for path in ("revet", "dense"):
        lg, aux = moe.forward(params, jnp.asarray(toks), cfg, impl="naive",
                              remat=False, path=path)
        out["forward_" + path] = np.asarray(lg, np.float32)
    lg, cache, pos = moe.prefill(params, jnp.asarray(toks), cfg, 40)
    steps = [np.asarray(lg, np.float32)]
    for j in range(3):
        lg, cache, pos = zoo.decode_step(params, jnp.asarray(toks[:, j:j + 1]),
                                         cache, pos)
        steps.append(np.asarray(lg, np.float32))
    out["served"] = np.concatenate(steps, 1)
    np.savez({out!r}, **out)
    eng = DecodeEngine(zoo, params, batch_slots=3, max_len=64)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(1, cfg.vocab, size=n)
                    .astype(np.int32), max_new=8)
            for i, n in enumerate({lens!r})]
    for r in reqs:
        eng.submit(r)
    assert eng.run_until_drained() == []
    print(json.dumps({{"tokens": [r.tokens for r in reqs],
                      "done": [r.done for r in reqs],
                      "stats": eng.stats()}}))
""")
PROMPT_LENS = (9, 2, 40, 17, 30)


@pytest.fixture(scope="module")
def ref_bf16(tmp_path_factory, reduced):
    """The reference's bf16 forward (both paths), prefill + 3 decode steps
    and engine tokens, from one process with XLA's excess precision off."""
    cfg = reduced[0]
    tmp = tmp_path_factory.mktemp("moe_ref")
    toks = _tokens(cfg, 6, (2, 24))
    np.save(tmp / "toks.npy", toks)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "") +
                          " --xla_allow_excess_precision=false").strip())
    code = _REF_BF16.format(arch=ARCH, toks=str(tmp / "toks.npy"),
                            out=str(tmp / "out.npz"), lens=PROMPT_LENS)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    arrays = dict(np.load(tmp / "out.npz"))
    return toks, arrays, json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("path", ["revet", "dense"])
def test_forward_bfloat16_matches_reference(reduced, ref_bf16, path):
    cfg, _, tp, _ = reduced
    toks, want, _ = ref_bf16
    got, _ = moe.forward(tp, torch.from_numpy(toks), cfg, impl="kernel",
                         path=path)
    w = want["forward_" + path]
    np.testing.assert_allclose(got.numpy(), w, atol=_bf16_tol(w), rtol=0)


def test_prefill_and_decode_bfloat16_match_reference(reduced, ref_bf16):
    cfg, _, tp, _ = reduced
    toks, want, _ = ref_bf16
    lg, cache, pos = moe.prefill(tp, torch.from_numpy(toks), cfg, 40,
                                 impl="kernel")
    steps = [lg]
    for j in range(3):
        lg, cache, pos = get_model(cfg).decode_step(
            tp, torch.from_numpy(toks[:, j:j + 1]), cache, pos)
        steps.append(lg)
    w = want["served"]
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(), w,
                               atol=_bf16_tol(w), rtol=0)


def test_decode_engine_tokens_identical_to_reference(reduced, ref_bf16):
    cfg, _, tp, _ = reduced
    want = ref_bf16[2]
    rng = np.random.default_rng(0)
    got = [engine.Request(rid=i, prompt=rng.integers(1, cfg.vocab, size=n)
                          .astype(np.int32), max_new=8)
           for i, n in enumerate(PROMPT_LENS)]
    eng = engine.DecodeEngine(get_model(cfg), tp, batch_slots=3, max_len=64,
                              device="cpu")
    assert eng.impl == "kernel"
    for r in got:
        eng.submit(r)
    assert eng.run_until_drained() == []
    assert [r.tokens for r in got] == want["tokens"]
    assert all(r.done for r in got) and all(want["done"])
    assert eng.stats() == want["stats"]


def test_launch_serve_olmoe_finishes_every_request(capsys):
    res = launch_serve.main(["--arch", ARCH, "--requests", "5", "--slots",
                             "2", "--max-new", "6"], device="cpu")
    out = capsys.readouterr().out
    assert "served 5 requests" in out and "decode steps" in out
    assert res["tokens"] >= 5 and res["peak_occupancy"] == 2


# ---------------------------------------------------------------------------
# qk_norm (olmoe, qwen3): the projection and the decode step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [ARCH, "qwen3-32b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qk_norm_projection_and_decode_match_reference(arch, dtype):
    """rms-norm of q and k per head before RoPE, in ``_project_qkv`` and in
    the decode step, on reduced olmoe (MHA) and reduced qwen3-32b (GQA);
    the reference runs op by op here, so bf16 rounds as the port does."""
    cfg = dataclasses.replace(get_reduced(arch), param_dtype=dtype)
    rcfg = dataclasses.replace(ref_get_reduced(arch), param_dtype=dtype)
    assert cfg.qk_norm and rcfg.qk_norm
    rp = ref_get_model(rcfg).init_params(0)["layers"]["attn"]
    rp = jax.tree.map(lambda a: a[0], rp)
    rng = np.random.default_rng(12)
    tp = tparams.from_numpy(jax.tree.map(np.asarray, rp), device="cpu")
    # non-trivial norm weights, so that a missing or misplaced norm shows
    qn = (1 + 0.5 * rng.standard_normal(cfg.hd)).astype(np.float32)
    kn = (1 + 0.5 * rng.standard_normal(cfg.hd)).astype(np.float32)
    rp = {**rp, "qn": jnp.asarray(qn, JNP[dtype]),
          "kn": jnp.asarray(kn, JNP[dtype])}
    tp = {**tp, "qn": torch.from_numpy(qn).to(TORCH[dtype]),
          "kn": torch.from_numpy(kn).to(TORCH[dtype])}
    b, s = 2, 12
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    positions = np.broadcast_to(np.arange(s)[None], (b, s)).astype(np.int32)
    want = ref_layers._project_qkv(rp, jnp.asarray(x, JNP[dtype]), rcfg,
                                   jnp.asarray(positions))
    got = layers._project_qkv(tp, torch.from_numpy(x).to(TORCH[dtype]), cfg,
                              torch.from_numpy(positions))
    tol = 1e-5 if dtype == "float32" else None
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and g.dtype == TORCH[dtype]
        np.testing.assert_allclose(g.float().numpy(), _np(w),
                                   atol=tol or _bf16_tol(w), rtol=0)
    ck = rng.standard_normal((b, cfg.n_kv_heads, 16, cfg.hd)).astype(
        np.float32)
    cv = rng.standard_normal(ck.shape).astype(np.float32)
    pos = np.array([5, 11], np.int32)
    xd = x[:, :1]
    w_out, w_k, w_v = ref_layers.decode_attention_step(
        rp, jnp.asarray(xd, JNP[dtype]), rcfg, jnp.asarray(ck, JNP[dtype]),
        jnp.asarray(cv, JNP[dtype]), jnp.asarray(pos))
    g_out, g_k, g_v = layers.decode_attention_step(
        tp, torch.from_numpy(xd).to(TORCH[dtype]), cfg,
        torch.from_numpy(ck).to(TORCH[dtype]),
        torch.from_numpy(cv).to(TORCH[dtype]), torch.from_numpy(pos))
    for g, w in ((g_out, w_out), (g_k, w_k), (g_v, w_v)):
        np.testing.assert_allclose(g.float().numpy(), _np(w),
                                   atol=tol or _bf16_tol(w), rtol=0)
