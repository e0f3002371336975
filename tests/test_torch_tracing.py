"""The port's recorder (``repro_torch.tracing``) and its sites, on the CPU.

The recorder's own semantics (off records nothing; on, spans nest with
their parents' ids and request ids, counters split by the innermost span;
``drain()`` empties it), then its sites: with tracing off an engine step
and a train step dispatch exactly the ATen ops they dispatched before the
sites were added (``PARENT_OPS``, counted under a ``TorchDispatchMode`` on
the tree before them), served tokens are the same on and off, the spans
and counters an engine records (on the CPU the decode attention counts
reference rows only), ``moe.kept`` against a hand count, and one
``train.backward`` a train step.
"""
import collections

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import tracing
from repro_torch.configs import get_reduced
from repro_torch.kernels import ops
from repro_torch.launch import train
from repro_torch.models import moe
from repro_torch.models.zoo import get_model
from repro_torch.optim import adamw
from repro_torch.serve.engine import DecodeEngine, Request

ARCHS = {"dense": "qwen2-0.5b", "moe": "olmoe-1b-7b"}

PARENT_OPS = {
    "dense": {
        "_local_scalar_dense.default": 2, "_softmax.default": 2,
        "_to_copy.default": 128, "_unsafe_view.default": 49, "add.Tensor": 60,
        "amax.default": 4, "arange.default": 16, "arange.start": 12,
        "argmax.default": 3, "bmm.default": 14, "cat.default": 12,
        "clamp.default": 6, "clamp_min.default": 4, "clone.default": 12,
        "constant_pad_nd.default": 8, "copy_.default": 8, "cos.default": 12,
        "detach.default": 2, "div.Tensor": 18, "embedding.default": 3,
        "eq.Tensor": 4, "exp.default": 4, "expand.default": 6,
        "full.default": 2, "le.Tensor": 4, "lift_fresh.default": 4,
        "lt.Tensor": 2, "mean.dim": 15, "mm.default": 43, "mul.Tensor": 115,
        "neg.default": 12, "permute.default": 63, "pow.Scalar": 12,
        "rsqrt.default": 15, "scalar_tensor.default": 6, "select.int": 89,
        "silu.default": 6, "sin.default": 12, "slice.Tensor": 54,
        "stack.default": 6, "sub.Tensor": 16, "sum.dim_IntList": 4,
        "transpose.int": 24, "unsqueeze.default": 91, "view.default": 147,
        "where.self": 10},
    "moe": {
        "_local_scalar_dense.default": 14, "_softmax.default": 12,
        "_to_copy.default": 164, "_unsafe_view.default": 41, "add.Tensor": 72,
        "amax.default": 4, "aminmax.default": 6, "arange.default": 16,
        "arange.start": 12, "argmax.default": 3, "bmm.default": 32,
        "cat.default": 12, "clamp.default": 22, "clamp_min.default": 4,
        "clone.default": 28, "constant_pad_nd.default": 8, "copy_.default": 8,
        "cos.default": 12, "cumsum.default": 6, "detach.default": 2,
        "div.Tensor": 28, "embedding.default": 9, "eq.Tensor": 4,
        "exp.default": 4, "expand.default": 12, "full.default": 2,
        "gather.default": 12, "index_add.default": 4, "index_put_.default": 6,
        "le.Tensor": 4, "lift_fresh.default": 4, "lt.Scalar": 6,
        "lt.Tensor": 2, "mean.dim": 31, "mm.default": 31, "mul.Tensor": 171,
        "neg.default": 12, "new_zeros.default": 6, "ones.default": 4,
        "permute.default": 60, "pow.Scalar": 12, "rsqrt.default": 27,
        "scalar_tensor.default": 18, "scatter_.value": 6, "select.int": 113,
        "silu.default": 6, "sin.default": 12, "slice.Tensor": 60,
        "sort.stable": 6, "stack.default": 6, "sub.Tensor": 22,
        "sum.default": 8, "sum.dim_IntList": 10, "transpose.int": 24,
        "unsqueeze.default": 127, "view.default": 165, "where.self": 22,
        "zeros.default": 10, "zeros_like.default": 6},
    "train": {
        "_softmax.default": 1, "_to_copy.default": 188,
        "_unsafe_view.default": 50, "add.Tensor": 122, "add_.Tensor": 56,
        "alias.default": 17, "amax.default": 4, "arange.default": 14,
        "arange.start": 8, "bmm.default": 20, "cat.default": 13,
        "clamp.default": 3, "clamp_min.default": 8, "clone.default": 22,
        "cos.default": 9, "detach.default": 157, "div.Scalar": 5,
        "div.Tensor": 44, "div_.Tensor": 14, "embedding.default": 1,
        "embedding_dense_backward.default": 1, "exp.default": 10,
        "expand.default": 6, "full.default": 5, "gather.default": 1,
        "le.Tensor": 6, "log.default": 4, "logsumexp.default": 1,
        "lt.Scalar": 1, "maximum.default": 4, "mean.dim": 9, "mm.default": 56,
        "mul.Scalar": 5, "mul.Tensor": 236, "mul_.Tensor": 28,
        "neg.default": 12, "ones_like.default": 1, "permute.default": 102,
        "pow.Scalar": 10, "pow.Tensor_Scalar": 19, "reciprocal.default": 1,
        "rsqrt.default": 9, "rsub.Scalar": 2, "scalar_tensor.default": 12,
        "scatter_add_.default": 1, "select.int": 1, "silu.default": 4,
        "silu_backward.default": 2, "sin.default": 8, "slice.Tensor": 26,
        "slice_backward.default": 9, "sqrt.default": 15, "stack.default": 12,
        "sub.Tensor": 22, "sub_.Tensor": 14, "sum.default": 15,
        "sum.dim_IntList": 22, "t.default": 28, "transpose.int": 24,
        "unbind.int": 12, "unsqueeze.default": 87, "view.default": 163,
        "where.self": 7, "zeros.default": 13},
}


@pytest.fixture(autouse=True)
def _recorder_off():
    """Every test starts and ends with the recorder off and empty."""
    tracing.disable()
    tracing.drain()
    yield
    tracing.disable()
    tracing.drain()


class _Ops(TorchDispatchMode):
    """Counts every ATen op dispatched under it, by name."""

    def __init__(self):
        super().__init__()
        self.n = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n[str(func).removeprefix("aten.")] += 1
        return func(*args, **(kwargs or {}))


def _engine(kind: str, slots: int = 2, max_len: int = 32):
    zoo = get_model(get_reduced(ARCHS[kind]))
    return DecodeEngine(zoo, zoo.init_params(0, device="cpu"), slots,
                        max_len, device="cpu")


def _requests(sizes=(5, 9), max_new: int = 4):
    return [Request(rid=i, prompt=np.arange(1, n + 1, dtype=np.int32),
                    max_new=max_new) for i, n in enumerate(sizes)]


def _train_step():
    zoo = get_model(get_reduced("qwen2-0.5b"))
    params = zoo.init_params(0, device="cpu")
    state = {"params": params, "opt": adamw.init_state(params)}
    step = train.build_step(zoo, adamw.OptConfig(), "chunked", None)
    toks = torch.arange(2 * 16, dtype=torch.int32).reshape(2, 16) % 500 + 1
    return step, state, {"tokens": toks}


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------

def test_off_records_nothing():
    assert tracing.on is False
    assert tracing.span("a") is tracing.span("b", rid=1, device=True)
    with tracing.span("a", rid=1):
        tracing.count("c", 3)
        tracing.count("c", torch.ones(4))
    assert tracing.drain() == {"spans": [], "counters": {}}


def test_on_records_nesting_rids_and_counters_by_innermost_span():
    tracing.enable()
    tracing.count("c", 5)
    with tracing.span("outer", rid=7):
        tracing.count("c", 2)
        with tracing.span("inner", rid=7, device=True):
            tracing.count("c", torch.tensor([True, False, True]))
            tracing.count("c", torch.tensor([4]))
        with tracing.span("inner"):
            tracing.count("d", 1)
    got = tracing.drain()
    assert tracing.on is True
    outer, in1, in2 = got["spans"]
    assert [s["name"] for s in got["spans"]] == ["outer", "inner", "inner"]
    assert outer["parent"] is None
    assert in1["parent"] == in2["parent"] == outer["id"]
    assert len({outer["id"], in1["id"], in2["id"]}) == 3
    assert (outer["rid"], in1["rid"], in2["rid"]) == (7, 7, None)
    assert outer["start_ns"] <= in1["start_ns"] <= in1["end_ns"] \
        <= in2["start_ns"] <= in2["end_ns"] <= outer["end_ns"]
    # without a card a device span's device times are its host times
    assert (in1["device_start_ns"], in1["device_end_ns"]) == \
        (in1["start_ns"], in1["end_ns"])
    assert "device_start_ns" not in outer
    assert got["counters"] == {("c", None): 5, ("c", "outer"): 2,
                               ("c", "inner"): 6, ("d", "inner"): 1}
    assert all(type(v) is int for v in got["counters"].values())
    assert tracing.drain() == {"spans": [], "counters": {}}
    tracing.disable()
    with tracing.span("late"):
        pass
    assert tracing.drain()["spans"] == []


def test_spans_are_profiler_ranges():
    from torch.profiler import ProfilerActivity, profile
    tracing.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("engine.decode"):
            torch.ones(3).sum()
    names = {ev.name for ev in prof.events()}
    assert "engine.decode" in names


# ---------------------------------------------------------------------------
# the sites, off: the parent's ops, one for one
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["dense", "moe", "train"])
def test_off_dispatches_the_parents_ops(kind):
    """An engine step that admits two requests (two prefills, two splices)
    and decodes once, or a train step, with the recorder off."""
    if kind == "train":
        step, state, batch = _train_step()
        with _Ops() as m:
            step(state, batch)
    else:
        eng = _engine(kind)
        for r in _requests():
            eng.submit(r)
        with _Ops() as m:
            eng.step()
    assert dict(m.n) == PARENT_OPS[kind]


# ---------------------------------------------------------------------------
# the sites, on
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["dense", "moe"])
def test_served_tokens_identical_on_and_off(kind):
    served = {}
    for state in (False, True):
        if state:
            tracing.enable()
        eng = _engine(kind)
        reqs = _requests((5, 9, 3), max_new=5)
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained()
        served[state] = [r.tokens for r in reqs]
    assert served[True] == served[False]


@pytest.mark.parametrize("kind", ["dense", "moe"])
def test_engine_spans_and_counters(kind):
    eng = _engine(kind)
    reqs = _requests((5, 9, 3), max_new=5)
    for r in reqs:
        eng.submit(r)
    tracing.enable()
    eng.run_until_drained()
    got = tracing.drain()
    spans = got["spans"]
    by = collections.defaultdict(list)
    for s in spans:
        by[s["name"]].append(s)
    n_layers = eng.zoo.cfg.n_layers
    assert sorted(s["rid"] for s in by["engine.prefill"]) == [0, 1, 2]
    assert sorted(s["rid"] for s in by["engine.splice"]) == [0, 1, 2]
    assert len(by["engine.decode"]) == eng.steps
    for name in ("engine.prefill", "engine.splice", "engine.decode"):
        assert all(s["parent"] is None and s["device"] for s in by[name])
    decode_ids = {s["id"] for s in by["engine.decode"]}
    # a decode step's cache work: each layer's write and attention, then
    # the stack of every layer's K and V
    assert len(by["decode.kv"]) == eng.steps * (n_layers + 1)
    assert {s["parent"] for s in by["decode.kv"]} == decode_ids
    assert set(by) == {"engine.prefill", "engine.splice", "engine.decode",
                       "decode.kv"}
    c = got["counters"]
    cfg = eng.zoo.cfg
    # on the CPU every layer's decode attention takes the reference route
    ref_rows = {("decode.ref_rows", "decode.kv"):
                n_layers * eng.steps * eng.b * cfg.n_kv_heads}
    if kind == "dense":
        assert c == ref_rows
        return
    prompt = sum(len(r.prompt) for r in reqs)
    assert c[("moe.assignments", "engine.prefill")] == \
        n_layers * prompt * cfg.top_k
    assert c[("moe.assignments", "engine.decode")] == \
        n_layers * eng.steps * eng.b * cfg.top_k
    assert c[("moe.slots", "engine.decode")] == n_layers * eng.steps \
        * cfg.n_experts * moe.capacity(cfg, eng.b)
    assert c[("moe.slots", "engine.prefill")] == n_layers * sum(
        cfg.n_experts * moe.capacity(cfg, len(r.prompt)) for r in reqs)
    for phase in ("engine.prefill", "engine.decode"):
        assert 0 < c[("moe.kept", phase)] <= c[("moe.assignments", phase)]
    assert set(c) == {(n, p) for n in ("moe.assignments", "moe.kept",
                                       "moe.slots")
                      for p in ("engine.prefill", "engine.decode")} | set(
        ref_rows)
    assert all(c[k] == v for k, v in ref_rows.items())


def test_moe_kept_counts_by_hand():
    """Twelve assignments over four experts of capacity 2: expert 0 gets
    five and keeps two, the others two each, so 8 are kept."""
    tokens = torch.randn(6, 4)
    gates = torch.full((6, 2), 0.5)
    eidx = torch.tensor([[0, 1], [0, 1], [0, 2], [0, 2], [0, 3], [1, 3]])
    tracing.enable()
    with tracing.span("phase"):
        ops.moe_dispatch_combine(tokens, gates, eidx, 4, 2, lambda x: x,
                                 impl="scatter")
    assert tracing.drain()["counters"] == {
        ("moe.assignments", "phase"): 12, ("moe.kept", "phase"): 8,
        ("moe.slots", "phase"): 8}


def test_moe_kept_matches_a_hand_count_in_a_model(monkeypatch):
    """A reduced olmoe prefill of 40 tokens at capacity factor 0.01: 80
    assignments over 8 experts of 8 slots, so some must drop.  Each
    layer's kept count is the sum over experts of min(assigned, capacity),
    from the routing the dispatch got."""
    import dataclasses
    cfg = dataclasses.replace(get_reduced("olmoe-1b-7b"),
                              capacity_factor=0.01)
    zoo = get_model(cfg)
    params = zoo.init_params(0, device="cpu")
    seen = []
    inner = ops.moe_dispatch_combine

    def spy(tokens, gates, eidx, n_experts, capacity, fn, impl="kernel"):
        seen.append((eidx.clone(), n_experts, capacity))
        return inner(tokens, gates, eidx, n_experts, capacity, fn, impl)

    monkeypatch.setattr(ops, "moe_dispatch_combine", spy)
    tokens = torch.as_tensor(np.arange(1, 41, dtype=np.int32) * 7 % 500)
    tracing.enable()
    with tracing.span("engine.prefill"):
        zoo.prefill(params, {"tokens": tokens[None]}, 64, impl="kernel")
    c = tracing.drain()["counters"]
    assert len(seen) == cfg.n_layers
    hand = 0
    for eidx, e, cap in seen:
        n = torch.bincount(eidx.reshape(-1), minlength=e)
        hand += int(torch.clamp(n, max=cap).sum())
    assert c[("moe.assignments", "engine.prefill")] == \
        cfg.n_layers * 40 * cfg.top_k
    assert c[("moe.kept", "engine.prefill")] == hand
    assert hand < c[("moe.assignments", "engine.prefill")]


def test_train_backward_once_per_step():
    step, state, batch = _train_step()
    tracing.enable()
    losses = []
    for _ in range(2):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    spans = tracing.drain()["spans"]
    assert [s["name"] for s in spans] == ["train.backward"] * 2
    assert all(s["parent"] is None and s["device"]
               and s["end_ns"] > s["start_ns"] for s in spans)
    tracing.disable()
    step, state, batch = _train_step()
    off = []
    for _ in range(2):
        state, metrics = step(state, batch)
        off.append(float(metrics["loss"]))
    assert off == losses
