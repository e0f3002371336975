"""The end-to-end arithmetic and the per-layer readers on hand-made
traces, against counts worked out by hand."""
from __future__ import annotations

import numpy as np
import pytest

from bench import measure, model, roofline, spec, traffic

QWEN = spec.config("qwen2-0.5b")
OLMOE = spec.config("olmoe-1b-7b")


@pytest.mark.parametrize("p", [50, 90, 95, 99])
def test_percentile_is_numpy_linear(p):
    xs = list(np.random.default_rng(p).exponential(size=137))
    assert measure.percentile(xs, p) == pytest.approx(np.percentile(xs, p))


def test_percentile_by_hand():
    # 11 samples 0..100: p90 sits on rank 9 exactly, p95 halfway 9-10
    xs = [10.0 * i for i in range(11)]
    assert measure.percentile(xs, 90) == 90.0
    assert measure.percentile(xs, 95) == 95.0


def test_union_of_intervals():
    assert measure.union_seconds([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4


def test_reduce_profile_busy_ops_and_gaps():
    kernels = [("gemm", 0.0, 100.0), ("gemm", 50.0, 150.0),
               ("where", 400.0, 500.0), ("gemm", 1000.0, 1100.0)]
    host = [("decode_step", -10.0, 2000.0), ("aten::item", 120.0, 900.0),
            ("aten::mul", 600.0, 610.0)]
    out = measure.reduce_profile(kernels, host)
    assert out["busy_s"] == pytest.approx(350e-6)
    assert out["span_s"] == pytest.approx(1100e-6)
    assert out["device_ops"][0] == ("gemm", pytest.approx(300e-6))
    # gap 500-1000 (middle 750): aten::item covers it; 150-400 (275) too
    assert dict(out["idle_gaps"]) == {"aten::item": pytest.approx(750e-6)}


def test_train_rate_and_mfu_by_hand():
    cfg = QWEN
    d, L, f, v = 896, 24, 4864, 151936
    n = L * (d * (14 + 2 * 2) * 64 + 14 * 64 * d + 3 * d * f) + d * v
    assert model.n_matmul_params(cfg) == n == 493_961_216
    per_tok = 6 * n + 6 * L * 4096 * 14 * 64
    assert roofline.train_flops_per_token(cfg, 4096) == per_tok
    trace = {"cfg": cfg, "seq_len": 4096, "tokens_per_step": 16384,
             "step_s": [1.5, 1.5, 2.0]}
    mfu = spec.metric("train_mfu").read(trace)
    assert mfu == pytest.approx(100 * per_tok * 16384 * 3 / 5.0 / 989e12)


def test_prefill_mfu_by_hand():
    cfg = OLMOE
    d, L, f, e, k, v = 2048, 16, 1024, 64, 8, 50304
    layer = d * 48 * 128 + 16 * 128 * d + k * 3 * d * f + d * e
    s = 2048
    flops = 2 * L * layer * s + 2 * L * 16 * 128 * s * s + 2 * d * v
    assert roofline.prefill_flops(cfg, s) == flops
    trace = {"cfg": cfg, "prefill": [(100.0, s), (300.0, s)]}
    assert spec.metric("prefill_mfu").read(trace) == pytest.approx(
        100 * 2 * flops / 0.4 / 989e12)
    assert spec.metric("prefill_ms").read(trace) == 200.0


def test_flash_bound_by_hand():
    # 14 query heads over 2 kv heads, S 4096 causal, D 64, bf16:
    # 4 D flops a pair over S(S+1)/2 pairs; operations bound it
    pairs = 4096 * 4097 // 2
    ops_ms = 4 * 14 * pairs * 64 / 989e12 * 1e3
    assert roofline.flash_bound_ms(14, 2, 4096, 4096, 64, True,
                                   "bfloat16") == pytest.approx(ops_ms)
    # one query row over 8 keys: bytes bound it
    nbytes = 2 * 1 * 1 * 64 * 2 + 2 * 1 * 8 * 64 * 2
    assert roofline.flash_bound_ms(1, 1, 1, 8, 64, True, "bfloat16") == \
        pytest.approx(nbytes / 3.35e12 * 1e3)
    calls = [(2 * ops_ms, 14, 2, 4096, 4096, 64, True, "bfloat16")] * 3
    assert spec.metric("flash_roofline").read({"flash": calls}) == \
        pytest.approx(50.0)


def test_serving_readers_by_hand():
    trace = {"slots": 8, "occupancy": [8, 8, 6, 8], "decode_ms": [40, 60],
             "profile": {"busy_s": 1.0, "window_s": 4.0, "ranges": {
                 "prefill": [(0, 100, 80.0), (200, 300, 20.0)],
                 "moe_dispatch": [(10, 20, 30.0), (150, 160, 99.0),
                                  (210, 220, 10.0)]}}}
    assert spec.metric("engine_occupancy").read(trace) == 93.75
    assert spec.metric("decode_step_ms").read(trace) == 50.0
    # a split reads with its quantity's reader; BENCHMARK.json says where
    assert spec.metric("device_idle.serve").read(trace) == 75.0
    assert spec.metric("decode_step_ms.hostpaced").read(trace) == 50.0
    # dispatch inside prefills only: (30 + 10) / (80 + 20)
    assert spec.metric("moe_dispatch_share").read(trace) == 40.0
    assert spec.metric("moe_dispatch_share.hostpaced").read(trace) == 40.0


def test_hostpaced_tails_by_hand():
    trace = {"ttft_ms": [float(x) for x in range(1, 12)],
             "itl_ms": [float(x) for x in range(21)]}
    assert spec.metric("ttft_p90_ms.hostpaced").read(trace) == 10.0
    assert spec.metric("itl_p95_ms.hostpaced").read(trace) == 19.0
    assert spec.metric("ttft_p90_ms.hostpaced").read({}) is None


def test_training_span_readers():
    trace = {"step_s": [1.0], "loss_grads_ms": [900.0, 1100.0],
             "optim_ms": [30.0], "profile": {"busy_s": 0.9,
                                             "window_s": 1.0}}
    assert spec.metric("loss_grads_ms").read(trace) == 1000.0
    assert spec.metric("optim_ms").read(trace) == 30.0
    assert spec.metric("device_idle.train").read(trace) == pytest.approx(10)


def test_stream_same_sizes_for_every_seed():
    """Every seed draws the same sizes in the same order, spread evenly
    over the distribution, while the ids differ."""
    cell = spec.workload("olmoe-1b-7b.rag_prefill")
    runs = []
    for seed in (1, 2**33 + 5, 77):
        st = traffic.Stream(cell["prompt"], cell["output"], 50304, seed)
        runs.append([st.sizes(i) for i in range(256)])
    assert runs[0] == runs[1] == runs[2]
    prompts = sorted(p for p, _ in runs[0])
    assert all(1024 <= p <= 3584 for p in prompts)
    assert all(16 <= o <= 64 for _, o in runs[0])
    assert prompts[128] == 2048          # the median of the log-normal
    assert traffic.van_der_corput(6, 2) == 0.375
    a = traffic.Stream(cell["prompt"], cell["output"], 50304, 1)
    b = traffic.Stream(cell["prompt"], cell["output"], 50304, 2)
    assert not np.array_equal(a.ids(0, 64), b.ids(0, 64))
    assert np.array_equal(a.request(3)[0], a.request(3)[0])


def test_packed_rows_differ_by_step_and_hold_documents():
    cell = spec.workload("qwen2-0.5b.train_4k")
    r0 = traffic.packed_rows(5, 0, 4, 4096, 151936, cell["documents"])
    r1 = traffic.packed_rows(5, 1, 4, 4096, 151936, cell["documents"])
    assert r0.shape == (4, 4096) and r0.dtype == np.int32
    assert not np.array_equal(r0, r1)
    assert (r0 == 0).any() and r0.min() >= 0 and r0.max() < 151936
