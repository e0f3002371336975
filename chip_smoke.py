#!/usr/bin/env python3
"""chip_smoke — drive the PyTorch port of Revet's dataflow executor on one
CUDA card and check it end to end.

    python3 chip_smoke.py            # from the repository root; needs nvcc

Phases, each printing JSON lines; any failure raises and exits non-zero:

1. build   — compile every ``src/repro_torch/kernels/csrc/*.cu`` for sm_90a,
             one nvcc per source, all at once (into ``build/``).
2. kernels — each kernel against its plain torch version on the card, exact
             equality of outputs, count and carry: windows of 1, 127, 128,
             129 and 512 lanes, D in 1..5, random masks, barrier levels 1-3,
             all six reduce ops, open and closed carries, and N = 2^24.
             Times (CUDA events) beside the bytes bound and a library call.
3. apps    — the nine Table III apps at benchmark scale through
             ``repro_torch.revet`` on ``TorchBackend("cuda")``: DRAM, stats
             and expected outputs equal to the numpy oracle; both kernels'
             launch counters must grow.  Plus hash_table at 16x.
4. serve   — ``DataflowEngine.step_batch`` of 8 requests with distinct seeds
             (strlen, hash_table) against sequential numpy serving, and one
             placed, replicated ``execute_batch``.

The last lines are the card's name and power limit, one ``{"kernels": ...}``
line, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
HBM_BYTES_PER_S = 3.35e12          # H100 SXM published memory rate
I32_MIN, I32_MAX = -(1 << 31), (1 << 31) - 1

# benchmark-scale app instances (the dict of benchmarks/common.py)
BENCH_SIZES = {
    "isipv4": dict(n_strings=256),
    "ip2int": dict(n_strings=256),
    "murmur3": dict(n_blobs=128),
    "hash_table": dict(n_lookups=256, n_slots=1024),
    "search": dict(n_chunks=32, chunk=256),
    "huff_dec": dict(n_threads=16, syms_per_thread=128),
    "huff_enc": dict(n_threads=16, syms_per_thread=128),
    "kdtree": dict(n_points=2048, n_queries=64),
    "strlen": dict(n_strings=128, avg_len=32),
}
HASH_TABLE_16X = dict(n_lookups=4096, n_slots=16384)

PATH_LANES = (1, 127, 128, 129, 512)
LARGE_N = 1 << 24


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(f"chip_smoke: {what}")


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------

def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bytes_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def _max_err(got, want) -> int:
    if got.numel() == 0:
        return 0
    return int((got.long() - want.long()).abs().max())


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _compact_case(sc, rng, n, d, density, dev):
    import numpy as np
    import torch
    mask = torch.from_numpy((rng.random(n) < density).astype(np.int32)).to(dev)
    vals = torch.from_numpy(rng.integers(I32_MIN, I32_MAX, (n, d),
                                         dtype=np.int64).astype(np.int32)
                            ).to(dev)
    out, cnt = sc.stream_compact(mask, vals)
    want, wcnt = sc.stream_compact_plain(mask, vals)
    require(int(cnt) == int(wcnt) and torch.equal(out, want),
            f"stream_compact differs from plain at n={n} d={d} "
            f"density={density}")
    return mask, vals, int(wcnt)


def _segred_window(rng, n, levels):
    import numpy as np
    kinds = np.zeros(n, np.int64)
    bars = rng.random(n) < 0.25
    kinds[bars] = rng.integers(1, levels + 1, int(bars.sum()))
    vals = rng.integers(I32_MIN, I32_MAX, n, dtype=np.int64)
    return kinds, vals


def _segred_case(sr, kinds_np, vals_np, op, init, acc, go, dev):
    import numpy as np
    import torch
    kinds = torch.from_numpy(kinds_np.astype(np.int32)).to(dev)
    vals = (None if vals_np is None
            else torch.from_numpy(vals_np.astype(np.int32)).to(dev))
    got = sr.segment_reduce(kinds, vals, init, op, acc, go)
    want = sr.segment_reduce_plain(kinds, vals, init, op, acc, go)
    m = int(want[2])
    same = (int(got[2]) == m and torch.equal(got[3], want[3])
            and torch.equal(got[0][:m], want[0][:m])
            and torch.equal(got[1][:m], want[1][:m]))
    require(same, f"segment_reduce differs from plain at n={len(kinds_np)} "
                  f"op={op} init={init} acc={acc} open={go} "
                  f"vals={'none' if vals_np is None else 'yes'}")
    return kinds, vals, m


def phase_kernels(dev):
    import numpy as np
    import torch
    from repro_torch.kernels import segment_reduce as sr
    from repro_torch.kernels import stream_compact as sc
    rng = np.random.default_rng(SEED)
    cases = 0
    # -- stream_compact at the path's window shapes, then at 2^24 rows
    for n in PATH_LANES:
        for d in range(1, 6):
            for density in (0.0, 0.3, 0.7, 1.0):
                _compact_case(sc, rng, n, d, density, dev)
                cases += 1
    _compact_case(sc, rng, LARGE_N, 1, 0.5, dev)
    cases += 1
    # -- segment_reduce: every op, barrier levels 1-3, open / closed /
    #    degenerate (closed with acc != init) carries, values or none
    for n in PATH_LANES:
        for op in sr.OPS:
            for levels in (1, 2, 3):
                kinds, vals = _segred_window(rng, n, levels)
                init = int(rng.integers(-4, 5))
                acc = int(rng.integers(I32_MIN, I32_MAX))
                for go, a in ((True, acc), (False, init), (False, acc)):
                    for v in (vals, None):
                        _segred_case(sr, kinds, v, op, init, a, go, dev)
                        cases += 1
    for op in ("add", "max", "xor"):
        kinds, vals = _segred_window(rng, LARGE_N, 3)
        _segred_case(sr, kinds, vals, op, 0, 7, True, dev)
        cases += 1
    long_seg = np.zeros(1 << 20, np.int64)
    long_seg[-2:] = (1, 2)
    _segred_case(sr, long_seg, np.full(1 << 20, 0xFFFF, np.int64), "add",
                 0, 0, False, dev)
    cases += 1
    torch.cuda.synchronize()
    emit({"phase": "kernels", "check": "exact vs plain", "cases": cases})
    return time_kernels(dev, sc, sr, rng)


def time_kernels(dev, sc, sr, rng):
    """Times at one window of the main path and at 2^24 rows."""
    import numpy as np
    import torch
    rows = {}
    # stream_compact: a full VLEN window with kinds + 3 payload columns
    # (what the apps' filters carry), then the large shape
    for label, n, d, iters in (("path", 128, 4, 300),
                               ("large", LARGE_N, 1, 10)):
        mask, vals, _ = _compact_case(sc, rng, n, d, 0.5, dev)
        rec = {"n": n, "d": d,
               "kernel_ms": time_ms(
                   lambda: sc.stream_compact(mask, vals), iters),
               "plain_ms": time_ms(
                   lambda: sc.stream_compact_plain(mask, vals), iters),
               "library_ms": time_ms(lambda: vals[mask.bool()], iters),
               "library": "vals[mask.bool()]",
               "bound_ms": bytes_ms(4 * n + 8 * n * d + 4)}
        out, _ = sc.stream_compact(mask, vals)
        want, _ = sc.stream_compact_plain(mask, vals)
        rec["max_abs_err"] = _max_err(out, want)
        rows.setdefault("stream_compact", {})[label] = rec
        emit({"phase": "kernels", "kernel": "stream_compact", "shape": label,
              **rec})
    for label, n, iters in (("path", 128, 300), ("large", LARGE_N, 10)):
        kinds_np, vals_np = _segred_window(rng, n, 3)
        kinds, vals, m = _segred_case(sr, kinds_np, vals_np, "add", 0, 0,
                                      False, dev)
        # yardstick: torch.segment_reduce sums the same segments (data
        # tokens only, float32) — partial: no carry, no emission protocol
        is_bar = kinds_np > 0
        seg = np.cumsum(is_bar) - is_bar
        lengths = torch.from_numpy(np.bincount(
            seg[~is_bar], minlength=int(is_bar.sum()) + 1)).to(dev)
        data_f = torch.from_numpy(vals_np[~is_bar].astype(np.float32)).to(dev)
        rec = {"n": n, "emitted": m,
               "kernel_ms": time_ms(
                   lambda: sr.segment_reduce(kinds, vals), iters),
               "plain_ms": time_ms(
                   lambda: sr.segment_reduce_plain(kinds, vals), iters),
               "library_ms": time_ms(lambda: torch.segment_reduce(
                   data_f, "sum", lengths=lengths), iters),
               "library": "torch.segment_reduce(sum, float32) — partial "
                          "yardstick: segment sums only",
               "bound_ms": bytes_ms(8 * n + 8 * m + 12)}
        got = sr.segment_reduce(kinds, vals)
        want = sr.segment_reduce_plain(kinds, vals)
        rec["max_abs_err"] = max(_max_err(got[0][:m], want[0][:m]),
                                 _max_err(got[1][:m], want[1][:m]))
        rows.setdefault("segment_reduce", {})[label] = rec
        emit({"phase": "kernels", "kernel": "segment_reduce", "shape": label,
              **rec})
    torch.cuda.synchronize()
    return rows


# ---------------------------------------------------------------------------
# phase 3: the apps on the card against the numpy oracle
# ---------------------------------------------------------------------------

def _launches():
    from repro_torch.kernels.segment_reduce import segment_reduce
    from repro_torch.kernels.stream_compact import stream_compact
    return {"stream_compact": stream_compact.launches,
            "segment_reduce": segment_reduce.launches}


def _reset_launches():
    from repro_torch.kernels.segment_reduce import segment_reduce
    from repro_torch.kernels.stream_compact import stream_compact
    stream_compact.launches = 0
    segment_reduce.launches = 0


def _same_run(name, ex_np, ex_t):
    for arr in ex_np.dram:
        require(ex_np.dram[arr].shape == ex_t.dram[arr].shape and
                (ex_np.dram[arr] == ex_t.dram[arr]).all(),
                f"{name}: dram '{arr}' differs from the numpy oracle")
    require(ex_np.vm.stats == ex_t.vm.stats,
            f"{name}: stats differ from the numpy oracle")


_PRIMITIVES = ("binop", "neg", "logical_not", "select", "compact",
               "lower_barriers", "segment_reduce", "data_run",
               "first_mismatch")


def counting_backend():
    """``TorchBackend("cuda")`` that counts its primitive calls — each one
    moves one window to the card and its result back."""
    from repro_torch.core.backend import TorchBackend

    class CountingTorchBackend(TorchBackend):
        calls = 0
        stop_at, on_stop = -1, None      # hook: called after call ``stop_at``

    def counted(method):
        def call(self, *args):
            self.calls += 1
            out = method(self, *args)
            if self.calls == self.stop_at:
                self.on_stop()
            return out
        return call

    for m in _PRIMITIVES:
        setattr(CountingTorchBackend, m, counted(getattr(TorchBackend, m)))
    return CountingTorchBackend("cuda")


def _run_app(name, app, tb):
    from repro_torch.apps.common import check_app
    from repro_torch.core.backend import NumpyBackend
    lowered = app.fn.lower(**app.dram_init, **app.params, **app.statics)
    ex_np = lowered.compile(NumpyBackend()).execute(dict(app.dram_init),
                                                    app.params)
    before, calls = _launches(), tb.calls
    ex_t = lowered.compile(tb).execute(dict(app.dram_init), app.params)
    after, calls = _launches(), tb.calls - calls
    _same_run(name, ex_np, ex_t)
    check_app(app, ex_t.dram)
    emit({"phase": "apps", "app": name, "match": True,
          "torch_cuda_wall_s": ex_t.report.wall_s,
          "numpy_wall_s": ex_np.report.wall_s,
          "backend_calls": calls,
          "us_per_call": ex_t.report.wall_s / calls * 1e6,
          "launches": {k: after[k] - before[k] for k in after}})


# torch.profiler's cost grows with the events it records: a whole huff_dec
# run (129k backend calls) does not finish within the script's time limit,
# so each app is profiled over its first PROFILE_CALLS backend calls only.
PROFILE_CALLS = 4000


def device_busy(name, app, tb) -> dict:
    """One run of ``app`` with ``torch.profiler`` on over its first
    ``PROFILE_CALLS`` backend calls (the whole run if it is shorter): device
    time of all CUDA kernels and copies against that window's wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    lowered = app.fn.lower(**app.dram_init, **app.params, **app.statics)
    compiled = lowered.compile(tb)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    window = {}

    def stop():
        torch.cuda.synchronize()
        window["wall_s"] = time.perf_counter() - t0
        window["calls"] = tb.calls - calls0
        prof.stop()

    calls0 = tb.calls
    tb.stop_at, tb.on_stop = calls0 + PROFILE_CALLS, stop
    prof.start()
    t0 = time.perf_counter()
    try:
        compiled.execute(dict(app.dram_init), app.params)
        if not window:
            stop()
    finally:
        tb.stop_at, tb.on_stop = -1, None
    device_us = 0.0
    top = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:   # host ops repeat their kernels
            continue
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        device_us += us
        top.append((us, ev.key, ev.count))
    require(device_us > 0, f"{name}: the profiler saw no device time")
    top.sort(reverse=True)
    return {"phase": "apps", "app": name, "profiled_calls": window["calls"],
            "run_calls": tb.calls - calls0,
            "profiled_wall_s": window["wall_s"],
            "device_s": device_us / 1e6,
            "device_busy_share": device_us / 1e6 / window["wall_s"],
            "top_device": [{"name": k[:60], "us": us, "count": c}
                           for us, k, c in top[:6]]}


def phase_apps(tb):
    from repro_torch.apps import ALL_APPS
    t0 = time.perf_counter()
    _reset_launches()
    for name in sorted(BENCH_SIZES):
        _run_app(name, ALL_APPS[name](**BENCH_SIZES[name]), tb)
    _run_app("hash_table_16x", ALL_APPS["hash_table"](**HASH_TABLE_16X), tb)
    launches = _launches()
    for k, v in launches.items():
        require(v > 0, f"the apps never launched the {k} kernel")
    emit({"phase": "apps", "apps": len(BENCH_SIZES) + 1, "launches": launches,
          "seconds": time.perf_counter() - t0})
    # device busy share of every app, from one more run each under the
    # profiler (after the counts are read, so they hold one run per app)
    for name in sorted(BENCH_SIZES):
        emit(device_busy(name, ALL_APPS[name](**BENCH_SIZES[name]), tb))
    return launches


# ---------------------------------------------------------------------------
# phase 4: serving
# ---------------------------------------------------------------------------

def _pad_inputs(apps) -> None:
    """Zero-pad each input array to its longest length across ``apps``, so
    that instances built from different seeds share one compiled shape (a
    string blob's trailing zeros are never read)."""
    import numpy as np
    for arr in apps[0].dram_init:
        width = max(len(a.dram_init[arr]) for a in apps)
        for a in apps:
            v = np.asarray(a.dram_init[arr])
            a.dram_init[arr] = np.concatenate(
                [v, np.zeros(width - len(v), v.dtype)])


def phase_serve(tb):
    from repro_torch import revet
    from repro_torch.apps import ALL_APPS
    from repro_torch.apps.common import check_app
    from repro_torch.core.vector_vm import VLEN, ReplicatedVectorVM
    from repro_torch.serve.dataflow import DataflowEngine, DataflowRequest
    _reset_launches()
    for name in ("strlen", "hash_table"):
        apps = [ALL_APPS[name](seed=s) for s in range(8)]
        _pad_inputs(apps)
        app = apps[0]
        lowered = app.fn.lower(**app.dram_init, **app.params, **app.statics)
        engines = {"torch": DataflowEngine(lowered.compile(tb)),
                   "numpy": DataflowEngine(lowered.compile("numpy"))}
        for eng in engines.values():
            for rid, a in enumerate(apps):
                eng.submit(DataflowRequest(rid, dict(a.params),
                                           dict(a.dram_init)))
        t0 = time.perf_counter()
        batch = engines["torch"].step_batch(max_batch=8)
        wall = time.perf_counter() - t0
        seq = engines["numpy"].drain(max_batch=1)
        require(len(batch) == 8 and [r.rid for r in batch] == list(range(8)),
                f"{name}: step_batch served {len(batch)} of 8 requests")
        for b, s, a in zip(batch, seq, apps):
            for arr in s.dram:
                require((b.dram[arr] == s.dram[arr]).all(),
                        f"{name} rid={b.rid}: '{arr}' differs from "
                        "sequential numpy serving")
            check_app(a, b.dram)
        emit({"phase": "serve", "app": name, "requests": 8, "match": True,
              "wall_s": wall, "requests_per_s": 8 / wall})
    # one placed, replicated fused launch over requests from distinct seeds,
    # so a request routed to the wrong rid, lane or DRAM slice shows
    apps = [ALL_APPS["murmur3"](seed=s) for s in range(8)]
    _pad_inputs(apps)
    app = apps[0]
    opts = revet.CompileOptions(place=True)
    kw = dict(**app.dram_init, **app.params, **app.statics)
    comp_t = revet.compile(app.fn, **kw, options=opts, backend=tb)
    comp_n = revet.compile(app.fn, **kw, options=opts, backend="numpy")
    reps = max(2, comp_t.default_replicas())
    reqs = [(dict(a.dram_init), dict(a.params)) for a in apps]
    require(len({a.dram_init["blobs"].tobytes() for a in apps}) == 8,
            "replicated murmur3: the seeds gave equal requests")
    t0 = time.perf_counter()
    repl = comp_t.execute_batch(reqs, replicas=reps)
    wall = time.perf_counter() - t0
    base = comp_n.execute_batch(reqs, replicas=1)
    require(isinstance(repl.vm, ReplicatedVectorVM)
            and repl.vm.vlen == reps * VLEN, "replicated launch not taken")
    for r, (er, eb) in enumerate(zip(repl, base)):
        for arr in eb.dram:
            require((er.dram[arr] == eb.dram[arr]).all(),
                    f"replicated murmur3 rid={r}: '{arr}' differs")
        require(repl.vm.request_stats(r) == base.vm.request_stats(r),
                f"replicated murmur3 rid={r}: stats differ")
        check_app(apps[r], er.dram)
    launches = _launches()
    for k, v in launches.items():
        require(v > 0, f"serving never launched the {k} kernel")
    emit({"phase": "serve", "app": "murmur3", "replicas": reps,
          "window": reps * VLEN, "requests": len(reqs), "match": True,
          "wall_s": wall, "requests_per_s": len(reqs) / wall,
          "launches": launches})


# ---------------------------------------------------------------------------

KERNEL_ROWS = {
    "stream_compact": {
        "source": "src/repro_torch/kernels/csrc/stream_compact.cu",
        "replaces": "src/repro/kernels/stream_compact.py:25"},
    "segment_reduce": {
        "source": "src/repro_torch/kernels/csrc/segment_reduce.cu",
        "replaces": "src/repro/kernels/segment_reduce.py:32"},
}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {ROOT}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    per_source = _build.build_all(force=True, extra_flags=("-Xptxas", "-v"))
    ptxas = [ln.strip() for log in _build.build_log.values()
             for ln in log.splitlines() if "Used" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source_s": per_source, "ptxas": ptxas})

    dev = torch.device("cuda")
    timings = phase_kernels(dev)
    tb = counting_backend()
    launches = phase_apps(tb)
    phase_serve(tb)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kernels = []
    for name, meta in KERNEL_ROWS.items():
        path = timings[name]["path"]
        kernels.append({
            "name": name, "route": "cuda", **meta,
            "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"]
                               for r in timings[name].values()),
            "ms": path["kernel_ms"], "plain_ms": path["plain_ms"],
            "bound_ms": path["bound_ms"], "bound_by": "bytes",
            "library_ms": path["library_ms"],
            "shape": {k: path[k] for k in ("n", "d", "emitted") if k in path},
            "large": timings[name]["large"]})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
