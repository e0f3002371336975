#!/usr/bin/env python3
"""chip_smoke — drive the PyTorch port of Revet (the dataflow executor and its
open-loop serving, the hash probe, dense-LM, SSM, hybrid, MoE,
encoder-decoder and VLM serving, training, and the distribution layer) on
one CUDA card and check it end to end.

    python3 chip_smoke.py            # from the repository root; needs nvcc

Phases, each printing JSON lines; any failure raises and exits non-zero:

1. build   — compile every ``src/repro_torch/kernels/csrc/*.cu`` for sm_90a,
             one nvcc per source, all at once (into ``build/``); the
             registers and spills of every attention and scan kernel
             (``-Xptxas -v``), and ``cuobjdump -sass``: each bf16 flash
             instance must issue tensor-core instructions (HMMA), no float32
             one may; no instance of the two scan kernels may spill or keep
             a stack frame, and one call of each at its path shape must
             put one kernel on the card (the nodes of one captured call,
             taken here, before the other phases).
2. kernels — each kernel against its plain torch version on the card, exact
             equality of outputs (zeros past the count included), count and
             carry: windows of 1, 127, 128, 129 and 512 lanes, D in 1..5,
             random masks, barrier levels 1-3, all six reduce ops, open and
             closed carries, N = 2^24; windows around the kernels' tile
             (TILE_ROWS - 1, TILE_ROWS, TILE_ROWS + 1, 3 TILE_ROWS + 5) with
             barriers on the tile edges, a segment over every tile, barriers
             only, Omega-2 opening a tile (also after a tile that emits
             nothing, under a closed carry with acc != init).  Times (CUDA
             events; eager and from a CUDA graph, each replay held to the
             plain version) beside the bytes bound and a library call (from
             a graph where it can be captured); the kernels, memsets and
             copies of one call (the nodes of one captured call): exactly
             one kernel at N = 128 and in the device-carry entry, one
             kernel and at most two memsets at 2^24.
3. apps    — the nine Table III apps at benchmark scale through
             ``repro_torch.revet`` on ``TorchBackend("cuda")``: DRAM, stats
             and expected outputs equal to the numpy oracle; both kernels'
             launch counters must grow.  Plus hash_table at 16x.
4. serve   — ``DataflowEngine.step_batch`` of 8 requests with distinct seeds
             (strlen, hash_table) against sequential numpy serving, and one
             placed, replicated ``execute_batch``.
4b. resident — the same ten app runs with ``execution="resident"`` (the
             resident loop, ``core/device_vm.py``: ticks replayed from a
             captured CUDA graph, with ``stream_compact`` and the
             device-carry ``segment_reduce`` inside), then a batch of 3 per
             app: DRAM and lane stats equal to the oracle, no windowed
             backend call, host reads equal to replays, both kernels
             launched by the replays; murmur3's and hash_table's ticks
             equal to the CPU port's; per app, wall beside the windowed and
             oracle walls, capture seconds, ticks, ticks per replay,
             replays, kernels per tick (the nodes of one captured block) and
             µs per tick; then ``DataflowEngine(compiled,
             execution="resident")`` serving 8 strlen requests.
4c. async_serve — murmur3 and hash_table at ``BENCH_SIZES``: 32 open-loop
             Poisson requests over two tenants at the measured batch-8
             capacity (8 over the warm wall of one ``step_batch(8)``)
             through ``AsyncServeEngine`` on the card, windowed (max_wave
             8) and resident (buckets "auto", each captured by
             ``warmup()``, none while serving), SLO 4x that wall; every
             response equal to its instance's solo run on the oracle,
             served + shed == submitted, nothing failed, degraded or sent
             back to windowed; p50/p99, goodput at the SLO, launches by
             bucket, mid-wave admissions; the executor kernels' launches
             of each serving window alone (counted from 0 after
             ``warmup()``), each > 0 in each mode; then one injected
             resident launch fault (attempt 0 raises once), replayed equal.
5. attention — the flash and decode attention kernels against their plain
             versions (float32 2e-5, bfloat16 2e-2) at the LM path's shapes
             (heads matched, and qwen2-0.5b's own 14 query heads on 2 kv
             heads, read by index) and at large ones, with eager and CUDA
             graph times beside the bound and ``scaled_dot_product_attention``
             (``enable_gqa`` where the heads are grouped) as a yardstick.
6. lm      — full-width qwen2-0.5b (random weights from seed 0) served by
             ``DecodeEngine`` (default ``impl="kernel"``) on 8 requests
             (prompts of 16-512 tokens): every prefill layer launches the
             flash kernel; prefill and teacher-forced decode logits match
             the plain route (``impl="naive"``, its decode attention forced
             to the float32 reference) within a bf16 tolerance;
             every decode step launches the decode kernel once a layer, and
             it runs once more over the served KV cache of every layer;
             then ``repro_torch.launch.serve.main`` at the full preset.
7. ssm_kernel — the ssm_scan kernel against its plain version (2e-5 of the
             largest |plain| value, on y and hT) over S in {1, 63, 64, 100,
             512}, Di in {128, 1000, 8192}, N in {8, 16}, zero and random
             h0; at the edges of each N's plan (S one short of and one past
             its buffer of L steps, a stage of CHUNK steps and two, a
             ragged block of channels, Di 8192); then at the path shape and
             a large one, with times (eager and from a CUDA graph, each
             replay held to the plain version) beside the bound (no PyTorch
             call computes a selective scan), the kernels of one call
             (captured, before the other phases: exactly one); one
             captured call replayed on two new inputs.
8. ssm_lm  — full-width, full-depth falcon-mamba-7b (random weights drawn
             on the card) served by ``DecodeEngine`` on the same 8
             requests; then ``ssm.forward(impl="kernel")`` over each
             request's prompt and generated tokens (64 kernel launches
             each), every layer held to the served prefill and decode
             layers on the same input (8 bf16 steps); end-to-end logits
             beside the plain forward's, reported; a torch.profiler window
             over one forward at S = 512; then ``launch.serve.main`` for
             falcon-mamba-7b (reduced preset).
9. rglru_kernel — the rg_lru scan kernel against its plain version (2e-5 of
             the largest |plain| value, on y and hT) over S in {1, 63, 64,
             100, 512, 4096}, D in {1, 100, 4096}, B in {1, 4}, zero and
             random h0; bit for bit at the edges of its ring (S around a
             stage, the prologue's stages - 1 tiles and the whole ring, as
             each (B, D)'s plan sets them; D at each block width's edge,
             and no multiple of 4); then at the path shape and a large
             one, with times beside the bound (each graph replay bit for
             bit), one kernel a call (captured), one captured call
             replayed on two new inputs; flash and decode attention at
             head dim 256 against their plain versions, with 16 kv heads
             and with recurrentgemma-9b's own one kv head for 16 query
             heads.
10. hybrid_lm — full-width, full-depth recurrentgemma-9b (random weights
             drawn on the card) served by ``DecodeEngine(max_len=4352)`` on
             the 8 requests and one 4096-token prompt, whose prefill takes
             the banded local attention and whose decode wraps the 2048-row
             K/V ring; then, per request, each block walked in order on the
             prompt and served tokens, the kernel route (``_rec_block(
             impl="kernel")``, ``_attn_block(impl="kernel")``) held to the
             served route's block on the same input (8 bf16 steps); the
             decode kernel over every attention block's served ring;
             end-to-end logits beside a plain control, reported; a
             torch.profiler window over one 512-token prefill; then
             ``launch.serve.main`` for recurrentgemma-9b (reduced preset).
11. hash_kernel — the hash_probe kernel against its plain version, exactly,
             over n_slots in {128, 1000, 1024, 2^16, 2^20, 2^24} at loads
             0.25 and 0.5 and N in {1, 255, 256, 257, 2^20, 2^24} (half
             hits, half misses, negative keys); the path: ``ops.hash_lookup``
             over the hash_table app's own tables (benchmark size and 16x)
             with the app's queries, equal to its expected results; times
             and kernels a call at the app at 16x and at 2^24 keys in 2^24
             and 2^22 slots beside the bound.
12. moe_kernel — the moe_dispatch kernel against its plain version, bit for
             bit, in bf16 and float32, over A in {1, 7, 256, 4096}, D in
             {32, 100, 2048}, E in {8, 64} and capacities that drop 0%,
             ~20% and ~90% of the rows; times at olmoe's 512-token prefill
             and at a large shape beside the bound and ``index_put_``.
13. moe_lm — full-width, full-depth olmoe-1b-7b (random weights drawn on
             the card) served by ``DecodeEngine`` on the 8 requests; then
             each request walked teacher-forced, layer by layer: the MoE FF
             through ``ops.moe_dispatch_combine(impl="kernel")`` equal bit
             for bit to the served scatter route, flash attention within 8
             bf16 steps of the plain route; the decode kernel over every
             layer's served cache (head dim 128); a torch.profiler window
             over one 512-token prefill on the kernel route; then
             ``launch.serve.main`` for olmoe-1b-7b (reduced preset).

14. encdec_lm — full-width, full-depth seamless-m4t-medium (random bf16
             weights drawn on the card): one prefill of 2 x 1024 frames and
             a 64-token prompt on the kernel route (36 flash launches: 12
             encoder layers non-causal, 12 decoder self-attentions causal,
             12 cross-attentions non-causal over the frames), 16 greedy
             decode steps (the decode kernel once a decoder layer a step;
             cross-attention ``decode_mha(impl="ref")``, as the reference);
             then every attention of the prefill held to the plain route on
             the same input (8 bf16 steps), and the decode kernel over each
             decoder layer's served cache (MHA, head dim 64: the lane-group
             instance) held to ``decode_mha(impl="ref")`` within 2 x the
             bf16 attention tolerance; prefill ms, decode ms/step, peak
             bytes, flash and decode launches.
15. vlm_lm — internvl2-1b the same way: 256 patch embeddings of 1024 and a
             512-token prompt (24 flash launches over 768 positions; the
             decode kernel's check over 24 served caches, G 7).
16. train  — (a) ``repro_torch.launch.train.main`` at the full width of
             qwen2-0.5b: 20 steps of 8 x 1024 tokens, int8 gradient
             compression, one checkpoint at the end; every loss finite;
             first and warm step ms, tokens/s, model-FLOP share, peak
             bytes, the save's seconds and bytes.  (b) 10 AdamW steps on
             one fixed batch at full width lower the loss; one more step
             timed in parts (loss and grads, compression, AdamW) and under
             torch.profiler (device busy share).  (c) 2 layers,
             a fault at step 6: one restart, 10 steps, the replayed
             losses against an uninterrupted run (bit for bit reported).
             (d) reduced qwen2-0.5b and falcon-mamba-7b in float32: a
             step's loss and every gradient within 1e-4 of the port's CPU
             step.  (e) one step of each other family at full width and 2
             layers (recurrentgemma-9b: a group and its 2 tail blocks):
             loss and gradients finite, step ms, peak bytes.  (f) flash
             attention on inputs that require grad raises.  The training
             route is the plain chunked one: no hand-written kernel may
             launch in (a)-(e).
17. distribution — (a) full-width qwen2-0.5b on ``make_host_mesh(1, 1)``
             under ``set_act_mesh``: a 4 x 512 prefill on the kernel route
             (24 flash launches, counted from 0; the attention under the
             mesh one kernel, as captured graph nodes) and 4 greedy decode
             steps, logits and cache bit-identical to no mesh.  (b)
             qwen2-0.5b's decode_32k arguments (a 128 x 32768 bf16 K/V
             cache) allocated on the card: the ``memory_allocated()``
             delta within 2 MiB a leaf above the dry-run's 1x1 argument
             bytes.  (c) ``python -m repro_torch.launch.dryrun --mesh
             both`` in subprocesses (every architecture's decode_32k and
             long_500k, qwen2-0.5b's train_4k and prefill_32k,
             olmoe-1b-7b's train_4k), beside (a) and (b): every cell's
             step runs on DTensors and passes; per-device argument,
             temporary and output bytes against the card's memory, traced
             FLOPs, rank 0's FLOPs and bytes and ``memory_s``, collective
             bytes by kind and ``collective_s`` (each train cell reducing
             its gradients), and seconds.  (d) the dry-run's memory
             against the card's allocator, on a 1x1 mesh at full width
             (``DIST_MEMORY_CELLS``: qwen2-0.5b's train 8 x 1024, prefill
             4 x 8192 and decode 8 x 32768, falcon-mamba-7b's decode 8 x
             32768, olmoe-1b-7b's prefill 2 x 2048): each step's peak of
             allocated bytes within [A + T - slack, A + T + O + slack], A
             the arguments, T the temporaries, O the outputs on meta.

The attention phase also holds flash and decode at head dim 128.
The last lines are the card's name and power limit, one ``{"kernels": ...}``
line, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
HBM_BYTES_PER_S = 3.35e12          # H100 SXM published memory rate
I32_MIN, I32_MAX = -(1 << 31), (1 << 31) - 1

# H100 SXM published peaks (dense): bf16 tensor cores, float32 CUDA cores
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
# attention kernels against their plain versions: the tolerances of the
# reference's kernel tests (sums in another order; bf16 rounds the output)
ATTN_TOL = {"bfloat16": 2e-2, "float32": 2e-5}
LM_ARCH = "qwen2-0.5b"
LM_SLOTS, LM_MAX_LEN, LM_REQUESTS, LM_MAX_NEW = 4, 1024, 8, 16
# bf16 logits of the two attention routes: their attention outputs differ
# by bf16 rounding, carried through 24 layers, and the logits are rounded
# to bf16 themselves; allow 8 bf16 steps (2^-7 relative each) at the plain
# route's largest |logit|
LM_LOGIT_BF16_STEPS = 8
LM_PROFILE_STEPS = 8

# ssm_scan against its plain version: float32, the same steps in the same
# order; expf's and FMA contraction's rounding and the order of the sum over
# N differ, so 2e-5 of the largest |plain| value
SSM_TOL = 2e-5
SFU_EXP_PER_SM_CLOCK = 16          # special-function unit exponentials
H100_SMS = 132
SSM_ARCH = "falcon-mamba-7b"
SSM_N_PARAMS = 7272665088          # 64 layers, d 4096, d_inner 8192
SSM_PATH = (1, 512, 8192, 16)      # (B, S, Di, N): the 512-token prompt
SSM_LARGE = (4, 4096, 8192, 16)
# each layer of the kernel forward against the served route's layer on the
# same input (teacher-forced per layer).  Prefill: the two scans differ in
# float32 rounding, which flips a bf16 rounding of y here and there.
SSM_PREFILL_BF16_STEPS = 8
# Decode: the decode step's conv window is float32 (the engine's cache),
# the forward's conv bf16, so the conv output differs by bf16 rounding and
# the state carries that over the decode steps.
SSM_DECODE_BF16_STEPS = 8

# rg_lru against its plain version: float32, the same rounded multiply and
# add per step (the kernel should agree bit for bit); the gate is SSM_TOL,
# 2e-5 of the largest |plain| value
RG_PATH = (1, 512, 4096)           # (B, S, D): the 512-token prompt
RG_LARGE = (4, 4096, 4096)
HYBRID_ARCH = "recurrentgemma-9b"
HYBRID_N_PARAMS = 10444771328      # 38 layers, d 4096, 16/1 heads of 256
HYBRID_MAX_LEN = 4352              # ring w = min(window 2048, max_len)
HYBRID_LONG = 4096                 # the prompt past the window
# each block of the kernel route against the served route's block on the
# same input (teacher-forced per block): the two scans (or attentions)
# differ in float32 rounding, which flips a bf16 rounding here and there
HYBRID_BF16_STEPS = 8

# the hash probe: the sweep, the reference's default probe limit, and the
# timed tables of 2^24 keys: 2^24 slots, and 2^22 (its used part fits L2)
HASH_SLOTS = (128, 1000, 1024, 1 << 16, 1 << 20, 1 << 24)
HASH_LOADS = (0.25, 0.5)
HASH_NS = (1, 255, 256, 257, 1 << 20, 1 << 24)
HASH_LARGE = 1 << 24               # slots, and keys probed, at load 0.5
HASH_MID = 1 << 22                 # slots, at load 0.5
HASH_MAX_PROBES = 16

# the MoE dispatch at olmoe-1b-7b's 512-token prefill (A = 512 x top-8,
# D 2048, 64 experts, capacity(cfg, 512) = 80) and at 8192 tokens
MOE_PATH = (512, 8, 2048, 64, 80)          # (T, K, D, E, C)
MOE_LARGE = (8192, 8, 2048, 64, 1280)
MOE_ARCH = "olmoe-1b-7b"
MOE_N_PARAMS = 6919624704          # 16 layers, d 2048, 64 experts top-8
# each layer's attention through flash against the plain route on the same
# input (teacher-forced per layer): bf16 rounding in another order
MOE_ATTN_BF16_STEPS = 8

PATH_LANES = (1, 127, 128, 129, 512)
CARRY_LANES = (1, 2, 127, 128, 256, 4096)   # the device-carry entry's windows
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


def graph_ms(fn, iters: int, reps: int = 5, check=None) -> float:
    """Mean device time of ``fn`` with the host taken out: ``iters`` calls
    captured in one CUDA graph, replayed ``reps`` times between CUDA
    events.  A loop of eager calls (``time_ms``) also counts the gaps while
    the host issues the next launch, which dominate a kernel of a few
    microseconds.  ``check``, if given, is called on the last captured
    call's output after the replays (what the last replay left there)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                       # warm, off the capture
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            out = fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    if check is not None:
        check(out)
    return start.elapsed_time(end) / (iters * reps)


def library_graph(fn, iters: int, what: str) -> dict:
    """``library_graph_ms`` of a library call from a CUDA graph, or None and
    the reason where the call synchronises the host with the card (torch's
    sync debug mode raises), which a graph cannot capture."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
        syncs = False
    except RuntimeError:
        syncs = True
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if syncs:
        return {"library_graph_ms": None,
                "library_graph_note": f"none: {what} syncs the host (its "
                                      "output size or a check of its input "
                                      "is read back), so a CUDA graph "
                                      "cannot capture it"}
    return {"library_graph_ms": graph_ms(fn, iters)}


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
    require(_same_segred(got, want),
            f"segment_reduce differs from plain at n={len(kinds_np)} "
            f"op={op} init={init} acc={acc} open={go} "
            f"vals={'none' if vals_np is None else 'yes'}")
    return kinds, vals, int(want[2])


def _same_segred(got, want) -> bool:
    """Count, carry, and both output arrays, zeros past the count included."""
    import torch
    return (int(got[2]) == int(want[2]) and torch.equal(got[3], want[3])
            and torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]))


def _carry_inputs(rng, w, t, dev):
    import numpy as np
    import torch
    kinds, vals = _segred_window(rng, w, 3)
    n = int(rng.integers(0, w + 1)) if t else 0
    i32 = lambda a: torch.tensor(np.asarray(a, np.int32), device=dev)
    return (i32(kinds), i32(vals) if t % 2 else None,
            i32(rng.integers(0, 8, w)), i32(n).reshape(()),
            [int(rng.integers(I32_MIN, I32_MAX)), t % 2])


def _carry_case(sr, rng, w, op, t, dev):
    """``segment_reduce_carry`` on the card against its plain version:
    every output word and the carry after the call."""
    import torch
    kinds, vals, rids, n, carry0 = _carry_inputs(rng, w, t, dev)
    init = int(rng.integers(-4, 5))
    outs = []
    for d in (dev, "cpu"):
        carry = torch.tensor(carry0, dtype=torch.int32, device=d)
        got = sr.segment_reduce_carry(
            kinds.to(d), None if vals is None else vals.to(d), rids.to(d),
            n.to(d), op, init, carry)
        outs.append([x.cpu() for x in got] + [carry.cpu()])
    require(all(torch.equal(a, b) for a, b in zip(*outs)),
            f"segment_reduce_carry differs from plain at w={w} op={op} "
            f"n={int(n)}")
    if int(n) == 0:
        require(outs[0][-1].tolist() == carry0,
                "segment_reduce_carry moved the carry at n = 0")


def _edge_kinds(rng, n, tile):
    """Barrier patterns across the edges of ``tile``-token tiles: random;
    barriers either side of each edge; one open segment over every tile;
    barriers only; Omega-2 opening each tile after a closed group; Omega-2
    opening tile 1 after a tile 0 that emits nothing (a closed carry with
    acc != init reaches it)."""
    import numpy as np
    random = rng.choice([0, 0, 0, 1, 2, 3], size=n).astype(np.int64)
    edges = np.zeros(n, np.int64)
    for e in range(tile, n + 1, tile):
        edges[e - 1] = rng.integers(1, 4)
        if e < n:
            edges[e] = rng.integers(1, 4)
    spanning = np.zeros(n, np.int64)
    spanning[-1] = 2
    omega2 = rng.choice([0, 0, 0, 1, 2], size=n).astype(np.int64)
    for e in range(tile, n, tile):
        omega2[e - 1], omega2[e] = 1, 2
    quiet = rng.choice([0, 0, 0, 1, 2, 3], size=n).astype(np.int64)
    quiet[:tile] = rng.integers(2, 4, size=min(tile, n))
    if n > tile:
        quiet[tile] = 2
    return {"random": random, "edges": edges, "spanning": spanning,
            "bars_only": rng.integers(1, 4, size=n).astype(np.int64),
            "omega2": omega2, "quiet": quiet}


def _tile_edge_cases(sc, sr, rng, dev) -> int:
    """Both kernels on windows of TILE_ROWS - 1, TILE_ROWS, TILE_ROWS + 1
    and 3 TILE_ROWS + 5 tokens: every barrier pattern of ``_edge_kinds``,
    every op, values and none, open / closed / degenerate carries; masks
    keeping nothing, everything, the edge rows, random rows.  One case of
    each kernel per length also runs from a CUDA graph, held to the plain
    version after the replays."""
    import numpy as np
    import torch
    tile = sr.TILE_ROWS
    require(sc.TILE_ROWS == tile, "the two kernels' tiles differ")
    cases = 0
    for n in (tile - 1, tile, tile + 1, 3 * tile + 5):
        vals = rng.integers(I32_MIN, I32_MAX, n, dtype=np.int64)
        for kinds in _edge_kinds(rng, n, tile).values():
            for op in sr.OPS:
                for go, acc in ((True, 5), (False, 1), (False, -9)):
                    for v in (vals, None):
                        _segred_case(sr, kinds, v, op, 1, acc, go, dev)
                        cases += 1
        edge = np.zeros(n, np.int32)
        edge[[e for t in range(tile, n + 1, tile) for e in (t - 1, t)
              if e < n]] = 1
        for keep in (np.zeros(n, np.int32), np.ones(n, np.int32), edge,
                     (rng.random(n) < 0.5).astype(np.int32)):
            mask = torch.from_numpy(keep).to(dev)
            for d in (1, 4, 40):
                rows = torch.from_numpy(rng.integers(
                    I32_MIN, I32_MAX, (n, d), dtype=np.int64)
                    .astype(np.int32)).to(dev)
                out, cnt = sc.stream_compact(mask, rows)
                want, wcnt = sc.stream_compact_plain(mask, rows)
                require(int(cnt) == int(wcnt) and torch.equal(out, want),
                        f"stream_compact differs from plain at n={n} d={d}")
                cases += 1
        kinds, vals_t, _ = _segred_case(
            sr, _edge_kinds(rng, n, tile)["spanning"], vals, "min", 1, 5,
            True, dev)
        want_r = sr.segment_reduce_plain(kinds, vals_t, 1, "min", 5, True)
        graph_ms(lambda: sr.segment_reduce(kinds, vals_t, 1, "min", 5, True),
                 2, reps=2, check=lambda got: require(
                     _same_segred(got, want_r),
                     f"segment_reduce replayed differs from plain at n={n}"))
        want_c = sc.stream_compact_plain(mask, rows)
        graph_ms(lambda: sc.stream_compact(mask, rows), 2, reps=2,
                 check=lambda got: require(
                     int(got[1]) == int(want_c[1])
                     and torch.equal(got[0], want_c[0]),
                     f"stream_compact replayed differs from plain at n={n}"))
        cases += 2
    return cases


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
    cases += _tile_edge_cases(sc, sr, rng, dev)
    # -- the device-carry entry of the resident loop: every op, windows of
    #    1 (protocol barriers) to 4096 lanes, any valid count (0 included),
    #    values or none, the carry written back in place
    for w in CARRY_LANES:
        for op in sr.OPS:
            for t in range(4):
                _carry_case(sr, rng, w, op, t, dev)
                cases += 1
    torch.cuda.synchronize()
    emit({"phase": "kernels", "check": "exact vs plain", "cases": cases})
    return time_kernels(dev, sc, sr, rng)


def time_kernels(dev, sc, sr, rng):
    """Times at one window of the main path and at 2^24 rows: eager (CUDA
    events around a loop of calls) and from a CUDA graph (the host's issue
    taken out, the replay held to the plain version); the kernels, memsets
    and copies a call puts on the card (``launches_per_call``); a library
    call beside each, eager and, where it can be captured, from a graph."""
    from repro_torch.kernels import graph_count as graphs
    import numpy as np
    import torch
    rows = {}
    # stream_compact: a full VLEN window with kinds + 3 payload columns
    # (what the apps' filters carry), then the large shape
    for label, n, d, iters in (("path", 128, 4, 300),
                               ("large", LARGE_N, 1, 10)):
        mask, vals, _ = _compact_case(sc, rng, n, d, 0.5, dev)
        want, wcnt = sc.stream_compact_plain(mask, vals)

        def same(got):
            require(int(got[1]) == int(wcnt) and torch.equal(got[0], want),
                    f"stream_compact replayed differs from plain at n={n}")

        def library():
            return vals[mask.bool()]
        rec = {"n": n, "d": d,
               "kernel_ms": time_ms(
                   lambda: sc.stream_compact(mask, vals), iters),
               "kernel_graph_ms": graph_ms(
                   lambda: sc.stream_compact(mask, vals), iters, check=same),
               "kernels_per_call": graphs.launches_per_call(
                   lambda: sc.stream_compact(mask, vals)),
               "plain_ms": time_ms(
                   lambda: sc.stream_compact_plain(mask, vals), iters),
               "library_ms": time_ms(library, iters),
               "library": "vals[mask.bool()]",
               "bound_ms": bytes_ms(4 * n + 8 * n * d + 4)}
        rec.update(library_graph(library, iters, "vals[mask.bool()]"))
        if label == "large":       # what a memset of the output would add
            flat = torch.empty(n * d + 1, dtype=torch.int32, device=dev)
            rec["zero_fill_ms"] = graph_ms(flat.zero_, iters)
        out, _ = sc.stream_compact(mask, vals)
        rec["max_abs_err"] = _max_err(out, want)
        rows.setdefault("stream_compact", {})[label] = rec
        emit({"phase": "kernels", "kernel": "stream_compact", "shape": label,
              **rec})
    for label, n, iters in (("path", 128, 300), ("large", LARGE_N, 10)):
        kinds_np, vals_np = _segred_window(rng, n, 3)
        kinds, vals, m = _segred_case(sr, kinds_np, vals_np, "add", 0, 0,
                                      False, dev)
        want = sr.segment_reduce_plain(kinds, vals)
        # yardstick: torch.segment_reduce sums the same segments (data
        # tokens only, float32) — partial: no carry, no emission protocol
        is_bar = kinds_np > 0
        seg = np.cumsum(is_bar) - is_bar
        lengths = torch.from_numpy(np.bincount(
            seg[~is_bar], minlength=int(is_bar.sum()) + 1)).to(dev)
        data_f = torch.from_numpy(vals_np[~is_bar].astype(np.float32)).to(dev)

        def library():
            return torch.segment_reduce(data_f, "sum", lengths=lengths)
        rec = {"n": n, "emitted": m,
               "kernel_ms": time_ms(
                   lambda: sr.segment_reduce(kinds, vals), iters),
               "kernel_graph_ms": graph_ms(
                   lambda: sr.segment_reduce(kinds, vals), iters,
                   check=lambda got: require(
                       _same_segred(got, want),
                       f"segment_reduce replayed differs from plain at "
                       f"n={n}")),
               "kernels_per_call": graphs.launches_per_call(
                   lambda: sr.segment_reduce(kinds, vals)),
               "plain_ms": time_ms(
                   lambda: sr.segment_reduce_plain(kinds, vals), iters),
               "library_ms": time_ms(library, iters),
               "library": "torch.segment_reduce(sum, float32) — partial "
                          "yardstick: segment sums only",
               # the whole output: 2N kinds and 2N values (zeros past the
               # count), count and carry
               "bound_ms": bytes_ms(8 * n + 16 * n + 12),
               "bound_emitted_ms": bytes_ms(8 * n + 8 * m + 12)}
        rec.update(library_graph(library, iters, "torch.segment_reduce"))
        got = sr.segment_reduce(kinds, vals)
        rec["max_abs_err"] = max(_max_err(got[0], want[0]),
                                 _max_err(got[1], want[1]))
        rows.setdefault("segment_reduce", {})[label] = rec
        emit({"phase": "kernels", "kernel": "segment_reduce", "shape": label,
              **rec})
    # the device-carry entry at the resident loop's window: VLEN lanes, all
    # valid, kinds, vals and rids read, three 2W output columns, count
    # and carry written (the carry changes each call, so a replay is held
    # to nothing; the exact checks are phase_kernels')
    w = 128
    kinds, vals, rids, n, carry0 = _carry_inputs(rng, w, 1, dev)
    n.fill_(w)
    carry = torch.tensor(carry0, dtype=torch.int32, device=dev)
    plain_carry = carry.cpu()
    call = lambda: sr.segment_reduce_carry(kinds, vals, rids, n, "add", 0,
                                           carry)
    want = sr.segment_reduce_carry_plain(kinds.cpu(), vals.cpu(), rids.cpu(),
                                         n.cpu(), "add", 0, plain_carry)
    got = call()
    rec = {"n": w, "emitted": int(want[3]),
           "max_abs_err": max(_max_err(g.cpu(), x)
                              for g, x in zip(got[:3], want[:3])),
           "kernel_ms": time_ms(call, 300),
           "kernel_graph_ms": graph_ms(call, 300),
           "kernels_per_call": graphs.launches_per_call(call),
           "plain_ms": time_ms(lambda: sr.segment_reduce_carry_plain(
               kinds, vals, rids, n, "add", 0, carry.clone()), 100),
           "library_ms": None,
           "library_note": "none: no PyTorch call reduces with a device "
                           "carry and emits per barrier",
           "bound_ms": bytes_ms(12 * w + 4 + 8 + 24 * w + 4 + 8)}
    require(rec["max_abs_err"] == 0, "segment_reduce_carry differs from plain")
    rows["segment_reduce"]["device_carry"] = rec
    emit({"phase": "kernels", "kernel": "segment_reduce",
          "entry": "device_carry", **rec})
    for name, rec in rows.items():
        per = rec["path"]["kernels_per_call"]
        require(per == graphs.ONE_KERNEL,
                f"{name} at N = 128 puts {per} on the card, not one kernel")
        per = rec["large"]["kernels_per_call"]
        require(per["kernels"] == 1 and per["memsets"] <= 2 and
                not per["copies"],
                f"{name} at N = 2^24 puts {per} on the card")
    per = rows["segment_reduce"]["device_carry"]["kernels_per_call"]
    require(per == graphs.ONE_KERNEL, f"the device-carry entry at {w} lanes puts "
            f"{per} on the card, not one kernel")
    torch.cuda.synchronize()
    return rows


# ---------------------------------------------------------------------------
# phase 3: the apps on the card against the numpy oracle
# ---------------------------------------------------------------------------

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
    from repro_torch.serve import traffic as tr
    from repro_torch.apps.common import check_app
    from repro_torch.core.backend import NumpyBackend
    lowered = app.fn.lower(**app.dram_init, **app.params, **app.statics)
    ex_np = lowered.compile(NumpyBackend()).execute(dict(app.dram_init),
                                                    app.params)
    before, calls = tr.executor_launches(), tb.calls
    ex_t = lowered.compile(tb).execute(dict(app.dram_init), app.params)
    after, calls = tr.executor_launches(), tb.calls - calls
    tr.same_run(name, ex_np, ex_t)
    check_app(app, ex_t.dram)
    rec = {"phase": "apps", "app": name, "match": True,
           "torch_cuda_wall_s": ex_t.report.wall_s,
           "numpy_wall_s": ex_np.report.wall_s,
           "backend_calls": calls,
           "us_per_call": ex_t.report.wall_s / calls * 1e6,
           "launches": {k: after[k] - before[k] for k in after}}
    emit(rec)
    return rec["torch_cuda_wall_s"]


# torch.profiler's cost grows with the events it records: a whole huff_dec
# run (129k backend calls) does not finish within the script's time limit,
# so each app is profiled over its first PROFILE_CALLS backend calls only.
PROFILE_CALLS = 1500       # 4000 until the resident phase joined the run


def device_busy(name, app, tb) -> dict:
    """One run of ``app`` with ``torch.profiler`` on over its first
    ``PROFILE_CALLS`` backend calls (the whole run if it is shorter): device
    time of all CUDA kernels and copies against that window's wall time."""
    import torch
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
    return {"phase": "apps", "app": name, "profiled_calls": window["calls"],
            "run_calls": tb.calls - calls0,
            **device_time(prof, window["wall_s"], name)}


def device_time(prof, wall_s: float, what: str, kernel: str = "") -> dict:
    """Device time of all CUDA kernels and copies a profile saw, against
    the profiled wall time, and the six largest items; with ``kernel``,
    also the share of device time of the items whose name holds it."""
    from torch.autograd import DeviceType
    device_us = kernel_us = 0.0
    top = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:   # host ops repeat their kernels
            continue
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        device_us += us
        if kernel and kernel in ev.key:
            kernel_us += us
        top.append((us, ev.key, ev.count))
    require(device_us > 0, f"{what}: the profiler saw no device time")
    top.sort(reverse=True)
    out = {"profiled_wall_s": wall_s, "device_s": device_us / 1e6,
           "device_busy_share": device_us / 1e6 / wall_s,
           "top_device": [{"name": k[:60], "us": us, "count": c}
                          for us, k, c in top[:6]]}
    if kernel:
        require(kernel_us > 0, f"{what}: the profiler saw no {kernel}")
        out[f"{kernel}_device_share"] = kernel_us / device_us
    return out


def phase_apps(tb):
    from repro_torch.serve import traffic as tr
    from repro_torch.apps import ALL_APPS
    t0 = time.perf_counter()
    tr.reset_executor_launches()
    walls = {name: _run_app(name, ALL_APPS[name](**tr.BENCH_SIZES[name]), tb)
             for name in sorted(tr.BENCH_SIZES)}
    walls["hash_table_16x"] = _run_app(
        "hash_table_16x", ALL_APPS["hash_table"](**tr.HASH_TABLE_16X), tb)
    launches = tr.executor_launches()
    for k, v in launches.items():
        require(v > 0, f"the apps never launched the {k} kernel")
    emit({"phase": "apps", "apps": len(tr.BENCH_SIZES) + 1, "launches": launches,
          "seconds": time.perf_counter() - t0})
    # device busy share of every app, from one more run each under the
    # profiler (after the counts are read, so they hold one run per app)
    for name in sorted(tr.BENCH_SIZES):
        emit(device_busy(name, ALL_APPS[name](**tr.BENCH_SIZES[name]), tb))
    return launches, walls


# ---------------------------------------------------------------------------
# phase 4: serving
# ---------------------------------------------------------------------------

def phase_serve(tb):
    from repro_torch.serve import traffic as tr
    from repro_torch import revet
    from repro_torch.apps import ALL_APPS
    from repro_torch.apps.common import check_app
    from repro_torch.core.vector_vm import VLEN, ReplicatedVectorVM
    from repro_torch.serve.dataflow import DataflowEngine, DataflowRequest
    tr.reset_executor_launches()
    for name in ("strlen", "hash_table"):
        apps = [ALL_APPS[name](seed=s) for s in range(8)]
        tr.pad_inputs(apps)
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
    tr.pad_inputs(apps)
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
    launches = tr.executor_launches()
    for k, v in launches.items():
        require(v > 0, f"serving never launched the {k} kernel")
    emit({"phase": "serve", "app": "murmur3", "replicas": reps,
          "window": reps * VLEN, "requests": len(reqs), "match": True,
          "wall_s": wall, "requests_per_s": len(reqs) / wall,
          "launches": launches})


# ---------------------------------------------------------------------------
# phase 4b: the resident loop
# ---------------------------------------------------------------------------

def _resident_instances():
    from repro_torch.serve import traffic as tr
    from repro_torch.apps import ALL_APPS
    out = {name: ALL_APPS[name](**tr.BENCH_SIZES[name])
           for name in sorted(tr.BENCH_SIZES)}
    out["hash_table_16x"] = ALL_APPS["hash_table"](**tr.HASH_TABLE_16X)
    return out


def _graph_per_tick(dp) -> dict:
    """Graph nodes (``graph_nodes`` of one more capture of the program's
    block of ticks, its launch counters left as they were) and device µs
    (CUDA events over replays of the program's own graph), per tick.  The
    masked form issues every kernel of a tick whatever the state, so a
    replay after the run measures what each of the run's replays issued."""
    from repro_torch.kernels import graph_count as graphs
    import torch
    from repro_torch.core import device_vm
    k = dp.ticks_per_replay
    counts = [kern.launches for kern in device_vm._KERNELS]
    nodes = graphs.graph_nodes(lambda: dp._block(dp._st, dp.form))
    for kern, n in zip(device_vm._KERNELS, counts):
        kern.launches = n
    reps = 10
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(reps):
        dp._graph.replay()
    e1.record()
    torch.cuda.synchronize()
    return {"kernels_per_tick": nodes["kernels"] / k,
            "memsets_per_tick": nodes["memsets"] / k,
            "copies_per_tick": nodes["copies"] / k,
            "graph_us_per_tick": e0.elapsed_time(e1) / (reps * k) * 1e3}


def phase_resident(tb, windowed_walls):
    """The nine apps at ``BENCH_SIZES`` and hash_table at 16x with
    ``execution="resident"``: one request, then a batch of 3, each equal to
    the oracle; no windowed backend call; both kernels launched from the
    replayed ticks; murmur3's and hash_table's ticks equal the CPU port's;
    ``DataflowEngine(compiled, execution="resident")`` serving 8 strlen
    requests from distinct seeds."""
    from repro_torch.serve import traffic as tr
    from repro_torch.apps import ALL_APPS
    from repro_torch.apps.common import check_app
    from repro_torch.core.backend import NumpyBackend, TorchBackend
    from repro_torch.core.device_vm import DeviceRun
    from repro_torch.serve.dataflow import DataflowEngine, DataflowRequest
    t0 = time.perf_counter()
    cpu = TorchBackend("cpu")
    calls0 = tb.calls
    tr.reset_executor_launches()
    for name, app in _resident_instances().items():
        lowered = app.fn.lower(**app.dram_init, **app.params, **app.statics)
        compiled = lowered.compile(tb)
        want = lowered.compile(NumpyBackend()).execute(dict(app.dram_init),
                                                       app.params)
        before = tr.executor_launches()
        got = compiled.execute(dict(app.dram_init), app.params,
                               execution="resident")
        after = tr.executor_launches()
        tr.same_resident(name, got, want)
        check_app(app, got.dram)
        run = got.vm
        require(isinstance(run, DeviceRun) and run.host_reads == run.replays,
                f"{name}: host reads {run.host_reads} != replays "
                f"{run.replays}")
        ticks = run.stats["ticks"]
        rec = {"phase": "resident", "app": name, "match": True,
               "execution": got.report.execution,
               "resident_wall_s": got.report.wall_s,
               "windowed_wall_s": windowed_walls[name],
               "numpy_wall_s": want.report.wall_s,
               "resident_over_windowed": got.report.wall_s /
               windowed_walls[name],
               "resident_over_numpy": got.report.wall_s / want.report.wall_s,
               "capture_s": run.capture_s, "form": run.form, "ticks": ticks,
               "ticks_per_replay": run.ticks_per_replay,
               "replays": run.replays, "host_reads": run.host_reads,
               "us_per_tick": run.run_s / ticks * 1e6,
               "contexts": len(run.fires),
               "ready_share": float(run.fires.sum()) /
               (ticks * len(run.fires)),
               "launches": {k: after[k] - before[k] for k in after},
               **_graph_per_tick(run.program)}
        if name in ("murmur3", "hash_table"):
            cpu_run = lowered.compile(cpu).execute(
                dict(app.dram_init), app.params, execution="resident")
            rec["cpu_port_ticks"] = cpu_run.report.stats["ticks"]
            require(rec["cpu_port_ticks"] == ticks,
                    f"{name}: {ticks} ticks on the card, "
                    f"{rec['cpu_port_ticks']} on the CPU port")
        # a fused batch of 3 against the oracle's batch
        reqs = [(dict(app.dram_init), dict(app.params))] * 3
        bw = lowered.compile(NumpyBackend()).execute_batch(reqs)
        t1 = time.perf_counter()
        br = compiled.execute_batch(reqs, execution="resident")
        rec["batch3_wall_s"] = time.perf_counter() - t1
        rec["batch3_ticks"] = br.report.stats["ticks"]
        tr.same_resident(f"{name} batch of 3", br, bw)
        emit(rec)
    # served: DataflowEngine batches as resident runs (pow2 buckets)
    apps = [ALL_APPS["strlen"](seed=s) for s in range(8)]
    tr.pad_inputs(apps)
    app = apps[0]
    lowered = app.fn.lower(**app.dram_init, **app.params, **app.statics)
    eng = DataflowEngine(lowered.compile(tb), execution="resident")
    seq = DataflowEngine(lowered.compile("numpy"))
    for e in (eng, seq):
        for rid, a in enumerate(apps):
            e.submit(DataflowRequest(rid, dict(a.params), dict(a.dram_init)))
    t1 = time.perf_counter()
    batch = eng.step_batch(max_batch=8)
    wall = time.perf_counter() - t1
    want = seq.drain(max_batch=1)
    require([r.rid for r in batch] == list(range(8)),
            "resident serving: step_batch did not serve the 8 requests")
    for b, w, a in zip(batch, want, apps):
        require(b.report.execution == "resident",
                f"strlen rid={b.rid}: served windowed")
        for arr in w.dram:
            require((b.dram[arr] == w.dram[arr]).all(),
                    f"strlen rid={b.rid}: served resident '{arr}' differs")
        check_app(a, b.dram)
    launches = tr.executor_launches()
    require(tb.calls == calls0,
            f"the resident phase made {tb.calls - calls0} windowed backend "
            "calls")
    for k, v in launches.items():
        require(v > 0, f"the resident runs never launched the {k} kernel")
    emit({"phase": "resident", "app": "strlen", "served": 8,
          "bucket": eng.bucket_sizes, "wall_s": wall,
          "requests_per_s": 8 / wall, "match": True,
          "launches": launches, "seconds": time.perf_counter() - t0})
    return launches


# ---------------------------------------------------------------------------
# phase 4c: open-loop serving through AsyncServeEngine
# ---------------------------------------------------------------------------

SERVE_REQUESTS = 32
SERVE_APPS = ("murmur3", "hash_table")


def phase_async_serve(tb):
    """murmur3 and hash_table at ``BENCH_SIZES`` on the card: 32 open-loop
    Poisson requests over two tenants at the measured batch-8 capacity
    through ``AsyncServeEngine``, windowed (max_wave 8) and resident
    (buckets "auto", every bucket captured by ``warmup()`` and none while
    serving), each response equal to the oracle's solo run, no request
    lost, failed, degraded or sent back to windowed; then one resident
    launch fault (the first attempt raises) whose replay must be equal.
    The executor kernels' launches are counted over each serving window
    alone (``traffic.drive_async``: from 0 after ``warmup()``), summed per
    mode over the two apps, and each must be > 0 in each mode."""
    from repro_torch.serve import traffic as tr
    from repro_torch.distributed.fault_tolerance import SimulatedFault
    t0 = time.perf_counter()
    by_mode = {m: dict.fromkeys(tr.executor_launches(), 0)
               for m in ("windowed", "resident")}
    for name in SERVE_APPS:
        apps, lowered, solos = tr.serve_instances(name, tr.BENCH_SIZES[name])
        compiled = lowered.compile(tb)
        t_launch = tr.batch8_wall(compiled, apps)
        capacity = tr.SERVE_BATCH / t_launch
        slo_s = tr.SERVE_SLO_MULT * t_launch
        sched = tr.poisson(SERVE_REQUESTS, capacity, SEED)
        for execution in ("windowed", "resident"):
            d = tr.drive_async(compiled, apps, solos, sched, slo_s,
                               execution)
            tr.require_clean(name, d, execution)
            for k, v in d["launches"].items():
                by_mode[execution][k] += v
            emit({"phase": "async_serve", "app": name, "mode": execution,
                  "t_launch8_s": t_launch, "capacity_rps": capacity,
                  "slo_s": slo_s, "warmed": d["warmed"],
                  "warmup_s": d["warmup_s"], "launches": d["launches"],
                  **tr.rate_cell(d, slo_s, capacity, SERVE_REQUESTS),
                  **tr.async_summary(d)})
        # one injected fault: the first resident launch attempt raises
        fired = []

        def hook(attempt, mode, reqs):
            if attempt == 0 and not fired:
                fired.append(len(reqs))
                raise SimulatedFault(f"{mode} launch of {len(reqs)} lost")

        d = tr.drive_async(compiled, apps, solos, [0.0] * tr.SERVE_BATCH,
                           slo_s, "resident", fault_hook=hook)
        st = d["stats"]
        require(fired and st["supervisor_retries"] == 1
                and st["supervisor_failures"] == 1 and not st["degraded"]
                and st["resident_fallbacks"] == 0
                and d["executions"] == ["resident"],
                f"{name}: the injected fault was not replayed resident: "
                f"{tr.async_summary(d)}")
        emit({"phase": "async_serve", "app": name, "fault": "resident "
              "attempt 0 raised once; replayed", "match": True,
              "launches": d["launches"], **tr.async_summary(d)})
    for mode, launches in by_mode.items():
        for k, v in launches.items():
            require(v > 0, f"async {mode} serving never launched the {k} "
                    "kernel")
    emit({"phase": "async_serve", "launches_by_mode": by_mode,
          "seconds": time.perf_counter() - t0})
    return by_mode


# ---------------------------------------------------------------------------
# phase 5: the attention kernels against their plain versions
# ---------------------------------------------------------------------------

def _attn_inputs(rng, bh, sq, skv, d, dtype, dev, bhkv=None):
    """q [bh, sq, d] and k/v [bhkv (default bh), skv, d]."""
    import torch

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            "float32")).to(dev, getattr(torch, dtype))
    bhkv = bh if bhkv is None else bhkv
    return t(bh, sq, d), t(bhkv, skv, d), t(bhkv, skv, d)


def _attn_err(got, want, dtype, what) -> float:
    import torch
    err = float((got.float() - want.float()).abs().max())
    tol = ATTN_TOL[dtype]
    require(torch.allclose(got.float(), want.float(), atol=tol, rtol=tol),
            f"{what} differs from its plain version (max |err| {err}, "
            f"tol {tol})")
    return err


def _bound(flops: float, nbytes: int, dtype: str) -> tuple[float, str]:
    """The least time for the work: operations at the type's peak or bytes
    at the memory rate, whichever is larger, and which one it is."""
    ops_ms = flops / PEAK_FLOPS[dtype] * 1e3
    mem_ms = bytes_ms(nbytes)
    return (ops_ms, "operations") if ops_ms >= mem_ms else (mem_ms, "bytes")


def _flash_case(rng, bh, s, dtype, causal, iters, dev, d=64, bhkv=None):
    """Flash over ``bh`` query rows of ``bhkv`` (default ``bh``) kv rows:
    vs plain, eager and graph times, the bound and SDPA."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    bhkv = bh if bhkv is None else bhkv
    q, k, v = _attn_inputs(rng, bh, s, s, d, dtype, dev, bhkv)
    err = _attn_err(fa.flash_attention(q, k, v, causal),
                    fa.flash_attention_plain(q, k, v, causal), dtype,
                    f"flash_attention bh={bh}/{bhkv} s={s} d={d} {dtype} "
                    f"causal={causal}")
    pairs = s * (s + 1) // 2 if causal else s * s   # (query, key) pairs seen
    size = q.element_size()
    # q and out per query row, k and v once per kv row
    bound, by = _bound(4.0 * bh * pairs * d,
                       2 * bh * s * d * size + 2 * bhkv * s * d * size, dtype)

    def sdpa():          # top-left causal, as the kernel (Sq == Skv here)
        return F.scaled_dot_product_attention(
            q[None], k[None], v[None], is_causal=causal,
            enable_gqa=bhkv != bh)

    return {"bh": bh, "bhkv": bhkv, "sq": s, "skv": s, "d": d,
            "dtype": dtype, "causal": causal, "max_abs_err": err,
            "kernel_ms": time_ms(lambda: fa.flash_attention(q, k, v, causal),
                                 iters),
            "kernel_graph_ms": graph_ms(
                lambda: fa.flash_attention(q, k, v, causal), iters),
            "plain_ms": time_ms(
                lambda: fa.flash_attention_plain(q, k, v, causal), iters),
            "library_ms": time_ms(sdpa, iters),
            "library_graph_ms": graph_ms(sdpa, iters),
            "bound_ms": bound, "bound_by": by}


def _decode_case(rng, bh, s, dtype, iters, dev, d=64, bhkv=None):
    """Decode of ``bh`` query rows over ``bhkv`` (default ``bh``) kv rows
    with random lengths: vs plain, eager and graph times, the bound and
    SDPA."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as da
    bhkv = bh if bhkv is None else bhkv
    g = bh // bhkv
    q, _, _ = _attn_inputs(rng, bh, 1, 1, d, dtype, dev)
    _, k, v = _attn_inputs(rng, bhkv, 1, s, d, dtype, dev)
    lens = rng.integers(1, s + 1, bhkv).astype(np.int32)
    lengths = torch.from_numpy(lens).to(dev)
    err = _attn_err(da.decode_attention(q, k, v, lengths),
                    da.decode_attention_plain(q, k, v, lengths), dtype,
                    f"decode_attention bh={bh}/{bhkv} s={s} d={d} {dtype}")
    size = q.element_size()
    keys = int(np.minimum(lens, s).sum())          # what this data needs
    # K and V once per kv row up to its length; q and out per query row
    bound, by = _bound(4.0 * keys * d * g,
                       2 * keys * d * size + 2 * bh * d * size + 4 * bhkv,
                       dtype)
    mask = (torch.arange(s, device=dev)[None, :]
            < lengths[:, None])[:, None, None, :]
    qg = q.reshape(bhkv, g, 1, d)

    def sdpa():
        return F.scaled_dot_product_attention(
            qg, k[:, None], v[:, None], attn_mask=mask, enable_gqa=g > 1)

    n_split = da.split_plan(bhkv, s)
    one_chunk = {}
    if n_split > 1:      # what the split buys over one chunk a kv row

        def whole():
            return da._launch(q, k, v, lengths, g, 1)

        err = max(err, _attn_err(whole(), da.decode_attention_plain(
            q, k, v, lengths), dtype, f"decode_attention bh={bh}/{bhkv} "
            f"s={s} d={d} {dtype} in one chunk"))
        one_chunk = {"one_chunk_ms": time_ms(whole, iters),
                     "one_chunk_graph_ms": graph_ms(whole, iters)}
    return {"bh": bh, "bhkv": bhkv, "s": s, "d": d, "dtype": dtype,
            "keys": keys, "n_split": n_split, **one_chunk,
            "max_abs_err": err,
            "kernel_ms": time_ms(lambda: da.decode_attention(q, k, v,
                                                             lengths), iters),
            "kernel_graph_ms": graph_ms(
                lambda: da.decode_attention(q, k, v, lengths), iters),
            "plain_ms": time_ms(
                lambda: da.decode_attention_plain(q, k, v, lengths), iters),
            "library_ms": time_ms(sdpa, iters),
            "library_graph_ms": graph_ms(sdpa, iters),
            "bound_ms": bound, "bound_by": by}


def phase_attention(dev):
    """Both attention kernels at the LM path's shapes (qwen2-0.5b: 14 query
    heads of 64 on 2 kv heads, prompts of 16-512 tokens, a cache of
    LM_MAX_LEN for LM_SLOTS slots), with the heads matched (as the first
    version was measured) and grouped (as the served path calls them), and
    at large ones.  Returns the rows for the kernels line."""
    import numpy as np
    import torch
    rng = np.random.default_rng(SEED + 1)
    flash, decode = [], []
    for dtype in ("bfloat16", "float32"):
        for s in (16, 100, 128, 512, 2048):
            flash.append(_flash_case(rng, 14, s, dtype, True,
                                     50 if s <= 512 else 10, dev))
        flash.append(_flash_case(rng, 14, 512, dtype, False, 50, dev))
        decode.append(_decode_case(rng, LM_SLOTS * 14, LM_MAX_LEN, dtype, 50,
                                   dev))
    # qwen2-0.5b's own head counts: 14 query heads on 2 kv heads (G = 7)
    gqa_flash = [_flash_case(rng, 14, s, dtype, True, 50, dev, bhkv=2)
                 for dtype in ("bfloat16", "float32") for s in (100, 512)]
    gqa_decode = [_decode_case(rng, LM_SLOTS * 14, LM_MAX_LEN, dtype, 50,
                               dev, bhkv=LM_SLOTS * 2)
                  for dtype in ("bfloat16", "float32")]
    flash.append(_flash_case(rng, 56, 4096, "bfloat16", True, 3, dev))
    decode.append(_decode_case(rng, 56, 32768, "bfloat16", 10, dev))
    # olmoe-1b-7b's heads: 16 of 128 (16 kv heads) over the 512-token
    # prompt; the decode kernel over LM_SLOTS slots x 16 heads of the
    # LM_MAX_LEN cache
    d128 = {"flash_attention": [], "decode_attention": []}
    for dtype in ("bfloat16", "float32"):
        d128["flash_attention"].append(
            _flash_case(rng, 16, 512, dtype, True, 30, dev, d=128))
        d128["decode_attention"].append(
            _decode_case(rng, LM_SLOTS * 16, LM_MAX_LEN, dtype, 50, dev,
                         d=128))
    torch.cuda.synchronize()
    for name, rows in (("flash_attention", flash + gqa_flash),
                       ("decode_attention", decode + gqa_decode)):
        for r in rows + d128[name]:
            emit({"phase": "attention", "kernel": name, **r})
    return {"flash_attention": {
                "path": next(r for r in gqa_flash if r["sq"] == 512
                             and r["dtype"] == "bfloat16"),
                "matched": next(r for r in flash if r["sq"] == 512
                                and r["causal"]
                                and r["dtype"] == "bfloat16"),
                "large": flash[-1], "max_abs_err": max(
                    r["max_abs_err"] for r in flash + gqa_flash
                    if r["dtype"] == "bfloat16")},
            "decode_attention": {
                "path": gqa_decode[0], "matched": decode[0],
                "large": decode[-1], "max_abs_err": max(
                    r["max_abs_err"] for r in decode + gqa_decode
                    if r["dtype"] == "bfloat16")},
            "d128": {k: v[0] for k, v in d128.items()}}


# ---------------------------------------------------------------------------
# phase 6: full-width LM serving through DecodeEngine
# ---------------------------------------------------------------------------

def _lm_kernels():
    """The kernels reached through the LM stack and the ops entry points
    (the executor's two are ``_launches``)."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.hash_probe import hash_probe
    from repro_torch.kernels.moe_dispatch import moe_dispatch
    from repro_torch.kernels.rg_lru import rg_lru
    from repro_torch.kernels.ssm_scan import ssm_scan
    return {"flash_attention": flash_attention,
            "decode_attention": decode_attention, "ssm_scan": ssm_scan,
            "rg_lru": rg_lru, "moe_dispatch": moe_dispatch,
            "hash_probe": hash_probe}


def _lm_launches():
    return {k: fn.launches for k, fn in _lm_kernels().items()}


def _reset_all_launches():
    from repro_torch.serve import traffic as tr
    tr.reset_executor_launches()
    for fn in _lm_kernels().values():
        fn.launches = 0


def timed_zoo(zoo):
    """``zoo`` whose prefill and decode_step record their wall time (each
    ends in a synchronise; the engine syncs there anyway to read tokens)."""
    import torch
    from repro_torch.models.zoo import Zoo

    class TimedZoo(Zoo):
        def prefill(self, *a, **kw):
            t0 = time.perf_counter()
            out = super().prefill(*a, **kw)
            torch.cuda.synchronize()
            self.prefill_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        def decode_step(self, *a, **kw):
            t0 = time.perf_counter()
            out = super().decode_step(*a, **kw)
            torch.cuda.synchronize()
            self.decode_ms.append((time.perf_counter() - t0) * 1e3)
            return out

    tz = TimedZoo(zoo.cfg, zoo.mod)
    tz.prefill_ms, tz.decode_ms = [], []
    return tz


def _lm_requests(cfg):
    import numpy as np
    from repro_torch.serve.engine import Request
    rng = np.random.default_rng(SEED)
    lens = rng.integers(16, 513, LM_REQUESTS)
    lens[0] = 512                                  # the longest prompt
    require(any(n % 128 for n in lens), "a prompt not a multiple of 128")
    return [Request(rid=i, prompt=rng.integers(1, cfg.vocab, int(n))
                    .astype(np.int32), max_new=LM_MAX_NEW)
            for i, n in enumerate(lens)]


def _serve(zoo, params, impl=None, max_len=LM_MAX_LEN, reqs=None):
    """The 8 requests (or ``reqs``) through ``DecodeEngine`` with LM_SLOTS
    slots of ``max_len`` (its default impl unless given).  Returns
    (requests, engine, wall seconds)."""
    import torch
    from repro_torch.serve.engine import DecodeEngine
    kw = {} if impl is None else {"impl": impl}
    eng = DecodeEngine(zoo, params, LM_SLOTS, max_len, **kw)
    reqs = _lm_requests(zoo.cfg) if reqs is None else reqs
    for r in reqs:
        eng.submit(r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    require(all(r.done for r in reqs), f"{eng.impl}: a request never ended")
    return reqs, eng, wall


@contextlib.contextmanager
def _reference_decode(on: bool = True):
    """Inside ``with``: the decode attention over a CUDA cache on the
    float32 grouped reference (``layers._decode_route`` replaced), as the
    plain route's; a plain CUDA cache otherwise takes the decode kernel,
    whatever ``impl`` says."""
    from repro_torch.models import layers as L
    route = L._decode_route
    if on:
        L._decode_route = lambda cache: "ref"
    try:
        yield
    finally:
        L._decode_route = route


def _teacher_forced(zoo, params, req):
    """Logits of both routes on one request, both fed the kernel engine's
    tokens: prefill, then one decode step per generated token (the plain
    route's decode attention on the reference)."""
    import torch
    dev = params["ln_f"]["w"].device
    out = {}
    for impl in ("kernel", "naive"):
        toks = torch.as_tensor(req.prompt, device=dev)[None]
        with _reference_decode(impl == "naive"):
            lg, cache, pos = zoo.prefill(params, {"tokens": toks},
                                         LM_MAX_LEN, impl=impl)
            steps = [lg[0, -1]]
            for t in req.tokens[:-1]:
                tok = torch.tensor([[t]], dtype=torch.int32, device=dev)
                lg, cache, pos = zoo.decode_step(params, tok, cache, pos)
                steps.append(lg[0, -1])
        out[impl] = torch.stack(steps).float()[:, :zoo.cfg.vocab]
    return out["kernel"], out["naive"]


def _bf16_steps(n: int, m: float) -> float:
    """``n`` spacings of bfloat16 (8 significant bits) at magnitude m."""
    return n * 2.0 ** (math.floor(math.log2(m)) - 7)


def lm_profile(zoo, params, reqs) -> dict:
    """torch.profiler over one 512-token prefill and LM_PROFILE_STEPS decode
    steps at batch LM_SLOTS (each step reads its tokens back, as the engine
    does): device busy share and the largest device items."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    dev = params["ln_f"]["w"].device
    cache = zoo.init_cache(LM_SLOTS, LM_MAX_LEN)
    pos = torch.tensor([len(r.prompt) for r in reqs[:LM_SLOTS]],
                       dtype=torch.int32, device=dev)
    tok = torch.tensor([[r.tokens[0]] for r in reqs[:LM_SLOTS]],
                       dtype=torch.int32, device=dev)
    prompt = torch.as_tensor(reqs[0].prompt, device=dev)[None]

    def run():
        nonlocal cache, pos, tok
        lg, _, _ = zoo.prefill(params, {"tokens": prompt}, LM_MAX_LEN,
                               impl="kernel")
        int(lg[0, -1].argmax())
        for _ in range(LM_PROFILE_STEPS):
            lg, cache, pos = zoo.decode_step(params, tok, cache, pos)
            tok = lg[:, 0].argmax(-1).to(torch.int32)[:, None]
            tok.cpu()

    run()                                          # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return {"phase": "lm", "profile": f"prefill 512 + {LM_PROFILE_STEPS} "
            f"decode steps at batch {LM_SLOTS}",
            **device_time(prof, wall, "lm profile")}


def phase_lm():
    from repro_torch.serve import traffic as tr
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models.zoo import get_model
    cfg = get_config(LM_ARCH)
    t0 = time.perf_counter()
    zoo = timed_zoo(get_model(cfg))
    params = zoo.init_params(0)                    # on the card by default
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    require(params["ln_f"]["w"].device.type == "cuda",
            "init_params did not use the card")

    # -- the main path: counts at 0 just before, read just after
    torch.cuda.reset_peak_memory_stats()
    _reset_all_launches()
    reqs, eng, wall = _serve(zoo, params)
    served = {**tr.executor_launches(), **_lm_launches()}
    require(eng.impl == "kernel", f"DecodeEngine's default is {eng.impl}")
    require(served["flash_attention"] == LM_REQUESTS * cfg.n_layers,
            f"flash_attention launched {served['flash_attention']} times, "
            f"want {LM_REQUESTS} x {cfg.n_layers}")
    require(served["decode_attention"] == eng.steps * cfg.n_layers,
            f"decode_attention launched {served['decode_attention']} times, "
            f"want {eng.steps} steps x {cfg.n_layers}")
    # the decode entry point over the served cache of every layer
    rng = __import__("numpy").random.default_rng(SEED + 2)
    lengths = torch.clamp(eng.position, 1, LM_MAX_LEN)
    qs = [torch.from_numpy(rng.standard_normal(
        (LM_SLOTS, cfg.n_heads, 1, cfg.hd)).astype("float32")).to(
        eng.device, torch.bfloat16) for _ in range(cfg.n_layers)]
    dec_out = [ops.decode_mha(qs[i], eng.cache["k"][i], eng.cache["v"][i],
                              lengths, impl="kernel")
               for i in range(cfg.n_layers)]
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches = {**tr.executor_launches(), **_lm_launches()}
    require(launches["decode_attention"] - served["decode_attention"]
            == cfg.n_layers,
            "decode_mha(impl='kernel') did not launch once per layer")
    tokens = sum(len(r.tokens) for r in reqs)
    emit({"phase": "lm", "arch": LM_ARCH, "n_params": zoo.n_params(),
          "init_s": init_s, "requests": LM_REQUESTS,
          "prompt_lens": [len(r.prompt) for r in reqs], "tokens": tokens,
          "wall_s": wall, "tokens_per_s": tokens / wall, **eng.stats(),
          "prefill_ms": zoo.prefill_ms, "decode_ms_per_step": zoo.decode_ms,
          "max_memory_allocated": peak, "launches": launches})

    # -- checks (launches from here on are comparisons, not the path)
    err = float((dec_out[0].float() - ops.decode_mha(
        qs[0], eng.cache["k"][0], eng.cache["v"][0], lengths,
        impl="ref").float()).abs().max())
    require(err <= ATTN_TOL["bfloat16"] * 2,
            f"decode_mha kernel vs ref on layer 0's cache: {err}")
    with _reference_decode():
        n_reqs, n_eng, n_wall = _serve(zoo, params, impl="naive")
    worst, flips, checked = 0.0, [], 0
    worst_diff, tols = 0.0, []
    for r, n in zip(reqs, n_reqs):
        lk, ln = _teacher_forced(zoo, params, r)
        tol = _bf16_steps(LM_LOGIT_BF16_STEPS, float(ln.abs().max()))
        diff = float((lk - ln).abs().max())
        worst, worst_diff = max(worst, diff / tol), max(worst_diff, diff)
        tols.append(tol)
        require(diff <= tol, f"rid {r.rid}: logits differ by {diff} "
                             f"(tol {tol})")
        top2 = ln.topk(2, -1).values
        for step, tok in enumerate(r.tokens):
            checked += 1
            want = int(ln[step].argmax())
            if tok != want:
                margin = float(top2[step, 0] - top2[step, 1])
                require(margin < tol, f"rid {r.rid} step {step}: token "
                        f"{tok} vs plain {want}, margin {margin} >= {tol}")
                flips.append({"rid": r.rid, "step": step, "kernel": tok,
                              "plain": want, "plain_margin": margin})
        # the naive engine decodes by itself: equal up to the first flip
        first = next((i for i, (a, b) in enumerate(zip(r.tokens, n.tokens))
                      if a != b), None)
        require(first is None or any(f["rid"] == r.rid and f["step"] <= first
                                     for f in flips),
                f"rid {r.rid}: naive engine departs at step {first} with no "
                "small-margin step before it")
    for f in flips:
        emit({"phase": "lm", "small_margin_flip": f})
    emit({"phase": "lm", "check": "kernel vs naive", "tokens_checked":
          checked, "flips": len(flips), "max_logit_diff": worst_diff,
          "logit_tol": [min(tols), max(tols)], "worst_diff_over_tol": worst,
          "decode_kernel_vs_ref_layer0": err,
          "naive_tokens_equal": [r.tokens == n.tokens
                                 for r, n in zip(reqs, n_reqs)],
          "naive_wall_s": n_wall, **{f"naive_{k}": v
                                    for k, v in n_eng.stats().items()}})

    emit(lm_profile(zoo, params, reqs))

    # -- the CLI entry point, in process, at the full preset
    del params, eng, n_eng
    _reset_all_launches()
    t0 = time.perf_counter()
    res = launch_serve.main(["--arch", LM_ARCH, "--preset", "full",
                             "--requests", "8", "--slots", "4"])
    cli = _lm_launches()
    require(cli["flash_attention"] == 8 * cfg.n_layers,
            f"launch.serve: flash_attention launched {cli}")
    emit({"phase": "lm", "entry": "repro_torch.launch.serve.main",
          "seconds": time.perf_counter() - t0, **res, "launches": cli})
    return launches


# ---------------------------------------------------------------------------
# phase 7: the ssm_scan kernel against its plain version
# ---------------------------------------------------------------------------

def _sm_clock_hz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def _ssm_inputs(gen, bsz, s, di, n, zero_h0, dev):
    """x, dt (softplus of a normal, as the model's), a (< 0), b, c, d, h0,
    drawn on the card."""
    import torch
    import torch.nn.functional as F

    def r(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    h0 = torch.zeros(bsz, di, n, device=dev) if zero_h0 else r(bsz, di, n)
    return (r(bsz, s, di), F.softplus(r(bsz, s, di)),
            -torch.exp(0.5 * r(di, n)), r(bsz, s, n), r(bsz, s, n), r(di),
            h0)


def _scan_case(name, kernel, plain, ins, what) -> tuple[float, float]:
    """A scan kernel against its plain version on y and hT; returns the
    largest |error| and the largest |error| over the largest |plain|
    value, which must stay within SSM_TOL."""
    got = kernel(*ins)
    want = plain(*ins)
    worst = (0.0, 0.0)
    for out, g, w in zip(("y", "hT"), got, want):
        err = float((g - w).abs().max())
        scale = float(w.abs().max())
        require(err <= SSM_TOL * scale,
                f"{name} {what}: {out} differs from plain by {err} "
                f"(largest |plain| {scale}, tol {SSM_TOL} of it)")
        worst = max(worst[0], err), max(worst[1], err / scale if scale else 0)
    return worst


def scan_kernels_per_call(dev) -> dict:
    """The kernels, memsets and copies one call of each scan kernel puts on
    the card at its path shape (``launches_per_call``), which must be one
    kernel and nothing else.  Taken before the other phases."""
    from repro_torch.kernels import graph_count as graphs
    import torch
    from repro_torch.kernels import rg_lru as rg
    from repro_torch.kernels import ssm_scan as sc
    gen = torch.Generator(dev).manual_seed(SEED + 9)
    ssm_ins = _ssm_inputs(gen, *SSM_PATH, True, dev)
    rg_ins = _rg_inputs(gen, *RG_PATH, True, dev)
    out = {"ssm_scan": graphs.launches_per_call(lambda: sc.ssm_scan(*ssm_ins)),
           "rg_lru": graphs.launches_per_call(lambda: rg.rg_lru(*rg_ins))}
    for name, per in out.items():
        require(per == graphs.ONE_KERNEL,
                f"{name} at its path shape puts {per} on the card, not one "
                "kernel")
    return out


def _ssm_case(sc, ins, what) -> tuple[float, float]:
    return _scan_case("ssm_scan", sc.ssm_scan, sc.ssm_scan_plain, ins, what)


def _ssm_bound(bsz, s, di, n, clock_hz) -> dict:
    """Bytes (each input read once, each output written once) at the memory
    rate, and the B*S*Di*N exponentials at the SFU rate."""
    nbytes = 4 * (3 * bsz * s * di + 2 * bsz * s * n + di * n + di
                  + 2 * bsz * di * n)
    exp_ms = bsz * s * di * n / (SFU_EXP_PER_SM_CLOCK * H100_SMS
                                 * clock_hz) * 1e3
    mem_ms = bytes_ms(nbytes)
    return {"bound_ms": max(exp_ms, mem_ms),
            "bound_by": "operations" if exp_ms >= mem_ms else "bytes",
            "bytes_ms": mem_ms, "exp_ms": exp_ms, "sm_clock_hz": clock_hz}


def _scan_close(name, got, want, what) -> None:
    """``got`` within SSM_TOL of the largest |want| on y and hT."""
    for out, g, w in zip(("y", "hT"), got, want):
        err = float((g - w).abs().max())
        require(err <= SSM_TOL * float(w.abs().max()),
                f"{name} {what}: {out} differs from plain by {err}")


def _scan_replayed(name, kernel, plain, ins, exact, gen_inputs) -> None:
    """One call of ``kernel`` captured in a CUDA graph and replayed on two
    new inputs copied into its static tensors: each replay equals the plain
    version on those inputs (bit for bit if ``exact``, else SSM_TOL)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kernel(*ins)                               # warm, off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = kernel(*ins)
    for i in range(2):
        for t, new in zip(ins, gen_inputs()):
            t.copy_(new)
        graph.replay()
        torch.cuda.synchronize()
        want = plain(*ins)
        if exact:
            require(all(torch.equal(g, w) for g, w in zip(got, want)),
                    f"{name} replay {i} differs from plain")
        else:
            _scan_close(name, got, want, f"replay {i}")


def phase_ssm_kernel(dev, per_call):
    import torch
    from repro_torch.kernels import ssm_scan as sc
    gen = torch.Generator(dev).manual_seed(SEED + 3)
    cases, worst_abs, worst_rel = 0, 0.0, 0.0
    for s in (1, 63, 64, 100, 512):
        for di in (128, 1000, 8192):            # 1000: a ragged last block
            for n in (8, 16):
                for zero_h0 in (True, False):
                    ins = _ssm_inputs(gen, 2, s, di, n, zero_h0, dev)
                    e, r = _ssm_case(sc, ins, f"B=2 S={s} Di={di} N={n} "
                                     f"h0={'zero' if zero_h0 else 'random'}")
                    worst_abs, worst_rel = max(worst_abs, e), max(worst_rel, r)
                    cases += 1
    # the edges of each N's plan: a buffer of L steps, a stage of CHUNK
    # steps, a block of C channels (a ragged one, and the path's Di)
    edge_cases = 0
    for n in (1, 5, 16, 32):
        p = sc.plan(1, 8192, n)
        for s in (p.lanes - 1, p.lanes + 1, sc.CHUNK - 1, sc.CHUNK + 1,
                  2 * sc.CHUNK + 1):
            for bsz, di in ((2, p.channels + 3), (1, 8192)):
                ins = _ssm_inputs(gen, bsz, s, di, n, s % 2 == 0, dev)
                e, r = _ssm_case(sc, ins, f"edge B={bsz} S={s} Di={di} "
                                 f"N={n} ({p.lanes} lanes x {p.states})")
                worst_abs, worst_rel = max(worst_abs, e), max(worst_rel, r)
                edge_cases += 1
    cases += edge_cases
    clock = _sm_clock_hz()
    rows = {}
    # the path shape with the model's zero h0; the large one with a random h0
    for label, shape, iters, plain_iters, zero_h0 in (
            ("path", SSM_PATH, 50, 3, True),
            ("large", SSM_LARGE, 5, 1, False)):
        ins = _ssm_inputs(gen, *shape, zero_h0, dev)
        e, r = _ssm_case(sc, ins, f"{label} {shape}")
        worst_abs, worst_rel = max(worst_abs, e), max(worst_rel, r)
        cases += 1
        want = sc.ssm_scan_plain(*ins)
        p = sc.plan(shape[0], shape[2], shape[3])
        rec = {"b": shape[0], "s": shape[1], "di": shape[2], "n": shape[3],
               "lanes": p.lanes, "states": p.states, "blocks": p.blocks,
               "smem_bytes": p.smem_bytes,
               "max_abs_err": e, "max_err_over_scale": r,
               "kernel_ms": time_ms(lambda: sc.ssm_scan(*ins), iters),
               "kernel_graph_ms": graph_ms(
                   lambda: sc.ssm_scan(*ins), iters,
                   check=lambda got: _scan_close("ssm_scan", got, want,
                                                 f"{label} replayed")),
               "plain_ms": time_ms(lambda: sc.ssm_scan_plain(*ins),
                                   plain_iters, warmup=1),
               "library_ms": None,
               "library_note": "none: no single PyTorch call computes a "
                               "selective scan",
               **_ssm_bound(*shape, clock)}
        if label == "path":
            rec["kernels_per_call"] = per_call
        rows[label] = rec
        emit({"phase": "ssm_kernel", "kernel": "ssm_scan", "shape": label,
              **rec})
    _scan_replayed("ssm_scan", sc.ssm_scan, sc.ssm_scan_plain,
                   _ssm_inputs(gen, 2, 129, 1000, 16, False, dev), False,
                   lambda: _ssm_inputs(gen, 2, 129, 1000, 16, False, dev))
    torch.cuda.synchronize()
    emit({"phase": "ssm_kernel", "check": f"vs plain, {SSM_TOL} of the "
          "largest |plain|", "cases": cases, "edge_cases": edge_cases,
          "replays": 2, "max_abs_err": worst_abs,
          "max_err_over_scale": worst_rel})
    return {"ssm_scan": {**rows, "max_abs_err": worst_abs}}


# ---------------------------------------------------------------------------
# phase 8: full-width falcon-mamba-7b served through DecodeEngine
# ---------------------------------------------------------------------------

def card_params(spec, dev):
    """Random weights for ``spec``, drawn on the card from a
    ``torch.Generator`` seeded SEED: standard normal over the square root
    of the fan-in, as ``params.init`` scales them (zeros and ones leaves as
    declared), in float32 one layer of a stacked leaf at a time, rounded to
    the leaf's dtype.  Not the reference's numbers (the CPU tests hold
    those): drawing 7 B of them on the host takes minutes."""
    import torch
    from repro_torch.models.params import tree_map
    gen = torch.Generator(dev).manual_seed(SEED)

    def leaf(p):
        dtype = getattr(torch, p.dtype)
        if p.init == "zeros":
            return torch.zeros(p.shape, dtype=dtype, device=dev)
        if p.init == "ones":
            return torch.ones(p.shape, dtype=dtype, device=dev)
        scale = 1.0 / math.sqrt(max(p.shape[-2] if len(p.shape) >= 2
                                    else p.shape[-1], 1))
        out = torch.empty(p.shape, dtype=dtype, device=dev)
        for part in (out if p.axes[0] == "layers" else out[None]):
            part.copy_(torch.randn(part.shape, generator=gen, device=dev)
                       * scale)
        return out

    return tree_map(leaf, spec)


def _ssm_layer_check(params, cfg, req, dev) -> dict:
    """Each layer of the kernel forward over the request's prompt and
    generated tokens, held against the served route's layer on the same
    input: the kernel forward's own stream into layer i goes through
    ``ssm.block(impl="kernel")``, through ``ssm.prefill_block`` over the
    prompt rows, and through ``ssm.decode_block`` one fed-back token at a
    time from the prefill's state (its conv tail cast to float32, as the
    engine's cache holds it).  Per layer and route, the largest |diff|
    over the tolerance (that many bf16 steps at the largest |output|)."""
    import numpy as np
    import torch
    from repro_torch.models import layers as L
    from repro_torch.models import ssm
    from repro_torch.models.transformer import layer_params
    p_len, n_dec = len(req.prompt), len(req.tokens) - 1
    seq = torch.as_tensor(np.concatenate([req.prompt, req.tokens])
                          .astype(np.int32), device=dev)[None]
    x = L.embed(params["embed"], seq)
    worst = {"prefill": [], "decode": []}
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        out = ssm.block(lp, x, cfg, "kernel")
        served, h, tail = ssm.prefill_block(lp, x[:, :p_len], cfg)
        conv, dec = tail.float(), []
        for j in range(p_len, p_len + n_dec):
            o, h, conv = ssm.decode_block(lp, x[:, j: j + 1], h, conv, cfg)
            dec.append(o)
        for what, got, want, steps in (
                ("prefill", served, out[:, :p_len], SSM_PREFILL_BF16_STEPS),
                ("decode", torch.cat(dec, 1), out[:, p_len: p_len + n_dec],
                 SSM_DECODE_BF16_STEPS)):
            tol = _bf16_steps(steps, float(want.abs().max()))
            diff = float((got.float() - want.float()).abs().max())
            require(diff <= tol, f"rid {req.rid} layer {i}: the served "
                    f"{what} layer differs from the kernel forward's by "
                    f"{diff} (tol {tol})")
            worst[what].append(diff / tol)
        x = out
    return {k: max(v) for k, v in worst.items()}


def _served_logits(zoo, params, req, max_len=LM_MAX_LEN, impl="chunked"):
    """The served logits of one request, at batch 1: its prefill, spliced
    into a fresh state as the engine splices it (an SSM's conv tail to
    float32, a hybrid's short K/V into the ring's leading rows), then one
    decode step per generated token fed back."""
    import torch
    from repro_torch.serve.engine import _splice_cache
    dev = params["ln_f"]["w"].device
    toks = torch.as_tensor(req.prompt, device=dev)[None]
    lg, cache1, pos = zoo.prefill(params, {"tokens": toks}, max_len,
                                  impl=impl)
    cache = _splice_cache(zoo.init_cache(1, max_len), cache1, 0)
    steps = [lg[0, -1]]
    for t in req.tokens[:-1]:
        tok = torch.tensor([[t]], dtype=torch.int32, device=dev)
        lg, cache, pos = zoo.decode_step(params, tok, cache, pos)
        steps.append(lg[0, -1])
    return torch.stack(steps).float()[:, :zoo.cfg.vocab]


def ssm_profile(params, cfg, prompt) -> dict:
    """torch.profiler over one kernel-route forward at S = len(prompt)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import ssm

    def run():
        ssm.forward(params, prompt, cfg, impl="kernel")[0, -1].argmax().item()

    run()                                          # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return {"phase": "ssm_lm", "profile": f"forward(impl='kernel') at S = "
            f"{prompt.shape[1]}", **device_time(prof, wall, "ssm profile",
                                                 kernel="ssm_scan")}


def phase_ssm_lm(dev):
    import gc

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import ssm
    from repro_torch.models.params import leaves
    from repro_torch.models.zoo import get_model
    gc.collect()                                   # the lm phase's weights
    torch.cuda.empty_cache()
    cfg = get_config(SSM_ARCH)
    zoo = timed_zoo(get_model(cfg))
    t0 = time.perf_counter()
    params = card_params(zoo.spec(), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = zoo.n_params()
    require(n_params == SSM_N_PARAMS, f"{SSM_ARCH}: {n_params} parameters")
    weight_bytes = sum(t.numel() * t.element_size() for t in leaves(params))

    # -- the main path: counts at 0 just before, read just after
    torch.cuda.reset_peak_memory_stats()
    _reset_all_launches()
    reqs, eng, wall = _serve(zoo, params)
    served_launches = _lm_launches()
    fwd_ms, fwd_logits = [], []
    for r in reqs:
        seq = torch.as_tensor(np.concatenate([r.prompt, r.tokens])
                              .astype(np.int32), device=dev)[None]
        t = time.perf_counter()
        lg = ssm.forward(params, seq, cfg, impl="kernel")
        p = len(r.prompt)                         # rows of the 16 tokens
        fwd_logits.append(lg[0, p - 1: p - 1 + len(r.tokens),
                             :cfg.vocab].float().clone())
        torch.cuda.synchronize()
        fwd_ms.append((time.perf_counter() - t) * 1e3)
        del lg
    peak = torch.cuda.max_memory_allocated()
    launches = _lm_launches()
    require(launches["ssm_scan"] == LM_REQUESTS * cfg.n_layers,
            f"ssm_scan launched {launches['ssm_scan']} times, want "
            f"{LM_REQUESTS} x {cfg.n_layers}")
    state = zoo.init_cache(1, LM_MAX_LEN)
    tokens = sum(len(r.tokens) for r in reqs)
    emit({"phase": "ssm_lm", "arch": SSM_ARCH, "n_params": n_params,
          "weight_bytes": weight_bytes, "init_s": init_s,
          "requests": LM_REQUESTS,
          "prompt_lens": [len(r.prompt) for r in reqs], "tokens": tokens,
          "wall_s": wall, "tokens_per_s": tokens / wall, **eng.stats(),
          "prefill_ms": zoo.prefill_ms, "decode_ms_per_step": zoo.decode_ms,
          "forward_kernel_ms": fwd_ms, "max_memory_allocated": peak,
          "state_bytes_per_slot": {k: v.numel() * v.element_size()
                                   for k, v in state.items()},
          "served_launches": served_launches, "launches": launches})
    del state

    # -- checks (launches from here on are comparisons, not the path).
    # Per layer, teacher-forced: the gate.
    worst = {"prefill": 0.0, "decode": 0.0}
    for r in reqs:
        for k, v in _ssm_layer_check(params, cfg, r, dev).items():
            worst[k] = max(worst[k], v)
    emit({"phase": "ssm_lm", "check": "kernel forward vs served, per layer "
          "on the same input", "layers": cfg.n_layers * LM_REQUESTS,
          "bf16_steps": {"prefill": SSM_PREFILL_BF16_STEPS,
                         "decode": SSM_DECODE_BF16_STEPS},
          "worst_diff_over_tol": worst})
    # End to end, measured: 64 bf16 layers of random weights carry a
    # rounding difference far (the plain forward, whose scan differs from
    # the served one only in rounding, is the control).
    e2e = {"kernel": [], "plain": []}
    agree = {"kernel": 0, "plain": 0}
    for r, lk in zip(reqs, fwd_logits):
        ls = _served_logits(zoo, params, r)
        seq = torch.as_tensor(np.concatenate([r.prompt, r.tokens])
                              .astype(np.int32), device=dev)[None]
        p = len(r.prompt)
        lp = ssm.forward(params, seq, cfg, impl="chunked")[
            0, p - 1: p - 1 + len(r.tokens), :cfg.vocab].float()
        for name, lf in (("kernel", lk), ("plain", lp)):
            require(bool(torch.isfinite(lf).all()) and lf.shape == ls.shape,
                    f"rid {r.rid}: {name} forward logits")
            e2e[name].append([float((ls[0] - lf[0]).abs().max()),
                              float((ls[1:] - lf[1:]).abs().max())])
            agree[name] += sum(int(t == int(lf[s].argmax()))
                               for s, t in enumerate(r.tokens))
    emit({"phase": "ssm_lm", "end_to_end": "served logits vs forward "
          "logits [prefill row, decode rows] per request",
          "max_abs_logit": float(max(lk.abs().max() for lk in fwd_logits)),
          "kernel_forward": e2e["kernel"], "plain_forward": e2e["plain"],
          "greedy_tokens_equal": agree, "tokens": tokens})

    emit(ssm_profile(params, cfg, torch.as_tensor(
        reqs[0].prompt, device=dev)[None]))

    # -- the CLI entry point for this architecture, in process, on the card
    del params, eng
    gc.collect()
    t0 = time.perf_counter()
    res = launch_serve.main(["--arch", SSM_ARCH])
    emit({"phase": "ssm_lm", "entry": "repro_torch.launch.serve.main",
          "arch": SSM_ARCH, "preset": "reduced",
          "seconds": time.perf_counter() - t0, **res})
    return launches


# ---------------------------------------------------------------------------
# phase 9: the rg_lru kernel, and attention at head dim 256
# ---------------------------------------------------------------------------

def _rg_inputs(gen, bsz, s, d, zero_h0, dev):
    """a in [0, 1), b ~ 0.1 N(0, 1), h0 zero or ~ 0.1 N(0, 1) (the
    reference's kernel test), drawn on the card."""
    import torch
    a = torch.rand((bsz, s, d), generator=gen, device=dev)
    b = 0.1 * torch.randn((bsz, s, d), generator=gen, device=dev)
    h0 = (torch.zeros(bsz, d, device=dev) if zero_h0
          else 0.1 * torch.randn((bsz, d), generator=gen, device=dev))
    return a, b, h0


def _rg_case(rg, ins, what) -> tuple[float, float]:
    return _scan_case("rg_lru", rg.rg_lru, rg.rg_lru_plain, ins, what)


def phase_rglru_kernel(dev, per_call):
    import numpy as np
    import torch
    from repro_torch.kernels import rg_lru as rg
    gen = torch.Generator(dev).manual_seed(SEED + 5)
    cases, worst_abs, worst_rel = 0, 0.0, 0.0
    for s in (1, 63, 64, 100, 512, 4096):
        for d in (1, 100, 4096):
            for bsz in (1, 4):
                for zero_h0 in (True, False):
                    ins = _rg_inputs(gen, bsz, s, d, zero_h0, dev)
                    e, r = _rg_case(rg, ins, f"B={bsz} S={s} D={d} h0="
                                    f"{'zero' if zero_h0 else 'random'}")
                    worst_abs, worst_rel = max(worst_abs, e), max(worst_rel, r)
                    cases += 1
    # the ring's edges, bit for bit, for the plan of each (B, D): a stage
    # of its steps, the prologue's stages - 1 tiles, one past the whole
    # ring; each width's block edge, a D that is no multiple of 4 (4-byte
    # copies), the path's D
    edge_cases = 0
    for d in (7, 8, 9, 15, 17, 31, 33, 4095, 4096):
        for bsz in (1, 4):
            p = rg.plan(bsz, d)
            ring = (p.stages - 1) * p.steps
            for s in (p.steps - 1, p.steps, p.steps + 1, ring, ring + 1,
                      p.stages * p.steps + 1):
                ins = _rg_inputs(gen, bsz, s, d, s % 2 == 0, dev)
                got, want = rg.rg_lru(*ins), rg.rg_lru_plain(*ins)
                require(all(torch.equal(g, w) for g, w in zip(got, want)),
                        f"rg_lru edge B={bsz} S={s} D={d} (width "
                        f"{p.width}) differs from plain")
                edge_cases += 1
    cases += edge_cases
    rows = {}
    # the path shape with the model's zero h0; the large one with a random h0
    for label, shape, iters, plain_iters, zero_h0 in (
            ("path", RG_PATH, 100, 3, True),
            ("large", RG_LARGE, 10, 1, False)):
        ins = _rg_inputs(gen, *shape, zero_h0, dev)
        e, r = _rg_case(rg, ins, f"{label} {shape}")
        worst_abs, worst_rel = max(worst_abs, e), max(worst_rel, r)
        cases += 1
        bsz, s, d = shape
        bound, by = _bound(2.0 * bsz * s * d, 4 * (3 * bsz * s * d
                                                   + 2 * bsz * d), "float32")
        want = rg.rg_lru_plain(*ins)
        p = rg.plan(bsz, d)
        rec = {"b": bsz, "s": s, "d": d, "width": p.width,
               "steps_a_stage": p.steps, "stages": p.stages,
               "blocks": p.blocks, "smem_bytes": p.smem_bytes,
               "max_abs_err": e, "max_err_over_scale": r,
               "kernel_ms": time_ms(lambda: rg.rg_lru(*ins), iters),
               "kernel_graph_ms": graph_ms(
                   lambda: rg.rg_lru(*ins), iters,
                   check=lambda got: require(
                       all(torch.equal(g, w) for g, w in zip(got, want)),
                       f"rg_lru {label} replayed differs from plain")),
               "plain_ms": time_ms(lambda: rg.rg_lru_plain(*ins),
                                   plain_iters, warmup=1),
               "library_ms": None,
               "library_note": "none: no single PyTorch call computes a "
                               "gated linear recurrence",
               "bound_ms": bound, "bound_by": by}
        if label == "path":
            rec["kernels_per_call"] = per_call
        rows[label] = rec
        emit({"phase": "rglru_kernel", "kernel": "rg_lru", "shape": label,
              **rec})
    p = rg.plan(3, 4095)
    replay = (3, p.stages * p.steps + 1, 4095)
    _scan_replayed("rg_lru", rg.rg_lru, rg.rg_lru_plain,
                   _rg_inputs(gen, *replay, False, dev), True,
                   lambda: _rg_inputs(gen, *replay, False, dev))
    torch.cuda.synchronize()
    emit({"phase": "rglru_kernel", "check": f"vs plain, {SSM_TOL} of the "
          "largest |plain|; edges and replays bit for bit", "cases": cases,
          "edge_cases": edge_cases, "replays": 2, "max_abs_err": worst_abs,
          "max_err_over_scale": worst_rel})
    # attention at recurrentgemma-9b's head dim: 16 query heads over the
    # 512-token prompt, matched (16 kv rows, as the first version was
    # measured) and on the model's one kv head (G = 16, as the served path
    # calls it); the decode kernel over 4 slots x 16 heads of the 2048-row
    # ring, likewise
    rng = np.random.default_rng(SEED + 6)
    d256 = {"flash_attention": [], "decode_attention": []}
    for dtype in ("bfloat16", "float32"):
        for bhkv in (16, 1):
            d256["flash_attention"].append(
                _flash_case(rng, 16, 512, dtype, True, 30, dev, d=256,
                            bhkv=bhkv))
            d256["decode_attention"].append(
                _decode_case(rng, LM_SLOTS * 16, 2048, dtype, 50, dev,
                             d=256, bhkv=LM_SLOTS * bhkv))
    torch.cuda.synchronize()
    for name, recs in d256.items():
        for rec in recs:
            emit({"phase": "rglru_kernel", "kernel": name, "head_dim": 256,
                  **rec})
    return {"rg_lru": {**rows, "max_abs_err": worst_abs},
            "d256": {k: v[0] for k, v in d256.items()},
            "d256_gqa": {k: v[1] for k, v in d256.items()}}


# ---------------------------------------------------------------------------
# phase 10: full-width recurrentgemma-9b served through DecodeEngine
# ---------------------------------------------------------------------------

def _hybrid_requests(cfg):
    """The 8 requests of the earlier phases, then one 4096-token prompt."""
    import numpy as np
    from repro_torch.serve.engine import Request
    reqs = _lm_requests(cfg)
    rng = np.random.default_rng(SEED + 4)
    reqs.append(Request(rid=len(reqs), prompt=rng.integers(
        1, cfg.vocab, HYBRID_LONG).astype(np.int32), max_new=LM_MAX_NEW))
    return reqs


def _hybrid_layer_check(params, cfg, req, dev) -> dict:
    """Each block of the request's prompt and served tokens, in order: the
    kernel route (``_rec_block(impl="kernel")``; ``_attn_block(impl=
    "kernel")``, flash where the sequence fits the window) against the
    served route's block (the chunked scan; ``impl="chunked"``) on the same
    input, the served output fed on.  Returns the largest |diff| over the
    tolerance (HYBRID_BF16_STEPS at the served block's largest |output|)
    per kind of block."""
    import numpy as np
    import torch
    from repro_torch.models import layers as L
    from repro_torch.models import rglru
    from repro_torch.models.transformer import _positions
    seq = torch.as_tensor(np.concatenate([req.prompt, req.tokens])
                          .astype(np.int32), device=dev)[None]
    positions = _positions(1, seq.shape[1], dev)
    x = L.embed(params["embed"], seq)
    worst = {"rec": 0.0, "attn": 0.0}
    for n, (kind, p, _, _) in enumerate(rglru.blocks(params, cfg)):
        if kind == "rec":
            got, _ = rglru._rec_block(p, x, cfg, impl="kernel")
            want, _ = rglru._rec_block(p, x, cfg)
        else:
            got, _ = rglru._attn_block(p, x, cfg, positions, "kernel")
            want, _ = rglru._attn_block(p, x, cfg, positions, "chunked")
        tol = _bf16_steps(HYBRID_BF16_STEPS, float(want.abs().max()))
        diff = float((got.float() - want.float()).abs().max())
        require(diff <= tol, f"rid {req.rid} block {n} ({kind}): the kernel "
                f"route differs from the served route by {diff} (tol {tol})")
        worst[kind] = max(worst[kind], diff / tol)
        x = want
    return worst


def _ring_wrap(zoo, params, eng, req) -> dict:
    """The long request's slot after serving.  Its prefill filled the
    w-row K ring (P = the prompt length, a multiple of w, so row j holds
    position P - w + j); its n decode steps wrote positions P..P+n-1 into
    rows (P + i) % w = 0..n-1.  Against the same prefill run again, those
    rows of every attention block must have changed and every other row
    must be exactly as the prefill left it."""
    import torch
    w = eng.cache["attn_k"].shape[3]
    p_len, n_dec = len(req.prompt), len(req.tokens) - 1
    final = p_len + n_dec
    slots = [i for i, pos in enumerate(eng.position.tolist()) if pos == final]
    require(len(slots) == 1, f"no single slot ended at position {final}: "
            f"{eng.position.tolist()}")
    rows = [(p_len + i) % w for i in range(n_dec)]
    require(p_len >= w and rows[0] == 0,
            f"the {p_len}-token prompt does not start the ring at row 0")
    toks = torch.as_tensor(req.prompt, device=eng.device)[None]
    _, cache1, _ = zoo.prefill(params, {"tokens": toks}, eng.max_len,
                               impl=eng.impl)
    before = cache1["attn_k"][:, 0, 0].float()         # [G, w, hd]
    after = eng.cache["attn_k"][:, slots[0], 0].float()
    moved = (after - before).abs().amax(-1)             # [G, w]
    written = torch.zeros(w, dtype=torch.bool, device=eng.device)
    written[rows] = True
    require(bool((moved[:, written] > 0).all()),
            f"ring rows {rows[0]}..{rows[-1]}: a block kept the prefill's K "
            "(the decode did not write there)")
    kept = float(moved[:, ~written].max())
    require(kept == 0.0, f"ring rows past {rows[-1]} changed by {kept} "
            "(the decode wrote outside rows (P + i) % w)")
    return {"slot": slots[0], "final_position": final, "ring": w,
            "rows_written": [rows[0], rows[-1]],
            "min_change_written": float(moved[:, written].min()),
            "max_change_elsewhere": kept}


def hybrid_profile(zoo, params, prompt) -> dict:
    """torch.profiler over one served prefill (``impl="kernel"``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def run():
        lg, _, _ = zoo.prefill(params, {"tokens": prompt}, HYBRID_MAX_LEN,
                               impl="kernel")
        int(lg[0, -1].argmax())

    run()                                          # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return {"phase": "hybrid_lm", "profile": f"prefill(impl='kernel') at S = "
            f"{prompt.shape[1]}", **device_time(prof, wall, "hybrid profile",
                                                 kernel="flash_fwd")}


def phase_hybrid_lm(dev):
    import gc

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import layers as L
    from repro_torch.models import rglru
    from repro_torch.models.params import leaves
    from repro_torch.models.zoo import get_model
    gc.collect()                                   # the earlier weights
    torch.cuda.empty_cache()
    cfg = get_config(HYBRID_ARCH)
    zoo = timed_zoo(get_model(cfg))
    t0 = time.perf_counter()
    params = card_params(zoo.spec(), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = zoo.n_params()
    require(n_params == HYBRID_N_PARAMS, f"{HYBRID_ARCH}: {n_params} "
            "parameters")
    weight_bytes = sum(t.numel() * t.element_size() for t in leaves(params))
    n_rec_pg, n_groups, n_tail = rglru._counts(cfg)
    n_rec = n_groups * n_rec_pg + n_tail

    # -- the main path: counts at 0 just before, read just after.  Serving,
    # then the kernel route of every block over each request's tokens, then
    # the decode kernel over every attention block's served ring.
    torch.cuda.reset_peak_memory_stats()
    _reset_all_launches()
    reqs, eng, wall = _serve(zoo, params, max_len=HYBRID_MAX_LEN,
                             reqs=_hybrid_requests(cfg))
    served_launches = _lm_launches()
    serve_peak = torch.cuda.max_memory_allocated()
    require(eng.impl == "kernel", f"DecodeEngine's default is {eng.impl}")
    short = [r for r in reqs if len(r.prompt) <= cfg.window]
    require(served_launches["flash_attention"] == n_groups * len(short),
            f"served flash_attention launches {served_launches}, want "
            f"{n_groups} x {len(short)}")
    require(served_launches["rg_lru"] == 0, "the served route ran the "
            "rg_lru kernel (the reference's prefill never passes impl)")
    require(served_launches["decode_attention"] == n_groups * eng.steps,
            f"served decode_attention launches {served_launches}, want "
            f"{n_groups} x {eng.steps} steps")
    long_req = reqs[-1]
    require(long_req.done and len(long_req.tokens) == LM_MAX_NEW,
            f"the {HYBRID_LONG}-token request was not served")
    worst = {"rec": 0.0, "attn": 0.0}
    torch.cuda.reset_peak_memory_stats()
    for r in reqs:
        wr = _hybrid_layer_check(params, cfg, r, dev)
        worst = {k: max(worst[k], wr[k]) for k in worst}
    gate_peak = torch.cuda.max_memory_allocated()
    w = eng.cache["attn_k"].shape[3]
    lengths = torch.clamp(eng.position, 1, w)
    rng = np.random.default_rng(SEED + 7)
    qs = [torch.from_numpy(rng.standard_normal(
        (LM_SLOTS, cfg.n_heads, 1, cfg.hd)).astype("float32")).to(
        dev, torch.bfloat16) for _ in range(n_groups)]
    dec_out = [ops.decode_mha(qs[g], eng.cache["attn_k"][g],
                              eng.cache["attn_v"][g], lengths, impl="kernel")
               for g in range(n_groups)]
    torch.cuda.synchronize()
    launches = _lm_launches()
    want = {"rg_lru": n_rec * len(reqs),
            "flash_attention": 2 * n_groups * len(short),
            "decode_attention": n_groups * (eng.steps + 1)}
    for k, v in want.items():
        require(launches[k] == v, f"{k} launched {launches[k]} times on "
                f"the path, want {v}")
    state = zoo.init_cache(1, HYBRID_MAX_LEN)
    tokens = sum(len(r.tokens) for r in reqs)
    emit({"phase": "hybrid_lm", "arch": HYBRID_ARCH, "n_params": n_params,
          "weight_bytes": weight_bytes, "init_s": init_s,
          "requests": len(reqs), "max_len": HYBRID_MAX_LEN, "ring": w,
          "prompt_lens": [len(r.prompt) for r in reqs], "tokens": tokens,
          "wall_s": wall, "tokens_per_s": tokens / wall, **eng.stats(),
          "prefill_ms": zoo.prefill_ms, "decode_ms_per_step": zoo.decode_ms,
          "max_memory_allocated": serve_peak,
          "gate_max_memory_allocated": gate_peak,
          "state_bytes_per_slot": {k: v.numel() * v.element_size()
                                   for k, v in state.items()},
          "served_launches": served_launches, "launches": launches})
    del state

    # -- checks (launches from here on are comparisons, not the path)
    emit({"phase": "hybrid_lm", "check": "kernel route vs served, per block "
          "on the same input", "blocks": cfg.n_layers * len(reqs),
          "bf16_steps": HYBRID_BF16_STEPS, "worst_diff_over_tol": worst})
    emit({"phase": "hybrid_lm", "check": "the long request's decode wrapped "
          "the ring", **_ring_wrap(zoo, params, eng, long_req)})
    errs = []
    for g in range(n_groups):
        ref_out = ops.decode_mha(qs[g], eng.cache["attn_k"][g],
                                 eng.cache["attn_v"][g], lengths, impl="ref")
        errs.append(float((dec_out[g].float() - ref_out.float()).abs()
                          .max()))
        require(errs[-1] <= ATTN_TOL["bfloat16"] * 2,
                f"decode_mha kernel vs ref on block {g}'s ring: {errs[-1]}")
    emit({"phase": "hybrid_lm", "check": "decode_mha kernel vs ref over "
          "each served ring", "lengths": lengths.tolist(),
          "max_abs_err": max(errs)})
    # End to end, measured: 38 bf16 blocks of random weights carry a
    # rounding difference far (the plain forward, whose attention differs
    # from the served one only in rounding, is the control).
    e2e = {"kernel": [], "plain": []}
    agree = {"kernel": 0, "plain": 0}
    max_logit = 0.0
    for r in reqs:
        ls = _served_logits(zoo, params, r, HYBRID_MAX_LEN, impl="kernel")
        seq = torch.as_tensor(np.concatenate([r.prompt, r.tokens])
                              .astype(np.int32), device=dev)[None]
        p = len(r.prompt)
        for name, impl in (("kernel", "kernel"), ("plain", "chunked")):
            x = rglru.trunk(params, seq, cfg, impl=impl)
            lf = L.logits(params["embed"], x[:, p - 1: p - 1 + len(r.tokens)],
                          cfg)[0, :, :cfg.vocab].float()
            del x
            require(bool(torch.isfinite(lf).all()) and lf.shape == ls.shape,
                    f"rid {r.rid}: {name} forward logits")
            max_logit = max(max_logit, float(lf.abs().max()))
            e2e[name].append([float((ls[0] - lf[0]).abs().max()),
                              float((ls[1:] - lf[1:]).abs().max())])
            agree[name] += sum(int(t == int(lf[s].argmax()))
                               for s, t in enumerate(r.tokens))
    emit({"phase": "hybrid_lm", "end_to_end": "served logits vs forward "
          "logits [prefill row, decode rows] per request",
          "max_abs_logit": max_logit, "kernel_forward": e2e["kernel"],
          "plain_forward": e2e["plain"], "greedy_tokens_equal": agree,
          "tokens": tokens})

    emit(hybrid_profile(zoo, params, torch.as_tensor(
        reqs[0].prompt, device=dev)[None]))

    # -- the CLI entry point for this architecture, in process, on the card
    del params, eng, dec_out, qs
    gc.collect()
    t0 = time.perf_counter()
    res = launch_serve.main(["--arch", HYBRID_ARCH])
    emit({"phase": "hybrid_lm", "entry": "repro_torch.launch.serve.main",
          "arch": HYBRID_ARCH, "preset": "reduced",
          "seconds": time.perf_counter() - t0, **res})
    return launches


# ---------------------------------------------------------------------------
# phase 11: the hash_probe kernel against its plain version, and the app
# ---------------------------------------------------------------------------

def _hash_table(gen, n_slots, load, dev):
    """An n_slots open-addressing table at ``load`` of distinct odd int32
    keys (negative ones too; misses are drawn even, so never stored), built
    on the card by rounds of linear probing: each unplaced key tries its next
    slot, one claimant per empty slot wins, the others move on.  Every slot
    from a key's home to its place ends up occupied, which is what a lookup
    needs.  Returns (keys, table_k, table_v), the tables duplicated to
    2 * n_slots as the reference pads them."""
    import torch
    from repro_torch.kernels.hash_probe import _mix
    n_keys = max(1, int(n_slots * load))
    keys = torch.empty(0, dtype=torch.int64, device=dev)
    while keys.numel() < n_keys:
        more = torch.randint(-(1 << 31), 1 << 31, (2 * n_keys,), generator=gen,
                             device=dev, dtype=torch.int64) | 1
        keys = torch.unique(torch.cat([keys, more]))
    keys = keys[torch.randperm(keys.numel(), generator=gen, device=dev)
                [:n_keys]].to(torch.int32)
    tk = torch.zeros(n_slots, dtype=torch.int32, device=dev)
    tv = torch.zeros_like(tk)
    vals = torch.randint(1, 1 << 30, (n_keys,), generator=gen, device=dev,
                         dtype=torch.int32)
    slot = _mix(keys) % n_slots
    todo = torch.arange(n_keys, device=dev)
    while todo.numel():
        s = slot[todo]
        free = tk[s] == 0
        claim = torch.full((n_slots,), n_keys, device=dev, dtype=torch.long)
        claim.scatter_reduce_(0, s[free], todo[free], "amin")
        won = free & (claim[s] == todo)
        tk[s[won]], tv[s[won]] = keys[todo[won]], vals[todo[won]]
        todo = todo[~won]
        slot[todo] = (slot[todo] + 1) % n_slots
    return keys, torch.cat([tk, tk]), torch.cat([tv, tv])


def _hash_queries(gen, keys, n, dev):
    import torch
    hits = keys[torch.randint(0, keys.numel(), (n - n // 2,), generator=gen,
                              device=dev)]
    misses = torch.randint(-(1 << 30), 1 << 30, (n // 2,), generator=gen,
                           device=dev, dtype=torch.int64) * 2
    misses[misses == 0] = 2
    return torch.cat([hits, misses.to(torch.int32)])


def _probe_counts(keys, tk, n_slots, max_probes):
    """Slots each key reads: up to its first hit or EMPTY slot, at most
    ``max_probes``, never past the table's end (the kernel's walk)."""
    import torch
    from repro_torch.kernels.hash_probe import _mix
    h = _mix(keys) % n_slots
    count = torch.zeros_like(h)
    done = torch.zeros(keys.shape, dtype=torch.bool, device=keys.device)
    for p in range(max_probes):
        idx = h + p
        inside = idx < tk.numel()
        ck = tk[idx.clamp(max=tk.numel() - 1)]
        count += (inside & ~done).long()
        done |= ~inside | (ck == keys) | (ck == 0)
    return h, count


def _hash_bound(keys, tk, n_slots, found) -> tuple[float, dict]:
    """Bytes this data needs, each read once: 4 per key in, 8 per key out,
    and the 32-byte sectors (8 slots) of table_k that the chains touch and
    of table_v that hold a hit, their union at every table size.  Beside
    it, ``random_sector_ms``: each key's own sectors instead (its chain's of
    table_k, one of table_v per hit), the first kernel's access pattern on
    a table that does not stay in L2.  Returns (bound ms, the counts)."""
    import torch
    h, count = _probe_counts(keys, tk, n_slots, HASH_MAX_PROBES)
    n = keys.numel()
    seen_k = torch.zeros(tk.numel() // 8 + 1, dtype=torch.bool,
                         device=keys.device)
    for p in range(HASH_MAX_PROBES):
        live = count > p
        seen_k[(h[live] + p) // 8] = True
    hit = found.bool()
    seen_v = torch.zeros_like(seen_k)
    seen_v[(h[hit] + count[hit] - 1) // 8] = True
    k_sectors, v_sectors = int(seen_k.sum()), int(seen_v.sum())
    last = h + count.clamp(min=1) - 1
    own = int(((last // 8) - (h // 8) + 1)[count > 0].sum()) + int(hit.sum())
    nbytes = 12 * n + 32 * (k_sectors + v_sectors)
    return bytes_ms(nbytes), {
        "probes_per_key": float(count.float().mean()),
        "table_k_sectors": k_sectors, "table_v_sectors": v_sectors,
        "bytes": nbytes, "random_sectors": own,
        "random_sector_ms": bytes_ms(12 * n + 32 * own)}


def _hash_case(hp, q, tk, tv, n_slots, what, max_probes=HASH_MAX_PROBES):
    import torch
    got = hp.hash_probe(q, tk, tv, n_slots, max_probes)
    want = hp.hash_probe_plain(q, tk, tv, n_slots, max_probes)
    require(all(torch.equal(g, w) for g, w in zip(got, want)),
            f"hash_probe differs from plain at {what}")
    return want


def _hash_timing_shapes(gen, app, dev):
    """The timed shapes, one after another, as (label, keys, table_k,
    table_v, n_slots): the hash_table app at 16x (the path), then 2^24 keys
    at load 0.5 in 2^24 slots (``large``) and in 2^22 slots (``mid``, whose
    used part fits the L2)."""
    import numpy as np
    import torch
    yield ("path", *[torch.from_numpy(app.dram_init[k].astype(np.int32))
                     .to(dev) for k in ("queries", "table_k", "table_v")],
           app.statics["n_slots"])
    for label, n_slots in (("large", HASH_LARGE), ("mid", HASH_MID)):
        keys, tk, tv = _hash_table(gen, n_slots, 0.5, dev)
        yield (label, _hash_queries(gen, keys, HASH_LARGE, dev), tk, tv,
               n_slots)


def hash_kernels_per_call(dev) -> dict:
    """The kernels, memsets and copies one hash_probe call puts on the card
    at each timed shape (``launches_per_call``), which must be one kernel
    and nothing else.  Counted before the other phases, as
    ``scan_kernels_per_call``, on inputs of those shapes that are freed at
    once."""
    from repro_torch.kernels import graph_count as graphs
    from repro_torch.serve import traffic as tr
    import torch
    from repro_torch.apps import ALL_APPS
    from repro_torch.kernels import hash_probe as hp
    gen = torch.Generator(dev).manual_seed(SEED + 12)
    app = ALL_APPS["hash_table"](**tr.HASH_TABLE_16X)
    out = {}
    for label, q, tk, tv, n_slots in _hash_timing_shapes(gen, app, dev):
        def call():
            return hp.hash_probe(q, tk, tv, n_slots)
        per = graphs.launches_per_call(call)
        require(per == graphs.ONE_KERNEL,
                f"hash_probe at {label} puts {per} on the card, not one "
                "kernel")
        out[label] = per
    del q, tk, tv
    return out


def phase_hash_kernel(dev, per_call):
    from repro_torch.serve import traffic as tr
    import numpy as np
    import torch
    from repro_torch.apps import ALL_APPS
    from repro_torch.kernels import hash_probe as hp
    from repro_torch.kernels import ops
    # -- the path: the entry point over the hash_table app's own tables
    apps = {"bench": ALL_APPS["hash_table"](**tr.BENCH_SIZES["hash_table"]),
            "16x": ALL_APPS["hash_table"](**tr.HASH_TABLE_16X)}
    longest = {}
    for label, app in apps.items():                # chains within the limit
        n_slots = app.statics["n_slots"]
        tk = torch.from_numpy(app.dram_init["table_k"].astype(np.int32)).to(
            dev)
        home = hp._mix(tk[:n_slots]) % n_slots
        stored = tk[:n_slots] != 0
        at = torch.arange(n_slots, device=dev)
        longest[label] = int(((at - home) % n_slots)[stored].max()) + 1
        require(longest[label] <= HASH_MAX_PROBES, f"hash_table {label}: a "
                f"chain of {longest[label]} > {HASH_MAX_PROBES} probes")
    _reset_all_launches()
    results = {label: ops.hash_lookup(
        app.dram_init["queries"], app.dram_init["table_k"],
        app.dram_init["table_v"], app.statics["n_slots"]) for label, app in
        apps.items()}
    torch.cuda.synchronize()
    launches = _lm_launches()
    require(launches["hash_probe"] == len(apps),
            f"hash_lookup launched {launches['hash_probe']} kernels")
    for label, (vals, found) in results.items():
        want = apps[label].expected["results"]
        got = torch.where(found == 1, vals, 0).cpu().numpy()
        require((got == want).all(), f"hash_table {label}: the probe's "
                "values differ from the app's expected results")
    emit({"phase": "hash_kernel", "path": "ops.hash_lookup on the hash_table "
          "app's tables", "apps": {k: {"n_slots": a.statics["n_slots"],
                                       "queries": len(a.dram_init["queries"]),
                                       "found": int(results[k][1].sum()),
                                       "longest_chain": longest[k]}
                                   for k, a in apps.items()},
          "expected_equal": True, "launches": launches})
    # -- the sweep (comparison launches, not the path)
    gen = torch.Generator(dev).manual_seed(SEED + 8)
    cases, found_share = 0, []
    for n_slots in HASH_SLOTS:
        for load in HASH_LOADS:
            keys, tk, tv = _hash_table(gen, n_slots, load, dev)
            for n in HASH_NS:
                q = _hash_queries(gen, keys, n, dev)
                _, f = _hash_case(hp, q, tk, tv, n_slots,
                                  f"n_slots={n_slots} load={load} n={n}")
                found_share.append(float(f[: n - n // 2].float().mean()))
                cases += 1
            del tk, tv
    # an overfull case: a full table and more probes than it holds past h
    keys, tk, tv = _hash_table(gen, 64, 1.0, dev)
    q = _hash_queries(gen, keys, 1000, dev)
    for max_probes in (1, 64, 200):
        _hash_case(hp, q, tk, tv, 64, f"full table, {max_probes} probes",
                   max_probes)
        cases += 1
    torch.cuda.synchronize()
    emit({"phase": "hash_kernel", "check": "exact vs plain", "cases": cases,
          "hits_found_share": [min(found_share), max(found_share)]})
    # -- times: the app at 16x (the path), 2^24 keys in 2^24 and 2^22 slots
    rows = {}
    for label, q, tk, tv, n_slots in _hash_timing_shapes(gen, apps["16x"],
                                                         dev):
        iters = 300 if label == "path" else 20
        v, f = _hash_case(hp, q, tk, tv, n_slots, f"{label} timing shape")
        bound, counts = _hash_bound(q, tk, n_slots, f)
        load = float((tk[:n_slots] != 0).float().mean())
        rec = {"n": q.numel(), "n_slots": n_slots, "load": load,
               "hits": int(f.sum()), **counts,
               "knuth_probes": {"hit": (1 + 1 / (1 - load)) / 2,
                                "miss": (1 + 1 / (1 - load) ** 2) / 2},
               "max_abs_err": 0,
               "kernel_ms": time_ms(lambda: hp.hash_probe(q, tk, tv, n_slots),
                                    iters),
               "kernel_graph_ms": graph_ms(
                   lambda: hp.hash_probe(q, tk, tv, n_slots), iters),
               "kernels_per_call": per_call[label],
               "plain_ms": time_ms(
                   lambda: hp.hash_probe_plain(q, tk, tv, n_slots),
                   max(3, iters // 10)),
               "library_ms": None,
               "library_note": "none: no PyTorch call computes an "
                               "open-addressing probe",
               "bound_ms": bound, "bound_by": "bytes"}
        rows[label] = rec
        emit({"phase": "hash_kernel", "kernel": "hash_probe", "shape": label,
              **rec})
    del q, tk, tv
    return {"hash_probe": {**rows, "max_abs_err": 0}}, launches


# ---------------------------------------------------------------------------
# phase 12: the moe_dispatch kernel against its plain version
# ---------------------------------------------------------------------------

def _dispatch_inputs(gen, t, k, d, e, dtype, dev, drop=None, cap=None):
    """``t`` tokens each routed to ``k`` distinct experts (a random top-k),
    flattened to A = t * k assignment rows with their cumsum positions, as
    ``ops.moe_dispatch_combine`` makes them; the capacity is ``cap`` or the
    one that drops about ``drop`` of the rows.  Rows drawn on the card."""
    import torch
    from repro_torch.kernels import ops
    eidx = torch.rand((t, e), generator=gen, device=dev).argsort(1)[:, :k]
    flat_e = eidx.reshape(-1)
    pos = ops._positions_in_expert(flat_e, e)
    if cap is None:
        cap = max(1, int(torch.quantile(pos.float(), 1 - drop).item())
                  if drop else int(pos.max()) + 1)
    tokens = torch.randn((t * k, d), generator=gen, device=dev).to(dtype)
    return (tokens, flat_e.to(torch.int32), pos.to(torch.int32), e, cap)


def _bits(x):
    import torch
    return x.view(torch.int16 if x.dtype == torch.bfloat16 else torch.int32)


def _dispatch_case(md, ins, what) -> float:
    import torch
    got = md.moe_dispatch(*ins)
    want = md.moe_dispatch_plain(*ins)
    require(got.shape == want.shape and torch.equal(_bits(got), _bits(want)),
            f"moe_dispatch differs from plain at {what}")
    return float((ins[2] >= ins[4]).float().mean())


def phase_moe_kernel(dev):
    import torch
    from repro_torch.kernels import moe_dispatch as md
    gen = torch.Generator(dev).manual_seed(SEED + 9)
    cases, drops = 0, []
    for dtype in (torch.bfloat16, torch.float32):
        for a in (1, 7, 256, 4096):
            for d in (32, 100, 2048):
                for e in (8, 64):
                    for drop in (0.0, 0.2, 0.9):
                        ins = _dispatch_inputs(gen, a, 1, d, e, dtype, dev,
                                               drop=drop)
                        drops.append(_dispatch_case(
                            md, ins, f"A={a} D={d} E={e} drop~{drop} "
                            f"{dtype}"))
                        cases += 1
    torch.cuda.synchronize()
    emit({"phase": "moe_kernel", "check": "bit for bit vs plain",
          "cases": cases, "drop_share": [min(drops), max(drops)]})
    rows = {}
    for label, (t, k, d, e, c), iters in (("path", MOE_PATH, 200),
                                          ("large", MOE_LARGE, 10)):
        ins = _dispatch_inputs(gen, t, k, d, e, torch.bfloat16, dev, cap=c)
        drop = _dispatch_case(md, ins, f"{label} timing shape")
        tokens, flat_e, pos = ins[:3]
        keep = pos < c
        row_bytes = d * tokens.element_size()
        kept = int(keep.sum())
        nbytes = kept * row_bytes + e * c * row_bytes + 8 * tokens.shape[0]
        # yardstick: one index_put_ of the kept rows into a zeroed buffer
        # (the kept rows and their indices picked beforehand)
        buf = torch.empty((e, c, d), dtype=tokens.dtype, device=dev)
        ek, pk, rk = flat_e[keep].long(), pos[keep].long(), tokens[keep]

        def library():
            buf.zero_()
            buf.index_put_((ek, pk), rk)

        rec = {"a": tokens.shape[0], "d": d, "e": e, "c": c,
               "dtype": "bfloat16", "drop_share": drop, "kept_rows": kept,
               "max_abs_err": 0,
               "kernel_ms": time_ms(lambda: md.moe_dispatch(*ins), iters),
               "kernel_graph_ms": graph_ms(lambda: md.moe_dispatch(*ins),
                                           iters),
               "plain_ms": time_ms(lambda: md.moe_dispatch_plain(*ins),
                                   iters),
               "library_ms": time_ms(library, iters),
               "library": "zeros + index_put_ of the kept rows",
               "bound_ms": bytes_ms(nbytes), "bound_by": "bytes"}
        rows[label] = rec
        emit({"phase": "moe_kernel", "kernel": "moe_dispatch", "shape": label,
              **rec})
    return {"moe_dispatch": {**rows, "max_abs_err": 0}}


# ---------------------------------------------------------------------------
# phase 13: full-width olmoe-1b-7b served through DecodeEngine
# ---------------------------------------------------------------------------

def _moe_ff_both(lp, x, cfg):
    """The layer's MoE FF on ``x`` by the served route (``moe_ff``, scatter)
    and by the kernel route (``ops.moe_dispatch_combine(impl="kernel")`` on
    the layer's own router and experts); they must agree bit for bit.
    Returns (x + FF, the share of assignments past capacity)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import layers as L
    from repro_torch.models import moe
    xn = L.apply_norm(lp["ln2"], x, cfg)
    served, _ = moe.moe_ff(lp["moe"], xn, cfg)
    toks = xn.reshape(-1, cfg.d_model)
    _, gates, eidx = moe.route(lp["moe"], toks, cfg)
    cap = moe.capacity(cfg, toks.shape[0])
    got = ops.moe_dispatch_combine(toks, gates, eidx, cfg.n_experts, cap,
                                   moe.expert_fn(lp["moe"], xn.dtype),
                                   impl="kernel")
    require(torch.equal(got, served.reshape(-1, cfg.d_model)),
            "the MoE FF's kernel route differs from the served route")
    pos = ops._positions_in_expert(eidx.reshape(-1), cfg.n_experts)
    return x + served, float((pos >= cap).float().mean())


def _moe_walk(params, cfg, req, dev) -> dict:
    """One request teacher-forced, layer by layer, on the served route's
    stream: its prompt (attention through flash, held to the plain route
    within MOE_ATTN_BF16_STEPS; the MoE FF through both routes), then one
    decode step per generated token but the last.  Returns the worst
    attention diff over its tolerance and each layer's prefill drop share."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.models import layers as L
    from repro_torch.models.transformer import _positions, layer_params
    p_len = len(req.prompt)
    toks = torch.as_tensor(req.prompt, device=dev)[None]
    positions = _positions(1, p_len, dev)
    x = L.embed(params["embed"], toks)
    worst, drops, cache = 0.0, [], []
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        xn = L.apply_norm(lp["ln1"], x, cfg)
        h, (k, v) = L.attention(lp["attn"], xn, cfg, positions=positions,
                                impl="kernel")
        hp, _ = L.attention(lp["attn"], xn, cfg, positions=positions,
                            impl="naive")
        tol = _bf16_steps(MOE_ATTN_BF16_STEPS, float(hp.abs().max()))
        diff = float((h.float() - hp.float()).abs().max())
        require(diff <= tol, f"rid {req.rid} layer {i}: flash attention "
                f"differs from the plain route by {diff} (tol {tol})")
        worst = max(worst, diff / tol)
        x, drop = _moe_ff_both(lp, x + h, cfg)
        drops.append(drop)
        pad = LM_MAX_LEN - p_len
        cache.append([F.pad(k, (0, 0, 0, pad)), F.pad(v, (0, 0, 0, pad))])
    pos = torch.tensor([p_len], dtype=torch.int32, device=dev)
    for t in req.tokens[:-1]:
        x = L.embed(params["embed"], torch.tensor([[t]], dtype=torch.int32,
                                                  device=dev))
        for i in range(cfg.n_layers):
            lp = layer_params(params, i)
            h, cache[i][0], cache[i][1] = L.decode_attention_step(
                lp["attn"], L.apply_norm(lp["ln1"], x, cfg), cfg,
                cache[i][0], cache[i][1], pos)
            x, _ = _moe_ff_both(lp, x + h, cfg)
        pos = pos + 1
    return {"attn_worst_over_tol": worst, "drops": np.array(drops)}


def _moe_kernel_prefill(params, cfg, prompt):
    """A prefill's trunk on the kernel routes (flash; the MoE FF through the
    dispatch kernel), logits of the last position."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import layers as L
    from repro_torch.models import moe
    from repro_torch.models.transformer import _positions, layer_params
    positions = _positions(1, prompt.shape[1], prompt.device)
    x = L.embed(params["embed"], prompt)
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        h, _ = L.attention(lp["attn"], L.apply_norm(lp["ln1"], x, cfg), cfg,
                           positions=positions, impl="kernel")
        x = x + h
        toks = L.apply_norm(lp["ln2"], x, cfg).reshape(-1, cfg.d_model)
        _, gates, eidx = moe.route(lp["moe"], toks, cfg)
        x = x + ops.moe_dispatch_combine(
            toks, gates, eidx, cfg.n_experts,
            moe.capacity(cfg, toks.shape[0]),
            moe.expert_fn(lp["moe"], toks.dtype)).reshape(x.shape)
    x = L.apply_norm(params["ln_f"], x[:, -1:], cfg)
    return L.logits(params["embed"], x, cfg)


def moe_profile(params, cfg, prompt) -> dict:
    """torch.profiler over one prefill on the kernel routes."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def run():
        int(_moe_kernel_prefill(params, cfg, prompt)[0, -1].argmax())

    run()                                          # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return {"phase": "moe_lm", "profile": "prefill on the kernel routes at "
            f"S = {prompt.shape[1]}", **device_time(prof, wall, "moe profile",
                                                     kernel="moe_dispatch")}


def phase_moe_lm(dev):
    import gc

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import moe
    from repro_torch.models.params import leaves
    from repro_torch.models.zoo import get_model
    gc.collect()                                   # the earlier weights
    torch.cuda.empty_cache()
    cfg = get_config(MOE_ARCH)
    zoo = timed_zoo(get_model(cfg))
    t0 = time.perf_counter()
    params = card_params(zoo.spec(), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = zoo.n_params()
    require(n_params == MOE_N_PARAMS, f"{MOE_ARCH}: {n_params} parameters")
    weight_bytes = sum(t.numel() * t.element_size() for t in leaves(params))

    # -- the main path: counts at 0 just before, read just after.  Serving,
    # then every request walked layer by layer through the kernel routes,
    # then the decode kernel over every layer's served cache.
    torch.cuda.reset_peak_memory_stats()
    _reset_all_launches()
    reqs, eng, wall = _serve(zoo, params)
    served_launches = _lm_launches()
    serve_peak = torch.cuda.max_memory_allocated()
    require(eng.impl == "kernel", f"DecodeEngine's default is {eng.impl}")
    served_want = {"flash_attention": cfg.n_layers * LM_REQUESTS,
                   "decode_attention": cfg.n_layers * eng.steps,
                   "moe_dispatch": 0}
    for k, v in served_want.items():
        require(served_launches[k] == v, f"served {k} launches "
                f"{served_launches[k]}, want {v}")
    walks = [_moe_walk(params, cfg, r, dev) for r in reqs]
    lengths = torch.clamp(eng.position, 1, LM_MAX_LEN)
    rng = np.random.default_rng(SEED + 10)
    qs = [torch.from_numpy(rng.standard_normal(
        (LM_SLOTS, cfg.n_heads, 1, cfg.hd)).astype("float32")).to(
        dev, torch.bfloat16) for _ in range(cfg.n_layers)]
    dec_out = [ops.decode_mha(qs[i], eng.cache["k"][i], eng.cache["v"][i],
                              lengths, impl="kernel")
               for i in range(cfg.n_layers)]
    torch.cuda.synchronize()
    launches = _lm_launches()
    decode_walked = sum(len(r.tokens) - 1 for r in reqs)
    want = {"moe_dispatch": cfg.n_layers * (LM_REQUESTS + decode_walked),
            "flash_attention": 2 * cfg.n_layers * LM_REQUESTS,
            "decode_attention": cfg.n_layers * (eng.steps + decode_walked
                                                + 1)}
    for k, v in want.items():
        require(launches[k] == v, f"{k} launched {launches[k]} times on "
                f"the path, want {v}")
    drops = np.stack([w["drops"] for w in walks])          # [request, layer]
    tokens = sum(len(r.tokens) for r in reqs)
    emit({"phase": "moe_lm", "arch": MOE_ARCH, "n_params": n_params,
          "weight_bytes": weight_bytes, "init_s": init_s,
          "requests": LM_REQUESTS,
          "prompt_lens": [len(r.prompt) for r in reqs], "tokens": tokens,
          "wall_s": wall, "tokens_per_s": tokens / wall, **eng.stats(),
          "prefill_ms": zoo.prefill_ms, "decode_ms_per_step": zoo.decode_ms,
          "max_memory_allocated": serve_peak,
          "capacity": {"prefill_512": moe.capacity(cfg, 512),
                       "decode": moe.capacity(cfg, LM_SLOTS)},
          "drop_share_per_layer": {
              "prompt_512": drops[0].tolist(),
              "mean_over_prompts": drops.mean(0).tolist(),
              "max_over_prompts": drops.max(0).tolist()},
          "decode_steps_walked": decode_walked,
          "served_launches": served_launches, "launches": launches,
          "reckoned": want})

    # -- checks (launches from here on are comparisons, not the path)
    emit({"phase": "moe_lm", "check": "kernel routes vs served, per layer on "
          "the same input", "layers": cfg.n_layers * LM_REQUESTS,
          "moe_ff_layer_calls": want["moe_dispatch"],
          "moe_ff_bit_for_bit": True, "attn_bf16_steps": MOE_ATTN_BF16_STEPS,
          "attn_worst_diff_over_tol": max(w["attn_worst_over_tol"]
                                          for w in walks)})
    errs = []
    for i in range(cfg.n_layers):
        ref_out = ops.decode_mha(qs[i], eng.cache["k"][i], eng.cache["v"][i],
                                 lengths, impl="ref")
        errs.append(float((dec_out[i].float() - ref_out.float()).abs()
                          .max()))
        require(errs[-1] <= ATTN_TOL["bfloat16"] * 2,
                f"decode_mha kernel vs ref on layer {i}'s cache: {errs[-1]}")
    emit({"phase": "moe_lm", "check": "decode_mha kernel vs ref over each "
          "served cache (head dim 128)", "lengths": lengths.tolist(),
          "max_abs_err": max(errs)})
    # End to end, measured: each request's prompt and tokens re-served at
    # batch 1 (the engine decoded at batch 4, whose products may round
    # otherwise): finite logits, and how many greedy tokens agree
    # (for each token that differs, the re-served logit margin of its
    # argmax over the engine's token)
    agree, margins = 0, []
    for r in reqs:
        ls = _served_logits(zoo, params, r)
        require(bool(torch.isfinite(ls).all()) and ls.shape == (
            len(r.tokens), cfg.vocab), f"rid {r.rid}: served logits")
        for step, t in enumerate(r.tokens):
            if t == int(ls[step].argmax()):
                agree += 1
            else:
                margins.append(float(ls[step].max() - ls[step, t]))
    emit({"phase": "moe_lm", "end_to_end": "engine tokens vs each request "
          "re-served at batch 1", "greedy_tokens_equal": agree,
          "tokens": tokens, "flip_margins": margins,
          "max_abs_logit": float(ls.abs().max())})

    emit(moe_profile(params, cfg, torch.as_tensor(
        reqs[0].prompt, device=dev)[None]))

    # -- the CLI entry point for this architecture, in process, on the card
    del params, eng, dec_out, qs
    gc.collect()
    t0 = time.perf_counter()
    res = launch_serve.main(["--arch", MOE_ARCH])
    emit({"phase": "moe_lm", "entry": "repro_torch.launch.serve.main",
          "arch": MOE_ARCH, "preset": "reduced",
          "seconds": time.perf_counter() - t0, **res})
    return launches


# ---------------------------------------------------------------------------
# phases 14-15: full-width seamless-m4t-medium and internvl2-1b, prefill on
# the flash kernel, then greedy decode
# ---------------------------------------------------------------------------

ENCDEC_ARCH = "seamless-m4t-medium"
ENCDEC_N_PARAMS = 877453312        # 12 + 12 layers, d 1024, 16/16 heads of 64
ENCDEC_FRAMES, ENCDEC_PROMPT = 1024, 64
VLM_ARCH = "internvl2-1b"
VLM_N_PARAMS = 631630720           # 24 layers, d 896, 14/2 heads of 64
VLM_PROMPT = 512                   # text tokens after the 256 patches
FAMILY_BATCH, FAMILY_DECODE_STEPS = 2, 16
# each attention of the kernel route against the plain route on the same
# input: bf16 rounding in another order
FAMILY_BF16_STEPS = 8


def _family_inputs(cfg, dev) -> dict:
    """A batch of FAMILY_BATCH drawn on the card: the stubbed frontend's
    float32 frames (encdec) or bf16 patch embeddings (vlm), standard
    normal, and the prompt's tokens."""
    import torch
    from repro_torch.models.encdec import FRAME_DIM
    gen = torch.Generator(dev).manual_seed(SEED + 20)
    b = FAMILY_BATCH
    if cfg.family == "encdec":
        batch = {"frames": torch.randn((b, ENCDEC_FRAMES, FRAME_DIM),
                                       generator=gen, device=dev)}
        prompt = ENCDEC_PROMPT
    else:
        batch = {"patch_embeds": torch.randn(
            (b, cfg.n_patches, cfg.vit_width), generator=gen,
            device=dev).to(torch.bfloat16)}
        prompt = VLM_PROMPT
    batch["tokens"] = torch.randint(1, cfg.vocab, (b, prompt), generator=gen,
                                    device=dev, dtype=torch.int32)
    return batch


def _attn_gate(what: str, h, hp, worst: float) -> float:
    """Flash's attention output ``h`` within FAMILY_BF16_STEPS bf16 steps of
    the plain route's ``hp`` (at its largest magnitude); returns the worst
    diff over its tolerance so far."""
    tol = _bf16_steps(FAMILY_BF16_STEPS, float(hp.abs().max()))
    diff = float((h.float() - hp.float()).abs().max())
    require(diff <= tol, f"{what}: flash differs from the plain route by "
            f"{diff} (tol {tol})")
    return max(worst, diff / tol)


def _both_routes(p, x, cfg, **kw):
    """One attention on ``x`` through flash and through the plain route."""
    from repro_torch.models import layers as L
    h, _ = L.attention(p, x, cfg, impl="kernel", **kw)
    hp, _ = L.attention(p, x, cfg, impl="naive", **kw)
    return h, hp


def _encdec_walk(params, cfg, batch) -> dict:
    """The prefill walked layer by layer on the kernel route's stream, each
    attention held to the plain route on the same input: the encoder's
    (non-causal over the frames), the decoder's causal self-attention and
    its cross-attention (non-causal, the prompt over the frames)."""
    from repro_torch.models import layers as L
    from repro_torch.models.transformer import _positions, layer_params
    frames, tokens = batch["frames"], batch["tokens"]
    b, s_enc, _ = frames.shape
    pos = _positions(b, s_enc, frames.device)
    x = frames.to(params["frontend"].dtype) @ params["frontend"]
    worst = {"encoder": 0.0, "self": 0.0, "cross": 0.0}
    for i in range(cfg.enc_layers):
        lp = layer_params(params, i, "enc")
        h, hp = _both_routes(lp["attn"], L.apply_norm(lp["ln1"], x, cfg),
                             cfg, positions=pos, causal=False)
        worst["encoder"] = _attn_gate(f"encoder layer {i}", h, hp,
                                      worst["encoder"])
        x = x + h
        x = x + L.mlp(lp["mlp"], L.apply_norm(lp["ln2"], x, cfg), cfg)
    enc_out = L.apply_norm(params["ln_enc"], x, cfg)
    pos = _positions(b, tokens.shape[1], tokens.device)
    x = L.embed(params["embed"], tokens)
    for i in range(cfg.dec_layers):
        lp = layer_params(params, i, "dec")
        h, hp = _both_routes(lp["self"], L.apply_norm(lp["ln1"], x, cfg),
                             cfg, positions=pos, causal=True)
        worst["self"] = _attn_gate(f"decoder layer {i} self", h, hp,
                                   worst["self"])
        x = x + h
        kv = L.project_kv(lp["cross"], enc_out, cfg)
        h, hp = _both_routes(lp["cross"], L.apply_norm(lp["ln_x"], x, cfg),
                             cfg, positions=None, causal=False,
                             kv_override=kv)
        worst["cross"] = _attn_gate(f"decoder layer {i} cross", h, hp,
                                    worst["cross"])
        x = x + h
        x = x + L.mlp(lp["mlp"], L.apply_norm(lp["ln2"], x, cfg), cfg)
    return worst


def _vlm_walk(params, cfg, batch) -> dict:
    """The prefill over [patches ; text] walked layer by layer on the kernel
    route's stream, each attention held to the plain route."""
    from repro_torch.models import layers as L
    from repro_torch.models import vlm
    from repro_torch.models.transformer import _positions, layer_params
    x = vlm._prefix(params, batch["patch_embeds"], batch["tokens"])
    pos = _positions(x.shape[0], x.shape[1], x.device)
    worst = 0.0
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        h, hp = _both_routes(lp["attn"], L.apply_norm(lp["ln1"], x, cfg),
                             cfg, positions=pos)
        worst = _attn_gate(f"layer {i}", h, hp, worst)
        x = x + h
        x = x + L.mlp(lp["mlp"], L.apply_norm(lp["ln2"], x, cfg), cfg)
    return {"layers": worst}


def phase_family_lm(dev, arch: str, n_params_want: int, walk):
    """``arch`` at full width and depth, random bf16 weights drawn on the
    card: the main path is one prefill of the batch on the kernel route
    (``impl="kernel"``: every attention a flash launch) and
    FAMILY_DECODE_STEPS greedy decode steps, counts at 0 just before and
    read just after; then a warm prefill's time, each layer's attentions
    held to the plain route (``walk``), the decode kernel over each
    decoder layer's served cache held to the reference
    (``decode_mha(impl="ref")``) on random bf16 queries, and the plain
    route's prefill logits beside the kernel route's, reported."""
    import gc

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.zoo import get_model
    gc.collect()                                   # the earlier weights
    torch.cuda.empty_cache()
    cfg = get_config(arch)
    phase = f"{cfg.family}_lm"
    zoo = get_model(cfg)
    t0 = time.perf_counter()
    params = card_params(zoo.spec(), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    require(zoo.n_params() == n_params_want, f"{arch}: {zoo.n_params()} "
            "parameters")
    batch = _family_inputs(cfg, dev)
    prompt = batch["tokens"].shape[1]
    max_len = prompt + FAMILY_DECODE_STEPS

    # -- the main path: counts at 0 just before, read just after
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_all_launches()
    t0 = time.perf_counter()
    lg, cache, pos = zoo.prefill(params, batch, max_len, impl="kernel")
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    first = pos.clone()
    tok = lg[:, -1].argmax(-1).to(torch.int32)[:, None]
    tokens, decode_ms = [tok], []
    for _ in range(FAMILY_DECODE_STEPS):
        t0 = time.perf_counter()
        lg, cache, pos = zoo.decode_step(params, tok, cache, pos)
        tok = lg[:, -1].argmax(-1).to(torch.int32)[:, None]
        torch.cuda.synchronize()
        decode_ms.append((time.perf_counter() - t0) * 1e3)
        tokens.append(tok)
    launches = _lm_launches()
    peak = torch.cuda.max_memory_allocated()
    want = {"flash_attention": (cfg.enc_layers + 2 * cfg.dec_layers
                                if cfg.family == "encdec" else cfg.n_layers),
            "decode_attention": FAMILY_DECODE_STEPS * (
                cfg.dec_layers if cfg.family == "encdec" else cfg.n_layers)}
    for k, v in want.items():
        require(launches[k] == v, f"{arch}: {k} launched {launches[k]} "
                f"times on the path, want {v}")
    require(lg.shape == (FAMILY_BATCH, 1, cfg.vocab_padded)
            and bool(torch.isfinite(lg[..., :cfg.vocab]).all()),
            f"{arch}: decode logits {tuple(lg.shape)} not finite")
    ctx = prompt + (cfg.n_patches if cfg.family == "vlm" else 0)
    require(first.tolist() == [ctx] * FAMILY_BATCH and pos.tolist() ==
            [ctx + FAMILY_DECODE_STEPS] * FAMILY_BATCH,
            f"{arch}: positions {first.tolist()} -> {pos.tolist()}")
    shapes = {k: tuple(v.shape) for k, v in cache.items()}

    # -- measurements and checks (launches from here on are not the path)
    t0 = time.perf_counter()
    lg_k, _, _ = zoo.prefill(params, batch, max_len, impl="kernel")
    torch.cuda.synchronize()
    prefill_warm_ms = (time.perf_counter() - t0) * 1e3
    worst = walk(params, cfg, batch)
    n_dec = cfg.dec_layers if cfg.family == "encdec" else cfg.n_layers
    lengths = torch.clamp(pos, 1, cache["k"].shape[3])
    rng = np.random.default_rng(SEED + 20)
    before = _lm_launches()["decode_attention"]
    dec_errs = []
    for i in range(n_dec):
        q = torch.from_numpy(rng.standard_normal(
            (FAMILY_BATCH, cfg.n_heads, 1, cfg.hd)).astype("float32")).to(
            dev, torch.bfloat16)
        got = ops.decode_mha(q, cache["k"][i], cache["v"][i], lengths,
                             impl="kernel")
        ref = ops.decode_mha(q, cache["k"][i], cache["v"][i], lengths,
                             impl="ref")
        dec_errs.append(float((got.float() - ref.float()).abs().max()))
        require(dec_errs[-1] <= ATTN_TOL["bfloat16"] * 2,
                f"{arch}: decode_mha kernel vs ref on decoder layer {i}'s "
                f"cache: {dec_errs[-1]}")
    require(_lm_launches()["decode_attention"] - before == n_dec,
            f"{arch}: decode_mha(impl='kernel') did not launch once per "
            "decoder layer")
    lg_p, _, _ = zoo.prefill(params, batch, max_len, impl="naive")
    v = cfg.vocab
    emit({"phase": phase, "arch": arch, "n_params": zoo.n_params(),
          "init_s": init_s, "batch": FAMILY_BATCH,
          "inputs": {k: list(t.shape) for k, t in batch.items()},
          "prompt": prompt, "context": ctx, "cache": shapes,
          "prefill_ms": prefill_ms, "prefill_warm_ms": prefill_warm_ms,
          "decode_ms_per_step": decode_ms,
          "decode_ms_median": sorted(decode_ms)[len(decode_ms) // 2],
          "max_memory_allocated": peak, "launches": launches,
          "reckoned": want,
          "tokens": torch.cat(tokens, 1).tolist(),
          "attn_bf16_steps": FAMILY_BF16_STEPS,
          "attn_worst_diff_over_tol": worst,
          "decode_kernel_vs_ref": {"lengths": lengths.tolist(),
                                   "head_dim": cfg.hd,
                                   "max_abs_err": max(dec_errs)},
          "prefill_logits_kernel_vs_plain": float(
              (lg_k[..., :v] - lg_p[..., :v]).abs().max()),
          "prefill_max_abs_logit": float(lg_p[..., :v].abs().max()),
          "prefill_argmax_equal": bool(torch.equal(
              lg_k[..., :v].argmax(-1), lg_p[..., :v].argmax(-1)))})
    del params, cache, q, got, ref
    return launches


# ---------------------------------------------------------------------------
# build: registers, spills and tensor-core instructions of the attention
# kernels
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# training: the optimizer, compression, the data pipeline and the driver
# ---------------------------------------------------------------------------

TRAIN_ARCH = "qwen2-0.5b"
TRAIN_N_PARAMS = 494147456         # N of the model-FLOP share 6·N·B·S
TRAIN_BATCH, TRAIN_SEQ = 8, 1024
TRAIN_FULL = ("--steps", "20", "--batch", str(TRAIN_BATCH), "--seq",
              str(TRAIN_SEQ), "--grad-compression", "int8", "--ckpt-every",
              "21")
TRAIN_LEARN_STEPS = 10             # AdamW steps on one fixed batch
TRAIN_RESTART = ("--steps", "10", "--batch", "2", "--seq", "256",
                 "--ckpt-every", "4")
TRAIN_FAULT_AT = 6
# one step's loss and every gradient leaf, card against the port's CPU
# step, reduced models in float32 (TF32 off): sums in another order
TRAIN_CARD_CPU_TOL = 1e-4
# every other family at full width, 2 layers (recurrentgemma-9b: one group
# of 3 blocks plus its 2 tail blocks), one step on (B, S)
TRAIN_FAMILIES = {"falcon-mamba-7b": 2, "recurrentgemma-9b": 5,
                  "olmoe-1b-7b": 2, "seamless-m4t-medium": 2,
                  "internvl2-1b": 2}
TRAIN_FAMILY_SHAPE = (2, 512)


class _TrainProbe:
    """Inside ``with``: ``launch.train``'s steps timed (a synchronise on
    each side of every step), each ``ckpt.save`` timed with the bytes it
    wrote, and ``train.get_config`` cut to ``n_layers`` when given.  Puts
    everything back on exit."""

    def __init__(self, n_layers=None):
        self.n_layers = n_layers
        self.step_s, self.saves = [], []

    def __enter__(self):
        import dataclasses

        import torch
        from repro_torch.checkpoint import ckpt
        from repro_torch.launch import train
        self._orig = (train.build_step, ckpt.save, train.get_config)
        build, save, get_config = self._orig

        def build_step(*a, **kw):
            step = build(*a, **kw)

            def timed(state, batch):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = step(state, batch)
                torch.cuda.synchronize()
                self.step_s.append(time.perf_counter() - t)
                return out
            return timed

        def timed_save(ckpt_dir, step, tree, keep=3):
            t = time.perf_counter()
            path = save(ckpt_dir, step, tree, keep)
            self.saves.append({"step": step,
                               "s": time.perf_counter() - t,
                               "bytes": sum(f.stat().st_size for f in
                                            Path(path).iterdir())})
            return path

        train.build_step, ckpt.save = build_step, timed_save
        if self.n_layers:
            train.get_config = lambda arch: dataclasses.replace(
                get_config(arch), n_layers=self.n_layers)
        return self

    def __exit__(self, *exc):
        from repro_torch.checkpoint import ckpt
        from repro_torch.launch import train
        train.build_step, ckpt.save, train.get_config = self._orig
        return False


def _train_main(argv, ckpt_dir, dev, n_layers=None):
    """``launch.train.main(argv)`` on ``dev`` in a fresh ``ckpt_dir``;
    returns (its dict, the probe, the launches of the 8 kernels in it)."""
    import shutil

    from repro_torch.launch import train
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    _reset_all_launches()
    with _TrainProbe(n_layers) as probe:
        out = train.main(list(argv) + ["--ckpt-dir", str(ckpt_dir),
                                       "--log-every", "5"], device=dev)
    launches = _lm_launches()
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    return out, probe, launches


def _family_batch(cfg, b, s, dev, step=0):
    """The train driver's batch of ``step``: the pipeline's tokens, and the
    stubbed frontend's frames or patch embeddings from default_rng(step)."""
    import numpy as np
    import torch
    from repro_torch.data.pipeline import DataConfig, Pipeline
    batch = Pipeline(DataConfig(vocab=cfg.vocab, seq_len=s,
                                global_batch=b)).batch(step, dev)
    rng = np.random.default_rng(step)
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.n_patches, cfg.vit_width))).to(torch.bfloat16).to(dev)
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (b, min(s, 4096), 80))).to(torch.float32).to(dev)
    return batch


def _finite_tree(tree) -> bool:
    import torch
    from repro_torch.models.params import leaves
    return all(bool(torch.isfinite(g.float()).all()) for g in leaves(tree))


def train_profile(zoo, state, batch, ocfg) -> dict:
    """One step of ``state`` on ``batch`` split on the host clock (each part
    ending in a synchronise): the loss and grads, int8 compression, AdamW;
    then torch.profiler over one whole step (with compression): device
    busy share and the largest device items."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import train
    from repro_torch.optim import adamw, compression
    err = compression.init_error_state(state["params"])
    parts = {}

    def part(name, fn, *args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        parts[name] = (time.perf_counter() - t) * 1e3
        return out

    _, grads = part("loss_and_grads_ms", train.loss_and_grads, zoo,
                    state["params"], batch)
    grads, err = part("int8_roundtrip_ms", compression.roundtrip_tree,
                      grads, err)
    part("adamw_ms", adamw.apply, state["params"], grads, state["opt"], ocfg)
    del grads
    step = train.build_step(zoo, ocfg, "chunked", "int8")
    full = dict(state, err=err)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(full, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return {**parts, "profile": "one step with int8 compression",
            **device_time(prof, wall, "train profile")}


def phase_train(dev):
    """(a) ``launch.train.main`` at the full width of qwen2-0.5b, 20 steps
    of 8 x 1024 tokens with int8 gradient compression, one checkpoint at
    the end: every loss finite; first and warm step ms, tokens/s, the
    model-FLOP share, peak bytes, the save's seconds and bytes.  (b) 10
    AdamW steps on one fixed batch at full width lower the loss; then one
    more step split into its parts and profiled.  (c) 2 layers at full
    width, a fault at step 6 restarted from step 4's
    checkpoint: the replayed steps' losses against an uninterrupted run.
    (d) reduced qwen2-0.5b and falcon-mamba-7b in float32: one step's loss
    and gradients on the card against the port's CPU step.  (e) one step
    of every other family at full width, 2 layers: finite loss and grads.
    (f) flash attention on inputs that require grad raises.  None of it
    launches a hand-written kernel (the training route is the plain
    chunked one): every count must stay 0."""
    import dataclasses
    import gc
    import statistics

    import torch
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import train
    from repro_torch.models.params import leaves, tree_map
    from repro_torch.models.zoo import get_model
    from repro_torch.optim import adamw

    rec = {}
    ck = ROOT / "build" / "train_ckpt"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]

    # (a) the driver at full width
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    out, probe, launches = _train_main(("--arch", TRAIN_ARCH, "--preset",
                                        "full") + TRAIN_FULL, ck / "a", dev)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    require(out["stopped"] == 20 and len(out["losses"]) == 20,
            f"train (a): {out['stopped']} steps")
    require(all(math.isfinite(x) for x in out["losses"]),
            f"train (a): a loss is not finite: {out['losses']}")
    require(not any(launches.values()), f"train (a): kernels {launches}")
    require(len(probe.saves) == 1, f"train (a): saves {probe.saves}")
    b, s = TRAIN_BATCH, TRAIN_SEQ
    warm_s = statistics.median(probe.step_s[1:])
    rec["a"] = {
        "arch": TRAIN_ARCH, "n_params": TRAIN_N_PARAMS, "batch": b, "seq": s,
        "steps": out["stopped"], "losses": out["losses"],
        "first_step_ms": probe.step_s[0] * 1e3,
        "warm_step_ms": warm_s * 1e3,
        "step_ms": [x * 1e3 for x in probe.step_s],
        "tokens_per_s": b * s / warm_s,
        "driver_tok_s": out["tok_s"], "wall_s": wall,
        "model_flop_share": 6 * TRAIN_N_PARAMS * b * s / warm_s
        / PEAK_FLOPS["bfloat16"],
        "peak_bytes": peak, "save_s": probe.saves[0]["s"],
        "save_bytes": probe.saves[0]["bytes"],
        "save_bytes_per_param": probe.saves[0]["bytes"] / TRAIN_N_PARAMS,
        "kernel_launches": launches, "card": smi}
    emit({"phase": "train", "part": "a_driver_full_width", **rec["a"]})

    # (b) learning on one fixed batch, full width
    gc.collect()
    torch.cuda.empty_cache()
    zoo = get_model(get_config(TRAIN_ARCH))
    params = card_params(zoo.spec(), dev)
    batch = _family_batch(zoo.cfg, TRAIN_BATCH, TRAIN_SEQ, dev)
    ocfg = adamw.OptConfig(lr=1e-3, warmup_steps=2,
                           total_steps=TRAIN_LEARN_STEPS)
    state = {"params": params, "opt": adamw.init_state(params)}
    step = train.build_step(zoo, ocfg, "chunked", None)
    losses = []
    for _ in range(TRAIN_LEARN_STEPS):
        state, met = step(state, batch)
        losses.append(float(met["loss"]))
    require(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
            f"train (b): no learning: {losses}")
    rec["b"] = {"losses": losses, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
                "lr": ocfg.lr}
    emit({"phase": "train", "part": "b_learns_fixed_batch", **rec["b"]})
    del params, step
    rec["profile"] = train_profile(zoo, state, batch, ocfg)
    emit({"phase": "train", "part": "a_b_step_profile", **rec["profile"]})
    del state

    # (c) fault and restart against an uninterrupted run, 2 layers
    gc.collect()
    torch.cuda.empty_cache()
    argv = ("--arch", TRAIN_ARCH, "--preset", "full") + TRAIN_RESTART
    faulted, fprobe, fl = _train_main(
        argv + ("--simulate-fault", str(TRAIN_FAULT_AT)), ck / "c1", dev,
        n_layers=2)
    clean, cprobe, cl = _train_main(argv, ck / "c2", dev, n_layers=2)
    require(faulted["restarts"] == 1 and faulted["stopped"] == 10,
            f"train (c): restarts {faulted['restarts']}, stopped "
            f"{faulted['stopped']}")
    require(not any(fl.values()) and not any(cl.values()),
            f"train (c): kernels {fl} {cl}")
    replay, want = faulted["losses"][TRAIN_FAULT_AT:], clean["losses"][4:]
    require(len(replay) == len(want) == 6 and
            faulted["losses"][:TRAIN_FAULT_AT] == clean["losses"][
                :TRAIN_FAULT_AT], f"train (c): {faulted['losses']} vs "
            f"{clean['losses']}")
    diff = max(abs(x - y) for x, y in zip(replay, want))
    require(diff <= 1e-3 * max(abs(x) for x in want),
            f"train (c): replayed losses {replay} vs {want}")
    rec["c"] = {"restarts": faulted["restarts"],
                "stopped": faulted["stopped"],
                "replayed_losses": replay, "uninterrupted_losses": want,
                "bit_for_bit": replay == want, "max_abs_diff": diff,
                "saves_faulted": fprobe.saves, "saves_clean": cprobe.saves}
    emit({"phase": "train", "part": "c_fault_restart", **rec["c"]})

    # (d) the card against the CPU, reduced, float32
    rec["d"] = {"tol": TRAIN_CARD_CPU_TOL}
    for arch in ("qwen2-0.5b", "falcon-mamba-7b"):
        rz = get_model(dataclasses.replace(get_reduced(arch),
                                           param_dtype="float32"))
        p_cpu = rz.init_params(0, device="cpu")
        b_cpu = rz.make_batch(ShapeConfig("t", 64, 2, "train"), seed=1,
                              device="cpu")
        l_cpu, g_cpu = train.loss_and_grads(rz, p_cpu, b_cpu)
        l_dev, g_dev = train.loss_and_grads(
            rz, tree_map(lambda t: t.to(dev), p_cpu),
            {k: v.to(dev) for k, v in b_cpu.items()})
        worst = 0.0
        for gc_, gd in zip(leaves(g_cpu), leaves(g_dev)):
            err = float((gd.cpu() - gc_).abs().max())
            worst = max(worst, err / max(1.0, float(gc_.abs().max())))
        ldiff = abs(float(l_dev) - float(l_cpu))
        require(ldiff <= TRAIN_CARD_CPU_TOL and worst <= TRAIN_CARD_CPU_TOL,
                f"train (d) {arch}: loss diff {ldiff}, grad {worst}")
        rec["d"][arch] = {"loss_cpu": float(l_cpu), "loss_card": float(l_dev),
                          "loss_diff": ldiff, "grad_err_over_scale": worst,
                          "leaves": len(leaves(g_cpu))}
    emit({"phase": "train", "part": "d_card_vs_cpu", **rec["d"]})

    # (e) every other family, full width, 2 layers, one step
    rec["e"] = {}
    fb, fs = TRAIN_FAMILY_SHAPE
    for arch, n_layers in TRAIN_FAMILIES.items():
        gc.collect()
        torch.cuda.empty_cache()
        cfg = dataclasses.replace(get_config(arch), n_layers=n_layers)
        if cfg.family == "encdec":
            cfg = dataclasses.replace(cfg, enc_layers=2, dec_layers=2)
        zoo = get_model(cfg)
        params = card_params(zoo.spec(), dev)
        batch = _family_batch(cfg, fb, fs, dev)
        _reset_all_launches()
        torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss, grads = train.loss_and_grads(zoo, params, batch)
        finite = math.isfinite(float(loss)) and _finite_tree(grads)
        grad_ms = (time.perf_counter() - t) * 1e3
        del grads
        state = {"params": params, "opt": adamw.init_state(params)}
        del params
        step = train.build_step(zoo, adamw.OptConfig(lr=1e-3), "chunked",
                                None)
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, met = step(state, batch)
        step_loss = float(met["loss"])
        step_ms = (time.perf_counter() - t) * 1e3
        finite = finite and math.isfinite(step_loss) and _finite_tree(
            state["params"])
        launches = _lm_launches()
        require(finite, f"train (e) {arch}: loss {float(loss)} or a "
                "gradient is not finite")
        require(not any(launches.values()),
                f"train (e) {arch}: kernels {launches}")
        rec["e"][arch] = {"n_layers": n_layers, "n_params": zoo.n_params(),
                          "batch": fb, "seq": fs, "loss": float(loss),
                          "first_grad_ms": grad_ms, "step_ms": step_ms,
                          "peak_bytes": torch.cuda.max_memory_allocated(dev)}
        emit({"phase": "train", "part": "e_family", "arch": arch,
              **rec["e"][arch]})
        del state, step

    # (f) the kernel refuses to be differentiated
    from repro_torch.kernels.flash_attention import flash_attention
    q, k, v = (torch.randn(4, 128, 64, device=dev, requires_grad=True)
               for _ in range(3))
    before = flash_attention.launches
    try:
        flash_attention(q, k, v)
        refused = False
    except RuntimeError as e:
        refused = "no backward" in str(e)
    require(refused and flash_attention.launches == before,
            "train (f): flash_attention ran on inputs that require grad")
    with torch.no_grad():
        flash_attention(q, k, v)
    require(flash_attention.launches == before + 1,
            "train (f): flash_attention did not launch under no_grad")
    rec["f"] = {"flash_attention_refused_under_grad": refused}
    emit({"phase": "train", "part": "f_refusal", **rec["f"]})
    gc.collect()
    torch.cuda.empty_cache()
    return rec


DIST_ARCH = "qwen2-0.5b"
DIST_PROMPT = (4, 512)             # (a): batch, prompt tokens
DIST_MAX_LEN = 1024
DIST_DECODE_STEPS = 4
# (b): the caching allocator rounds each block up, by at most 2 MiB (a
# large block is a multiple of 2 MiB, a small one of 512 bytes)
DIST_ALLOC_SLACK = 2 << 20
DIST_TIMEOUT_S = 300               # (c): the dry-run subprocesses' limit
# (d): the cells whose dry-run memory the card's allocator checks (arch,
# kind, batch, sequence), each on a 1x1 mesh at full width
DIST_MEMORY_CELLS = (("qwen2-0.5b", "train", 8, 1024),
                     ("qwen2-0.5b", "prefill", 4, 8192),
                     ("qwen2-0.5b", "decode", 8, 32768),
                     ("falcon-mamba-7b", "decode", 8, 32768),
                     ("olmoe-1b-7b", "prefill", 2, 2048))
# (d): the caching allocator rounds each block up to a multiple of 512 bytes
ALLOC_ROUNDING = 512


def _dryrun_cells() -> list[tuple[str, str]]:
    """Phase (c)'s cells: every architecture's decode_32k (and long_500k
    where it has one), qwen2-0.5b's train_4k (the attention's batch
    reshard) and prefill_32k (the head split before the view), and
    olmoe-1b-7b's train_4k (the MoE hints)."""
    from repro_torch.configs import ARCHS, cells_for, get_config
    cells = [(a, s) for a in ARCHS for s in cells_for(get_config(a))
             if s in ("decode_32k", "long_500k")]
    return cells + [(DIST_ARCH, "train_4k"), (DIST_ARCH, "prefill_32k"),
                    ("olmoe-1b-7b", "train_4k")]


def _start_dryruns(outdir: Path) -> list:
    """One ``python -m repro_torch.launch.dryrun --mesh both`` a cell, all
    started at once (each initialises its own fake process group, apart
    from this process).  Each sees no card: its fake group stands for the
    production mesh's cards and touches none."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    return [(cell, subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         cell[0], "--shape", cell[1], "--mesh", "both", "--outdir",
         str(outdir)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)) for cell in _dryrun_cells()]


def _finish_dryruns(procs, outdir: Path, total_memory: int) -> dict:
    """Waits for every dry-run (killing all at the time limit); each must
    exit 0 with a record per mesh (each cell's step ran on DTensors, its
    collectives counted as many times as ``CommDebugMode`` counts them, or
    the cell failed), and each train cell must reduce its gradients (a
    nonzero all-reduce or reduce-scatter).  Returns the records by
    cell."""
    deadline = time.perf_counter() + DIST_TIMEOUT_S
    logs, failed = {}, []
    try:
        for cell, proc in procs:
            try:
                logs[cell] = proc.communicate(
                    timeout=max(deadline - time.perf_counter(), 1))[0]
            except subprocess.TimeoutExpired:
                failed.append(f"{cell}: past {DIST_TIMEOUT_S} s")
                continue
            if proc.returncode:
                failed.append(f"{cell}: exit {proc.returncode}: "
                              f"{logs[cell][-2000:]}")
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    require(not failed, f"dry-run cells failed: {failed}")
    out = {}
    for arch, shape in _dryrun_cells():
        for mesh in ("single", "multi"):
            path = outdir / mesh / f"{arch}__{shape}.json"
            require(path.exists(), f"no dry-run record {path}")
            r = json.loads(path.read_text())
            arg = r["memory_analysis"]["argument_size_in_bytes"]
            coll = r["collective_bytes"]
            if shape == "train_4k":
                require(coll.get("all-reduce", 0)
                        + coll.get("reduce-scatter", 0) > 0,
                        f"{mesh}/{arch}/{shape} reduced no gradient: {coll}")
            mem = r["memory_analysis"]
            need = (arg + mem["temp_size_in_bytes"]
                    + mem["output_size_in_bytes"])
            rec = {"chips": r["chips"], "argument_bytes": arg,
                   "temp_bytes": mem["temp_size_in_bytes"],
                   "output_bytes": mem["output_size_in_bytes"],
                   "argument_share_of_card": arg / total_memory,
                   "argument_temp_output_share_of_card":
                       need / total_memory,
                   "traced_flops": r["traced_flops"],
                   "model_flops": r["model_flops"],
                   "compute_s": r["roofline"]["compute_s"],
                   "hlo_flops": r["hlo_flops"],
                   "hlo_bytes": r["hlo_bytes"],
                   "memory_s": r["roofline"]["memory_s"],
                   "collective_bytes": coll,
                   "collective_ops": r["collective_ops"],
                   "collective_s": r["roofline"]["collective_s"],
                   "trace_s": r["trace_s"]}
            out[f"{mesh}/{arch}/{shape}"] = rec
            emit({"phase": "distribution", "dryrun": f"{mesh}/{arch}/"
                  f"{shape}", **rec, "total_memory": total_memory})
    return out


def _cell_arguments(zoo, shape, args, dev):
    """A cell's arguments on the card, in the structure of its meta
    ``args``: the parameters drawn by ``card_params``, zero optimiser
    moments (``adamw.init_state``), the batch of ``zoo.make_batch``; for a
    decode step random tokens, a zero cache and every row at the cache's
    last position."""
    import torch
    from repro_torch.optim import adamw
    params = card_params(zoo.spec(), dev)
    if shape.kind == "train":
        return (params, adamw.init_state(params),
                zoo.make_batch(shape, SEED, dev))
    if shape.kind == "prefill":
        return params, zoo.make_batch(shape, SEED, dev)
    gen = torch.Generator(dev).manual_seed(SEED + 29)
    _, token, cache, position = args
    zeros = lambda t: torch.zeros(t.shape, dtype=t.dtype, device=dev)
    return (params,
            torch.randint(1, zoo.cfg.vocab, tuple(token.shape),
                          generator=gen, device=dev, dtype=token.dtype),
            {k: zeros(t) for k, t in cache.items()},
            torch.full(tuple(position.shape), shape.seq_len - 1,
                       dtype=position.dtype, device=dev))


def _memory_cell(arch, kind, b, s, dev, mesh) -> dict:
    """(d) for one cell: the dry-run on meta gives A (argument and unused
    argument bytes), T (temporaries) and O (outputs) on the 1x1 mesh; the
    same ``cell_program`` step then runs on the card, once to warm up (a
    workspace it leaves allocated is named), then after
    ``reset_peak_memory_stats()``: its peak above what was allocated
    before its arguments must lie in [A + T - slack, A + T + O + slack],
    slack ``ALLOC_ROUNDING`` an allocation (the step's and the
    arguments') plus the workspace; the outputs finite.  Beside it, the
    dry-run's peak with the outputs counted (``live_peak_bytes``), which
    the card's peak above A should equal up to the slack."""
    import gc

    import torch
    from torch.utils._pytree import tree_leaves
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.models.zoo import get_model

    shape = ShapeConfig(f"{kind}_{b}x{s}", s, b, kind)
    tr = dryrun.trace_cell(arch, shape, mesh)
    a = tr["argument_size_in_bytes"] + tr["unused_argument_bytes"]
    t, o = tr["temp_size_in_bytes"], tr["output_size_in_bytes"]
    fn, args, _, out_shard = dryrun.cell_program(arch, shape, mesh)
    zoo = get_model(get_config(arch))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    requested_held = torch.cuda.memory_stats()["requested_bytes.all.current"]
    real = _cell_arguments(zoo, shape, args, dev)
    torch.cuda.synchronize()
    arg_bytes = torch.cuda.memory_allocated() - held
    n_args = len(tree_leaves(real))

    def step():
        with torch.no_grad():
            return dryrun.call_sharded(fn, real, out_shard, mesh)

    out = step()
    torch.cuda.synchronize()
    del out
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    # what the warm-up left allocated: a library's workspace (cuBLAS keeps
    # one for each thread that runs a product, autograd's backward thread
    # among them) made by this step first
    workspace = torch.cuda.memory_allocated() - held - arg_bytes
    torch.cuda.reset_peak_memory_stats()
    out = step()
    torch.cuda.synchronize()
    peak_allocated = torch.cuda.max_memory_allocated()
    stats = torch.cuda.memory_stats()
    finite = all(bool(torch.isfinite(x).all()) for x in tree_leaves(out)
                 if x.is_floating_point())
    del out, real
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    peak = peak_allocated - held
    slack = ALLOC_ROUNDING * (tr["allocations"] + n_args) + workspace
    rec = {"cell": f"{arch}/{shape.name}", "argument_bytes": a,
           "temp_bytes": t, "output_bytes": o,
           "max_memory_allocated": peak_allocated, "held_before": held,
           "peak_above_held": peak,
           "requested_peak_above_held": stats["requested_bytes.all.peak"]
           - requested_held,
           "allocated_argument_bytes": arg_bytes,
           "workspace_bytes": workspace, "allocations": tr["allocations"],
           "argument_leaves": n_args, "slack": slack,
           "low": a + t - slack, "high": a + t + o + slack,
           "peak_minus_a_t": peak - a - t,
           "live_peak_bytes": tr["live_peak_bytes"],
           "peak_minus_a_live_peak": peak - a - tr["live_peak_bytes"],
           "finite": finite,
           "trace_s": tr["trace_s"]}
    emit({"phase": "distribution", "d": rec})
    require(finite, f"(d) {rec['cell']}: outputs not finite")
    require(rec["low"] <= peak <= rec["high"],
            f"(d) {rec['cell']}: peak {peak} outside [A + T - slack, A + T "
            f"+ O + slack] = [{rec['low']}, {rec['high']}]: {rec}")
    return rec


def phase_distribution(dev):
    """(a) Full-width qwen2-0.5b (random weights drawn on the card) on
    ``make_host_mesh(1, 1)`` under ``set_act_mesh``: one prefill of 4 x 512
    tokens on the kernel route (flash counted from 0: one launch a layer;
    one call of the attention under the mesh is one kernel, the nodes of
    one captured call), then 4 greedy decode steps; the logits and the
    cache bit-identical to the same calls with no mesh active.  (b)
    qwen2-0.5b's decode_32k arguments allocated on the card (parameters,
    128 x 32768 bf16 K/V cache, token, position): the
    ``memory_allocated()`` delta equals the dry-run's argument bytes on the
    1x1 mesh, less at most ``DIST_ALLOC_SLACK`` a leaf of allocator
    rounding above.  (c) ``python -m repro_torch.launch.dryrun --mesh both``
    over ``_dryrun_cells()`` in subprocesses, started first and run beside
    (a) and (b): every cell must pass; each cell's per-device bytes beside
    the card's ``total_memory``, its ``traced_flops``, its collective bytes
    by kind and ``collective_s``, and seconds.  (d) After (b):
    ``_memory_cell`` for each of ``DIST_MEMORY_CELLS``."""
    import shutil

    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as sh
    from repro_torch.kernels import graph_count as graphs
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.models.params import leaves
    from repro_torch.models.zoo import get_model

    outdir = ROOT / "build" / "dryrun_torch"
    shutil.rmtree(outdir, ignore_errors=True)
    procs = _start_dryruns(outdir)
    try:
        cfg = get_config(DIST_ARCH)
        zoo = get_model(cfg)
        params = card_params(zoo.spec(), dev)
        b, s = DIST_PROMPT
        gen = torch.Generator(dev).manual_seed(SEED + 23)
        batch = {"tokens": torch.randint(1, cfg.vocab, (b, s), generator=gen,
                                         device=dev, dtype=torch.int32)}
        mesh = make_host_mesh(1, 1)
        require(mesh.device.type == "cuda" and mesh.device_mesh is None,
                f"make_host_mesh(1, 1) gave {mesh}")

        def run(on_mesh: bool):
            sh.set_act_mesh(mesh if on_mesh else None)
            try:
                flash_attention.launches = 0
                lg, cache, pos = zoo.prefill(params, batch, DIST_MAX_LEN,
                                             impl="kernel")
                torch.cuda.synchronize()
                launched = flash_attention.launches
                logits = [lg]
                for _ in range(DIST_DECODE_STEPS):
                    tok = lg[:, -1].argmax(-1, keepdim=True).to(torch.int32)
                    lg, cache, pos = zoo.decode_step(params, tok, cache, pos)
                    logits.append(lg)
                torch.cuda.synchronize()
                return logits, cache, launched
            finally:
                sh.set_act_mesh(None)

        t0 = time.perf_counter()
        logits, cache, launched = run(True)
        mesh_s = time.perf_counter() - t0
        plain_logits, plain_cache, plain_launched = run(False)
        require(launched == plain_launched == cfg.n_layers,
                f"flash launched {launched} (mesh), {plain_launched} (no "
                f"mesh) times in the prefill, want {cfg.n_layers}")
        same = (all(torch.equal(x, y) for x, y in zip(logits, plain_logits))
                and all(torch.equal(cache[k], plain_cache[k])
                        for k in cache))
        require(same, "the 1x1 mesh changed the logits or the cache")
        lp = T.layer_params(params, 0)
        x = L.apply_norm(lp["ln1"], L.embed(params["embed"],
                                            batch["tokens"]), cfg)
        q, k, v = (t.contiguous() for t in L._project_qkv(
            lp["attn"], x, cfg, T._positions(b, s, dev)))
        sh.set_act_mesh(mesh)
        try:
            per_call = graphs.launches_per_call(
                lambda: ops.mha(q, k, v, causal=True, impl="kernel"))
        finally:
            sh.set_act_mesh(None)
        require(per_call == graphs.ONE_KERNEL,
                f"the attention under the mesh put {per_call} on the card")
        rec_a = {"flash_launches": launched, "bit_identical": same,
                  "kernels_per_attention": per_call,
                  "prefill_and_decode_s": mesh_s,
                  "logits_shape": list(logits[-1].shape)}
        emit({"phase": "distribution", "a": rec_a})
        del params, cache, plain_cache, logits, plain_logits, q, k, v, x
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

        # (b) the decode_32k arguments, for real
        rec = dryrun.analyze_cell(DIST_ARCH, "decode_32k", "host", mesh=mesh,
                                  save=False)
        want = rec["memory_analysis"]["argument_size_in_bytes"]
        require(rec["unused_argument_bytes"] == 0,
                f"decode_32k leaves unused arguments: {rec}")
        args = dryrun.cell_program(DIST_ARCH, "decode_32k", mesh)[1]
        abstract = [t for part in args
                    for t in (leaves(part) if isinstance(part, dict)
                              else [part])]
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        real = [torch.zeros(t.shape, dtype=t.dtype, device=dev)
                for t in abstract]
        torch.cuda.synchronize()
        delta = torch.cuda.memory_allocated() - before
        del real
        torch.cuda.empty_cache()
        slack = DIST_ALLOC_SLACK * len(abstract)
        require(0 <= delta - want <= slack,
                f"decode_32k arguments took {delta} bytes on the card, the "
                f"dry-run counts {want} (allowed rounding {slack})")
        rec_b = {"argument_bytes": want, "allocated_bytes": delta,
                  "leaves": len(abstract), "rounding_bytes": delta - want,
                  "allowed_rounding_bytes": slack}
        emit({"phase": "distribution", "b": rec_b})
        del args, abstract

        # (d) the dry-run's memory against the card's allocator
        rec_d = [_memory_cell(*cell, dev, mesh) for cell in DIST_MEMORY_CELLS]
    except BaseException:
        for _, proc in procs:
            proc.kill()
            proc.wait()
        raise
    total = torch.cuda.get_device_properties(0).total_memory
    cells = _finish_dryruns(procs, outdir, total)
    return {"flash_attention": launched, "a": rec_a, "b": rec_b,
            "c": cells, "d": rec_d}


def _demangle(names: list[str]) -> list[str]:
    """``kernel<args>`` for each mangled name (the names as they are when
    ``c++filt`` is missing)."""
    import re
    import shutil
    if not names or not shutil.which("c++filt"):
        return names
    out = subprocess.run(["c++filt"], input="\n".join(names),
                         capture_output=True, text=True).stdout.splitlines()
    short = []
    for name, full in zip(names, out):
        m = re.findall(r"::(\w+(?:<[^()]*>)?)\(", full)
        short.append(m[-1] if m else name)
    return short


def ptxas_by_function(log: str) -> list[dict]:
    """Registers, stack frame and spill bytes (an array indexed at run time
    lands in the stack frame without a spill) and static shared memory of
    every entry function that ``-Xptxas -v`` reported in ``log``."""
    import re
    rows, cur = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            cur = {"function": m.group(1)}
            rows.append(cur)
        elif cur is not None:
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", ln)
            if m:
                (cur["stack_frame"], cur["spill_stores"],
                 cur["spill_loads"]) = map(int, m.groups())
            m = re.search(r"Used (\d+) registers", ln)
            if m:
                cur["registers"] = int(m.group(1))
                smem = re.search(r"(\d+) bytes smem", ln)
                cur["static_smem"] = int(smem.group(1)) if smem else 0
    for row, short in zip(rows, _demangle([r["function"] for r in rows])):
        row["function"] = short
    return rows


def flash_sass_mma(build) -> dict:
    """Tensor-core instructions (HMMA) in each function of the built
    flash_attention library, from ``cuobjdump -sass``: the bfloat16
    instances must issue them, the float32 ones must not (they stay on the
    CUDA cores: tensor cores would mean TF32)."""
    import shutil
    tool = shutil.which("cuobjdump") or str(
        Path(build.nvcc()).parent / "cuobjdump")
    sass = subprocess.run([tool, "-sass",
                           str(build.library_path("flash_attention"))],
                          capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            fn = ln.split("Function :")[1].strip()
            counts[fn] = 0
        elif fn is not None and "HMMA" in ln:
            counts[fn] += 1
    counts = dict(zip(_demangle(list(counts)), counts.values()))
    mma = {f: n for f, n in counts.items() if "flash_fwd_mma" in f}
    f32 = {f: n for f, n in counts.items() if "flash_fwd_f32" in f}
    require(len(mma) == 5 and all(mma.values()),
            f"bf16 flash instances without HMMA: {mma}")
    require(len(f32) == 5 and not any(f32.values()),
            f"float32 flash instances with HMMA: {f32}")
    return counts


# ---------------------------------------------------------------------------

KERNEL_ROWS = {
    "stream_compact": {
        "source": "src/repro_torch/kernels/csrc/stream_compact.cu",
        "replaces": "src/repro/kernels/stream_compact.py:25"},
    "segment_reduce": {
        "source": "src/repro_torch/kernels/csrc/segment_reduce.cu",
        "replaces": "src/repro/kernels/segment_reduce.py:32"},
    "hash_probe": {
        "source": "src/repro_torch/kernels/csrc/hash_probe.cu",
        "replaces": "src/repro/kernels/hash_probe.py:34"},
    "moe_dispatch": {
        "source": "src/repro_torch/kernels/csrc/moe_dispatch.cu",
        "replaces": "src/repro/kernels/moe_dispatch.py:28"},
    "flash_attention": {
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:25",
        "design": "bf16: mma.sync m16n8k16, cp.async ring, 16 rows a "
                  "warp; f32: CUDA-core FMAs; GQA by index"},
    "decode_attention": {
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:22",
        "design": "split-KV (chunks of >= 256 keys) + a combine kernel, "
                  "all G heads of a kv row per block (bf16 2 <= G <= 16: "
                  "an m16 mma.sync tile; else scalar lane groups), "
                  "cp.async; GQA by index"},
    "ssm_scan": {
        "source": "src/repro_torch/kernels/csrc/ssm_scan.cu",
        "replaces": "src/repro/kernels/ssm_scan.py:23",
        "design": "8 lanes x K states a channel (K 2 at N 16), "
                  "partial sums over n buffered 8 steps and reduce-"
                  "scattered once, exp as one ex2, a 2-stage cp.async "
                  "ring (b and c transposed), y out in 16-byte stores"},
    "rg_lru": {
        "source": "src/repro_torch/kernels/csrc/rg_lru.cu",
        "replaces": "src/repro/kernels/rg_lru.py:20",
        "design": "one thread a channel, rounded multiply then add (bit "
                  "for bit the plain loop), one warp of 4-32 channels a "
                  "block, fed by a cp.async ring (6 stages of 64 steps, "
                  "10 of 32 at 32 channels); y out in whole tiles"},
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
    by_function = {
        name: ptxas_by_function(_build.build_log.get(name, ""))
        for name in ("flash_attention", "decode_attention", "stream_compact",
                     "segment_reduce", "ssm_scan", "rg_lru")}
    emit({"phase": "build", "ptxas_by_function": by_function,
          "flash_sass_mma": flash_sass_mma(_build)})
    for name in ("ssm_scan", "rg_lru"):      # their state and tiles in
        for row in by_function[name]:        # registers, every instance
            require(row.get("spill_stores") == 0 and
                    row.get("stack_frame") == 0,
                    f"{row['function']} spills or keeps a stack frame: "
                    f"{row}")

    # float32 products in full float32 (the tolerances assume it)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    seconds = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t
        return out

    per_call = scan_kernels_per_call(dev)
    hash_per_call = hash_kernels_per_call(dev)
    emit({"phase": "build", "kernels_per_call": {
        **per_call, "hash_probe": hash_per_call}})
    timings = timed("kernels", phase_kernels, dev)
    tb = counting_backend()
    launches, windowed_walls = timed("apps", phase_apps, tb)
    apps_launches = dict(launches)
    timed("serve", phase_serve, tb)
    resident = timed("resident", phase_resident, tb, windowed_walls)
    async_serve = timed("async_serve", phase_async_serve, tb)
    attn = timed("attention", phase_attention, dev)
    for name, rec in attn.pop("d128").items():
        attn[name]["d128"] = rec
    timings.update(attn)
    lm = timed("lm", phase_lm)
    timings.update(timed("ssm_kernel", phase_ssm_kernel, dev,
                         per_call["ssm_scan"]))
    ssm_lm = timed("ssm_lm", phase_ssm_lm, dev)
    rg = timed("rglru_kernel", phase_rglru_kernel, dev, per_call["rg_lru"])
    timings["rg_lru"] = rg["rg_lru"]
    for name, rec in rg["d256"].items():
        timings[name]["d256"] = rec
    for name, rec in rg["d256_gqa"].items():
        timings[name]["d256_gqa"] = rec
    hybrid = timed("hybrid_lm", phase_hybrid_lm, dev)
    hash_rows, hash_path = timed("hash_kernel", phase_hash_kernel, dev,
                                 hash_per_call)
    timings.update(hash_rows)
    timings.update(timed("moe_kernel", phase_moe_kernel, dev))
    moe_lm = timed("moe_lm", phase_moe_lm, dev)
    encdec_lm = timed("encdec_lm", phase_family_lm, dev, ENCDEC_ARCH,
                      ENCDEC_N_PARAMS, _encdec_walk)
    vlm_lm = timed("vlm_lm", phase_family_lm, dev, VLM_ARCH, VLM_N_PARAMS,
                   _vlm_walk)
    timed("train", phase_train, dev)
    distribution = timed("distribution", phase_distribution, dev)
    emit({"phase_seconds": seconds,
          "total_s": time.perf_counter() - t0})
    launches.update({k: lm[k] for k in ("flash_attention",
                                        "decode_attention")})
    launches["ssm_scan"] = ssm_lm["ssm_scan"]
    launches["rg_lru"] = hybrid["rg_lru"]
    launches["hash_probe"] = hash_path["hash_probe"]
    launches["moe_dispatch"] = moe_lm["moe_dispatch"]
    # each path's own run, counted from 0 (the line's ``launches`` is the
    # first path that runs the kernel)
    by_path = {"apps": apps_launches, "resident": resident,
               "async_windowed": async_serve["windowed"],
               "async_resident": async_serve["resident"], "lm": lm,
               "ssm_lm": ssm_lm, "hybrid_lm": hybrid,
               "hash_kernel": hash_path, "moe_lm": moe_lm,
               "encdec_lm": encdec_lm, "vlm_lm": vlm_lm,
               "distribution": distribution}
    for name, n in resident.items():        # the executor kernels' paths
        launches[name] += n

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
            "max_abs_err": timings[name].get("max_abs_err", max(
                timings[name][k]["max_abs_err"]
                for k in ("path", "large", "device_carry")
                if k in timings[name])),
            "ms": path["kernel_ms"], "plain_ms": path["plain_ms"],
            **({"graph_ms": path["kernel_graph_ms"]}
               if "kernel_graph_ms" in path else {}),
            "bound_ms": path["bound_ms"],
            "bound_by": path.get("bound_by", "bytes"),
            "library_ms": path["library_ms"],
            **({k: path[k] for k in ("library_graph_ms", "library_graph_note",
                                     "kernels_per_call") if k in path}),
            **({"library_note": path["library_note"]}
               if path["library_ms"] is None else {}),
            "shape": {k: path[k] for k in ("b", "n", "d", "di", "emitted",
                                           "bh", "bhkv", "sq", "skv", "s",
                                           "a", "e", "c", "n_slots", "load",
                                           "dtype", "causal", "n_split")
                      if k in path},
            "large": timings[name]["large"],
            **({"mid": timings[name]["mid"]} if "mid" in timings[name]
               else {}),
            **({"device_carry": timings[name]["device_carry"]}
               if "device_carry" in timings[name] else {}),
            **({"head_dim_128": timings[name]["d128"]}
               if "d128" in timings[name] else {}),
            **({"head_dim_256": timings[name]["d256"]}
               if "d256" in timings[name] else {}),
            **({"head_dim_256_gqa": timings[name]["d256_gqa"],
                "matched_heads": timings[name]["matched"]}
               if "d256_gqa" in timings[name] else {}),
            **({"launches_by_path": {p: c[name] for p, c in by_path.items()
                                     if c.get(name)}}
               if name in _lm_kernels() or name in resident else {})})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
