"""The port's hand-written CUDA kernels against their plain torch versions,
on the card: ``python -m pytest -q tests/test_torch_cuda.py``.

These tests import neither jax nor the JAX package, so they run on a
machine with only the port's dependencies.  Without a card they skip: the
kernels have no CPU mode.  The executor kernels' outputs are int32, so
equality is exact; the attention and scan kernels are held to stated
tolerances (the RG-LRU scan rounds as its plain loop does, so it is held
to exact equality).  The MoE dispatch copies rows and the hash probe
returns int32, so both are held to bit-for-bit equality.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import segment_reduce as tsr
from repro_torch.kernels import stream_compact as tsc

I32_MIN, I32_MAX = -(1 << 31), (1 << 31) - 1
REDUCE_OPS = tsr.OPS


def _window(rng, n, max_bar=3):
    kinds = rng.choice([0, 0, 0, 1, 2, max_bar], size=n).astype(np.int64)
    vals = rng.integers(I32_MIN, I32_MAX, size=n).astype(np.int64)
    return kinds, vals


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_stream_compact_matches_plain(cuda_device):
    rng = np.random.default_rng(11)
    for n in (0, 1, 127, 128, 129, 512, 1025, 70000):
        for d in (1, 3, 5):
            mask = torch.from_numpy(
                (rng.random(n) < 0.4).astype(np.int32)).to(cuda_device)
            vals = torch.from_numpy(rng.integers(
                I32_MIN, I32_MAX, (n, d)).astype(np.int32)).to(cuda_device)
            before = tsc.stream_compact.launches
            out, cnt = tsc.stream_compact(mask, vals)
            assert tsc.stream_compact.launches == before + 1
            want, wcnt = tsc.stream_compact_plain(mask, vals)
            assert int(cnt) == int(wcnt) and torch.equal(out, want)


@pytest.mark.cuda
@pytest.mark.parametrize("op", REDUCE_OPS)
def test_cuda_segment_reduce_matches_plain(cuda_device, op):
    rng = np.random.default_rng(12)
    for n in (0, 1, 127, 128, 129, 512, 5000):
        kinds, vals = _window(rng, n)
        k = torch.from_numpy(kinds.astype(np.int32)).to(cuda_device)
        v = torch.from_numpy(vals.astype(np.int32)).to(cuda_device)
        for go, acc in ((True, 5), (False, 0), (False, -9)):
            for vv in (v, None):
                before = tsr.segment_reduce.launches
                got = tsr.segment_reduce(k, vv, 0, op, acc, go)
                assert tsr.segment_reduce.launches == before + 1
                want = tsr.segment_reduce_plain(k, vv, 0, op, acc, go)
                m = int(want[2])
                assert int(got[2]) == m
                assert torch.equal(got[3], want[3])
                assert torch.equal(got[0][:m], want[0][:m])
                assert torch.equal(got[1][:m], want[1][:m])


# windows around the kernels' tile (TILE_ROWS tokens): one short, one tile,
# one past, three and a bit
TILE = tsr.TILE_ROWS
EDGE_NS = (TILE - 1, TILE, TILE + 1, 3 * TILE + 5)


def _edge_kinds(rng, n):
    """Barrier patterns that cross tile edges: random, barriers either side
    of each edge, one open segment over every tile, barriers only, Omega-2
    opening each tile after a closed group, and Omega-2 opening tile 1
    after a tile 0 that emits nothing (a closed carry with acc != init
    reaches it)."""
    random = rng.choice([0, 0, 0, 1, 2, 3], size=n).astype(np.int64)
    edges = np.zeros(n, np.int64)
    for e in range(TILE, n + 1, TILE):
        edges[e - 1] = rng.integers(1, 4)
        if e < n:
            edges[e] = rng.integers(1, 4)
    spanning = np.zeros(n, np.int64)
    spanning[-1] = 2
    omega2 = rng.choice([0, 0, 0, 1, 2], size=n).astype(np.int64)
    for e in range(TILE, n, TILE):
        omega2[e - 1], omega2[e] = 1, 2
    quiet = rng.choice([0, 0, 0, 1, 2, 3], size=n).astype(np.int64)
    quiet[:TILE] = rng.integers(2, 4, size=min(TILE, n))
    if n > TILE:
        quiet[TILE] = 2
    return (random, edges, spanning,
            rng.integers(1, 4, size=n).astype(np.int64), omega2, quiet)


def _same_segred(got, want):
    assert int(got[2]) == int(want[2])
    assert torch.equal(got[3], want[3])
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("n", EDGE_NS)
def test_cuda_scan_kernels_at_tile_edges(cuda_device, n):
    """Both kernels bit for bit their plain versions, zeros past the count
    included, on windows that cross the tile edges: every op, values and
    none, open / closed / degenerate carries; masks keeping nothing,
    everything, the edge rows, random rows."""
    rng = np.random.default_rng(n)
    vals = torch.from_numpy(rng.integers(I32_MIN, I32_MAX, n)
                            .astype(np.int32)).to(cuda_device)
    for kinds_np in _edge_kinds(rng, n):
        k = torch.from_numpy(kinds_np.astype(np.int32)).to(cuda_device)
        for op in REDUCE_OPS:
            for go, acc in ((True, 5), (False, 1), (False, -9)):
                for vv in (vals, None):
                    _same_segred(tsr.segment_reduce(k, vv, 1, op, acc, go),
                                 tsr.segment_reduce_plain(k, vv, 1, op, acc,
                                                          go))
    edge = np.zeros(n, np.int32)
    edge[[e for t in range(TILE, n + 1, TILE) for e in (t - 1, t)
          if e < n]] = 1
    for mask_np in (np.zeros(n, np.int32), np.ones(n, np.int32), edge,
                    (rng.random(n) < 0.5).astype(np.int32)):
        mask = torch.from_numpy(mask_np).to(cuda_device)
        for d in (1, 4, 40):
            rows = torch.from_numpy(rng.integers(I32_MIN, I32_MAX, (n, d))
                                    .astype(np.int32)).to(cuda_device)
            out, cnt = tsc.stream_compact(mask, rows)
            want, wcnt = tsc.stream_compact_plain(mask, rows)
            assert int(cnt) == int(wcnt) and torch.equal(out, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n", (128, 3 * TILE + 5))
def test_cuda_scan_kernels_replay_from_a_graph(cuda_device, n):
    """One call of each kernel captured in a CUDA graph, replayed on two
    different inputs copied into its static tensors: both replays equal the
    plain version, so no look-back state outlives a replay."""
    rng = np.random.default_rng(n + 1)

    def window():
        kinds = rng.choice([0, 0, 0, 1, 2, 3], size=n).astype(np.int32)
        return (torch.from_numpy(kinds).to(cuda_device),
                torch.from_numpy(rng.integers(I32_MIN, I32_MAX, n)
                                 .astype(np.int32)).to(cuda_device),
                torch.from_numpy(rng.integers(I32_MIN, I32_MAX, (n, 3))
                                 .astype(np.int32)).to(cuda_device))

    kinds, vals, rows = window()
    mask = (kinds == 0).int()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                # warm, off the capture
        tsr.segment_reduce(kinds, vals, 0, "xor", 3, True)
        tsc.stream_compact(mask, rows)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got_r = tsr.segment_reduce(kinds, vals, 0, "xor", 3, True)
        got_c = tsc.stream_compact(mask, rows)
    for _ in range(2):
        new_kinds, new_vals, new_rows = window()
        kinds.copy_(new_kinds)
        vals.copy_(new_vals)
        rows.copy_(new_rows)
        mask.copy_((new_kinds == 0).int())
        graph.replay()
        torch.cuda.synchronize()
        _same_segred(got_r, tsr.segment_reduce_plain(kinds, vals, 0, "xor",
                                                     3, True))
        want, wcnt = tsc.stream_compact_plain(mask, rows)
        assert int(got_c[1]) == int(wcnt) and torch.equal(got_c[0], want)


@pytest.mark.cuda
def test_cuda_scan_kernels_are_one_kernel_per_window(cuda_device):
    """At n <= TILE_ROWS each call is exactly one CUDA kernel and no memset;
    above it, one kernel and one memset; never a copy.  Counted as the
    nodes of one captured call (``graph_count.launches_per_call``), exact
    where a torch.profiler window loses the events of kernels launched
    from the repo's ctypes libraries."""
    from repro_torch.kernels.graph_count import launches_per_call
    rng = np.random.default_rng(7)
    for n, memsets in ((128, 0), (TILE, 0), (TILE + 1, 1)):
        kinds = torch.from_numpy(rng.choice([0, 0, 1, 2], size=n)
                                 .astype(np.int32)).to(cuda_device)
        rows = torch.from_numpy(rng.integers(0, 9, (n, 4))
                                .astype(np.int32)).to(cuda_device)
        mask = (kinds == 0).int()
        for call in (lambda: tsr.segment_reduce(kinds, kinds, 0, "add"),
                     lambda: tsc.stream_compact(mask, rows)):
            per = launches_per_call(call)
            assert per == {"kernels": 1, "memsets": memsets, "copies": 0}, \
                (n, per)


@pytest.mark.cuda
def test_cuda_torch_backend_runs_an_app_on_the_card(cuda_device):
    """One app end to end on ``TorchBackend()`` (CUDA by default) against
    the port's numpy oracle, through both kernels."""
    from repro_torch.apps import ALL_APPS
    from repro_torch.core.backend import TorchBackend
    app = ALL_APPS["strlen"]()
    lowered = app.fn.lower(**app.dram_init, **app.params, **app.statics)
    want = lowered.compile("numpy").execute(dict(app.dram_init), app.params)
    before = (tsc.stream_compact.launches, tsr.segment_reduce.launches)
    got = lowered.compile(TorchBackend()).execute(dict(app.dram_init),
                                                  app.params)
    assert got.report.backend == "torch[cuda]"
    assert tsc.stream_compact.launches > before[0]
    assert tsr.segment_reduce.launches > before[1]
    for arr in want.dram:
        np.testing.assert_array_equal(got.dram[arr], want.dram[arr])
    assert got.vm.stats == want.vm.stats


@pytest.mark.cuda
@pytest.mark.parametrize("op", REDUCE_OPS)
def test_cuda_segment_reduce_carry_matches_plain(cuda_device, op):
    """The device-carry entry (n, carry and rids on the device) against its
    plain version: every output word and the carry written back; n = 0
    leaves the carry as it was."""
    rng = np.random.default_rng(13)
    for w in (1, 2, 127, 128, 256, 4096):
        for t in range(8):
            n = int(rng.integers(0, w + 1)) if t else 0
            kinds, vals = _window(rng, w)
            rids = rng.integers(0, 5, w)
            carry0 = [int(rng.integers(I32_MIN, I32_MAX)), t % 2]
            outs = []
            for dev in ("cpu", cuda_device):
                i32 = lambda a: torch.tensor(np.asarray(a, np.int32),
                                             device=dev)
                carry = i32(carry0)
                got = tsr.segment_reduce_carry(
                    i32(kinds), i32(vals) if t % 3 else None, i32(rids),
                    i32(n).reshape(()), op, 4, carry)
                outs.append([x.cpu() for x in got] + [carry.cpu()])
            for g, want in zip(outs[1], outs[0]):
                assert torch.equal(g, want), (w, n, op)
            if n == 0:
                assert outs[1][-1].tolist() == carry0


@pytest.mark.cuda
def test_cuda_resident_run_matches_the_oracle(cuda_device):
    """One app through ``execution="resident"`` on the card: ticks replayed
    from a captured CUDA graph, one host read a replay, both kernels
    launched by the replays; DRAM, lane stats and ticks equal to the CPU
    port's resident run."""
    from repro_torch.apps import ALL_APPS
    from repro_torch.core.backend import TorchBackend
    app = ALL_APPS["hash_table"]()
    lowered = app.fn.lower(**app.dram_init, **app.params, **app.statics)
    want = lowered.compile(TorchBackend("cpu")).execute(
        dict(app.dram_init), app.params, execution="resident")
    before = (tsc.stream_compact.launches, tsr.segment_reduce.launches)
    got = lowered.compile(TorchBackend()).execute(
        dict(app.dram_init), app.params, execution="resident")
    run = got.vm
    assert got.report.execution == "resident" and run.form == "masked"
    assert run.replays == run.host_reads > 0 and run.capture_s > 0
    assert tsc.stream_compact.launches > before[0]
    assert tsr.segment_reduce.launches > before[1]
    for arr in want.dram:
        np.testing.assert_array_equal(got.dram[arr], want.dram[arr])
    assert got.report.stats == want.report.stats


# ---------------------------------------------------------------------------
# attention kernels (float32: 2e-5, bfloat16: 2e-2 — the tolerances of the
# reference's kernel tests; the sums run in another order, and bfloat16
# rounds the output)
# ---------------------------------------------------------------------------

HEAD_DIMS = (16, 32, 64, 128, 256)
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _qkv(rng, bh, sq, skv, d, dtype, device):
    def t(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(device, dtype)
    return t(bh, sq, d), t(bh, skv, d), t(bh, skv, d)


@pytest.mark.cuda
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_attention_matches_plain(cuda_device, d, dtype):
    from repro_torch.kernels import flash_attention as fa
    rng = np.random.default_rng(d)
    shapes = [(3, s, s) for s in (1, 17, 64, 100, 128, 300)]
    shapes += [(2, 50, 130), (2, 130, 50), (1, 65, 1)]
    for bh, sq, skv in shapes:
        q, k, v = _qkv(rng, bh, sq, skv, d, dtype, cuda_device)
        for causal in (True, False):
            before = fa.flash_attention.launches
            got = fa.flash_attention(q, k, v, causal=causal)
            assert fa.flash_attention.launches == before + 1
            want = fa.flash_attention_plain(q, k, v, causal=causal)
            assert got.dtype == dtype and got.shape == q.shape
            torch.testing.assert_close(got.float(), want.float(),
                                       atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_decode_attention_matches_plain(cuda_device, d, dtype):
    from repro_torch.kernels import decode_attention as da
    rng = np.random.default_rng(100 + d)
    for bh, s in ((5, 1), (5, 7), (7, 128), (6, 1000), (2, 4099)):
        q, k, v = _qkv(rng, bh, 1, s, d, dtype, cuda_device)
        lens = rng.integers(1, s + 1, bh)
        lens[0] = s                                  # the whole cache
        if bh > 2:
            lens[1], lens[2] = 0, s + 5              # every key masked; > S
        lengths = torch.from_numpy(lens.astype(np.int32)).to(cuda_device)
        before = da.decode_attention.launches
        got = da.decode_attention(q, k, v, lengths)
        assert da.decode_attention.launches == before + 1
        want = da.decode_attention_plain(q, k, v, lengths)
        torch.testing.assert_close(got.float(), want.float(),
                                   atol=TOL[dtype], rtol=TOL[dtype])


GQA_GROUPS = (1, 2, 7, 16)


@pytest.mark.cuda
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g", GQA_GROUPS)
def test_cuda_flash_attention_gqa_matches_plain(cuda_device, d, dtype, g):
    """G query rows per kv row (query row bh reads kv row bh // G); Sq !=
    Skv both ways, and lengths that are no multiple of any tile (16, 32 or
    64 keys; 64 query rows)."""
    from repro_torch.kernels import flash_attention as fa
    rng = np.random.default_rng(1000 * g + d)
    for bhkv, sq, skv in ((2, 100, 100), (1, 17, 130), (2, 130, 17),
                          (1, 65, 1), (1, 300, 300)):
        q, _, _ = _qkv(rng, bhkv * g, sq, 1, d, dtype, cuda_device)
        _, k, v = _qkv(rng, bhkv, 1, skv, d, dtype, cuda_device)
        for causal in (True, False):
            before = fa.flash_attention.launches
            got = fa.flash_attention(q, k, v, causal=causal)
            assert fa.flash_attention.launches == before + 1
            want = fa.flash_attention_plain(q, k, v, causal=causal)
            assert got.dtype == dtype and got.shape == q.shape
            torch.testing.assert_close(got.float(), want.float(),
                                       atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g", GQA_GROUPS)
def test_cuda_decode_attention_split_matches_plain(cuda_device, d, dtype, g):
    """The kernel at the chunk counts its shapes plan (1 chunk of 64 keys,
    3 of 334, 16 of 257), G query rows per kv row, lengths 0, 1, S, past S
    and inside / at the edge of a chunk; one launch counted per call,
    though more than one chunk runs two device kernels.  The kernel is
    also held to the plain split merge."""
    from repro_torch.kernels import decode_attention as da
    rng = np.random.default_rng(2000 * g + d)
    for bhkv, s, n_split in ((6, 1000, 3), (3, 4099, 16), (2, 64, 1)):
        assert da.split_plan(bhkv, s) == n_split
        q, _, _ = _qkv(rng, bhkv * g, 1, 1, d, dtype, cuda_device)
        _, k, v = _qkv(rng, bhkv, 1, s, d, dtype, cuda_device)
        chunk = -(-s // n_split)
        lens = rng.integers(1, s + 1, bhkv)
        lens[:2] = (0, s + 5)
        if bhkv > 2:
            lens[2:6] = (1, s, chunk, 2 * chunk + 1)[:bhkv - 2]
        lengths = torch.from_numpy(lens.astype(np.int32)).to(cuda_device)
        before = da.decode_attention.launches
        got = da.decode_attention(q, k, v, lengths)
        assert da.decode_attention.launches == before + 1
        assert got.dtype == dtype and got.shape == q.shape
        for want in (da.decode_attention_plain(q, k, v, lengths),
                     da.decode_attention_split_plain(q, k, v, lengths,
                                                     n_split)):
            torch.testing.assert_close(got.float(), want.float(),
                                       atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.cuda
def test_cuda_attention_kernels_refuse_what_they_cannot_take(cuda_device):
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    rng = np.random.default_rng(5)
    q, k, v = _qkv(rng, 2, 8, 8, 48, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="head dim 48"):
        flash_attention(q, k, v)
    q, k, v = _qkv(rng, 2, 8, 8, 64, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(0, 1).contiguous().transpose(0, 1), k, v)
    lengths = torch.full((2,), 8, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="head dim 48"):
        decode_attention(*_qkv(rng, 2, 1, 8, 48, torch.float32,
                               cuda_device)[:1],
                         *_qkv(rng, 2, 8, 8, 48, torch.float32,
                               cuda_device)[1:], lengths)
    # GQA: BHq must be a multiple of BHkv
    q, k, v = _qkv(rng, 3, 8, 8, 64, torch.bfloat16, cuda_device)
    with pytest.raises(ValueError, match="not a multiple of BHkv"):
        flash_attention(q, k[:2], v[:2])
    with pytest.raises(ValueError, match="not a multiple of BHkv"):
        decode_attention(q[:, :1], k[:2], v[:2], lengths)


@pytest.mark.cuda
def test_cuda_decode_engine_serves_reduced_qwen2(cuda_device):
    """Reduced qwen2-0.5b through ``DecodeEngine()`` on the card (its
    defaults: CUDA, ``impl="kernel"``): every prefill layer launches the
    flash kernel once, and the tokens equal the plain prefill route's
    (``impl="naive"``) on the card.  ``impl`` does not reach the decode
    attention, which is the ``decode_attention`` kernel on both engines
    (a plain CUDA cache); the near-tie test below holds it to the plain
    decode attention."""
    from repro_torch.configs import get_reduced
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.zoo import get_model
    from repro_torch.serve.engine import DecodeEngine, Request
    cfg = get_reduced("qwen2-0.5b")
    zoo = get_model(cfg)
    params = zoo.init_params(0)
    assert params["ln_f"]["w"].device.type == "cuda"
    runs = {}
    for impl in ("kernel", "naive"):
        rng = np.random.default_rng(0)
        reqs = [Request(rid=i, prompt=rng.integers(
            1, cfg.vocab, size=int(rng.integers(4, 17))).astype(np.int32),
            max_new=6) for i in range(5)]
        eng = (DecodeEngine(zoo, params, batch_slots=3, max_len=32)
               if impl == "kernel" else
               DecodeEngine(zoo, params, 3, 32, impl="naive"))
        for r in reqs:
            eng.submit(r)
        before = flash_attention.launches
        eng.run_until_drained()
        runs[impl] = ([r.tokens for r in reqs], eng.stats(),
                      flash_attention.launches - before)
        assert all(r.done for r in reqs)
    assert runs["kernel"][2] == 5 * cfg.n_layers
    assert runs["naive"][2] == 0
    assert runs["kernel"][:2] == runs["naive"][:2]


# ---------------------------------------------------------------------------
# the served decode route: ``layers.decode_attention_step`` on a plain CUDA
# cache launches ``decode_attention``; the grouped float32 reference (the
# route every other cache keeps) is forced by replacing
# ``layers._decode_route``
# ---------------------------------------------------------------------------

def _force_ref(cache):
    return "ref"


@pytest.mark.cuda
@pytest.mark.parametrize("plain", ["naive", "ref"])
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "olmoe-1b-7b"])
def test_cuda_reduced_routes_part_only_at_near_ties(cuda_device, arch, plain,
                                                    monkeypatch):
    """``DecodeEngine`` on reduced qwen2-0.5b (G 2: the decode kernel's
    tensor-core instance) and olmoe-1b-7b (G 1: its lane groups) in bf16,
    the kernel route (flash in prefill; ``decode_attention`` once a layer
    a decode step) against a plain one: the plain prefill (``"naive"``) or
    the flash prefill (``"ref"``), with the decode attention on the plain
    side forced to the float32 grouped reference (``layers._decode_route``
    replaced), which launches no kernel.  Where the greedy tokens part
    (bf16 rounding in another order), the first differing step is a near
    tie: fed the kernel engine's tokens up to that step, each route puts
    the two tokens' logits within 2 bf16 steps of each other.  Prints each
    such step and its margins."""
    import contextlib
    import math
    from repro_torch.configs import get_reduced
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.models import layers as L
    from repro_torch.models.zoo import get_model
    from repro_torch.serve.engine import DecodeEngine, Request
    cfg = get_reduced(arch)
    zoo = get_model(cfg)
    params = zoo.init_params(0)
    assert params["ln_f"]["w"].dtype == torch.bfloat16
    prefill = {"kernel": "kernel", "plain": "naive" if plain == "naive"
               else "kernel"}

    @contextlib.contextmanager
    def route(side):
        with monkeypatch.context() as m:
            if side == "plain":
                m.setattr(L, "_decode_route", _force_ref)
            yield

    served = {}
    for side in ("kernel", "plain"):
        rng = np.random.default_rng(0)
        reqs = [Request(rid=i, prompt=rng.integers(
            1, cfg.vocab, size=int(rng.integers(4, 17))).astype(np.int32),
            max_new=6) for i in range(5)]
        eng = DecodeEngine(zoo, params, 3, 32, impl=prefill[side])
        for r in reqs:
            eng.submit(r)
        before = decode_attention.launches
        with route(side):
            eng.run_until_drained()
        launched = decode_attention.launches - before
        assert all(r.done for r in reqs)
        assert launched == (cfg.n_layers * eng.steps if side == "kernel"
                            else 0), (side, launched, eng.steps)
        served[side] = reqs
    for rk, rp in zip(served["kernel"], served["plain"]):
        first = next((i for i, (a, b) in enumerate(zip(rk.tokens, rp.tokens))
                      if a != b), None)
        if first is None:
            continue
        tk, tp = rk.tokens[first], rp.tokens[first]
        for side in ("kernel", "plain"):
            toks = torch.as_tensor(rk.prompt, device=cuda_device)[None]
            with route(side):
                lg, cache, pos = zoo.prefill(params, {"tokens": toks}, 32,
                                             impl=prefill[side])
                for t in rk.tokens[:first]:
                    lg, cache, pos = zoo.decode_step(params, torch.tensor(
                        [[t]], dtype=torch.int32, device=cuda_device),
                        cache, pos)
            x = lg[0, -1, :cfg.vocab].float()
            step = 2.0 ** (math.floor(math.log2(float(x.abs().max()))) - 7)
            margin = abs(float(x[tk]) - float(x[tp])) / step
            print(f"{arch} rid {rk.rid} step {first}: kernel token {tk}, "
                  f"plain token {tp}; {side} route logits {float(x[tk])}, "
                  f"{float(x[tp])}: {margin} bf16 steps of {step}")
            assert margin <= 2, (arch, plain, rk.rid, first, side, margin)


@pytest.mark.cuda
@pytest.mark.parametrize("hq,hkv,d", [(14, 2, 64), (16, 16, 128)])
def test_cuda_decode_kernel_route_on_a_ragged_cache(cuda_device, hq, hkv, d,
                                                    monkeypatch):
    """qwen2-0.5b's heads (G 7, head dim 64) and olmoe-1b-7b's (G 1, head
    dim 128) over a 1000-row bf16 cache of 4 slots.  ``decode_mha``'s
    kernel route at lengths 1, 500, S and past S is within TOL (bf16) of
    ``_grouped_ref``'s (``decode_mha(impl="ref")``); one layer's
    ``decode_attention_step`` at positions 0, 499, S - 1 and past S (a
    write there goes to the last row, the length is S) launches once and
    is within 2e-2 of its largest value of the reference route's."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.models import layers as L
    rng = np.random.default_rng(d)
    b, s = 4, 1000

    def t(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(
            np.float32)).to(cuda_device, torch.bfloat16)

    q, k, v = t(b, hq, 1, d), t(b, hkv, s, d), t(b, hkv, s, d)
    lengths = torch.tensor([1, 500, s, s + 37], dtype=torch.int32,
                           device=cuda_device)
    before = decode_attention.launches
    got = ops.decode_mha(q, k, v, lengths, impl="kernel")
    assert decode_attention.launches == before + 1
    want = ops.decode_mha(q, k, v, lengths, impl="ref")
    tol = TOL[torch.bfloat16]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)

    cfg = ModelConfig(name="ragged", family="dense", d_model=hq * d,
                      n_layers=1, n_heads=hq, n_kv_heads=hkv, d_ff=64,
                      vocab=64)
    wd = hq * d
    p = {"wq": t(wd, hq * d, scale=wd ** -0.5),
         "wk": t(wd, hkv * d, scale=wd ** -0.5),
         "wv": t(wd, hkv * d, scale=wd ** -0.5),
         "wo": t(hq * d, wd, scale=wd ** -0.5)}
    x = t(b, 1, wd)
    position = torch.tensor([0, 499, s - 1, s + 36], dtype=torch.int32,
                            device=cuda_device)
    before = decode_attention.launches
    got, gk, gv = L.decode_attention_step(p, x, cfg, k, v, position)
    assert decode_attention.launches == before + 1
    monkeypatch.setattr(L, "_decode_route", _force_ref)
    want, wk, wv = L.decode_attention_step(p, x, cfg, k, v, position)
    assert torch.equal(gk, wk) and torch.equal(gv, wv)
    err = float((got.float() - want.float()).abs().max())
    assert err <= 2e-2 * float(want.float().abs().max()), err


@pytest.mark.cuda
def test_cuda_decode_counters_read_the_live_keys(cuda_device):
    """One decode step of reduced qwen2-0.5b over a 64-row cache at
    positions 0, 10, 63 and 100: every layer's kv rows on the kernel,
    ``decode.keys_read / decode.keys_held`` = sum of min(pos + 1, S) over
    (B x S), and no reference row."""
    from repro_torch import tracing
    from repro_torch.configs import get_reduced
    from repro_torch.models.zoo import get_model
    zoo = get_model(get_reduced("qwen2-0.5b"))
    cfg = zoo.cfg
    params = zoo.init_params(0)
    b, s = 4, 64
    position = torch.tensor([0, 10, 63, 100], dtype=torch.int32,
                            device=cuda_device)
    token = torch.tensor([[3], [5], [7], [9]], dtype=torch.int32,
                         device=cuda_device)
    cache = zoo.init_cache(b, s)
    tracing.disable()
    tracing.drain()
    tracing.enable()
    try:
        zoo.decode_step(params, token, cache, position)
        got = tracing.drain()["counters"]
    finally:
        tracing.disable()
        tracing.drain()
    c = {k[0]: v for k, v in got.items() if k[1] == "decode.kv"}
    rows = cfg.n_layers * b * cfg.n_kv_heads
    assert set(c) == {"decode.kernel_rows", "decode.keys_read",
                      "decode.keys_held"}
    assert c["decode.kernel_rows"] == rows
    assert c["decode.keys_held"] == rows * s
    live = sum(min(p + 1, s) for p in (0, 10, 63, 100))
    assert c["decode.keys_read"] / c["decode.keys_held"] == live / (b * s)


# ---------------------------------------------------------------------------
# ssm_scan (float32: within 2e-5 of the largest |plain| value, on y and hT —
# the same steps in the same order; the exponential (ex2 on the special-
# function unit), FMA contraction's rounding and the order of the sum over
# N differ)
# ---------------------------------------------------------------------------

SSM_TOL = 2e-5


def _ssm_inputs(gen, bsz, s, di, n, zero_h0, device):
    def r(*shape):
        return torch.randn(shape, generator=gen, device=device)
    h0 = (torch.zeros(bsz, di, n, device=device) if zero_h0
          else r(bsz, di, n))
    return (r(bsz, s, di), torch.nn.functional.softplus(r(bsz, s, di)),
            -torch.exp(0.5 * r(di, n)), r(bsz, s, n), r(bsz, s, n), r(di),
            h0)


@pytest.mark.cuda
@pytest.mark.parametrize("n", (1, 5, 8, 16, 32))
def test_cuda_ssm_scan_matches_plain(cuda_device, n):
    from repro_torch.kernels import ssm_scan as sc
    gen = torch.Generator(cuda_device).manual_seed(n)
    for s in (1, 63, 64, 100, 512):
        for di in (128, 200):
            for zero_h0 in (True, False):
                ins = _ssm_inputs(gen, 2, s, di, n, zero_h0, cuda_device)
                before = sc.ssm_scan.launches
                got = sc.ssm_scan(*ins)
                assert sc.ssm_scan.launches == before + 1
                want = sc.ssm_scan_plain(*ins)
                for g, w in zip(got, want):
                    assert g.shape == w.shape and g.dtype == torch.float32
                    err = float((g - w).abs().max())
                    assert err <= SSM_TOL * float(w.abs().max()), (s, di, err)


def _ssm_within_tol(got, want, what):
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        err = float((g - w).abs().max())
        assert err <= SSM_TOL * float(w.abs().max()), (what, err)


@pytest.mark.cuda
@pytest.mark.parametrize("n", (1, 5, 16, 32))
def test_cuda_ssm_scan_at_tile_edges(cuda_device, n):
    """The edges of N's plan: one short of and one past a buffer of L
    steps and a stage of CHUNK steps, two stages and one; a ragged block
    of channels; the path's (B 1, Di 8192)."""
    from repro_torch.kernels import ssm_scan as sc
    p = sc.plan(1, 8192, n)
    gen = torch.Generator(cuda_device).manual_seed(100 + n)
    for s in (p.lanes - 1, p.lanes, p.lanes + 1, sc.CHUNK - 1, sc.CHUNK,
              sc.CHUNK + 1, 2 * sc.CHUNK + 1):
        for bsz, di in ((2, p.channels - 1), (3, 2 * p.channels + 3),
                        (1, 8192)):
            ins = _ssm_inputs(gen, bsz, s, di, n, s % 2 == 1, cuda_device)
            before = sc.ssm_scan.launches
            got = sc.ssm_scan(*ins)
            assert sc.ssm_scan.launches == before + 1
            _ssm_within_tol(got, sc.ssm_scan_plain(*ins), (s, bsz, di))
    ins = _ssm_inputs(gen, 1, 512, 8192, n, True, cuda_device)
    _ssm_within_tol(sc.ssm_scan(*ins), sc.ssm_scan_plain(*ins), "path")


@pytest.mark.cuda
def test_cuda_ssm_scan_replays_from_a_graph(cuda_device):
    """One call captured in a CUDA graph, replayed on two different inputs
    copied into its static tensors: both replays equal the plain version
    on those inputs, and the graph holds one kernel launch."""
    from repro_torch.kernels import ssm_scan as sc
    gen = torch.Generator(cuda_device).manual_seed(7)
    ins = _ssm_inputs(gen, 2, 2 * sc.CHUNK + 1, 200, 16, False, cuda_device)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                # warm, off the capture
        sc.ssm_scan(*ins)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = sc.ssm_scan.launches
    with torch.cuda.graph(graph):
        got = sc.ssm_scan(*ins)
    assert sc.ssm_scan.launches == before + 1
    for i in range(2):
        for t, new in zip(ins, _ssm_inputs(gen, 2, 2 * sc.CHUNK + 1, 200, 16,
                                           i == 0, cuda_device)):
            t.copy_(new)
        graph.replay()
        torch.cuda.synchronize()
        _ssm_within_tol(got, sc.ssm_scan_plain(*ins), f"replay {i}")


@pytest.mark.cuda
def test_cuda_ssm_scan_refuses_what_it_cannot_take(cuda_device):
    from repro_torch.kernels.ssm_scan import ssm_scan
    gen = torch.Generator(cuda_device).manual_seed(0)
    x, dt, a, b, c, d, h0 = _ssm_inputs(gen, 2, 8, 64, 8, False, cuda_device)
    with pytest.raises(TypeError, match="float32"):
        ssm_scan(x.bfloat16(), dt, a, b, c, d, h0)
    with pytest.raises(ValueError, match="contiguous"):
        ssm_scan(x.transpose(0, 1).contiguous().transpose(0, 1), dt, a, b,
                 c, d, h0)
    big = _ssm_inputs(gen, 1, 8, 64, 33, False, cuda_device)
    with pytest.raises(ValueError, match="N = 33"):
        ssm_scan(*big)


@pytest.mark.cuda
def test_cuda_ssm_model_runs_the_kernel(cuda_device):
    """Reduced falcon-mamba-7b on the card: ``forward(impl="kernel")``
    launches the kernel once per layer and agrees with the plain
    ``"chunked"`` route; ``DecodeEngine()`` serves every request."""
    from repro_torch.configs import get_reduced
    from repro_torch.kernels.ssm_scan import ssm_scan
    from repro_torch.models import ssm
    from repro_torch.models.zoo import get_model
    from repro_torch.serve.engine import DecodeEngine, Request
    cfg = get_reduced("falcon-mamba-7b")
    zoo = get_model(cfg)
    params = zoo.init_params(0)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab, (2, 150))
                            .astype(np.int32)).to(cuda_device)
    before = ssm_scan.launches
    got = ssm.forward(params, toks, cfg, impl="kernel")
    assert ssm_scan.launches == before + cfg.n_layers
    want = ssm.forward(params, toks, cfg, impl="chunked")
    torch.testing.assert_close(got, want, atol=3e-2, rtol=3e-2)
    reqs = [Request(rid=i, prompt=rng.integers(
        1, cfg.vocab, size=int(rng.integers(4, 200))).astype(np.int32),
        max_new=6) for i in range(5)]
    eng = DecodeEngine(zoo, params, batch_slots=3, max_len=256)
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    assert all(r.done and len(r.tokens) == 6 for r in reqs)
    assert eng.cache["conv"].dtype == torch.float32


# ---------------------------------------------------------------------------
# rg_lru (float32: each step rounds the product and then the sum, as the
# plain loop does, so the two agree bit for bit)
# ---------------------------------------------------------------------------

def _rg_lru_inputs(gen, bsz, s, d, zero_h0, device):
    """a in [0, 1), b ~ 0.1 N(0, 1), as the reference's kernel tests."""
    a = torch.rand((bsz, s, d), generator=gen, device=device)
    b = 0.1 * torch.randn((bsz, s, d), generator=gen, device=device)
    h0 = (torch.zeros(bsz, d, device=device) if zero_h0
          else torch.randn((bsz, d), generator=gen, device=device))
    return a, b, h0


@pytest.mark.cuda
@pytest.mark.parametrize("d", (1, 33, 100, 4096))
def test_cuda_rg_lru_matches_plain(cuda_device, d):
    from repro_torch.kernels import rg_lru as rg
    gen = torch.Generator(cuda_device).manual_seed(d)
    for s in (0, 1, 7, 8, 63, 64, 100, 513):
        for bsz in (1, 3):
            for zero_h0 in (True, False):
                ins = _rg_lru_inputs(gen, bsz, s, d, zero_h0, cuda_device)
                before = rg.rg_lru.launches
                got = rg.rg_lru(*ins)
                assert rg.rg_lru.launches == before + 1
                want = rg.rg_lru_plain(*ins)
                for g, w in zip(got, want):
                    assert g.shape == w.shape and g.dtype == torch.float32
                    assert torch.equal(g, w), (s, bsz, d, zero_h0)


def _rg_edge_steps(width):
    """One short of, at and one past a stage, the prologue's stages - 1
    tiles and one past them, the whole ring and one past it."""
    from repro_torch.kernels import rg_lru as rg
    steps, stages = rg.STEPS[width], rg.STAGES[width]
    ring = (stages - 1) * steps
    return (steps - 1, steps, steps + 1, ring, ring + 1, stages * steps,
            stages * steps + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("width", (32, 16, 8, 4))
def test_cuda_rg_lru_at_stage_edges(cuda_device, width):
    """Bit for bit at the ring's edges, for each block width the plan
    takes (its steps a stage and stages): S around a stage, the prologue
    and the whole ring; one channel short of and one past a block; a D
    that is no multiple of 4 (4-byte copies); the path's (B 1, D 4096) at
    width 8."""
    from repro_torch.kernels import rg_lru as rg
    gen = torch.Generator(cuda_device).manual_seed(width)
    # B and D chosen so that the plan takes this width
    shapes = {32: ((5, 4096), (13, 31 * 32 + 1)),
              16: ((1, 8192), (3, 16 * 140 - 1)),
              8: ((1, 4096), (2, 8 * 200 + 4)),
              4: ((1, 9), (3, 4 * 40 + 3))}[width]
    for s in _rg_edge_steps(width):
        for bsz, d in shapes:
            assert rg.plan(bsz, d).width == width
            ins = _rg_lru_inputs(gen, bsz, s, d, s % 2 == 0, cuda_device)
            before = rg.rg_lru.launches
            got = rg.rg_lru(*ins)
            assert rg.rg_lru.launches == before + 1
            for g, w in zip(got, rg.rg_lru_plain(*ins)):
                assert torch.equal(g, w), (s, bsz, d)


@pytest.mark.cuda
def test_cuda_rg_lru_replays_from_a_graph(cuda_device):
    """One call captured in a CUDA graph, replayed on two different inputs
    copied into its static tensors: both replays equal the plain version
    bit for bit, and the graph holds one kernel launch."""
    from repro_torch.kernels import rg_lru as rg
    gen = torch.Generator(cuda_device).manual_seed(11)
    shape = (1, _rg_edge_steps(rg.plan(1, 4096).width)[-1], 4096)
    ins = _rg_lru_inputs(gen, *shape, False, cuda_device)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                # warm, off the capture
        rg.rg_lru(*ins)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = rg.rg_lru.launches
    with torch.cuda.graph(graph):
        got = rg.rg_lru(*ins)
    assert rg.rg_lru.launches == before + 1
    for i in range(2):
        for t, new in zip(ins, _rg_lru_inputs(gen, *shape, i == 0,
                                              cuda_device)):
            t.copy_(new)
        graph.replay()
        torch.cuda.synchronize()
        for g, w in zip(got, rg.rg_lru_plain(*ins)):
            assert torch.equal(g, w), i


@pytest.mark.cuda
def test_cuda_rg_lru_refuses_what_it_cannot_take(cuda_device):
    from repro_torch.kernels import ops
    from repro_torch.kernels.rg_lru import rg_lru
    gen = torch.Generator(cuda_device).manual_seed(0)
    a, b, h0 = _rg_lru_inputs(gen, 2, 8, 64, False, cuda_device)
    before = rg_lru.launches
    with pytest.raises(TypeError, match="float32"):
        rg_lru(a.bfloat16(), b, h0)
    with pytest.raises(TypeError, match="float32"):
        ops.rg_lru_scan(a.bfloat16(), b.bfloat16(), h0, impl="kernel")
    with pytest.raises(ValueError, match="contiguous"):
        rg_lru(a.transpose(0, 1).contiguous().transpose(0, 1), b, h0)
    with pytest.raises(ValueError, match="h0"):
        rg_lru(a, b, h0[:, :4])
    assert rg_lru.launches == before


@pytest.mark.cuda
def test_cuda_hybrid_model_runs_the_kernels(cuda_device):
    """Reduced recurrentgemma-9b (head dim 16, window 32) on the card:
    ``_rec_block(impl="kernel")`` launches the scan and agrees with the
    served chunked route; ``DecodeEngine()`` serves prompts shorter and
    longer than the window, launching flash once per attention block of
    each prompt that fits the window."""
    from repro_torch.configs import get_reduced
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rg_lru import rg_lru
    from repro_torch.models import rglru
    from repro_torch.models.zoo import get_model
    from repro_torch.serve.engine import DecodeEngine, Request
    cfg = get_reduced("recurrentgemma-9b")
    zoo = get_model(cfg)
    params = zoo.init_params(0)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 150, cfg.d_model)).astype(
        np.float32)).to(cuda_device, torch.bfloat16)
    _, p, _, _ = next(rglru.blocks(params, cfg))
    before = rg_lru.launches
    got, (h, _) = rglru._rec_block(p, x, cfg, impl="kernel")
    assert rg_lru.launches == before + 1
    want, (wh, _) = rglru._rec_block(p, x, cfg)
    torch.testing.assert_close(got.float(), want.float(), atol=3e-2,
                               rtol=3e-2)
    torch.testing.assert_close(h, wh, atol=1e-5, rtol=1e-5)
    lens = (5, 20, 31, 70, 12)
    reqs = [Request(rid=i, prompt=rng.integers(1, cfg.vocab, n).astype(
        np.int32), max_new=6) for i, n in enumerate(lens)]
    eng = DecodeEngine(zoo, params, batch_slots=3, max_len=128)
    for r in reqs:
        eng.submit(r)
    before = flash_attention.launches
    eng.run_until_drained()
    _, n_groups, _ = rglru._counts(cfg)
    assert flash_attention.launches - before == n_groups * sum(
        n <= cfg.window for n in lens)
    assert all(r.done and len(r.tokens) == 6 for r in reqs)
    assert eng.cache["attn_k"].shape[3] == cfg.window


# ---------------------------------------------------------------------------
# olmoe-1b-7b's path: attention at head dim 128, the MoE dispatch kernel and
# the hash probe kernel (both held bit for bit to their plain versions)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_attention_at_olmoe_head_dim(cuda_device, dtype):
    """olmoe-1b-7b's heads: 16 of 128, a 512-token prompt for flash and a
    1024-row cache of 4 slots for decode."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    rng = np.random.default_rng(128)
    q, k, v = _qkv(rng, 16, 512, 512, 128, dtype, cuda_device)
    torch.testing.assert_close(fa.flash_attention(q, k, v).float(),
                               fa.flash_attention_plain(q, k, v).float(),
                               atol=TOL[dtype], rtol=TOL[dtype])
    q, k, v = _qkv(rng, 64, 1, 1024, 128, dtype, cuda_device)
    lengths = torch.from_numpy(rng.integers(1, 1025, 64).astype(
        np.int32)).to(cuda_device)
    torch.testing.assert_close(
        da.decode_attention(q, k, v, lengths).float(),
        da.decode_attention_plain(q, k, v, lengths).float(),
        atol=TOL[dtype], rtol=TOL[dtype])


def _dispatch_inputs(rng, a, d, e, cap_share, dtype, device):
    """A top-k style assignment stream of ``a`` rows over ``e`` experts with
    its cumsum positions, and a capacity that keeps about ``cap_share`` of
    the rows of the busiest expert."""
    flat_e = rng.integers(0, e, a)
    onehot = np.eye(e, dtype=np.int64)[flat_e]
    pos = (np.cumsum(onehot, 0) - onehot)[np.arange(a), flat_e]
    cap = max(1, int(np.ceil(onehot.sum(0).max() * cap_share)))
    tokens = torch.from_numpy(rng.standard_normal((a, d)).astype(
        np.float32)).to(device, dtype)
    as_i32 = (lambda x: torch.from_numpy(x.astype(np.int32)).to(device))
    return tokens, as_i32(flat_e), as_i32(pos), cap


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_moe_dispatch_matches_plain(cuda_device, dtype):
    from repro_torch.kernels import moe_dispatch as md
    rng = np.random.default_rng(7)
    for a in (1, 7, 256, 4096):
        for d in (32, 100, 2048):
            for e in (8, 64):
                for share in (1.0, 0.8, 0.1):
                    tok, ei, pos, cap = _dispatch_inputs(rng, a, d, e, share,
                                                         dtype, cuda_device)
                    before = md.moe_dispatch.launches
                    got = md.moe_dispatch(tok, ei, pos, e, cap)
                    assert md.moe_dispatch.launches == before + 1
                    want = md.moe_dispatch_plain(tok, ei, pos, e, cap)
                    assert got.dtype == dtype and got.shape == want.shape
                    bits = torch.int16 if dtype == torch.bfloat16 \
                        else torch.int32
                    assert torch.equal(got.view(bits), want.view(bits)), \
                        (a, d, e, cap)
    # an odd row width on an odd base address takes the 2-byte copy
    tok, ei, pos, cap = _dispatch_inputs(rng, 33, 7, 4, 0.5, dtype,
                                         cuda_device)
    tok = torch.cat([tok.flatten(), tok.flatten()[:1]])[1:].view(33, 7)
    assert torch.equal(md.moe_dispatch(tok, ei, pos, 4, cap),
                       md.moe_dispatch_plain(tok, ei, pos, 4, cap))


@pytest.mark.cuda
def test_cuda_moe_dispatch_refuses_what_it_cannot_take(cuda_device):
    from repro_torch.kernels.moe_dispatch import moe_dispatch
    rng = np.random.default_rng(8)
    tok, ei, pos, cap = _dispatch_inputs(rng, 64, 32, 8, 1.0,
                                         torch.bfloat16, cuda_device)
    before = moe_dispatch.launches
    with pytest.raises(TypeError, match="int32"):
        moe_dispatch(tok, ei.long(), pos, 8, cap)
    with pytest.raises(ValueError, match="contiguous"):
        moe_dispatch(tok.t().contiguous().t(), ei, pos, 8, cap)
    with pytest.raises(ValueError, match="contiguous"):
        moe_dispatch(tok, torch.stack([ei, ei], 1)[:, 0], pos, 8, cap)
    assert moe_dispatch.launches == before


@pytest.mark.cuda
def test_cuda_moe_routes_agree_bit_for_bit(cuda_device):
    """Reduced olmoe-1b-7b's first layer on the card: the kernel route of
    ``moe_dispatch_combine`` equals the served scatter route, and
    ``DecodeEngine()`` serves the model, launching flash once per layer of
    each prompt."""
    from repro_torch.configs import get_reduced
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.moe_dispatch import moe_dispatch
    from repro_torch.models import moe
    from repro_torch.models.transformer import layer_params
    from repro_torch.models.zoo import get_model
    from repro_torch.serve.engine import DecodeEngine, Request
    cfg = get_reduced("olmoe-1b-7b")
    zoo = get_model(cfg)
    params = zoo.init_params(0)
    rng = np.random.default_rng(9)
    p = layer_params(params, 0)["moe"]
    for t in (1, 4, 100, 333):
        x = torch.from_numpy(rng.standard_normal((t, cfg.d_model)).astype(
            np.float32)).to(cuda_device, torch.bfloat16)
        _, gates, eidx = moe.route(p, x, cfg)
        cap = moe.capacity(cfg, t)
        before = moe_dispatch.launches
        got = ops.moe_dispatch_combine(x, gates, eidx, cfg.n_experts, cap,
                                       moe.expert_fn(p, x.dtype))
        assert moe_dispatch.launches == before + 1
        want, _ = moe.moe_ff(p, x[None], cfg)
        assert torch.equal(got, want[0])
    lens = (5, 20, 70, 12)
    reqs = [Request(rid=i, prompt=rng.integers(1, cfg.vocab, n).astype(
        np.int32), max_new=6) for i, n in enumerate(lens)]
    eng = DecodeEngine(zoo, params, batch_slots=3, max_len=96)
    for r in reqs:
        eng.submit(r)
    before = flash_attention.launches
    eng.run_until_drained()
    assert flash_attention.launches - before == cfg.n_layers * len(lens)
    assert all(r.done and len(r.tokens) == 6 for r in reqs)


@pytest.mark.cuda
def test_cuda_hash_probe_matches_plain(cuda_device):
    from repro_torch.kernels import hash_probe as hp
    rng = np.random.default_rng(10)
    for n_slots in (1, 8, 128, 1000, 1024, 1 << 16):
        for load in (0.25, 0.5, 1.0):
            n_keys = max(1, int(n_slots * load))
            keys = rng.choice(np.arange(-(1 << 20), 1 << 20), n_keys,
                              replace=False)
            keys[keys == 0] = 1 << 21
            tk = np.zeros(n_slots, np.int64)
            tv = np.zeros(n_slots, np.int64)
            slots = rng.permutation(n_slots)[:n_keys]   # any layout will do
            tk[slots], tv[slots] = keys, rng.integers(-99, 99, n_keys)
            as_i32 = (lambda x: torch.from_numpy(
                np.concatenate([x, x]).astype(np.int32)).to(cuda_device))
            tk_t, tv_t = as_i32(tk), as_i32(tv)
            for n in (1, 255, 256, 257, 5000):
                q = np.concatenate([rng.choice(keys, n - n // 2),
                                    rng.integers(-(1 << 31), 1 << 31,
                                                 n // 2)])
                q[:: 97] = 0                            # EMPTY as a key
                qt = torch.from_numpy(q.astype(np.int32)).to(cuda_device)
                for max_probes in (1, 16, min(3 * n_slots, 40)):
                    before = hp.hash_probe.launches
                    got = hp.hash_probe(qt, tk_t, tv_t, n_slots, max_probes)
                    assert hp.hash_probe.launches == before + 1
                    want = hp.hash_probe_plain(qt, tk_t, tv_t, n_slots,
                                               max_probes)
                    for g, w in zip(got, want):
                        assert g.dtype == torch.int32 and torch.equal(g, w), \
                            (n_slots, load, n, max_probes)


@pytest.mark.cuda
def test_cuda_hash_probe_refuses_what_it_cannot_take(cuda_device):
    from repro_torch.kernels.hash_probe import hash_probe
    k = torch.zeros(8, dtype=torch.int32, device=cuda_device)
    t = torch.zeros(16, dtype=torch.int32, device=cuda_device)
    before = hash_probe.launches
    with pytest.raises(ValueError, match="contiguous"):
        hash_probe(torch.zeros(16, dtype=torch.int32,
                               device=cuda_device)[::2], t, t, 8)
    with pytest.raises(ValueError, match="different devices"):
        hash_probe(k.cpu(), t, t, 8)
    assert hash_probe.launches == before
    # what it takes: both outputs are views of one int32 buffer, values
    # then found flags
    vals, found = hash_probe(k, t, t, 8)
    assert vals.untyped_storage().data_ptr() == \
        found.untyped_storage().data_ptr()
    assert found.data_ptr() == vals.data_ptr() + 4 * k.numel()
    assert vals.shape == found.shape == k.shape
    assert torch.equal(found, torch.ones_like(k))       # key 0, empty slot
    assert hash_probe.launches == before + 1


# ---------------------------------------------------------------------------
# encdec's attention shapes, async serving, checkpoints of card tensors
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_at_cross_attention_shapes(cuda_device, dtype):
    """Non-causal flash where many key tiles lie behind a short query block:
    seamless-m4t-medium's cross-attention in prefill (2 x 16 heads of 64,
    a 64-token prompt over 1024 encoder frames), a ragged encoder (1000),
    the reverse, and the encoder's own self-attention."""
    from repro_torch.kernels import flash_attention as fa
    rng = np.random.default_rng(64)
    for bh, sq, skv in ((32, 64, 1024), (32, 64, 1000), (32, 1000, 64),
                        (32, 1024, 1024), (32, 1, 1000)):
        q, k, v = _qkv(rng, bh, sq, skv, 64, dtype, cuda_device)
        before = fa.flash_attention.launches
        got = fa.flash_attention(q, k, v, causal=False)
        assert fa.flash_attention.launches == before + 1
        want = fa.flash_attention_plain(q, k, v, causal=False)
        torch.testing.assert_close(got.float(), want.float(),
                                   atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.cuda
def test_cuda_async_engine_serves_resident(cuda_device):
    """``AsyncServeEngine`` on ``TorchBackend()`` in resident mode: warmup
    captures every bucket, serving captures nothing, no launch fails or
    degrades, and every response equals the numpy oracle's solo run."""
    from repro_torch.apps import ALL_APPS
    from repro_torch.core.backend import TorchBackend
    from repro_torch.serve.async_engine import AsyncRequest, AsyncServeEngine
    app = ALL_APPS["hash_table"]()
    tb = TorchBackend()
    compiled = app.fn.lower(**app.dram_init, **app.params,
                            **app.statics).compile(tb)
    eng = AsyncServeEngine(compiled, execution="resident", max_wave=4,
                           queue_cap=16)
    assert eng.warmup(dict(app.dram_init), dict(app.params))["resident"] \
        == [1, 2, 4]
    programs = len(compiled.result._resident_cache)
    for n in (64, 17, 1, 40, 64, 9):
        eng.submit(AsyncRequest(params={"count": n},
                                dram_init=dict(app.dram_init),
                                tenant=f"t{n % 2}"))
    done = eng.run_until_idle()
    assert len(compiled.result._resident_cache) == programs
    st = eng.stats()
    assert (st["degraded"], st["resident_fallbacks"],
            st["supervisor_failures"], st["failed"]) == (False, 0, 0, 0)
    assert st["served"] == st["submitted"] == 6
    for r in done:
        assert r.status == "ok" and r.report.execution == "resident"
        solo = compiled.execute(dict(app.dram_init), r.request.params,
                                backend="numpy")
        for arr in solo.dram:
            np.testing.assert_array_equal(r.dram[arr], solo.dram[arr])


@pytest.mark.cuda
def test_cuda_checkpoint_roundtrip(cuda_device, tmp_path):
    """A tree of card tensors (bf16 included) saves and restores onto the
    card (the default) bit for bit."""
    from repro_torch.checkpoint import ckpt
    gen = torch.Generator(cuda_device).manual_seed(0)
    tree = {"w": torch.randn(64, 32, generator=gen, device=cuda_device)
            .to(torch.bfloat16),
            "layers": [{"b": torch.randn(8, generator=gen,
                                         device=cuda_device)},
                       {"i": torch.arange(5, dtype=torch.int32,
                                          device=cuda_device)}]}
    ckpt.save(str(tmp_path), 2, tree)
    like = {"w": torch.zeros(64, 32, dtype=torch.bfloat16),
            "layers": [{"b": torch.zeros(8)},
                       {"i": torch.zeros(5, dtype=torch.int32)}]}
    out = ckpt.restore(str(tmp_path), 2, like)
    assert out["w"].device.type == "cuda" and out["w"].dtype == torch.bfloat16
    assert torch.equal(out["w"].view(torch.int16),
                       tree["w"].view(torch.int16))
    assert torch.equal(out["layers"][0]["b"], tree["layers"][0]["b"])
    assert torch.equal(out["layers"][1]["i"], tree["layers"][1]["i"])


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "falcon-mamba-7b"])
def test_cuda_train_step_matches_cpu(cuda_device, arch):
    """One reduced float32 training step on the card against the port's
    own step on the CPU, on the same numpy inputs: the loss and every
    gradient leaf within 1e-4 (of max(1, the leaf's largest |grad|)); then
    the whole step (int8 compression, AdamW) runs on the card, finite."""
    import dataclasses

    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import train
    from repro_torch.models.params import leaves, tree_map
    from repro_torch.models.zoo import get_model
    from repro_torch.optim import adamw, compression
    zoo = get_model(dataclasses.replace(get_reduced(arch),
                                        param_dtype="float32"))
    params = zoo.init_params(0, device="cpu")
    batch = zoo.make_batch(ShapeConfig("t", 64, 2, "train"), seed=1,
                           device="cpu")
    want_l, want_g = train.loss_and_grads(zoo, params, batch)
    on_card = tree_map(lambda t: t.to(cuda_device), params)
    card_batch = {k: v.to(cuda_device) for k, v in batch.items()}
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        got_l, got_g = train.loss_and_grads(zoo, on_card, card_batch)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
    assert abs(float(got_l) - float(want_l)) <= 1e-4
    for g, w in zip(leaves(got_g), leaves(want_g)):
        assert g.device.type == "cuda"
        err = float((g.cpu() - w).abs().max())
        assert err <= 1e-4 * max(1.0, float(w.abs().max()))
    state = {"params": on_card, "opt": adamw.init_state(on_card),
             "err": compression.init_error_state(on_card)}
    step = train.build_step(zoo, adamw.OptConfig(lr=1e-3), "chunked", "int8")
    state, met = step(state, card_batch)
    assert np.isfinite(float(met["loss"])) and int(state["opt"]["step"]) == 1
    assert all(bool(torch.isfinite(t).all()) for t in leaves(state["params"]))


@pytest.mark.cuda
def test_cuda_host_mesh_leaves_serving_bit_identical(cuda_device):
    """The twin of ``chip_smoke.py``'s ``distribution`` (a) at reduced
    size: qwen2 on ``make_host_mesh(1, 1)`` under ``set_act_mesh``, a
    prefill on the kernel route (flash launched once a layer) and 4 greedy
    decode steps, bit-identical to the same calls with no mesh; and a
    checkpoint restores onto the mesh's card through a sharding."""
    from repro_torch.configs import get_reduced
    from repro_torch.distributed import sharding as sh
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.zoo import get_model
    zoo = get_model(get_reduced("qwen2-0.5b"))
    params = zoo.init_params(0)
    gen = torch.Generator(cuda_device).manual_seed(3)
    batch = {"tokens": torch.randint(1, zoo.cfg.vocab, (2, 40), generator=gen,
                                     device=cuda_device, dtype=torch.int32)}
    mesh = make_host_mesh(1, 1)
    assert mesh.device.type == "cuda" and mesh.device_mesh is None

    def run(active):
        sh.set_act_mesh(active)
        try:
            before = flash_attention.launches
            lg, cache, pos = zoo.prefill(params, batch, 64, impl="kernel")
            launched = flash_attention.launches - before
            out = [lg]
            for _ in range(4):
                tok = lg[:, -1].argmax(-1, keepdim=True).to(torch.int32)
                lg, cache, pos = zoo.decode_step(params, tok, cache, pos)
                out.append(lg)
            return out, cache, launched
        finally:
            sh.set_act_mesh(None)

    got, got_cache, launched = run(mesh)
    want, want_cache, _ = run(None)
    assert launched == zoo.cfg.n_layers
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert all(torch.equal(got_cache[k], want_cache[k]) for k in want_cache)
    placed = sh.replicated(mesh).distribute(torch.arange(6.0))
    assert placed.device.type == "cuda"
