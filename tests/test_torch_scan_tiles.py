"""The executor's two tile-scan kernels, held here on the CPU: the windows
that cross their tiles, and the look-back algebra of ``segment_reduce``.

``stream_compact`` and ``segment_reduce`` run on the card as one launch
that walks the window in tiles of ``TILE_ROWS`` tokens, each tile taking
its predecessors' state by a decoupled look-back.  The CUDA kernels cannot
run here, so this file holds two things that can:

* the plain versions (what a CPU tensor runs, and what the card tests hold
  the kernels to) against the numpy oracle ``segment_reduce_window_np`` and
  the reference's ``vm_compact`` / ``vm_segment_reduce``, on windows built
  around ``TILE_ROWS``: one short of a tile, a tile, one past, three and a
  bit; barriers on tile edges; a segment across three tiles with an open
  carry; barriers only; Omega-2 opening a tile after a closed group, and
  after a first tile that emits nothing, so that a degenerate carry
  (closed, ``acc != init``) reaches it;
* a numpy model of the kernel's cross-tile rule, written from the
  definitions in ``csrc/segment_reduce.cu``'s header: per-tile aggregates,
  their composition, the look-back from a random published predecessor,
  and the emission walk inside a tile.  It must equal the oracle on random
  windows cut into tiles of 1-7 tokens, for every op and carry; the
  composition must be associative.

Everything is int32-exact, so every comparison is exact equality.
"""
import numpy as np
import pytest
import torch

from repro.core.backend import segment_reduce_window_np
from repro.kernels import ops as jops
from repro_torch.kernels import ops as tops
from repro_torch.kernels import segment_reduce as tsr
from repro_torch.kernels import stream_compact as tsc

I32_MIN, I32_MAX = -(1 << 31), (1 << 31) - 1
REDUCE_OPS = tsr.OPS
T = tsr.TILE_ROWS
EDGE_NS = (T - 1, T, T + 1, 3 * T + 5)


def _same_reduce(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert tuple(got[2:]) == tuple(want[2:])


def _values(rng, n):
    return rng.integers(I32_MIN, I32_MAX, size=n).astype(np.int64)


def _edge_windows(rng, n):
    """Windows of ``n`` tokens that stress the tile edges, by name."""
    random = rng.choice([0, 0, 0, 1, 2, 3], size=n).astype(np.int64)
    edges = np.zeros(n, np.int64)
    for e in range(T, n + 1, T):                 # barriers either side of
        edges[e - 1] = rng.integers(1, 4)        # each tile edge
        if e < n:
            edges[e] = rng.integers(1, 4)
    spanning = np.zeros(n, np.int64)             # one open segment over
    spanning[-1] = 2                             # every tile, closed at the
    bars_only = rng.integers(1, 4, size=n).astype(np.int64)   # very end
    omega2 = rng.choice([0, 0, 0, 1, 2], size=n).astype(np.int64)
    for e in range(T, n, T):                     # Omega-2 opens each tile
        omega2[e - 1], omega2[e] = 1, 2          # after a closed group
    # tile 0 emits nothing, so a closed carry with acc != init reaches the
    # Omega-2 that opens tile 1
    quiet = rng.choice([0, 0, 0, 1, 2, 3], size=n).astype(np.int64)
    quiet[:T] = rng.integers(2, 4, size=min(T, n))
    if n > T:
        quiet[T] = 2
    return {"random": random, "edges": edges, "spanning": spanning,
            "bars_only": bars_only, "omega2": omega2, "quiet": quiet}


# ---------------------------------------------------------------------------
# plain versions against the reference, around the tile size
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", EDGE_NS)
@pytest.mark.parametrize("op", REDUCE_OPS)
def test_segment_reduce_plain_at_tile_edges(n, op):
    """All six ops, values and none, open / closed / degenerate carries,
    against the oracle and the reference's jnp route."""
    rng = np.random.default_rng(n + REDUCE_OPS.index(op))
    vals = _values(rng, n)
    for name, kinds in _edge_windows(rng, n).items():
        init = int(rng.integers(-4, 5))
        acc = int(rng.integers(I32_MIN, I32_MAX))
        for go, a in ((True, acc), (False, init), (False, acc)):
            for v in (vals, None):
                got = tops.vm_segment_reduce(kinds, v, op, init, a, go)
                want = segment_reduce_window_np(kinds, v, op, init, a, go)
                _same_reduce(got, want)
                _same_reduce(got, jops.vm_segment_reduce(
                    kinds, v, op, init, a, go, route="jnp"))


@pytest.mark.parametrize("name", ["edges", "spanning", "omega2", "quiet"])
def test_segment_reduce_plain_matches_pallas_across_tiles(name):
    """The reference's Pallas route (interpret mode; it re-splits the window
    into 256-token blocks) on add, one tile and a token."""
    rng = np.random.default_rng(17)
    n = T + 1
    kinds = _edge_windows(rng, n)[name]
    vals = _values(rng, n)
    for go, acc in ((True, -77), (False, 0)):
        want = jops.vm_segment_reduce(kinds, vals, "add", 0, acc, go,
                                      route="pallas", interpret=True)
        _same_reduce(tops.vm_segment_reduce(kinds, vals, "add", 0, acc, go),
                     want)


def test_segment_reduce_flat_layout():
    """``segment_reduce_flat`` is one buffer: kinds [2N], values [2N],
    count, carry; ``segment_reduce`` returns views of it."""
    rng = np.random.default_rng(3)
    n = T + 1
    kinds = torch.from_numpy(_edge_windows(rng, n)["random"].astype(np.int32))
    vals = torch.from_numpy(_values(rng, n).astype(np.int32))
    flat = tsr.segment_reduce_flat(kinds, vals, 2, "max", 9, True)
    ok, ov, cnt, carry = tsr.segment_reduce(kinds, vals, 2, "max", 9, True)
    assert flat.shape == (4 * n + 3,) and flat.dtype == torch.int32
    assert torch.equal(flat[:2 * n], ok) and torch.equal(flat[2 * n:4 * n], ov)
    assert int(flat[4 * n]) == int(cnt) and torch.equal(flat[4 * n + 1:],
                                                        carry)
    m = int(cnt)
    assert not ok[m:].any() and not ov[m:].any()        # zeros past count


@pytest.mark.parametrize("n", EDGE_NS)
def test_stream_compact_plain_at_tile_edges(n):
    """Masks that keep nothing, everything, one tile's edge rows, and random
    rows, against the reference's jnp route; the flat buffer holds the rows,
    zeros past the count, then the count."""
    rng = np.random.default_rng(n)
    kinds = rng.choice([0, 1, 2], size=n).astype(np.int64)
    edge = np.zeros(n, bool)
    edge[[e for t in range(T, n + 1, T) for e in (t - 1, t) if e < n]] = True
    for keep in (np.zeros(n, bool), np.ones(n, bool), edge,
                 rng.random(n) < 0.5):
        for d in (0, 1, 4):
            payload = (None if d == 0 else
                       rng.integers(I32_MIN, I32_MAX, (n, d)).astype(np.int64))
            gk, gp = tops.vm_compact(keep, kinds, payload)
            wk, wp = jops.vm_compact(keep, kinds, payload, route="jnp")
            np.testing.assert_array_equal(gk, wk)
            if payload is not None:
                np.testing.assert_array_equal(gp, wp)
        vals = torch.from_numpy(rng.integers(I32_MIN, I32_MAX, (n, 3))
                                .astype(np.int32))
        mask = torch.from_numpy(keep.astype(np.int32))
        flat = tsc.stream_compact_flat(mask, vals)
        out, cnt = tsc.stream_compact(mask, vals)
        assert flat.shape == (3 * n + 1,) and int(flat[-1]) == int(keep.sum())
        assert int(cnt) == int(keep.sum())
        assert torch.equal(flat[:-1].view(n, 3), out)
        assert torch.equal(out[:int(cnt)], vals[torch.from_numpy(keep)])
        assert not out[int(cnt):].any()


# ---------------------------------------------------------------------------
# the look-back algebra of csrc/segment_reduce.cu, in numpy
# ---------------------------------------------------------------------------

HB, D, EI, H = 1, 2, 4, 8         # flag bits of an aggregate, as in the .cu
IDENT = {"add": 0, "min": I32_MAX, "max": I32_MIN, "and": -1, "or": 0,
         "xor": 0}


def _combine(op, a, b):
    if op == "add":
        return ((a + b - I32_MIN) & 0xFFFFFFFF) + I32_MIN
    if op == "min":
        return min(a, b)
    if op == "max":
        return max(a, b)
    if op == "and":
        return a & b
    if op == "or":
        return a | b
    return a ^ b


def _token(op, k, x):
    """The aggregate of one token: (a, cnt, flags)."""
    if k > 0:
        return (IDENT[op], 1, HB | (D if k > 1 else 0) | (EI if k == 1 else 0))
    return (IDENT[op] if x is None else x, 0, H)


def _compose(op, A, B):
    """A then B."""
    (aa, ac, af), (ba, bc, bf) = A, B
    if bf & HB:
        extra = 1 if (af & H) and (bf & D) else 0
        d = (af & D) if af & HB else (0 if af & H else bf & D)
        ei = EI if (af | bf) & EI or af & H else 0
        return (ba, ac + bc + extra, HB | d | ei | (bf & H))
    return (_combine(op, aa, ba), ac, (af & (HB | D | EI)) | ((af | bf) & H))


def _apply(op, init, G, S):
    """The state (v, open, slots) after the tokens of aggregate G."""
    (a, cnt, f), (v, o, slots) = G, S
    if f & HB:
        slots += cnt + (1 if o and f & D else 0)
        v = _combine(op, init if (f & EI or o) else v, a)
        return (v, bool(f & H), slots)
    return (_combine(op, v, a), o or bool(f & H), slots)


def _walk(op, init, S, kinds, vals, out):
    """Emit one tile's tokens from its exclusive state, as the kernel's
    emission walk; returns the state after them."""
    v, o, slots = S
    for i, k in enumerate(kinds):
        if k > 0:
            emit = k == 1 or o
            if emit:
                out[slots] = (0, v)
                slots += 1
            if k > 1:
                out[slots] = (k - 1, 0)
                slots += 1
            v, o = (init if emit else v), False
        else:
            if vals is not None:
                v = _combine(op, v, int(vals[i]))
            o = True
    return (v, o, slots)


def _tile_model(kinds, vals, op, init, acc, go, rng):
    """The kernel's two-level algorithm with random tiles of 1-7 tokens and
    a look-back that stops at a random predecessor whose inclusive state is
    already published."""
    n = len(kinds)
    cuts = [0]
    while cuts[-1] < n:
        cuts.append(min(n, cuts[-1] + int(rng.integers(1, 8))))
    tiles = list(zip(cuts[:-1], cuts[1:]))
    aggs, incs, out = [], [], {}
    for t, (lo, hi) in enumerate(tiles):
        agg = (IDENT[op], 0, 0)
        for i in range(lo, hi):
            agg = _compose(op, agg, _token(
                op, int(kinds[i]), None if vals is None else int(vals[i])))
        aggs.append(agg)
        if t == 0:
            excl = (acc, go, 0)
        else:
            j = int(rng.integers(-1, t))         # -1: back to the carry-in
            run = (IDENT[op], 0, 0)
            for p in range(j + 1, t):
                run = _compose(op, run, aggs[p])
            excl = _apply(op, init, run, incs[j] if j >= 0 else (acc, go, 0))
        inc = _apply(op, init, agg, excl)
        end = _walk(op, init, excl, kinds[lo:hi],
                    None if vals is None else vals[lo:hi], out)
        assert end == inc                        # the walk ends where the
        incs.append(inc)                         # aggregate says
    v, o, m = incs[-1] if tiles else (acc, go, 0)
    assert sorted(out) == list(range(m))
    ok = np.array([out[s][0] for s in range(m)], np.int64)
    ov = np.array([out[s][1] for s in range(m)], np.int64)
    return ok, ov, v, o


@pytest.mark.parametrize("op", REDUCE_OPS)
def test_lookback_model_matches_oracle(op):
    rng = np.random.default_rng(100 + REDUCE_OPS.index(op))
    for _ in range(150):
        n = int(rng.integers(0, 40))
        kinds = rng.choice([0, 0, 0, 1, 2, 3], size=n).astype(np.int64)
        if rng.random() < 0.2:                   # long runs of one kind
            kinds = np.repeat(kinds[:4], 10)[:n]
        vals = rng.integers(-20, 20, size=n).astype(np.int64)
        if rng.random() < 0.5:
            vals = _values(rng, n)
        init = int(rng.integers(-4, 5))
        acc = int(rng.integers(I32_MIN, I32_MAX))
        for go, a in ((True, acc), (False, init), (False, acc)):
            for v in (vals, None):
                want = segment_reduce_window_np(kinds, v, op, init, a, go)
                _same_reduce(_tile_model(kinds, v, op, init, a, go, rng),
                             want)


@pytest.mark.parametrize("op", REDUCE_OPS)
def test_lookback_composition_is_associative(op):
    rng = np.random.default_rng(200 + REDUCE_OPS.index(op))

    def rand_agg():
        agg = (IDENT[op], 0, 0)
        for _ in range(int(rng.integers(0, 6))):
            k = int(rng.choice([0, 0, 1, 2, 3]))
            agg = _compose(op, agg, _token(op, k, int(rng.integers(-9, 9))))
        return agg

    ident = (IDENT[op], 0, 0)
    for _ in range(500):
        a, b, c = rand_agg(), rand_agg(), rand_agg()
        assert _compose(op, _compose(op, a, b), c) == \
            _compose(op, a, _compose(op, b, c))
        assert _compose(op, ident, a) == a == _compose(op, a, ident)
        s = (int(rng.integers(-9, 9)), bool(rng.random() < 0.5),
             int(rng.integers(0, 9)))
        assert _apply(op, 3, _compose(op, a, b), s) == \
            _apply(op, 3, b, _apply(op, 3, a, s))
