"""The resident loop's tick primitives (``repro_torch.kernels.device_loop``)
against the reference's ``repro.kernels.device_loop`` on the same seeded
int32 inputs, bit for bit; the device-carry segmented reduction against the
numpy oracle; and twins of the reference's ring and capacity tests
(``tests/test_device_vm.py``).

Where the reference leaves stale rows past a count, only the first
``count`` rows are compared (the port's kernels write zeros there).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.kernels.device_loop as ref_dl
from repro.core import ir
from repro.core.backend import _vec_binop, segment_reduce_window_np
from repro_torch.apps import ALL_APPS
from repro_torch.core.compiler import compile_program
from repro_torch.core.device_vm import (DeviceProgram, QueueOverflow,
                                        resident_unsupported)
from repro_torch.core.vector_vm import VLEN
from repro_torch.kernels import device_loop as dl
from repro_torch.kernels.segment_reduce import (OPS, segment_reduce_carry,
                                                segment_reduce_carry_plain)

I32_MIN, I32_MAX = -(1 << 31), (1 << 31) - 1
EDGES = np.array([0, 1, -1, 2, -2, 3, -3, 7, 31, 32, 33, 63, 64, -32, 255,
                  0x7FFF, 0x10000, I32_MAX, I32_MIN, I32_MIN + 1, 12345,
                  -98765], np.int64)


def _t(a):
    return torch.tensor(np.asarray(a, np.int32))


def _operands(seed):
    a, b = (x.ravel() for x in np.meshgrid(EDGES, EDGES))
    rng = np.random.default_rng(seed)
    a = np.concatenate([a, rng.integers(I32_MIN, I32_MAX + 1, 400)])
    b = np.concatenate([b, rng.integers(I32_MIN, I32_MAX + 1, 200),
                        rng.integers(-40, 40, 200)])
    return a, b


@pytest.mark.parametrize("op", sorted(ir.BINOPS))
def test_dev_binop_matches_reference_and_oracle(op):
    """Every IR binop on edge values (0, ±1, shift counts past 31, the int32
    extremes) and random ones: equal to the numpy oracle everywhere, and to
    the reference's ``dev_binop`` except where the reference itself departs
    from the oracle — ``sdiv``/``smod`` with ``INT32_MIN`` as either
    operand, whose int32 ``abs`` overflows there."""
    a, b = _operands(sorted(ir.BINOPS).index(op))
    got = dl.dev_binop(op, _t(a), _t(b)).long().numpy()
    np.testing.assert_array_equal(got, _vec_binop(op, a, b), err_msg=op)
    ref = np.asarray(ref_dl.dev_binop(op, jnp.asarray(a, jnp.int32),
                                      jnp.asarray(b, jnp.int32)), np.int64)
    held = ~(((a == I32_MIN) | (b == I32_MIN)) & (op in ("sdiv", "smod")))
    np.testing.assert_array_equal(got[held], ref[held], err_msg=op)


def _window(rng, w, n, levels=3):
    kinds = rng.choice(np.arange(levels + 1), w,
                       p=[0.6] + [0.4 / levels] * levels).astype(np.int32)
    vals = rng.integers(I32_MIN, I32_MAX + 1, w).astype(np.int32)
    rids = rng.integers(0, 4, w).astype(np.int32)
    return kinds, vals, rids


@pytest.mark.parametrize("with_vals", [True, False])
@pytest.mark.parametrize("op", ref_dl.SCATTER_REDUCE_OPS)
def test_segment_reduce_window_matches_reference(op, with_vals):
    """One reduce window with a carry: the emitted kinds, values and rids
    (the first ``count``) and the new carry equal the reference's
    fixed-shape form, on windows of VLEN lanes with every valid count."""
    rng = np.random.default_rng(OPS.index(op) * 2 + with_vals)
    for t in range(60):
        n = int(rng.integers(0, VLEN + 1)) if t % 6 else 0
        kinds, vals, rids = _window(rng, VLEN, n)
        acc = int(rng.integers(I32_MIN, I32_MAX + 1))
        init = int(rng.integers(-5, 5))
        opened = bool(rng.integers(0, 2))
        want = ref_dl.segment_reduce_window(
            jnp.asarray(kinds), jnp.asarray(vals) if with_vals else None,
            jnp.asarray(rids), jnp.int32(n), op, init, jnp.int32(acc),
            jnp.asarray(opened))
        carry = _t([acc, opened])
        got = dl.segment_reduce_window(
            _t(kinds), _t(vals) if with_vals else None, _t(rids),
            torch.tensor(n, dtype=torch.int32), op, init, carry)
        cnt = int(want[3])
        assert int(got[3]) == cnt
        for g, r in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(g.numpy()[:cnt],
                                          np.asarray(r)[:cnt])
            assert not g.numpy()[cnt:].any()      # zeros past the count
        assert carry.tolist() == [int(want[4]), int(bool(want[5]))]
        if n == 0:
            assert carry.tolist() == [acc, int(opened)]


def _emission_rids(kinds, rids, opened):
    """The rid of every token the sequential reduce machine emits."""
    out = []
    for k, r in zip(kinds, rids):
        if k == 0:
            opened = True
            continue
        if k == 1 or opened:
            out.append(r)
        if k > 1:
            out.append(r)
        opened = False
    return np.array(out, np.int64)


@pytest.mark.parametrize("op", OPS)
def test_device_carry_plain_matches_oracle(op):
    """The device-carry entry's plain version (what the CUDA kernel is held
    to on the card) equals ``segment_reduce_window_np`` on the valid lanes,
    for every reduce op the kernel takes."""
    rng = np.random.default_rng(40 + OPS.index(op))
    for t in range(40):
        w = int(rng.choice([1, 5, VLEN, 2 * VLEN]))
        n = int(rng.integers(0, w + 1))
        kinds, vals, rids = _window(rng, w, n)
        acc, opened = int(rng.integers(-1000, 1000)), bool(t % 2)
        carry = _t([acc, opened])
        ok, ov, orid, count = segment_reduce_carry(
            _t(kinds), _t(vals), _t(rids), torch.tensor(n, dtype=torch.int32),
            op, 3, carry)
        wk, wv, wacc, wopen = segment_reduce_window_np(
            kinds[:n], vals[:n].astype(np.int64), op, 3, acc, opened)
        c = int(count)
        assert c == len(wk)
        np.testing.assert_array_equal(ok.numpy()[:c], wk)
        np.testing.assert_array_equal(ov.numpy()[:c], wv)
        assert carry.tolist() == [wacc, int(wopen)]
        # each emission carries the rid of the barrier that emits it
        np.testing.assert_array_equal(orid.numpy()[:c],
                                      _emission_rids(kinds[:n], rids, opened))
        assert not orid.numpy()[c:].any()


def test_device_carry_checks_its_inputs():
    k = _t([0, 1])
    with pytest.raises(TypeError, match="carry"):
        segment_reduce_carry_plain(k, None, _t([0, 0]),
                                   torch.tensor(2, dtype=torch.int32), "add",
                                   0, torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="window"):
        segment_reduce_carry_plain(
            torch.zeros(5000, dtype=torch.int32), None,
            torch.zeros(5000, dtype=torch.int32),
            torch.tensor(1, dtype=torch.int32), "add", 0,
            torch.zeros(2, dtype=torch.int32))


@pytest.mark.parametrize("size", [1, 7, 40])
def test_atomic_add_window_matches_reference(size):
    """Fetch-and-add with duplicate addresses: each lane sees the earlier
    ok lanes' deltas on its address; memory equal to the reference's (the
    port's buffer ends in a dump slot, which is not compared)."""
    rng = np.random.default_rng(size)
    for t in range(25):
        mem = rng.integers(-100, 100, size).astype(np.int32)
        addr = rng.integers(0, size, VLEN).astype(np.int32)
        delta = rng.integers(I32_MIN, I32_MAX + 1, VLEN).astype(np.int32)
        ok = rng.random(VLEN) < (0.2 + 0.03 * t)
        want_mem, want_old = ref_dl.atomic_add_window(
            jnp.asarray(mem), jnp.asarray(addr), jnp.asarray(delta),
            jnp.asarray(ok), jnp.arange(VLEN, dtype=jnp.int32))
        got_mem = _t(np.concatenate([mem, [0]]))
        got_old = dl.atomic_add_window(got_mem, _t(addr), _t(delta),
                                       torch.tensor(ok))
        np.testing.assert_array_equal(got_old.numpy(), np.asarray(want_old))
        np.testing.assert_array_equal(got_mem.numpy()[:-1],
                                      np.asarray(want_mem))


def test_leading_run_and_first_index_match_reference():
    rng = np.random.default_rng(7)
    for t in range(100):
        mask = rng.random(VLEN) < (t / 100)
        n = int(rng.integers(0, VLEN + 1))
        assert int(dl.leading_run(torch.tensor(mask),
                                  torch.tensor(n, dtype=torch.int32))) == \
            int(ref_dl.leading_run(jnp.asarray(mask), jnp.int32(n)))
        assert int(dl.first_index(torch.tensor(mask),
                                  torch.tensor(n, dtype=torch.int32))) == \
            int(ref_dl.first_index(jnp.asarray(mask), jnp.int32(n)))


# ---------------------------------------------------------------------------
# ring invariants (twins of tests/test_device_vm.py): absolute head/tail
# counters & (cap-1), a scratch pad past cap
# ---------------------------------------------------------------------------

PAD = 8


def _ring(cap: int, nv: int = 2):
    return (torch.zeros(cap + PAD, dtype=torch.int32),
            torch.zeros(cap + PAD, nv, dtype=torch.int32))


def _push(kinds, vals, tail, used, cap, ks, vs):
    over, written = dl.ring_push(
        kinds, vals, torch.tensor(tail, dtype=torch.int32),
        torch.tensor(used, dtype=torch.int32), cap, _t(ks), _t(vs),
        torch.tensor(len(ks), dtype=torch.int32))
    assert int(written) == (0 if bool(over) else len(ks))
    return bool(over)


def _peek(kinds, vals, head, cap, width):
    k, v = dl.ring_peek(kinds, vals, torch.tensor(head, dtype=torch.int32),
                        cap, width)
    return k.numpy(), v.numpy()


def test_ring_fifo_roundtrip():
    cap = 8
    kinds, vals = _ring(cap)
    ks = [0, 0, 1, 2]
    vs = [[10, 0], [11, 1], [0, 2], [0, 0]]
    assert not _push(kinds, vals, 0, 0, cap, ks, vs)
    k, v = _peek(kinds, vals, 0, cap, 4)
    np.testing.assert_array_equal(k, ks)
    np.testing.assert_array_equal(v, vs)


def test_ring_wraparound_keeps_fifo_order():
    cap = 8
    kinds, vals = _ring(cap)
    _push(kinds, vals, 0, 0, cap, [0] * 6, [[i, i] for i in range(6)])
    ks = [0, 1, 0, 2]
    vs = [[7, 0], [0, 1], [9, 2], [0, 3]]
    assert not _push(kinds, vals, 6, 0, cap, ks, vs)
    k, v = _peek(kinds, vals, 6, cap, 4)
    np.testing.assert_array_equal(k, ks)
    np.testing.assert_array_equal(v[:, 1], [0, 1, 2, 3],
                                  err_msg="rid column lost across the wrap")


def test_ring_overflow_writes_nothing():
    cap = 8
    kinds, vals = _ring(cap)
    assert not _push(kinds, vals, 0, 0, cap, [0] * 7,
                     [[i, 0] for i in range(1, 8)])
    before_k, before_v = kinds.clone(), vals.clone()
    assert _push(kinds, vals, 7, 7, cap, [0, 0], [[8, 0], [9, 0]]), \
        "7 used + 2 pushed > cap 8 must overflow"
    assert torch.equal(kinds, before_k), "overflow corrupted the ring"
    assert torch.equal(vals, before_v)


def test_ring_matches_reference_over_random_traffic():
    """Random pushes and pops of random widths: the live slots the port
    peeks equal the reference's, wrap seams and stale lanes included."""
    rng = np.random.default_rng(3)
    cap, width, pad = 32, 8, 16
    rk, rv = (jnp.zeros(cap + pad, jnp.int32),
              jnp.zeros((cap + pad, 2), jnp.int32))
    pk, pv = (torch.zeros(cap + pad, dtype=torch.int32),
              torch.zeros(cap + pad, 2, dtype=torch.int32))
    head = tail = 0
    for _ in range(200):
        n = int(rng.integers(0, width + 1))
        kb = rng.integers(0, 3, width).astype(np.int32)
        vb = rng.integers(-9, 9, (width, 2)).astype(np.int32)
        rk, rv, rover = ref_dl.ring_push(rk, rv, jnp.int32(tail),
                                         jnp.int32(tail - head), cap,
                                         jnp.asarray(kb), jnp.asarray(vb),
                                         jnp.int32(n))
        pover, _ = dl.ring_push(
            pk, pv, torch.tensor(tail, dtype=torch.int32),
            torch.tensor(tail - head, dtype=torch.int32), cap, _t(kb),
            _t(vb), torch.tensor(n, dtype=torch.int32))
        assert bool(rover) == bool(pover)
        if not bool(pover):
            tail += n
        wk, wv = ref_dl.ring_peek(rk, rv, jnp.int32(head), cap, width)
        gk, gv = _peek(pk, pv, head, cap, width)
        np.testing.assert_array_equal(gk, np.asarray(wk))
        np.testing.assert_array_equal(gv, np.asarray(wv))
        head += int(rng.integers(0, tail - head + 1))
    np.testing.assert_array_equal(pk.numpy()[:cap], np.asarray(rk)[:cap])


def test_window_compact_preserves_order_and_rid():
    keep = torch.tensor([1, 0, 1, 1, 0], dtype=torch.bool)
    k_in = _t([0, 9, 1, 0, 9])
    v_in = _t([[5, 0], [0, 0], [0, 1], [7, 2], [0, 0]])
    k_out, v_out, count = dl.window_compact(keep, k_in, v_in)
    assert int(count) == 3
    np.testing.assert_array_equal(k_out.numpy()[:3], [0, 1, 0])
    np.testing.assert_array_equal(v_out.numpy()[:3, 1], [0, 1, 2])


def test_window_compact_matches_reference():
    rng = np.random.default_rng(11)
    for _ in range(20):
        keep = rng.random(2 * VLEN) < 0.5
        k_in = rng.integers(0, 4, 2 * VLEN).astype(np.int32)
        v_in = rng.integers(-50, 50, (2 * VLEN, 3)).astype(np.int32)
        wk, wv, wc = ref_dl.window_compact(jnp.asarray(keep),
                                           jnp.asarray(k_in),
                                           jnp.asarray(v_in))
        gk, gv, gc = dl.window_compact(torch.tensor(keep), _t(k_in),
                                       _t(v_in))
        c = int(wc)
        assert int(gc) == c
        np.testing.assert_array_equal(gk.numpy()[:c], np.asarray(wk)[:c])
        np.testing.assert_array_equal(gv.numpy()[:c], np.asarray(wv)[:c])


# ---------------------------------------------------------------------------
# host-side capacity pre-check + overflow diagnostics
# ---------------------------------------------------------------------------

def _dfg(name="murmur3"):
    return compile_program(ALL_APPS[name]().prog).dfg


def test_capacity_precheck_names_link():
    g = _dfg()
    lid = sorted(g.links)[0]
    with pytest.raises(QueueOverflow) as ei:
        DeviceProgram(g, queue_caps={lid: 64}, device="cpu")
    assert ei.value.link == lid and ei.value.capacity == 64
    assert f"link {lid}" in str(ei.value)


def test_capacity_precheck_rejects_non_pow2():
    g = _dfg()
    lid = sorted(g.links)[0]
    with pytest.raises(QueueOverflow):
        DeviceProgram(g, queue_caps={lid: 4 * VLEN + 1}, device="cpu")


def test_runtime_overflow_decode_names_link_and_capacity():
    """The tick latches ``err = ring_row + 1``; the host decode names the
    link's variables and capacity, not an opaque code."""
    dp = DeviceProgram(_dfg(), device="cpu")
    lid = dp.lids[0]
    with pytest.raises(QueueOverflow) as ei:
        dp._raise_err(dp.row_of[lid] + 1)
    assert ei.value.link == lid and ei.value.capacity == dp.caps[lid]
    assert "queue_caps=" in str(ei.value)
    with pytest.raises(QueueOverflow, match="source queue"):
        dp._raise_err(dp.src_row + 1)


def test_resident_unsupported_is_the_reference_list():
    """The port's fallback list is the reference's: and/or/xor reduces
    fall back although the port's kernel covers them."""
    g = _dfg("strlen")
    red = [o for c in g.contexts.values() for o in c.outs
           if o.kind == "reduce"]
    assert red and not resident_unsupported(g)
    for op in ("and", "or", "xor"):
        red[0].reduce_op = op
        assert op in "; ".join(resident_unsupported(g))
