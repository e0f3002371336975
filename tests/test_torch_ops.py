"""The PyTorch port's executor entry points (``repro_torch.kernels.ops``) and
its two kernels' plain versions, held against the JAX reference.

The same seeded numpy inputs go through ``repro.kernels.ops`` (the jnp route,
or the Pallas kernels in interpret mode) and through the port on the CPU,
where the port's wrappers run their plain torch versions.  Everything is
int32-exact, so every comparison is exact equality.  The CUDA kernels
themselves are held against their plain versions in ``test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

from repro.core import ir
from repro.core.backend import segment_reduce_window_np
from repro.kernels import ops as jops
from repro_torch.kernels import ops as tops
from repro_torch.kernels import segment_reduce as tsr
from repro_torch.kernels import stream_compact as tsc

I32_MIN, I32_MAX = -(1 << 31), (1 << 31) - 1
TRICKY = np.array([0, 1, -1, 2, -2, 3, 31, 32, 33, 63, 64, 100, 12345,
                   -54321, I32_MAX, I32_MIN, I32_MIN + 1], np.int64)
REDUCE_OPS = ("add", "min", "max", "and", "or", "xor")


def _pairs(rng, n_random=64):
    """Every pair of tricky values (INT_MIN / -1, x / 0, shift counts >= 32)
    plus random int32 pairs, as int64 windows."""
    a = np.concatenate([np.repeat(TRICKY, len(TRICKY)),
                        rng.integers(I32_MIN, I32_MAX, n_random)])
    b = np.concatenate([np.tile(TRICKY, len(TRICKY)),
                        rng.integers(I32_MIN, I32_MAX, n_random)])
    return a.astype(np.int64), b.astype(np.int64)


def _window(rng, n, max_bar=3):
    kinds = rng.choice([0, 0, 0, 1, 2, max_bar], size=n).astype(np.int64)
    vals = rng.integers(I32_MIN, I32_MAX, size=n).astype(np.int64)
    return kinds, vals


def _same_reduce(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert tuple(got[2:]) == tuple(want[2:])


# ---------------------------------------------------------------------------
# element-wise windows and run selection against the jnp route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", sorted(ir.BINOPS))
def test_vm_binop_matches_reference(op):
    a, b = _pairs(np.random.default_rng(1))
    got = tops.vm_binop(op, a, b)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, jops.vm_binop(op, a, b), err_msg=op)


@pytest.mark.parametrize("op", ["neg", "not"])
def test_vm_unop_matches_reference(op):
    a, _ = _pairs(np.random.default_rng(2))
    np.testing.assert_array_equal(tops.vm_unop(op, a), jops.vm_unop(op, a))


def test_vm_select_matches_reference():
    rng = np.random.default_rng(3)
    a, b = _pairs(rng)
    c = rng.choice([0, 1, -1, I32_MIN], size=len(a)).astype(np.int64)
    np.testing.assert_array_equal(tops.vm_select(c, a, b),
                                  jops.vm_select(c, a, b))


def test_vm_run_selection_matches_reference():
    rng = np.random.default_rng(4)
    for n in list(range(0, 40)) + [127, 128, 129, 512]:
        kinds, _ = _window(rng, n)
        assert tops.vm_data_run(kinds) == jops.vm_data_run(kinds)
        zeros = np.zeros(n, np.int64)              # all-data window
        assert tops.vm_data_run(zeros) == jops.vm_data_run(zeros) == n
    for _ in range(40):
        n = int(rng.integers(1, 30))
        ref = rng.choice([0, 1, 2], size=n).astype(np.int64)
        others = [ref.copy(), ref.copy(), np.concatenate([ref, [5]])]
        if rng.random() < 0.7:
            others[int(rng.integers(0, 2))][int(rng.integers(0, n))] += 1
        assert tops.vm_first_mismatch(ref, others) == \
            jops.vm_first_mismatch(ref, others)
    assert tops.vm_first_mismatch(np.zeros(3, np.int64), []) == 3


# ---------------------------------------------------------------------------
# compaction: vm_compact and the plain kernel version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route", ["jnp", "pallas"])
def test_vm_compact_matches_reference(route):
    rng = np.random.default_rng(5)
    for n in (0, 1, 5, 127, 128, 129, 300):
        kinds, _ = _window(rng, n)
        keep = rng.random(n) < 0.5
        for d in (0, 1, 3):
            payload = (None if d == 0 else
                       rng.integers(I32_MIN, I32_MAX, (n, d)).astype(np.int64))
            gk, gp = tops.vm_compact(keep, kinds, payload)
            wk, wp = jops.vm_compact(keep, kinds, payload, route=route,
                                     interpret=True)
            np.testing.assert_array_equal(gk, wk)
            if payload is None:
                assert gp is None and wp is None
            else:
                np.testing.assert_array_equal(gp, wp)


@pytest.mark.parametrize("n,d", [(256, 8), (512, 4), (1024, 16), (96, 2)])
def test_plain_stream_compact_matches_pallas(n, d):
    """The N/D sweep of the reference's own kernel test, int32 payloads."""
    rng = np.random.default_rng(n + d)
    mask = rng.integers(0, 2, n).astype(np.int32)
    vals = rng.integers(I32_MIN, I32_MAX, (n, d)).astype(np.int32)
    want, wcnt = jops.stream_compact(mask, vals, interpret=True)
    got, cnt = tsc.stream_compact(torch.from_numpy(mask),
                                  torch.from_numpy(vals))
    assert int(cnt) == int(wcnt)
    assert got.shape == (n, d) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy()[:int(cnt)],
                                  np.asarray(want)[:int(wcnt)])
    assert not got[int(cnt):].any()                # zero past the count


def test_stream_compact_rejects_bad_inputs():
    m = torch.ones(4, dtype=torch.int32)
    with pytest.raises(TypeError):
        tsc.stream_compact(m, torch.ones((4, 2), dtype=torch.int64))
    with pytest.raises(ValueError):
        tsc.stream_compact(m, torch.ones((5, 2), dtype=torch.int32))
    with pytest.raises(ValueError):
        tsc.stream_compact(m, torch.ones((2, 4), dtype=torch.int32).t())


# ---------------------------------------------------------------------------
# segmented reduction
# ---------------------------------------------------------------------------

def test_vm_segment_reduce_carry_across_blocks():
    """One segment longer than the reference's 256-token block."""
    kinds = np.zeros(600, np.int64)
    kinds[-1] = 1
    vals = np.ones(600, np.int64)
    want = jops.vm_segment_reduce(kinds, vals, "add", 0, 0, False,
                                  route="pallas", interpret=True)
    got = tops.vm_segment_reduce(kinds, vals, "add", 0, 0, False)
    _same_reduce(got, want)
    _same_reduce(got, segment_reduce_window_np(kinds, vals, "add", 0, 0,
                                               False))
    assert int(got[1][0]) == 599


def test_vm_segment_reduce_long_segment_exact():
    """A segment of 1000 max-half values: exact past 2^24."""
    n = 1000
    kinds = np.concatenate([np.zeros(n, np.int64), [1, 2]]).astype(np.int64)
    vals = np.concatenate([np.full(n, 0xFFFF, np.int64), [0, 0]])
    want = jops.vm_segment_reduce(kinds, vals, "add", 0, 0, False,
                                  route="pallas", interpret=True)
    got = tops.vm_segment_reduce(kinds, vals, "add", 0, 0, False)
    _same_reduce(got, want)
    assert int(got[1][0]) == ((n * 0xFFFF) & 0xFFFFFFFF)


def test_vm_segment_reduce_random_windows_pallas():
    rng = np.random.default_rng(9)
    for _ in range(6):
        n = int(rng.integers(1, 700))
        kinds = rng.choice([0, 0, 0, 0, 1, 2], size=n).astype(np.int64)
        vals = rng.integers(I32_MIN, I32_MAX, size=n).astype(np.int64)
        acc = int(rng.integers(-100, 100))
        go = bool(rng.random() < 0.5) or acc == 0
        if not go:
            acc = 0                  # the Pallas route's non-degenerate state
        want = jops.vm_segment_reduce(kinds, vals, "add", 0, acc, go,
                                      route="pallas", interpret=True)
        _same_reduce(tops.vm_segment_reduce(kinds, vals, "add", 0, acc, go),
                     want)


@pytest.mark.parametrize("op", REDUCE_OPS)
def test_vm_segment_reduce_every_op_and_carry(op):
    """All six ops, open / closed / degenerate (closed, acc != init) carries
    and ``vals=None``, against the numpy oracle and the reference entry
    point (which hands what its kernel cannot cover to the oracle)."""
    rng = np.random.default_rng(REDUCE_OPS.index(op))
    for _ in range(40):
        n = int(rng.integers(0, 60))
        kinds, vals = _window(rng, n)
        init = int(rng.integers(-4, 5))
        acc = int(rng.integers(I32_MIN, I32_MAX))
        for go, a in ((True, acc), (False, init), (False, acc)):
            for v in (vals, None):
                got = tops.vm_segment_reduce(kinds, v, op, init, a, go)
                _same_reduce(got, segment_reduce_window_np(kinds, v, op, init,
                                                           a, go))
                _same_reduce(got, jops.vm_segment_reduce(kinds, v, op, init,
                                                         a, go, route="jnp"))


def test_segment_reduce_empty_group_distinctions():
    """[[ ]] -> [0] ; [[],[]] -> [0,0] ; [] -> [] (§III-A(b))."""
    for kinds, want in (([1, 2], [0, 1]), ([2], [1]), ([1, 1, 2], [0, 0, 1])):
        k = torch.tensor(kinds, dtype=torch.int32)
        ok, ov, cnt, carry = tsr.segment_reduce(k, torch.zeros_like(k))
        assert ok[:int(cnt)].tolist() == want
        assert carry.tolist() == [0, 0]


def test_segment_reduce_rejects_bad_inputs():
    k = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(NotImplementedError):
        tsr.segment_reduce(k, k, op="mul")
    with pytest.raises(TypeError):
        tsr.segment_reduce(k.long(), None)
    with pytest.raises(TypeError):
        tsr.segment_reduce(k, torch.zeros(5, dtype=torch.int32))
