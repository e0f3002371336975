"""The attention kernels' grouped (GQA) contract against the JAX reference,
on the CPU.

The port's kernels index the kv row of each query row (``bh // G``) where
the reference repeats kv heads before its kernels (``jnp.repeat``, the
reference's ``kernels/ops.py:599-600``).  So each plain version here takes
grouped inputs, and the reference kernel (interpret mode, as its own tests
run it) takes the same inputs with K/V repeated.  The decode kernel's split
over the keys is held to the unsplit plain version through its plain
merge, ``decode_attention_split_plain``.

Tolerances: float32 2e-5 and bfloat16 2e-2 (the reference's kernel tests:
the sums run in another order, and bfloat16 rounds the output); the split
merge 1e-6 in float32 (the same scores, merged in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import decode_attention as ref_dec
from repro.kernels import flash_attention as ref_fa
from repro.kernels import ops as ref_ops
from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
SPLIT_TOL = 1e-6


def _t(a, dtype="float32"):
    return torch.from_numpy(np.asarray(a, np.float32)).to(TORCH[dtype])


def _j(a, dtype="float32"):
    return jnp.asarray(np.asarray(a, np.float32), JNP[dtype])


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _grouped(rng, bhkv, g, sq, skv, d):
    q = rng.standard_normal((bhkv * g, sq, d))
    k, v = (rng.standard_normal((bhkv, skv, d)) for _ in range(2))
    return q, k, v


# ---------------------------------------------------------------------------
# flash: grouped plain version against the reference kernel on repeated K/V
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("g", [1, 2, 7])
@pytest.mark.parametrize("d", [16, 64, 256])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_grouped_matches_reference_kernel(g, d, causal, dtype):
    rng = np.random.default_rng(100 * g + d)
    q, k, v = _grouped(rng, 2, g, 32, 64, d)          # Sq != Skv
    want = ref_fa.flash_attention(
        _j(q, dtype), jnp.repeat(_j(k, dtype), g, axis=0),
        jnp.repeat(_j(v, dtype), g, axis=0), causal=causal, block_q=32,
        block_k=32, interpret=True)
    got = fa.flash_attention(_t(q, dtype), _t(k, dtype), _t(v, dtype),
                             causal=causal)
    assert got.dtype == TORCH[dtype] and got.shape == q.shape
    _close(got, want, TOL[dtype])


# ---------------------------------------------------------------------------
# decode: grouped plain version against the reference kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("g", [1, 2, 7])
@pytest.mark.parametrize("d", [16, 64, 256])
def test_decode_plain_grouped_matches_reference_kernel(g, d):
    """Lengths 0 (every key masked: uniform weights), 1, S and past S; the
    reference kernel takes one length per query row, repeated G times."""
    rng = np.random.default_rng(200 * g + d)
    s = 256
    q, k, v = _grouped(rng, 4, g, 1, s, d)
    lengths = np.array([0, 1, s, s + 9])
    want = ref_dec.decode_attention(
        _j(q), jnp.repeat(_j(k), g, axis=0), jnp.repeat(_j(v), g, axis=0),
        jnp.repeat(jnp.asarray(lengths), g), block_k=128, interpret=True)
    got = dec.decode_attention(_t(q), _t(k), _t(v),
                               torch.from_numpy(lengths.astype(np.int32)))
    assert got.shape == q.shape
    _close(got, want, TOL["float32"])


# ---------------------------------------------------------------------------
# the split over the keys: its plain merge against the unsplit plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_split", [1, 2, 3, 7])
@pytest.mark.parametrize("g", [1, 3])
def test_decode_split_merge_matches_unsplit(n_split, g):
    """Chunks of ceil(300 / n_split) keys: 300, 150, 100 and 43.  Lengths
    end inside a chunk (7, 140, 251), at a chunk's edge (150, 100, 86, 43),
    at 0, at S and past S."""
    rng = np.random.default_rng(300 + n_split)
    s = 300
    lengths = np.array([7, 140, 251, 150, 100, 86, 43, 0, s, s + 1, 1])
    q, k, v = _grouped(rng, len(lengths), g, 1, s, 32)
    args = (_t(q), _t(k), _t(v), torch.from_numpy(lengths.astype(np.int32)))
    want = dec.decode_attention_plain(*args)
    got = dec.decode_attention_split_plain(*args, n_split=n_split)
    _close(got, want.numpy(), SPLIT_TOL)
    # the wrapper runs the unsplit plain version on a CPU tensor
    _close(dec.decode_attention(*args), want.numpy(), 0.0)


def test_decode_split_merge_empty_chunks():
    """S = 5 in 4 chunks of 2 keys: the last chunk holds none."""
    rng = np.random.default_rng(5)
    lengths = np.array([0, 1, 2, 5, 9])
    q, k, v = _grouped(rng, 5, 2, 1, 5, 16)
    args = (_t(q), _t(k), _t(v), torch.from_numpy(lengths.astype(np.int32)))
    _close(dec.decode_attention_split_plain(*args, n_split=4),
           dec.decode_attention_plain(*args).numpy(), SPLIT_TOL)


@pytest.mark.parametrize("bhkv,s,want", [
    (1, 100, 1), (1, 255, 1), (1, 256, 1), (1, 1024, 4), (8, 1024, 4),
    (4, 2048, 8), (64, 1024, 4), (56, 32768, 5), (264, 32768, 1),
    (2, 65536, 132)])
def test_decode_split_plan(bhkv, s, want):
    """Two waves of 132 SMs, chunks of at least 256 keys."""
    n = dec.split_plan(bhkv, s)
    assert n == want
    assert n == 1 or -(-s // n) >= dec.MIN_CHUNK


# ---------------------------------------------------------------------------
# ops.mha / ops.decode_mha on the kernel route: no K/V copies
# ---------------------------------------------------------------------------

def _no_copies(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("K/V copied to match heads")
    monkeypatch.setattr(ops, "_match_heads", refuse)
    monkeypatch.setattr(torch.Tensor, "repeat_interleave", refuse)


@pytest.mark.parametrize("hq,hkv", [(8, 2), (7, 1), (6, 3)])
@pytest.mark.parametrize("causal", [True, False])
def test_mha_kernel_route_indexes_kv_heads(monkeypatch, hq, hkv, causal):
    rng = np.random.default_rng(hq * hkv)
    q = rng.standard_normal((2, hq, 64, 32))
    k, v = (rng.standard_normal((2, hkv, 64, 32)) for _ in range(2))
    want = ref_ops.mha(_j(q), _j(k), _j(v), causal=causal, impl="pallas",
                       interpret=True)
    _no_copies(monkeypatch)
    got = ops.mha(_t(q), _t(k), _t(v), causal=causal, impl="kernel")
    _close(got, want, TOL["float32"])


@pytest.mark.parametrize("hq,hkv", [(8, 2), (7, 1), (6, 3)])
def test_decode_mha_kernel_route_indexes_kv_heads(monkeypatch, hq, hkv):
    rng = np.random.default_rng(10 + hq * hkv)
    q = rng.standard_normal((3, hq, 1, 16))
    k, v = (rng.standard_normal((3, hkv, 512, 16)) for _ in range(2))
    lengths = np.array([5, 512, 300])
    want = ref_ops.decode_mha(_j(q), _j(k), _j(v), jnp.asarray(lengths),
                              impl="pallas", interpret=True)
    _no_copies(monkeypatch)
    got = ops.decode_mha(_t(q), _t(k), _t(v), torch.from_numpy(lengths),
                         impl="kernel")
    _close(got, want, TOL["float32"])


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def test_wrappers_refuse_bhq_not_a_multiple_of_bhkv():
    q = torch.zeros(5, 4, 16)
    k = torch.zeros(2, 4, 16)
    for fn in (fa.flash_attention, fa.flash_attention_plain):
        with pytest.raises(ValueError, match="not a multiple of BHkv"):
            fn(q, k, k)
    lengths = torch.ones(2, dtype=torch.int32)
    for fn in (dec.decode_attention, dec.decode_attention_plain):
        with pytest.raises(ValueError, match="not a multiple of BHkv"):
            fn(q[:, :1], k, k, lengths)
    with pytest.raises(ValueError, match="not a multiple of BHkv"):
        dec.decode_attention_split_plain(q[:, :1], k, k, lengths, 2)


def test_decode_refuses_lengths_per_query_row():
    """Lengths are per kv row: [BHkv], not [BHq]."""
    q, k = torch.zeros(4, 1, 16), torch.zeros(2, 8, 16)
    with pytest.raises(TypeError, match=r"int32 \[BHkv\]"):
        dec.decode_attention(q, k, k, torch.ones(4, dtype=torch.int32))


@pytest.mark.parametrize("n_split", [0, 9])
def test_decode_refuses_n_split_outside_one_to_s(n_split):
    q, k = torch.zeros(2, 1, 16), torch.zeros(2, 8, 16)
    with pytest.raises(ValueError, match="n_split"):
        dec.decode_attention_split_plain(q, k, k,
                                         torch.ones(2, dtype=torch.int32),
                                         n_split)


def test_decode_heads_per_group_instances():
    """G query rows per kv row fit the split kernel's kH instances (groups
    of D/8 lanes in 256 threads), and a larger G is refused."""
    assert dec._heads_per_group(64, 7) == 1          # 32 groups
    assert dec._heads_per_group(256, 16) == 2        # 8 groups
    assert dec._heads_per_group(128, 1) == 1
    with pytest.raises(ValueError, match="exceeds 16"):
        dec._heads_per_group(256, 17)
