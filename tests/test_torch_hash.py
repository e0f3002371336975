"""The port's hash probe (``ops.hash_lookup`` and the ``hash_probe`` kernel's
plain version) against the JAX reference, on the CPU.

Same keys and tables (numpy, from a seed) through the reference's
``ops.hash_lookup`` (its Pallas kernel in interpret mode, as
``tests/test_kernels.py`` runs it, or its XLA loop above 2^20 table entries)
and through the port.  Values and found flags are int32: every comparison
is exact.
"""
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_oracle
from repro_torch.apps import ALL_APPS
from repro_torch.kernels import hash_probe as hp
from repro_torch.kernels import ops, ref

I32_MIN = -(1 << 31)


def _table(rng, n_slots, load, key_range=(1, 1 << 16), signed=False):
    """An n_slots open-addressing table at ``load``, built with the hash and
    linear probing of the reference's test, duplicated to 2 * n_slots."""
    lo, hi = key_range
    pool = np.arange(lo, hi)
    if signed:
        pool = np.concatenate([-pool, pool])
    keys = rng.choice(pool, int(n_slots * load), replace=False)
    vals = rng.integers(1, 1 << 16, len(keys))
    tk = np.zeros(2 * n_slots, np.int64)
    tv = np.zeros(2 * n_slots, np.int64)
    for k, v in zip(keys, vals):
        h = ref_oracle._mix_ref(int(k)) % n_slots
        while tk[h] != 0:
            h = (h + 1) % n_slots
        tk[h], tv[h] = k, v
    tk[n_slots:] = tk[:n_slots]
    tv[n_slots:] = tv[:n_slots]
    return keys, tk, tv


def _queries(rng, keys, n):
    """Half hits, half misses (keys outside the table's range)."""
    hits = rng.choice(keys, n - n // 2)
    misses = rng.integers(1 << 17, 1 << 18, n // 2)
    return np.concatenate([hits, misses])


def _port(keys, tk, tv, n_slots, max_probes=16):
    v, f = ops.hash_lookup(keys, tk, tv, n_slots, max_probes, device="cpu")
    assert v.dtype == f.dtype == torch.int32 and v.device.type == "cpu"
    return v.numpy(), f.numpy()


def _reference(keys, tk, tv, n_slots, max_probes=16):
    v, f = ref_ops.hash_lookup(keys, tk, tv, n_slots, max_probes)
    return np.asarray(v), np.asarray(f)


@pytest.mark.parametrize("n_slots,n_keys", [(128, 64), (512, 256),
                                            (1000, 300), (512, 1)])
def test_hash_lookup_matches_reference(n_slots, n_keys):
    """``tests/test_kernels.py``'s cases, then n_slots no power of two and
    N no multiple of the reference's 256-key block."""
    rng = np.random.default_rng(7)
    keys, tk, tv = _table(rng, n_slots, 0.25)
    q = _queries(rng, keys, n_keys)
    got, want = _port(q, tk, tv, n_slots), _reference(q, tk, tv, n_slots)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(
        got[1], ref.hash_probe_ref(q, tk, tv, n_slots)[1])
    assert got[1][: n_keys - n_keys // 2].all() and not got[1][
        n_keys - n_keys // 2:].any()


def test_hash_lookup_negative_and_wide_keys():
    """Negative int32 keys in the table and among the queries; int64 keys at
    or above 2^31, which both sides wrap to int32 and hash as uint32."""
    rng = np.random.default_rng(8)
    n_slots = 256
    keys, tk, tv = _table(rng, n_slots, 0.5, signed=True)
    wide = np.array([(1 << 32) + int(k) if k < 0 else int(k)
                     for k in keys[:20]], np.int64)
    q = np.concatenate([_queries(rng, keys, 100), wide,
                        [-5, I32_MIN + 1, (1 << 31) + 7, 0]])
    got, want = _port(q, tk, tv, n_slots), _reference(q, tk, tv, n_slots)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[1][100:120].all()              # the wide keys are found


def test_hash_lookup_large_table_takes_the_same_path():
    """Above 2^20 entries the reference leaves its kernel for the XLA loop;
    the port's probe serves the table the same way (here its plain version:
    the tensors lie on the CPU)."""
    rng = np.random.default_rng(9)
    n_slots = (1 << 19) + 3
    assert 2 * n_slots > ref_ops.VMEM_TABLE_LIMIT
    keys, tk, tv = _table(rng, n_slots, 0.01, key_range=(1, 1 << 24))
    q = _queries(rng, keys, 300)
    got, want = _port(q, tk, tv, n_slots), _reference(q, tk, tv, n_slots)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_hash_lookup_past_the_end_of_a_full_table():
    """A full table (no EMPTY slot) and more probes than the padded table
    holds past h: the port stops at the end of the table.  The reference
    reads past it with ``jnp.take``, whose out-of-range fill is INT32_MIN,
    so its only difference is that key INT32_MIN is "found" with value
    INT32_MIN (ROADMAP Queue 3)."""
    n_slots = 8
    tk = np.tile(np.arange(1, n_slots + 1), 2)
    tv = np.tile(np.arange(100, 100 + n_slots), 2)
    q = np.array([I32_MIN, 5, 12345, 0, -7, 8], np.int64)
    for max_probes in (16, 40):
        got = _port(q, tk, tv, n_slots, max_probes)
        want = _reference(q, tk, tv, n_slots, max_probes)
        oracle = ref.hash_probe_ref(q, tk, tv, n_slots, max_probes)
        for g, w, o in zip(got, want, oracle):
            np.testing.assert_array_equal(g, o)
            np.testing.assert_array_equal(g[1:], w[1:])
        assert (got[0][0], got[1][0]) == (0, 0)
        assert (want[0][0], want[1][0]) == (I32_MIN, 1)


def test_hash_probe_plain_matches_the_oracle_on_key_zero_and_chains():
    """Key 0 (EMPTY) is found at an empty slot, as the reference's hit test
    runs before its empty test; max_probes cuts long chains short."""
    rng = np.random.default_rng(10)
    n_slots = 64
    keys, tk, tv = _table(rng, n_slots, 0.75)
    q = np.concatenate([keys, [0], rng.integers(1 << 17, 1 << 18, 30)])
    for max_probes in (0, 1, 3, 16, 200):
        got = _port(q, tk, tv, n_slots, max_probes)
        want = ref.hash_probe_ref(q, tk, tv, n_slots, max_probes)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert got[1][len(keys)] == (max_probes > 0)   # key 0


def test_hash_probe_serves_the_hash_table_app():
    """The hash_table app's own table (benchmark size and 16x) probed with
    the app's queries: found values equal the app's expected results, and
    misses are the ones it expects 0 for."""
    for n_lookups, n_slots in ((256, 1024), (4096, 16384)):
        app = ALL_APPS["hash_table"](n_lookups=n_lookups, n_slots=n_slots)
        tk, tv = app.dram_init["table_k"], app.dram_init["table_v"]
        q = app.dram_init["queries"]
        vals, found = _port(q, tk, tv, n_slots)
        np.testing.assert_array_equal(np.where(found == 1, vals, 0),
                                      app.expected["results"])
        assert found.sum() == (app.expected["results"] != 0).sum()


def test_hash_probe_refuses_what_it_cannot_take():
    k = torch.zeros(4, dtype=torch.int32)
    t = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        hp.hash_probe(k.long(), t, t, 4)
    with pytest.raises(ValueError, match="differ in shape"):
        hp.hash_probe(k, t, t[:6], 4)
    with pytest.raises(ValueError, match="n_slots"):
        hp.hash_probe(k, t, t, 9)
    with pytest.raises(ValueError, match="max_probes"):
        hp.hash_probe(k, t, t, 4, -1)


def test_hash_lookup_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.hash_lookup(np.arange(4), np.zeros(8), np.zeros(8), 4)


def _walk_slots(keys, tk, n_slots, max_probes):
    """Each key's slots read, as the kernel walks them: (home, slots read,
    the slot of its hit or -1)."""
    homes, reads, hits = [], [], []
    for k in keys:
        h = ref_oracle._mix_ref(int(k)) % n_slots
        n, hit = 0, -1
        for p in range(max_probes):
            if h + p >= len(tk):
                break
            n += 1
            if tk[h + p] == k:
                hit = h + p
                break
            if tk[h + p] == 0:
                break
        homes.append(h)
        reads.append(n)
        hits.append(hit)
    return homes, reads, hits


@pytest.mark.parametrize("n_slots,load,n", [(64, 0.5, 300), (64, 1.0, 300),
                                            (1000, 0.5, 5000)])
def test_smoke_bound_counts_each_table_sector_once(n_slots, load, n):
    """``chip_smoke._hash_bound`` charges each 32-byte sector of table_k
    that a chain reads, and of table_v that holds a hit, once (their union,
    whatever the table's size), and reports each key's own sectors beside
    it as ``random_sectors``."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    rng = np.random.default_rng(15)
    keys, tk, tv = _table(rng, n_slots, load)
    q = _queries(rng, keys, n)
    q[::41] = 0                                   # EMPTY as a key
    mp = chip_smoke.HASH_MAX_PROBES
    homes, reads, hits = _walk_slots(q, tk, n_slots, mp)
    k_sec = {(h + p) // 8 for h, r in zip(homes, reads) for p in range(r)}
    v_sec = {s // 8 for s in hits if s >= 0}
    own = sum((h + r - 1) // 8 - h // 8 + 1
              for h, r in zip(homes, reads) if r > 0)
    own += sum(s >= 0 for s in hits)
    qt, tkt, tvt = (torch.from_numpy(a.astype(np.int32)) for a in (q, tk, tv))
    _, found = hp.hash_probe_plain(qt, tkt, tvt, n_slots, mp)
    ms, counts = chip_smoke._hash_bound(qt, tkt, n_slots, found)
    assert counts["table_k_sectors"] == len(k_sec)
    assert counts["table_v_sectors"] == len(v_sec)
    assert counts["bytes"] == 12 * n + 32 * (len(k_sec) + len(v_sec))
    assert counts["random_sectors"] == own > len(k_sec) + len(v_sec)
    assert ms == chip_smoke.bytes_ms(counts["bytes"])
    assert counts["random_sector_ms"] == chip_smoke.bytes_ms(12 * n
                                                             + 32 * own)
