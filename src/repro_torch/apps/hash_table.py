"""hash-table — open-addressing lookup (Table III): int32 keys/values,
linear probing from a hashed slot via ReadIt (sequential scan = the iterator's
sweet spot; no cache tag checks, §VI-B(b))."""
from __future__ import annotations

import numpy as np

from .. import api as revet
from .common import App, make_app

_EMPTY = 0  # sentinel key


def _mix(x: int) -> int:
    x &= 0xFFFFFFFF
    x ^= x >> 16
    x = x * 0x45D9F3B & 0xFFFFFFFF
    x ^= x >> 16
    return x


@revet.program(name="hash_table", outputs={"results": "queries"},
               statics=("n_slots",))
def hash_table_program(m, table_k, table_v, queries, results, *, count,
                       n_slots=256):
    with m.foreach(count) as (b, i):
        key = b.let(b.dram_load(queries, i))
        h = b.let(key)
        b.set(h, h ^ (h >> 16))
        b.set(h, h * 0x45D9F3B)
        b.set(h, h ^ (h >> 16))
        b.set(h, h.umod(n_slots))
        it = b.read_it(table_k, h, tile=8)
        off = b.let(0, "off")
        res = b.let(0, "res")
        done = b.let(0, "done")
        with b.while_(lambda hd: (hd.let(hd.deref(it), "cur") != 0)
                      & (done == 0)) as w:
            cur = w.let(w.deref(it))
            with w.if_(cur == key) as f:
                v = f.dram_load(table_v, h + off)
                f.set(res, v)
                f.set(done, 1)
            w.advance(it)
            w.set(off, off + 1)
        b.dram_store(results, i, res)


def build(n_lookups: int = 64, n_slots: int = 256, load: float = 0.25,
          seed: int = 0) -> App:
    rng = np.random.default_rng(seed)
    n_keys = int(n_slots * load)
    keys = rng.choice(np.arange(1, 1 << 20), size=n_keys, replace=False)
    vals = rng.integers(1, 1 << 20, size=n_keys)

    table_k = np.zeros(n_slots, np.int64)
    table_v = np.zeros(n_slots, np.int64)
    for k, v in zip(keys, vals):
        h = _mix(int(k)) % n_slots
        while table_k[h] != _EMPTY:
            h = (h + 1) % n_slots
        table_k[h] = k
        table_v[h] = v

    # lookups: 75% hits, 25% misses
    hit = rng.random(n_lookups) < 0.75
    lookups = np.where(hit, rng.choice(keys, n_lookups),
                       rng.integers(1 << 20, 1 << 21, n_lookups))

    # duplicated-at-wrap table copy so linear probes never wrap (load 25%)
    tk2 = np.concatenate([table_k, table_k])
    tv2 = np.concatenate([table_v, table_v])

    kv = dict(zip(map(int, keys), map(int, vals)))
    expected = np.array([kv.get(int(q), 0) for q in lookups])
    return make_app(
        hash_table_program, name="hash_table",
        inputs={"table_k": tk2, "table_v": tv2, "queries": lookups},
        params={"count": n_lookups},
        statics={"n_slots": n_slots},
        expected={"results": expected},
        bytes_processed=n_lookups * 4 * 2,  # Table III: keys+values moved
        meta={"threads": n_lookups, "features": "ReadIt probe, while"})
