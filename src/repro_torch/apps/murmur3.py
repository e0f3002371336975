"""murmur3 — data hashing over 64 B blobs (Table III), ReadIt-driven."""
from __future__ import annotations

import numpy as np

from .. import api as revet
from .common import App, make_app, murmur3_32, to_i32

C1 = 0xCC9E2D51
C2 = 0x1B873593


def _rotl(b, x, r):
    return (x << r) | (x >> (32 - r))


@revet.program(
    name="murmur3",
    outputs={"hashes": lambda env: env["blobs"] // env["blob_words"]},
    statics=("blob_words",))
def murmur3_program(m, blobs, hashes, *, count, blob_words=16):
    with m.foreach(count) as (b, i):
        it = b.read_it(blobs, i * blob_words, tile=16)
        h = b.let(0, "h")
        j = b.let(0)
        with b.while_(j < blob_words) as w:
            k = w.let(w.deref(it))
            w.advance(it)
            w.set(k, k * C1)
            w.set(k, _rotl(w, k, 15))
            w.set(k, k * C2)
            w.set(h, h ^ k)
            w.set(h, _rotl(w, h, 13))
            w.set(h, h * 5 + 0xE6546B64)
            w.set(j, j + 1)
        b.set(h, h ^ (blob_words * 4))
        b.set(h, h ^ (h >> 16))
        b.set(h, h * 0x85EBCA6B)
        b.set(h, h ^ (h >> 13))
        b.set(h, h * 0xC2B2AE35)
        b.set(h, h ^ (h >> 16))
        b.dram_store(hashes, i, h)


def build(n_blobs: int = 32, blob_words: int = 16, seed: int = 0) -> App:
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 1 << 32, size=(n_blobs, blob_words),
                        dtype=np.uint32)

    expected = np.array([to_i32(murmur3_32(list(map(int, row))))
                         for row in data])
    return make_app(
        murmur3_program, name="murmur3",
        inputs={"blobs": data.reshape(-1)},
        params={"count": n_blobs},
        statics={"blob_words": blob_words},
        expected={"hashes": expected},
        bytes_processed=n_blobs * blob_words * 4 + n_blobs * 4,
        meta={"threads": n_blobs, "features": "ReadIt, while"})
