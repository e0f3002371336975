"""search — exact-match substring search with Boyer-Moore-Horspool
(Table III: 'PeekReadIt, while (x2)').

The nested data-dependent while loops (outer alignment sweep, inner backwards
match) are exactly what MapReduce cannot express and what gives the
asymptotic win over the GPU baseline (§VI-B(b)). Each thread scans one chunk.
"""
from __future__ import annotations

import numpy as np

from .. import api as revet
from ..core.lang import select
from .common import App, make_app

_PAD = 64  # peek-window overfetch padding appended to the text


@revet.program(name="search", outputs={"matches": "count"},
               statics=("chunk", "pat_len"))
def search_program(m_, text, pattern, shift, matches, *, count,
                   chunk=256, pat_len=5):
    m = pat_len
    with m_.foreach(count) as (b, t):
        base = b.let(t * chunk)
        pos = b.let(0, "pos")          # alignment start within chunk
        found = b.let(0, "found")
        # peek window covers pattern + shift lookahead
        it = b.read_it(text, base, tile=32, peek=True)
        with b.while_(pos <= chunk - m) as w:
            j = w.let(m - 1, "j")
            ok = w.let(1, "ok")
            with w.while_((j >= 0) & (ok == 1)) as inner:
                cc = inner.let(inner.deref(it, ahead=j))
                pc = inner.let(inner.dram_load(pattern, j))
                inner.set(ok, select(cc == pc, 1, 0))
                inner.set(j, j - select(cc == pc, 1, 0))
            adv = w.let(0)
            with w.if_else(j < 0) as (hit, miss):
                hit.set(found, found + 1)
                hit.set(adv, m)
                last = miss.let(miss.deref(it, ahead=m - 1))
                miss.set(adv, miss.dram_load(shift, last))
            w.set(pos, pos + adv)
            w.advance(it, adv)
        b.dram_store(matches, t, found)


def build(n_chunks: int = 16, chunk: int = 256, pattern: bytes = b"whale",
          seed: int = 0) -> App:
    rng = np.random.default_rng(seed)
    m = len(pattern)
    # text with planted occurrences (moby-dick-ish alphabet)
    alphabet = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz ", np.uint8)
    text = rng.choice(alphabet, size=n_chunks * chunk).astype(np.uint8)
    for _ in range(n_chunks * 2):
        pos = int(rng.integers(0, n_chunks * chunk - m))
        text[pos: pos + m] = np.frombuffer(pattern, np.uint8)

    # Horspool bad-character shift table
    shift = np.full(256, m, np.int64)
    for j, ch in enumerate(pattern[:-1]):
        shift[ch] = m - 1 - j

    # reference: non-overlapping-after-match count (matches `adv = m` on hit)
    expected = []
    for t in range(n_chunks):
        s = bytes(text[t * chunk:(t + 1) * chunk])
        cnt = 0
        i = 0
        while i <= chunk - len(pattern):
            if s[i:i + len(pattern)] == pattern:
                cnt += 1
                i += len(pattern)
            else:
                i += int(shift[s[i + len(pattern) - 1]])
        expected.append(cnt)

    padded = np.concatenate([text, np.zeros(_PAD, np.uint8)])
    return make_app(
        search_program, name="search",
        inputs={"text": padded,
                "pattern": np.frombuffer(pattern, np.uint8),
                "shift": shift},
        params={"count": n_chunks},
        statics={"chunk": chunk, "pat_len": m},
        expected={"matches": np.array(expected)},
        bytes_processed=n_chunks * chunk,
        meta={"threads": n_chunks, "features": "PeekReadIt, while(x2), "
              "Boyer-Moore-Horspool"})
