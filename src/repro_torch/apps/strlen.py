"""strlen — the paper's running example (Fig. 7), built feature-complete:
tile views for thread args/results, hierarchy elimination on the inner
foreach, replicate for outer parallelism, and a demand-fetched ReadIt."""
from __future__ import annotations

import numpy as np

from .. import api as revet
from .common import App, make_app, pack_strings


@revet.program(
    name="strlen",
    outputs={"lengths": "offsets"},
    statics=("tile", "replicate", "it_tile"),
    pools={"default": dict(buf_words=64, n_bufs=2048)})
def strlen_program(m, input, offsets, lengths, *, count,
                   tile=16, replicate=2, it_tile=16):
    with m.foreach(count, step=tile) as (b, outer):
        in_view = b.read_view(offsets, outer, tile)
        out_view = b.write_view(lengths, outer, tile)
        with b.foreach(tile, eliminate_hierarchy=True) as (t, idx):
            off = t.let(t.view_load(in_view, idx))
            with t.replicate(replicate) as r:
                ln = r.let(0, "len")
                it = r.read_it(input, off, tile=it_tile)
                with r.while_(lambda h: h.deref(it) != 0) as w:
                    w.set(ln, ln + 1)
                    w.advance(it)
                r.view_store(out_view, idx, ln)


def build(n_strings: int = 64, avg_len: int = 24, tile: int = 16,
          replicate: int = 2, it_tile: int = 16, seed: int = 0) -> App:
    rng = np.random.default_rng(seed)
    strings = [bytes(rng.integers(1, 256, size=int(l), dtype=np.uint8))
               for l in rng.integers(0, 2 * avg_len, size=n_strings)]
    blob, offs = pack_strings(strings)
    # pad so the demand-fetched iterator's last tile stays in bounds
    blob = np.concatenate([blob, np.zeros(it_tile, np.uint8)])

    assert n_strings % tile == 0
    expected = np.array([len(s) for s in strings])
    return make_app(
        strlen_program, name="strlen",
        inputs={"input": blob, "offsets": offs},
        params={"count": n_strings},
        statics={"tile": tile, "replicate": replicate, "it_tile": it_tile},
        expected={"lengths": expected},
        bytes_processed=len(blob) - it_tile + 4 * 2 * n_strings,
        meta={"threads": n_strings, "features": "views, elim-hier, "
              "replicate, ReadIt, while"})
