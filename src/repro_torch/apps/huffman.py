"""huff-enc / huff-dec — canonical Huffman (64 codes, 16-bit max length),
Table III. Encode appends variable-length codes into a 32-bit bit buffer and
flushes words through a ManualWriteIt; decode walks a canonical
(first_code/count/offset) table, emitting symbols through a WriteIt.
"""
from __future__ import annotations

import heapq

import numpy as np

from .. import api as revet
from .common import App, make_app

N_SYMS = 64
MAX_LEN = 16


def _canonical_code(freqs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Package-merge-free canonical Huffman (depth-limited by construction
    for our symbol counts). Returns (lengths, codes)."""
    heap = [(int(f) + 1, i, (i,)) for i, f in enumerate(freqs)]
    heapq.heapify(heap)
    lengths = np.zeros(N_SYMS, np.int64)
    while len(heap) > 1:
        fa, _, sa = heapq.heappop(heap)
        fb, _, sb = heapq.heappop(heap)
        for s in sa + sb:
            lengths[s] += 1
        heapq.heappush(heap, (fa + fb, min(sa + sb), sa + sb))
    lengths = np.clip(lengths, 1, MAX_LEN)
    # canonical assignment: sort by (length, symbol)
    order = sorted(range(N_SYMS), key=lambda s: (lengths[s], s))
    codes = np.zeros(N_SYMS, np.int64)
    code, prev_len = 0, 0
    for s in order:
        code <<= (lengths[s] - prev_len)
        codes[s] = code
        code += 1
        prev_len = int(lengths[s])
    return lengths, codes


def _tables(lengths: np.ndarray, codes: np.ndarray):
    count = np.zeros(MAX_LEN + 1, np.int64)
    for l in lengths:
        count[l] += 1
    first = np.zeros(MAX_LEN + 1, np.int64)
    offset = np.zeros(MAX_LEN + 1, np.int64)
    order = sorted(range(N_SYMS), key=lambda s: (lengths[s], s))
    symbols = np.array(order, np.int64)
    idx = 0
    for l in range(1, MAX_LEN + 1):
        if count[l]:
            firsts = [codes[s] for s in order if lengths[s] == l]
            first[l] = firsts[0]
            offset[l] = idx
            idx += count[l]
    return count, first, offset, symbols


def _encode_ref(syms, lengths, codes) -> list[int]:
    words, buf, nbits = [], 0, 0
    for s in syms:
        l, c = int(lengths[s]), int(codes[s])
        buf = ((buf << l) | c) & ((1 << 64) - 1)
        nbits += l
        while nbits >= 32:
            words.append((buf >> (nbits - 32)) & 0xFFFFFFFF)
            nbits -= 32
    if nbits:
        words.append((buf << (32 - nbits)) & 0xFFFFFFFF)
    return words


def c_one(b):
    return b.let(1)


@revet.program(
    name="huff_enc",
    outputs={"out": "syms",
             "out_words": lambda env: env["syms"] // env["syms_per_thread"]},
    statics=("syms_per_thread",))
def huff_enc_program(m, syms, lens_tab, codes_tab, out, out_words, *, count,
                     syms_per_thread=64):
    out_stride = syms_per_thread  # words; generous (<=16 bits/sym avg)
    with m.foreach(count) as (b, t):
        wit = b.write_it(out, t * out_stride, tile=8, manual=True)
        buf = b.let(0, "buf")
        nbits = b.let(0, "nbits")
        nwords = b.let(0, "nwords")
        j = b.let(0)
        with b.while_(j < syms_per_thread) as w:
            s = w.let(w.dram_load(syms, t * syms_per_thread + j))
            l = w.let(w.dram_load(lens_tab, s))
            code = w.let(w.dram_load(codes_tab, s))
            is_last = w.let(j == syms_per_thread - 1)
            with w.if_else(nbits + l > 32) as (sp, no):
                # spill: emit a full word combining buf + code prefix
                spill = sp.let(nbits + l - 32)
                word = sp.let((buf << (32 - nbits)) | (code >> spill))
                sp.it_write(wit, word, last=0)
                sp.set(nwords, nwords + 1)
                sp.set(buf, code & ((c_one(sp) << spill) - 1))
                sp.set(nbits, spill)
                no.set(buf, (buf << l) | code)
                no.set(nbits, nbits + l)
            with w.if_(is_last & (nbits > 0)) as fin:
                fin.it_write(wit, buf << (32 - nbits), last=1)
                fin.set(nwords, nwords + 1)
            w.set(j, j + 1)
        b.dram_store(out_words, t, nwords)


def build_enc(n_threads: int = 8, syms_per_thread: int = 64,
              seed: int = 0) -> App:
    rng = np.random.default_rng(seed)
    freqs = rng.zipf(1.5, size=N_SYMS * 50)
    hist = np.bincount(np.clip(freqs, 1, N_SYMS) - 1, minlength=N_SYMS)
    lengths, codes = _canonical_code(hist)
    syms = rng.integers(0, N_SYMS, size=(n_threads, syms_per_thread))

    out_stride = syms_per_thread
    exp_out = np.zeros(n_threads * out_stride, np.int64)
    exp_words = np.zeros(n_threads, np.int64)
    for t in range(n_threads):
        words = _encode_ref(syms[t], lengths, codes)
        for k, wv in enumerate(words):
            exp_out[t * out_stride + k] = wv - (1 << 32) \
                if wv >= (1 << 31) else wv
        exp_words[t] = len(words)

    return make_app(
        huff_enc_program, name="huff_enc",
        inputs={"syms": syms.reshape(-1).astype(np.uint8),
                "lens_tab": lengths, "codes_tab": codes},
        params={"count": n_threads},
        statics={"syms_per_thread": syms_per_thread},
        expected={"out": exp_out, "out_words": exp_words},
        bytes_processed=n_threads * syms_per_thread
        + int(exp_words.sum()) * 4,
        meta={"threads": n_threads, "features": "ManualWriteIt, while, "
              "bit packing"})


@revet.program(
    name="huff_dec",
    outputs={"out": ("enc", "i8")},
    statics=("syms_per_thread",))
def huff_dec_program(m, enc, count_tab, first_tab, offset_tab, symbols_tab,
                     out, *, count, syms_per_thread=64):
    in_stride = syms_per_thread  # words
    with m.foreach(count) as (b, t):
        it = b.read_it(enc, t * in_stride, tile=8)
        wit = b.write_it(out, t * syms_per_thread, tile=8)
        word = b.let(0, "word")
        avail = b.let(0, "avail")
        code = b.let(0, "code")
        clen = b.let(0, "clen")
        decoded = b.let(0, "decoded")
        with b.while_(decoded < syms_per_thread) as w:
            with w.if_(avail == 0) as rf:
                rf.set(word, rf.deref(it))
                rf.advance(it)
                rf.set(avail, 32)
            bit = w.let((word >> 31) & 1)
            w.set(word, word << 1)
            w.set(avail, avail - 1)
            w.set(code, (code << 1) | bit)
            w.set(clen, clen + 1)
            cnt = w.let(w.dram_load(count_tab, clen))
            fst = w.let(w.dram_load(first_tab, clen))
            idx = w.let(code - fst)
            hit = w.let((cnt > 0) & (idx >= 0) & (idx < cnt))
            with w.if_(hit) as h:
                off = h.let(h.dram_load(offset_tab, clen))
                sym = h.let(h.dram_load(symbols_tab, off + idx))
                h.it_write(wit, sym)
                h.set(decoded, decoded + 1)
                h.set(code, 0)
                h.set(clen, 0)


def build_dec(n_threads: int = 8, syms_per_thread: int = 64,
              seed: int = 0) -> App:
    rng = np.random.default_rng(seed)
    freqs = rng.zipf(1.5, size=N_SYMS * 50)
    hist = np.bincount(np.clip(freqs, 1, N_SYMS) - 1, minlength=N_SYMS)
    lengths, codes = _canonical_code(hist)
    count_t, first_t, offset_t, symbols_t = _tables(lengths, codes)
    syms = rng.integers(0, N_SYMS, size=(n_threads, syms_per_thread))

    in_stride = syms_per_thread  # words
    enc = np.zeros(n_threads * in_stride, np.int64)
    for t in range(n_threads):
        words = _encode_ref(syms[t], lengths, codes)
        for k, wv in enumerate(words):
            enc[t * in_stride + k] = wv - (1 << 32) if wv >= (1 << 31) else wv

    return make_app(
        huff_dec_program, name="huff_dec",
        inputs={"enc": enc, "count_tab": count_t, "first_tab": first_t,
                "offset_tab": offset_t,
                "symbols_tab": symbols_t.astype(np.uint8)},
        params={"count": n_threads},
        statics={"syms_per_thread": syms_per_thread},
        expected={"out": syms.reshape(-1)},
        bytes_processed=int(np.count_nonzero(enc)) * 4
        + n_threads * syms_per_thread,
        meta={"threads": n_threads, "features": "ReadIt, WriteIt, while, "
              "canonical Huffman"})
