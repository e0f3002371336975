"""isipv4 (DFA regex validation) & ip2int (parsing) — Table III string apps.

Both walk NUL-terminated strings with a ReadIt and use ``replicate`` for
outer parallelism. isipv4 validates dotted-quad syntax + per-octet range; the
dataset is 90% valid addresses / 10% the literal 'INVALID' (paper's mix).
"""
from __future__ import annotations

import numpy as np

from .. import api as revet
from ..core.lang import select
from .common import App, make_app, pack_strings, to_i32

_PAD = 16  # iterator-overfetch padding appended to the input blob


def _gen_addresses(n: int, valid_frac: float, rng) -> list[bytes]:
    out = []
    for i in range(n):
        if rng.random() < valid_frac:
            out.append(".".join(str(int(x))
                                for x in rng.integers(0, 256, 4)).encode())
        else:
            out.append(b"INVALID")
    return out


def _scan_ipv4(b, it, w_block):
    """Shared parser loop body builder: returns (valid, value) variables.

    state: acc (current octet), groups (dots seen), digits (in octet),
    ok (still valid).
    """
    acc = b.let(0, "acc")
    groups = b.let(0, "groups")
    digits = b.let(0, "digits")
    ok = b.let(1, "ok")
    val = b.let(0, "val")
    ch = b.let(255)   # placeholder; loop reads
    with b.while_(lambda h: h.let(h.deref(it)) != 0) as w:
        cc = w.let(w.deref(it))
        w.advance(it)
        is_digit = w.let((cc >= 48) & (cc <= 57))
        is_dot = w.let(cc == 46)
        with w.if_else(is_digit) as (d, nd):
            d.set(acc, acc * 10 + (cc - 48))
            d.set(digits, digits + 1)
            d.set(ok, select((acc <= 255) & (digits <= 3), ok, 0))
            with nd.if_else(is_dot) as (dot, other):
                dot.set(ok, select((digits >= 1) & (groups < 3), ok, 0))
                dot.set(val, (val << 8) | acc)
                dot.set(acc, 0)
                dot.set(digits, 0)
                dot.set(groups, groups + 1)
                other.set(ok, 0)
    with b.if_else((groups == 3) & (digits >= 1) & (ok == 1)) as (fin, bad):
        fin.set(val, (val << 8) | acc)
        bad.set(ok, 0)
        bad.set(val, 0)
    return ok, val


@revet.program(name="ipv4", outputs={"out": "offsets"},
               statics=("out_is_value", "replicate"))
def ipv4_program(m, input, offsets, out, *, count,
                 out_is_value=False, replicate=2):
    with m.foreach(count) as (b, i):
        off = b.let(b.dram_load(offsets, i))
        with b.replicate(replicate) as r:
            it = r.read_it(input, off, tile=16)
            ok, val = _scan_ipv4(r, it, r)
            r.dram_store(out, i, val if out_is_value else ok)


def _build_common(name: str, out_is_value: bool, n_strings: int,
                  valid_frac: float, replicate: int, seed: int) -> App:
    rng = np.random.default_rng(seed)
    strings = _gen_addresses(n_strings, valid_frac, rng)
    blob, offs = pack_strings(strings)
    blob = np.concatenate([blob, np.zeros(_PAD, np.uint8)])

    def ref(s: bytes):
        parts = s.split(b".")
        if len(parts) != 4:
            return 0, 0
        v = 0
        for part in parts:
            if not part or len(part) > 3 or not part.isdigit():
                return 0, 0
            x = int(part)
            if x > 255:
                return 0, 0
            v = (v << 8) | x
        return 1, v

    refs = [ref(s) for s in strings]
    expected = np.array([to_i32(r[1]) if out_is_value else r[0]
                         for r in refs])
    return make_app(
        ipv4_program, name=name,
        inputs={"input": blob, "offsets": offs},
        params={"count": n_strings},
        statics={"out_is_value": out_is_value, "replicate": replicate},
        expected={"out": expected},
        bytes_processed=len(blob) - _PAD + 4 * n_strings,
        meta={"threads": n_strings, "features": "replicate(x2), ReadIt, "
              "nested if, while"})


def build_isipv4(n_strings: int = 64, replicate: int = 2, seed: int = 0) -> App:
    return _build_common("isipv4", False, n_strings, 0.9, replicate, seed)


def build_ip2int(n_strings: int = 64, replicate: int = 2, seed: int = 1) -> App:
    return _build_common("ip2int", True, n_strings, 1.0, replicate, seed)
