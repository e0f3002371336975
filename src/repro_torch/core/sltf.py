"""Structured-Link Tensor Format (SLTF) — paper §III-A.

An SLTF stream is a sequence of *tokens*. Each token is either

* a **data token** carrying a tuple of live values (one "thread"'s state as it
  crosses a dataflow link), or
* a **barrier token** Ω_n terminating the *n* innermost ragged-tensor
  dimensions.

Canonical encoding rules (matching the paper's examples exactly):

* ``[[0, 1], [2]]``  ->  ``0, 1, Ω1, 2, Ω2``   (Ω2 *implies* an Ω1 after 2,
  because the trailing dim-1 group is non-empty).
* ``[[]]``           ->  ``Ω1, Ω2``            (the empty inner group's Ω1 is
  explicit — it cannot be implied).
* ``[[], []]``       ->  ``Ω1, Ω1, Ω2``
* ``[]``             ->  ``Ω2``

Decoder law: on receiving Ω_n, close dims ``1..n-1`` *iff their current group
is non-empty* (cascading upward), then close dim ``n`` unconditionally.

This module provides the token representation, the ragged<->token codec, a
validator, and conversion to/from the dense array form used by the vectorized
VM (``kinds: int32[N]`` with 0 = data, n>0 = Ω_n; payload columns are parallel
arrays).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterable, Sequence

import numpy as np

__all__ = [
    "Tok",
    "data_tok",
    "bar",
    "is_data",
    "is_bar",
    "encode_ragged",
    "decode_ragged",
    "validate_stream",
    "stream_depth_ok",
    "shift_barriers",
    "ArrayStream",
    "tokens_to_arrays",
    "arrays_to_tokens",
]


@dataclasses.dataclass(frozen=True)
class Tok:
    """One SLTF token.

    ``level == 0``: data token; ``values`` is a tuple of scalars (the thread's
    live variables on this link).
    ``level >= 1``: barrier Ω_level; ``values`` is ``()``.
    """

    level: int
    values: tuple = ()

    def __repr__(self) -> str:  # compact, test-friendly
        if self.level == 0:
            if len(self.values) == 1:
                return f"d({self.values[0]})"
            return f"d{self.values}"
        return f"Ω{self.level}"


def data_tok(*values: Any) -> Tok:
    return Tok(0, tuple(values))


def bar(level: int) -> Tok:
    if level < 1:
        raise ValueError(f"barrier level must be >= 1, got {level}")
    return Tok(int(level))


def is_data(t: Tok) -> bool:
    return t.level == 0


def is_bar(t: Tok) -> bool:
    return t.level >= 1


# ---------------------------------------------------------------------------
# Ragged <-> token codec
# ---------------------------------------------------------------------------

def _encode(x: Any, ndim: int) -> tuple[list[Tok], int]:
    """Returns (tokens, n_items). ``n_items`` is len(x) for ndim >= 1."""
    if ndim == 0:
        return [data_tok(x) if not isinstance(x, tuple) else Tok(0, x)], 1
    toks: list[Tok] = []
    last_nonempty = False
    for child in x:
        ct, n = _encode(child, ndim - 1)
        toks.extend(ct)
        last_nonempty = ndim == 1 or n > 0
    if x and last_nonempty and ndim >= 2:
        # The trailing barrier of a non-empty last child is *implied* by this
        # group's higher barrier (paper: "Ω2 implies an Ω1 after element 2").
        assert toks and is_bar(toks[-1]) and toks[-1].level == ndim - 1
        toks.pop()
    toks.append(bar(ndim))
    return toks, len(x)


def encode_ragged(x: Any, ndim: int) -> list[Tok]:
    """Encode one ragged ``ndim``-dimensional tensor into canonical SLTF tokens.

    Scalars may be raw values or tuples (multi-variable thread payloads).
    """
    if ndim < 1:
        raise ValueError("encode_ragged needs ndim >= 1")
    toks, _ = _encode(x, ndim)
    return toks


def decode_ragged(tokens: Sequence[Tok], ndim: int) -> list:
    """Decode canonical SLTF tokens into a list of ragged ``ndim``-D tensors.

    A well-formed stream is a concatenation of complete tensors, each
    terminated by an Ω_ndim. Returns the list of decoded tensors (usually one).
    """
    out: list = []
    # stack[d] = currently-open group at dim d (1-indexed; stack[0] unused).
    stack: list[list] = [None] + [[] for _ in range(ndim)]  # type: ignore

    def unwrap(v: tuple):
        return v[0] if len(v) == 1 else v

    for t in tokens:
        if is_data(t):
            stack[1].append(unwrap(t.values))
        else:
            n = t.level
            if n > ndim:
                raise ValueError(f"barrier Ω{n} exceeds stream depth {ndim}")
            # Close dims 1..n-1 iff non-empty (the "implied barrier" law).
            for d in range(1, n):
                if stack[d]:
                    stack[d + 1].append(stack[d])
                    stack[d] = []
            # Close dim n unconditionally.
            if n == ndim:
                out.append(stack[n])
                stack[n] = []
            else:
                stack[n + 1].append(stack[n])
                stack[n] = []
    if any(stack[d] for d in range(1, ndim + 1)):
        raise ValueError("stream ended with an unterminated tensor")
    return out


def validate_stream(tokens: Sequence[Tok], ndim: int) -> None:
    """Raise if ``tokens`` is not a well-formed depth-``ndim`` SLTF stream."""
    for t in tokens:
        if is_bar(t) and t.level > ndim:
            raise ValueError(f"barrier Ω{t.level} exceeds stream depth {ndim}")
    decode_ragged(tokens, ndim)  # raises on structural problems


def stream_depth_ok(tokens: Sequence[Tok], ndim: int) -> bool:
    try:
        validate_stream(tokens, ndim)
        return True
    except ValueError:
        return False


def shift_barriers(tokens: Iterable[Tok], delta: int) -> list[Tok]:
    """Raise/lower every barrier level by ``delta`` (data passes through).

    Used by loop headers (add a level, reserving Ω1 — §III-B(d)) and loop
    exits (strip the reserved level).
    """
    out = []
    for t in tokens:
        if is_data(t):
            out.append(t)
        else:
            lvl = t.level + delta
            if lvl < 1:
                raise ValueError("barrier level would drop below 1")
            out.append(bar(lvl))
    return out


# ---------------------------------------------------------------------------
# Dense array form (used by the vectorized VM and the Pallas kernels)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ArrayStream:
    """Dense SoA encoding of an SLTF token window.

    ``kinds[i] == 0``  -> data token; payload columns hold its live values.
    ``kinds[i] == n>0`` -> barrier Ω_n; payload at i is undefined (zeros).
    ``length`` is the number of valid tokens (<= capacity ``kinds.shape[0]``).
    """

    kinds: np.ndarray            # int32 [N]
    payload: tuple[np.ndarray, ...]  # each [N]
    length: int

    @property
    def capacity(self) -> int:
        return int(self.kinds.shape[0])


def tokens_to_arrays(tokens: Sequence[Tok], n_vars: int,
                     capacity: int | None = None,
                     dtypes: Sequence[Any] | None = None) -> ArrayStream:
    n = len(tokens)
    cap = capacity if capacity is not None else n
    if cap < n:
        raise ValueError(f"capacity {cap} < token count {n}")
    if dtypes is None:
        dtypes = [np.int32] * n_vars
    kinds = np.zeros(cap, np.int32)
    cols = [np.zeros(cap, dt) for dt in dtypes]
    for i, t in enumerate(tokens):
        kinds[i] = t.level
        if is_data(t):
            if len(t.values) != n_vars:
                raise ValueError(
                    f"data token has {len(t.values)} values, expected {n_vars}")
            for c, v in zip(cols, t.values):
                c[i] = v
    return ArrayStream(kinds, tuple(cols), n)


def arrays_to_tokens(s: ArrayStream) -> list[Tok]:
    out = []
    for i in range(s.length):
        lvl = int(s.kinds[i])
        if lvl == 0:
            out.append(Tok(0, tuple(np.asarray(c[i]).item() for c in s.payload)))
        else:
            out.append(bar(lvl))
    return out
