"""Streaming tensor primitives — paper §III-B.

Token-level *reference semantics* of every Revet streaming primitive. These
definitions are the oracle for (a) the vectorized VM in ``core/vm.py``, (b)
the Pallas kernels in ``kernels/``, and (c) the hypothesis property tests.

Composability contract (paper §III-B):
  1. every barrier that enters a primitive exits exactly once, in order;
  2. data tokens are never reordered across barriers (reordering *between*
     barriers is allowed).

All functions are pure: ``list[Tok] -> list[Tok]`` (or tuples thereof).
"""
from __future__ import annotations

from typing import Callable, Sequence

from .sltf import Tok, bar, data_tok, is_bar, is_data, shift_barriers

__all__ = [
    "elementwise",
    "filter_stream",
    "partition_stream",
    "forward_merge",
    "broadcast",
    "counter_expand",
    "reduce_stream",
    "flatten",
    "fork_expand",
    "while_loop",
]


# ---------------------------------------------------------------------------
# Element-wise (§III-B(a))
# ---------------------------------------------------------------------------

def elementwise(fn: Callable[..., tuple], stream: Sequence[Tok]) -> list[Tok]:
    """Apply ``fn`` to each data token's payload tuple; barriers pass through.

    ``fn`` receives the payload tuple unpacked and must return the new payload
    tuple. Never changes ordering, hierarchy, or thread count.
    """
    out = []
    for t in stream:
        if is_data(t):
            res = fn(*t.values)
            if not isinstance(res, tuple):
                res = (res,)
            out.append(Tok(0, res))
        else:
            out.append(t)
    return out


# ---------------------------------------------------------------------------
# Filtering (§III-B(c)) — the `if` primitive
# ---------------------------------------------------------------------------

def filter_stream(pred: Callable[..., bool], stream: Sequence[Tok]) -> list[Tok]:
    """Keep data tokens whose payload satisfies ``pred``; barriers pass."""
    out = []
    for t in stream:
        if is_data(t) and not pred(*t.values):
            continue
        out.append(t)
    return out


def partition_stream(pred: Callable[..., bool], stream: Sequence[Tok]
                     ) -> tuple[list[Tok], list[Tok]]:
    """One-pass if/else split: (true-branch stream, false-branch stream).

    Both outputs receive every barrier (paper: "Barriers are passed through
    unmodified, creating two tensors from one").
    """
    t_out, f_out = [], []
    for t in stream:
        if is_bar(t):
            t_out.append(t)
            f_out.append(t)
        elif pred(*t.values):
            t_out.append(t)
        else:
            f_out.append(t)
    return t_out, f_out


# ---------------------------------------------------------------------------
# Forward merge (§III-B(c))
# ---------------------------------------------------------------------------

def forward_merge(a: Sequence[Tok], b: Sequence[Tok]) -> list[Tok]:
    """Merge two forward branches (e.g. after an if/else).

    Interleaves data eagerly within a barrier group; when one input reaches a
    barrier it stalls until the other reaches an *equal* barrier, then a single
    barrier is emitted. The reference drains ``a`` first within each group
    (any interleaving is semantically legal — threads within a hierarchy level
    are unordered).
    """
    out: list[Tok] = []
    ia = ib = 0
    while ia < len(a) or ib < len(b):
        while ia < len(a) and is_data(a[ia]):
            out.append(a[ia]); ia += 1
        while ib < len(b) and is_data(b[ib]):
            out.append(b[ib]); ib += 1
        a_done, b_done = ia >= len(a), ib >= len(b)
        if a_done and b_done:
            break
        if a_done != b_done:
            raise ValueError("forward_merge: unbalanced barrier structure")
        if a[ia].level != b[ib].level:
            raise ValueError(
                f"forward_merge: mismatched barriers Ω{a[ia].level} vs Ω{b[ib].level}")
        out.append(a[ia])
        ia += 1
        ib += 1
    return out


# ---------------------------------------------------------------------------
# Expansion (§III-B(b))
# ---------------------------------------------------------------------------

def broadcast(parent: Sequence[Tok], child: Sequence[Tok]) -> list[Tok]:
    """Pair each parent element with every element of one child group.

    ``parent`` is a depth-k stream, ``child`` a depth-(k+1) stream; output is
    depth-(k+1): each child data token's payload is *extended* with the
    corresponding parent payload (scalar-to-vector broadcast — how read-only
    parent live-ins enter a ``foreach`` body). The parent element is popped
    when its group's Ω1 arrives on the child link (§III-C).
    """
    out: list[Tok] = []
    ip = 0

    def parent_vals() -> tuple:
        while ip < len(parent) and is_bar(parent[ip]):
            raise ValueError("broadcast: parent barrier where data expected")
        return parent[ip].values

    for t in child:
        if is_data(t):
            out.append(Tok(0, t.values + parent_vals()))
        else:
            out.append(t)
            # Ω_n on the child closes its current group: pop parent element,
            # then consume the parent's own barrier Ω_{n-1} (implied or real).
            ip += 1
            if t.level >= 2:
                # parent barrier Ω_{t.level-1} must follow (possibly implied by
                # the canonical encoding, i.e. absent if its group non-empty).
                if ip < len(parent) and is_bar(parent[ip]) \
                        and parent[ip].level == t.level - 1:
                    ip += 1
    return out


def counter_expand(stream: Sequence[Tok],
                   bounds: Callable[..., tuple[int, int, int]]) -> list[Tok]:
    """Counter expansion: depth-k -> depth-(k+1)  (the `foreach` entry).

    For each data token, ``bounds(*payload)`` returns (lo, hi, step); the
    token becomes a dim-1 group of data tokens ``payload + (i,)`` closed by
    Ω1 (implied when a higher barrier immediately follows). Input barriers
    Ω_n become Ω_{n+1}.
    """
    out: list[Tok] = []
    pending_group = False  # True if the last emitted group's Ω1 is pending
    for t in stream:
        if is_data(t):
            if pending_group:
                out.append(bar(1))
            lo, hi, step = bounds(*t.values)
            for i in range(lo, hi, step):
                out.append(Tok(0, t.values + (i,)))
            if (hi - lo) // max(step, 1) <= 0 or lo >= hi:
                # empty group: its Ω1 must be explicit (cannot be implied)
                out.append(bar(1))
                pending_group = False
            else:
                pending_group = True
        else:
            if pending_group:
                pass  # Ω_{n+1} implies the trailing Ω1 of a non-empty group
            out.append(bar(t.level + 1))
            pending_group = False
    if pending_group:
        out.append(bar(1))
    return out


def fork_expand(stream: Sequence[Tok],
                count: Callable[..., int]) -> list[Tok]:
    """``fork``: duplicate threads *without* adding hierarchy (§IV-A).

    Each data token becomes ``count(*payload)`` data tokens (payload + (i,))
    at the *same* barrier level. Implemented as expansion followed by
    flattening (paper: "an expansion/flattening pair ... implements a fork").
    """
    expanded = counter_expand(stream, lambda *v: (0, count(*v), 1))
    return flatten(expanded)


# ---------------------------------------------------------------------------
# Reduction & flattening (§III-B(b))
# ---------------------------------------------------------------------------

def reduce_stream(op: Callable[[tuple, tuple], tuple], init: tuple,
                  stream: Sequence[Tok]) -> list[Tok]:
    """Associative reduction of the innermost dimension: depth-(k+1) -> k.

    Emits the accumulator as a data token at every dim-1 close and resets it
    (paper §III-A: "when a reduction receives a loop termination, it sends the
    current value and resets the accumulator"). Handles the implied-Ω1 law and
    the empty-tensor cases: ``[[]] -> [0]``, ``[[],[]] -> [0,0]``, ``[] -> []``.
    """
    out: list[Tok] = []
    acc = init
    group_open = False  # have we seen data since the last dim-1 close?
    for t in stream:
        if is_data(t):
            acc = op(acc, t.values)
            group_open = True
        elif t.level == 1:
            out.append(Tok(0, acc))
            acc = init
            group_open = False
        else:
            if group_open:
                # Ω_n implies the Ω1 of a non-empty trailing group.
                out.append(Tok(0, acc))
                acc = init
                group_open = False
            out.append(bar(t.level - 1))
    return out


def flatten(stream: Sequence[Tok]) -> list[Tok]:
    """Remove one level of hierarchy: Ω1 dropped, Ω_n -> Ω_{n-1}."""
    out = []
    for t in stream:
        if is_data(t):
            out.append(t)
        elif t.level == 1:
            continue
        else:
            out.append(bar(t.level - 1))
    return out


# ---------------------------------------------------------------------------
# Forward-backward merge (§III-B(d)) — the `while` primitive
# ---------------------------------------------------------------------------

def while_loop(body: Callable[[list[Tok]], tuple[list[Tok], list[Tok]]],
               stream: Sequence[Tok]) -> list[Tok]:
    """Reference semantics of a natural loop built on a forward-backward merge.

    ``body`` maps one *wave* of threads (data tokens only, no barriers) to
    ``(continuing, exiting)`` token lists. The header implements the paper's
    protocol:

    * incoming barriers are raised one level, reserving Ω1 for wave
      termination inside the loop;
    * the merge outputs forward-branch values until a done-token arrives, then
      stalls the forward branch and recirculates the backedge;
    * loop-body-empty is detected when the backedge yields an empty wave (the
      hardware signature: two consecutive Ω1 tokens), after which the pending
      forward barrier is released at its original level;
    * exit edges lower all barriers by one level, removing the reserved Ω1.

    No timeouts — correct for arbitrarily long / nested loop bodies (the
    paper's fix over Aurochs).
    """
    out: list[Tok] = []
    wave: list[Tok] = []

    def drain(wave: list[Tok]) -> None:
        # Recirculate until the loop body is empty.
        while wave:
            cont, exits = body(wave)
            for e in exits:
                assert is_data(e)
                out.append(e)
            wave = cont

    for t in stream:
        if is_data(t):
            wave.append(t)
        else:
            # A barrier on the forward branch stalls new entries until the
            # body is empty (threads of one group never cross its barrier).
            drain(wave)
            wave = []
            out.append(t)  # released at its original level (raise+lower = id)
    drain(wave)
    return out
