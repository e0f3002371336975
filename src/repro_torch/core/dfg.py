"""Dataflow graph (DFG) — the compiler's target, mirroring §III-C / §V-C.

A program lowers to a graph of *contexts*. Each context is structured exactly
like the paper's virtual compute unit:

* **pipeline head** — merging / expansion / synchronization logic
  (:class:`SingleHead`, :class:`ZipHead`, :class:`ForwardMergeHead`,
  :class:`FwdBwdMergeHead`, :class:`CounterHead`, :class:`SourceHead`);
* **pipeline body** — a register program of element-wise operations,
  including memory operations (scratchpad / DRAM / atomics) chained by
  program order (the void-token discipline of §III-B(a) is implicit in the
  body's sequential op list and is made explicit when splitting);
* **pipeline tail** — outputs: unconditional, filtered (conditional branch),
  reducing (foreach exit), or barrier-lowering (loop exit / flatten).

Links carry SLTF streams (``core/sltf.py``). ``Link.depth`` records static
barrier nesting; ``Link.kind`` records the vector/scalar mapping decision of
the link-analysis pass (§V-D(a)).

Machine-model note (documented deviation, see DESIGN.md): our loop header
emits group barriers *only* on the exit edge and the reserved Ω1 wave markers
*only* on the backedge/body path. The paper routes the raised barrier through
the body; both disciplines are equivalent (the header is the single
synchronization point of a natural loop) and ours avoids a barrier round-trip
per group.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

# ---------------------------------------------------------------------------
# Links
# ---------------------------------------------------------------------------

@dataclass
class Link:
    id: int
    vars: tuple[str, ...]          # payload variable names (ordered)
    depth: int                     # static barrier nesting depth
    kind: str = "vector"           # "vector" | "scalar"  (§V-D(a))
    src: Optional[int] = None      # producer context id
    dst: Optional[int] = None      # consumer context id

    @property
    def nvars(self) -> int:
        return len(self.vars)


# ---------------------------------------------------------------------------
# Heads
# ---------------------------------------------------------------------------

@dataclass
class SourceHead:
    """Program entry: the launcher injects main()'s parameter tuple."""


@dataclass
class SingleHead:
    link: int


@dataclass
class ZipHead:
    """Wait-for-all element-wise alignment of parallel tensors (§III-C:
    "wait for all inputs to be available for element-wise operations").
    All links must carry identical barrier structure; payloads concatenate."""
    links: list[int]


@dataclass
class ForwardMergeHead:
    """Interleaves two forward branches; stalls at barriers until both sides
    reach an equal barrier, then emits one (§III-B(c))."""
    a: int
    b: int


@dataclass
class FwdBwdMergeHead:
    """Natural-loop header (§III-B(d)). Protocol state lives in the VM:
    forward tokens flow until a barrier arrives; then the loop recirculates
    via ``back`` until an empty wave (two consecutive Ω1) is observed, after
    which the pending forward barrier is released on the exit path."""
    fwd: int
    back: int


@dataclass
class CounterHead:
    """Expansion (§III-B(b)): each input token becomes a group of tokens with
    an appended counter value.

    ``add_level=True``  -> foreach: output barriers are input+1, each group
                           closed by (possibly implied) Ω1.
    ``add_level=False`` -> fork: expansion/flattening pair fused — children
                           appear at the *same* level, no group barriers.
    ``lo/hi/step`` name payload vars of the incoming link.
    """
    link: int
    lo: str
    hi: str
    step: str
    ivar: str
    add_level: bool = True


# ---------------------------------------------------------------------------
# Body ops (element-wise register program)
# ---------------------------------------------------------------------------

@dataclass
class BodyOp:
    """One pipeline-stage instruction. ``op`` is an IR binop/unop name or:
    const, mov, select, sram_load, sram_store, dram_load, dram_store,
    atomic_add, alloc, free. ``dst``/``srcs`` are register names (strings ==
    variable names; lowering keeps IR var names for debuggability)."""
    op: str
    dst: Optional[str]
    srcs: tuple[str, ...] = ()
    imm: Optional[int] = None
    space: Optional[str] = None    # memory space: SRAM pool or DRAM array name
    width: int = 32                # sub-word annotation (packing pass)
    pred: Optional[str] = None     # predicate register (predicated stores)


# ---------------------------------------------------------------------------
# Outputs (pipeline tail)
# ---------------------------------------------------------------------------

@dataclass
class Output:
    """One tail output.

    kind:
      "pass"    — every thread is sent.
      "filter"  — only threads with ``pred`` != 0 are sent (§III-B(c)).
      "reduce"  — associative reduction of the innermost dimension; emits one
                  token per Ω1 group carrying the accumulator; lowers barriers
                  by one (§III-B(b)).
      "discard" — tail of an Exit path: barriers pass, data is dropped.
    ``lower_barrier`` additionally applies `flatten` (Ω1 dropped, Ωn->Ωn-1) —
    used on loop-exit edges and yield relays.
    """
    link: int
    kind: str = "pass"
    values: tuple[str, ...] = ()
    pred: Optional[str] = None
    reduce_op: Optional[str] = None
    reduce_init: int = 0
    lower_barrier: bool = False


# ---------------------------------------------------------------------------
# Context & graph
# ---------------------------------------------------------------------------

Head = object


@dataclass
class Context:
    id: int
    name: str
    head: Head
    body: list[BodyOp] = field(default_factory=list)
    outs: list[Output] = field(default_factory=list)
    replicate_group: Optional[int] = None   # id shared by replicate copies
    replicate_copy: Optional[int] = None    # which copy this context is in
    nest_depth: int = 0                     # loop-nesting (placement priority)


@dataclass
class DFG:
    name: str = "prog"
    contexts: dict[int, Context] = field(default_factory=dict)
    links: dict[int, Link] = field(default_factory=dict)
    entry: Optional[int] = None             # context with SourceHead
    result_link: Optional[int] = None       # main()'s completion link
    dram: dict = field(default_factory=dict)      # name -> ir.DRAMArray
    pools: dict = field(default_factory=dict)     # name -> ir.SRAMPool
    _next_ctx: int = 0
    _next_link: int = 0

    # -- construction helpers -------------------------------------------------
    def new_link(self, vars: tuple[str, ...], depth: int) -> Link:
        l = Link(self._next_link, tuple(vars), depth)
        self.links[l.id] = l
        self._next_link += 1
        return l

    def new_context(self, name: str, head: Head, nest_depth: int = 0) -> Context:
        c = Context(self._next_ctx, name, head, nest_depth=nest_depth)
        self.contexts[c.id] = c
        self._next_ctx += 1
        for lid in head_links(head):
            self.links[lid].dst = c.id
        return c

    def attach_out(self, ctx: Context, out: Output) -> None:
        ctx.outs.append(out)
        self.links[out.link].src = ctx.id

    # -- queries ----------------------------------------------------------------
    def in_links(self, ctx: Context) -> list[int]:
        return head_links(ctx.head)

    def out_links(self, ctx: Context) -> list[int]:
        return [o.link for o in ctx.outs]

    def validate(self) -> None:
        for l in self.links.values():
            if l.dst is None:
                raise ValueError(f"link {l.id} ({l.vars}) has no consumer")
            if l.src is None and not isinstance(
                    self.contexts[l.dst].head, SourceHead):
                raise ValueError(f"link {l.id} ({l.vars}) has no producer")
        for c in self.contexts.values():
            for o in c.outs:
                link = self.links[o.link]
                if o.kind in ("pass", "filter") and not o.lower_barrier \
                        and len(o.values) != link.nvars:
                    raise ValueError(
                        f"ctx {c.name}: output arity {len(o.values)} != "
                        f"link {link.id} arity {link.nvars}")

    def context_depths(self) -> dict[int, int]:
        """Longest acyclic path length (in contexts) from the entry;
        loop-header backedges ignored.  Shared by the machine model's
        retiming estimates (``machine.map_graph``) and the placement
        stage's section ordering (``place.place_graph``)."""
        depth: dict[int, int] = {}
        order = list(self.contexts)
        for _ in range(len(order)):
            changed = False
            for cid in order:
                c = self.contexts[cid]
                d = 0
                for lid in head_links(c.head):
                    src = self.links[lid].src
                    if src is None:
                        continue
                    if isinstance(c.head, FwdBwdMergeHead) and \
                            lid == c.head.back:
                        continue   # ignore the backedge
                    d = max(d, depth.get(src, 0) + 1)
                if depth.get(cid) != d:
                    depth[cid] = d
                    changed = True
            if not changed:
                break
        return depth

    def topo_order(self) -> list[int]:
        """Context ids sorted by acyclic depth (ties broken by id) — the
        dataflow-forward order placement packs sections in."""
        depth = self.context_depths()
        return sorted(self.contexts, key=lambda cid: (depth.get(cid, 0), cid))

    def stats(self) -> dict:
        return {
            "contexts": len(self.contexts),
            "links": len(self.links),
            "body_ops": sum(len(c.body) for c in self.contexts.values()),
            "vector_links": sum(1 for l in self.links.values()
                                if l.kind == "vector"),
            "scalar_links": sum(1 for l in self.links.values()
                                if l.kind == "scalar"),
        }


def head_links(head: Head) -> list[int]:
    if isinstance(head, SourceHead):
        return []
    if isinstance(head, SingleHead):
        return [head.link]
    if isinstance(head, ZipHead):
        return list(head.links)
    if isinstance(head, ForwardMergeHead):
        return [head.a, head.b]
    if isinstance(head, FwdBwdMergeHead):
        return [head.fwd, head.back]
    if isinstance(head, CounterHead):
        return [head.link]
    raise TypeError(f"unknown head {head}")
