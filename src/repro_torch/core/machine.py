"""Abstract vRDA machine model + mapping (§III-C, §V-D, Table II/IV).

Maps the virtual dataflow graph onto physically-constrained units:

* **CU** — 16 lanes × 6 pipeline stages (one element-wise op per stage),
  4 vector + 4 scalar input buffers, 4+4 outputs;
* **MU** — 256 KiB scratchpad (16 banks) — holds SRAM pools, allocator
  free-list queues, deadlock-avoidance and retiming buffers;
* **AG** — DRAM address generator: one per random-access / bulk stream.

The mapping follows §V-D(b): memory operations are placed into their own
contexts first, then over-size compute contexts are split by stage count and
input/output/buffer budgets. Merge heads, counters, constant and void inputs
are free (they use the pipeline-head logic), but their *links* consume input
buffers — only two vector-vector merges fit per context.

Sub-word packing (§V-B(d)) changes a link's buffer cost: packed links carry
``ceil(Σ width_i / 32)`` words instead of one word per live value.

This is an analytical mapping (the execution VMs run the *virtual* graph);
it produces the Table IV-style resource report and the Fig. 12 ablations.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, fields

from .dfg import (DFG, Context, CounterHead, ForwardMergeHead,
                  FwdBwdMergeHead, SingleHead, SourceHead, ZipHead,
                  head_links)

_MEM_OPS = {"sram_load", "sram_store", "alloc", "free", "atomic_add"}
_DRAM_OPS = {"dram_load", "dram_store"}
_FREE_OPS = {"mov"}          # register renames are absorbed into routing


@dataclass(frozen=True)
class MachineParams:
    """Table II."""
    n_cu: int = 200
    n_mu: int = 200
    n_ag: int = 80
    lanes: int = 16
    stages: int = 6
    vec_in_buffers: int = 4
    scal_in_buffers: int = 4
    vec_outputs: int = 4
    scal_outputs: int = 4
    mu_bytes: int = 256 * 1024
    net_vec: int = 3
    net_scal: int = 6
    dram_gbps: float = 900.0
    freq_ghz: float = 1.6

    def token(self) -> tuple:
        """Hashable identity — keys the front-end compile cache when a
        placement stage is in the pipeline (see ``api._make_key``)."""
        return tuple(getattr(self, f.name) for f in fields(self))


@dataclass
class ContextMap:
    """Per-context resource accounting.  ``mu_deadlock``/``mu_retime`` and
    ``pools`` attribute the graph-level MU totals back to the contexts that
    cause them, so the placement stage (``core/place.py``) can pack contexts
    into resource-bounded sections without re-deriving the analysis."""
    name: str
    ctx_id: int = -1
    cu: int = 0
    mu: int = 0
    ag: int = 0
    stages_used: int = 0
    vec_buf: int = 0
    scal_buf: int = 0
    mu_deadlock: int = 0
    mu_retime: int = 0
    pools: tuple[str, ...] = ()


@dataclass
class MappingReport:
    per_context: list[ContextMap] = field(default_factory=list)
    cu: int = 0                  # compute contexts (inner logic)
    mu_sram: int = 0             # SRAM pools
    mu_deadlock: int = 0         # cyclic-region buffers (§V-D(b))
    mu_retime: int = 0           # path-imbalance retiming buffers
    ag: int = 0
    vec_links: int = 0
    scal_links: int = 0
    packed_words_saved: int = 0

    @property
    def mu(self) -> int:
        return self.mu_sram + self.mu_deadlock + self.mu_retime

    def totals(self) -> dict:
        return {"CU": self.cu, "MU": self.mu, "AG": self.ag,
                "MU_sram": self.mu_sram, "MU_deadlock": self.mu_deadlock,
                "MU_retime": self.mu_retime,
                "vec_links": self.vec_links, "scal_links": self.scal_links,
                "packed_words_saved": self.packed_words_saved}


def link_words(g: DFG, lid: int, widths: dict[str, int],
               packing: bool) -> int:
    """Buffer words one link's payload occupies (§V-B(d) packing)."""
    link = g.links[lid]
    if not link.vars:
        return 1                           # void token still needs a slot
    if not packing:
        return len(link.vars)
    bits = sum(min(widths.get(v, 32), 32) for v in link.vars)
    return max(1, math.ceil(bits / 32))


def map_graph(g: DFG, widths: dict[str, int] | None = None,
              params: MachineParams | None = None,
              packing: bool = True) -> MappingReport:
    params = params or MachineParams()
    widths = widths or {}
    rep = MappingReport()

    # ---- link analysis (§V-D(a)): defaults chosen by lowering; count them
    for l in g.links.values():
        if l.kind == "vector":
            rep.vec_links += 1
        else:
            rep.scal_links += 1
        if packing:
            rep.packed_words_saved += (len(l.vars)
                                       - link_words(g, l.id, widths, True))

    # ---- per-context splitting (§V-D(b))
    for c in g.contexts.values():
        cm = ContextMap(c.name, ctx_id=c.id)
        cm.pools = tuple(sorted({op.space for op in c.body
                                 if op.op in _MEM_OPS and op.space}))
        compute_ops = [op for op in c.body
                       if op.op not in _MEM_OPS | _DRAM_OPS | _FREE_OPS]
        sram_ops = [op for op in c.body if op.op in _MEM_OPS]
        dram_ops = [op for op in c.body if op.op in _DRAM_OPS]

        # input buffers from head links
        for lid in head_links(c.head):
            w = link_words(g, lid, widths, packing)
            if g.links[lid].kind == "vector":
                cm.vec_buf += w
            else:
                cm.scal_buf += w

        # every DRAM op is an AG stream
        cm.ag += len(dram_ops)

        # compute splitting: stages per CU, and buffer-driven splits
        n_stage_cu = math.ceil(len(compute_ops) / params.stages) \
            if compute_ops else 0
        n_buf_cu = max(math.ceil(cm.vec_buf / params.vec_in_buffers),
                       math.ceil(cm.scal_buf / params.scal_in_buffers), 0)
        n_out_cu = math.ceil(len(c.outs) / params.vec_outputs) \
            if c.outs else 0
        cm.cu = max(n_stage_cu, n_buf_cu, n_out_cu,
                    0 if (not compute_ops and not c.outs
                          and isinstance(c.head, SingleHead)) else 1)
        cm.stages_used = len(compute_ops)
        rep.per_context.append(cm)
        rep.cu += cm.cu
        rep.ag += cm.ag

    # ---- SRAM pools: counted once globally (pool bytes / MU capacity)
    pools_used = {op.space for c in g.contexts.values() for op in c.body
                  if op.op in _MEM_OPS and op.space}
    for space in sorted(pools_used):
        pool = g.pools.get(space)
        if pool is None:
            continue
        pool_bytes = pool.n_bufs * pool.buf_words * 4
        rep.mu_sram += max(1, math.ceil(pool_bytes / params.mu_bytes))

    # ---- deadlock-avoidance + retiming MU, attributed per context so the
    # placement stage can pack them into sections (§V-D(b))
    by_ctx = {cm.ctx_id: cm for cm in rep.per_context}
    depth = g.context_depths()
    for c in g.contexts.values():
        cm = by_ctx[c.id]
        if isinstance(c.head, FwdBwdMergeHead):
            cm.mu_deadlock += 1
            rep.mu_deadlock += 1
        if isinstance(c.head, (ForwardMergeHead, ZipHead)):
            lids = head_links(c.head)
            srcs = [g.links[l].src for l in lids if g.links[l].src is not None]
            if len(srcs) >= 2:
                ds = [depth.get(s, 0) for s in srcs]
                imbalance = max(ds) - min(ds)
                retime = math.ceil(imbalance / 4)
                cm.mu_retime += retime
                rep.mu_retime += retime
        cm.mu = cm.mu_deadlock + cm.mu_retime
    return rep


def scale_outer_parallelism(rep: MappingReport, params: MachineParams | None
                            = None, target: float = 0.7) -> dict:
    """Paper §VI-B(a): scale outer parallelism until ~70% of the critical
    resource is used. Returns the replication factor and totals."""
    params = params or MachineParams()
    base = {"CU": max(rep.cu, 1), "MU": max(rep.mu, 1), "AG": max(rep.ag, 1)}
    cap = {"CU": params.n_cu, "MU": params.n_mu, "AG": params.n_ag}
    outer = max(1, min(int(target * cap[k] / base[k]) for k in base))
    used = {k: base[k] * outer for k in base}
    critical = max(base, key=lambda k: used[k] / cap[k])
    return {"outer": outer, "lanes": outer * params.lanes,
            "used": used, "critical": critical,
            "utilization": {k: used[k] / cap[k] for k in base}}
