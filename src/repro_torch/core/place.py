"""Placement — the §III-C/§V-D machine mapping turned into an executable
compiler stage.

``machine.map_graph`` is an *analysis*: it prices every context in CU/MU/AG
terms and produces the Table IV resource report.  This module makes that
analysis load-bearing:

* :func:`place_graph` partitions the DFG's contexts into **sections** —
  groups that fit the physical fabric (``MachineParams`` CU/MU/AG caps plus
  a link-buffer budget) simultaneously.  A program whose whole graph fits is
  one section; under deliberately tiny parameters the partition splits in
  dataflow order (:meth:`~repro_torch.core.dfg.DFG.topo_order`), modeling the
  time-multiplexed configurations a real vRDA would run.
* For single-section programs it computes the §VI-B(a) **replication
  factor**: outer parallelism is scaled until ~``target`` (70%) of the
  critical resource is used — ``R = max(1, min_r target·cap_r/use_r)``.
  Multi-section programs don't replicate (the fabric is already
  oversubscribed), mirroring the paper's "scale until resources bound".
* The resulting :class:`Placement` rides on
  ``CompileResult.placement`` / ``CompiledProgram.placement`` when the
  pipeline spec contains the ``place`` stage (``CompileOptions(place=True)``
  or ``pipeline="...,place"``), keys the front-end compile cache
  (same ``MachineParams`` → hit, different → miss), and drives the
  replicated executor (``vector_vm.ReplicatedVectorVM``): each of the R
  replicas contributes one ``VLEN``-lane slice of every execution window,
  and batched requests shard across replicas.

The ``place`` registry entry itself is a *marker* pass: placement needs the
lowered DFG, which only exists after the IR pipeline, so the pass is an IR
identity and the compiler driver (``compiler.compile_program``) performs the
actual placement post-lowering when the spec requests it.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

from .dfg import DFG
from .machine import (ContextMap, MachineParams, MappingReport, map_graph,
                      scale_outer_parallelism)
from .pipeline import register_pass

__all__ = ["Placement", "PlacementError", "Section", "place_graph"]


class PlacementError(ValueError):
    """A context exceeds the machine's capacity on its own — no partition
    can make the program fit."""


@dataclass(frozen=True)
class Section:
    """One fabric-resident group of contexts: everything in a section is
    configured onto the array at once; sections execute in dataflow order
    (time-multiplexed on a machine smaller than the program)."""
    id: int
    context_ids: tuple[int, ...]
    cu: int
    mu: int
    ag: int
    vec_buf: int
    scal_buf: int

    def as_dict(self) -> dict:
        return {"id": self.id, "contexts": list(self.context_ids),
                "CU": self.cu, "MU": self.mu, "AG": self.ag,
                "vec_buf": self.vec_buf, "scal_buf": self.scal_buf}


@dataclass
class Placement:
    """The executable artifact of the mapping stage."""
    sections: list[Section]
    replicas: int                      # §VI-B(a) outer replication factor
    critical: str                      # resource that bounds replication
    utilization: dict[str, float]      # per-resource used/cap at R replicas
    params: MachineParams
    target: float
    report: MappingReport              # the underlying per-context analysis
    section_of: dict[int, int] = field(default_factory=dict)

    # (cache identity lives in CompileOptions.placement_token(), computed
    # before any Placement exists — machine params + target fully determine
    # the placement of a given DFG, so nothing more needs to key)

    # -- queries ------------------------------------------------------------
    @property
    def n_sections(self) -> int:
        return len(self.sections)

    def totals(self) -> dict:
        return {"CU": self.report.cu, "MU": self.report.mu,
                "AG": self.report.ag}

    def replica_lanes(self) -> int:
        """Machine lanes the placed program owns (Fig. 12 x-axis)."""
        return self.replicas * self.params.lanes

    def queue_capacities(self, g: DFG, vlen: int = 128,
                         floor_windows: int = 8,
                         cap_max: int = 1 << 16) -> dict[int, int]:
        """Device ring capacity per link for the resident executor
        (DESIGN.md §9), sized from this placement's link-buffer budgets.

        The floor is ``floor_windows * vlen`` words (full windows plus
        protocol-emission headroom); each link then scales by its
        destination context's buffer attribution from ``machine.map_graph``
        — links into a loop header carry the §V-D(b) deadlock-avoidance
        margin ``mu_deadlock``, links into a retimed merge/zip carry the
        path-imbalance margin ``mu_retime``.  The same budgets that size
        the physical FIFOs size the device rings.  Capacities round up to
        powers of two (ring indexing masks) and clamp at ``cap_max``."""
        margin = {cid: 1 for cid in g.contexts}
        for cm in self.report.per_context:
            margin[cm.ctx_id] = 1 + cm.mu_deadlock + cm.mu_retime
        base = floor_windows * vlen
        caps: dict[int, int] = {}
        for lid, l in g.links.items():
            n = base * margin.get(l.dst, 1)
            caps[lid] = min(cap_max, 1 << max(1, (int(n) - 1).bit_length()))
        return caps

    def as_dict(self) -> dict:
        return {
            "sections": [s.as_dict() for s in self.sections],
            "replicas": self.replicas,
            "critical": self.critical,
            "utilization": {k: round(v, 4)
                            for k, v in self.utilization.items()},
            "target": self.target,
            "totals": self.totals(),
            "machine": {"n_cu": self.params.n_cu, "n_mu": self.params.n_mu,
                        "n_ag": self.params.n_ag,
                        "lanes": self.params.lanes},
        }

    def table(self, name: str = "program") -> str:
        """Table IV-style resource report, grounded in this placement."""
        p = self.params
        lines = [
            f"placement: {name}  "
            f"(machine CU={p.n_cu} MU={p.n_mu} AG={p.n_ag})",
            f"  sections: {self.n_sections}   replicas: {self.replicas}  "
            f"({self.replica_lanes()} lanes)   critical: {self.critical}",
            "  section  contexts  CU  MU  AG  vec_buf  scal_buf",
        ]
        for s in self.sections:
            lines.append(
                f"  {s.id:>7}  {len(s.context_ids):>8}  {s.cu:>2}  "
                f"{s.mu:>2}  {s.ag:>2}  {s.vec_buf:>7}  {s.scal_buf:>8}")
        t = self.totals()
        util = "  ".join(f"{k}={self.utilization[k] * 100:.0f}%"
                         for k in sorted(self.utilization))
        lines.append(
            f"  total    CU={t['CU']} MU={t['MU']} AG={t['AG']}  "
            f"x{self.replicas} replicas -> utilization {util}")
        return "\n".join(lines)

    def validate(self, g: DFG) -> None:
        """Structural invariants: sections partition the contexts, fit the
        machine, and replication never overshoots the caps."""
        placed = [cid for s in self.sections for cid in s.context_ids]
        if sorted(placed) != sorted(g.contexts):
            raise PlacementError(
                f"sections do not partition the graph: placed {placed}, "
                f"graph has {sorted(g.contexts)}")
        p = self.params
        for s in self.sections:
            if s.cu > p.n_cu or s.mu > p.n_mu or s.ag > p.n_ag:
                raise PlacementError(
                    f"section {s.id} exceeds the machine: "
                    f"{s.cu}/{p.n_cu} CU, {s.mu}/{p.n_mu} MU, "
                    f"{s.ag}/{p.n_ag} AG")
        if self.replicas < 1:
            raise PlacementError(f"replicas must be >= 1, "
                                 f"got {self.replicas}")
        if self.n_sections == 1 and self.replicas > 1:
            for k, cap in (("CU", p.n_cu), ("MU", p.n_mu), ("AG", p.n_ag)):
                used = self.totals()[k] * self.replicas
                if used > cap:
                    raise PlacementError(
                        f"{self.replicas} replicas oversubscribe {k}: "
                        f"{used} > {cap}")


def _section_budgets(params: MachineParams) -> dict:
    """Per-section capacity: the machine's unit counts, plus a link-buffer
    budget — every CU contributes its input buffers, so a section can hold
    at most ``n_cu * vec_in_buffers`` buffered vector words (likewise
    scalar).  Links between co-resident contexts consume them; a section
    boundary spills to DRAM-backed staging instead (time-multiplexing)."""
    return {
        "cu": params.n_cu, "mu": params.n_mu, "ag": params.n_ag,
        "vec_buf": params.n_cu * params.vec_in_buffers,
        "scal_buf": params.n_cu * params.scal_in_buffers,
    }


def place_graph(g: DFG, widths: dict[str, int] | None = None,
                params: MachineParams | None = None, *,
                target: float = 0.7, packing: bool = True) -> Placement:
    """Partition the DFG into fabric-fitting sections and compute the
    replication factor (see module docstring)."""
    params = params or MachineParams()
    rep = map_graph(g, widths, params, packing=packing)
    by_ctx: dict[int, ContextMap] = {cm.ctx_id: cm for cm in rep.per_context}
    budget = _section_budgets(params)

    # SRAM-pool MU is charged to the first (dataflow-ordered) section whose
    # contexts use the pool; later sections reference it for free (the pool
    # stays resident — pools are global state, not per-section)
    pool_mu: dict[str, int] = {}
    for space in sorted({p for cm in rep.per_context for p in cm.pools}):
        pool = g.pools.get(space)
        if pool is None:
            continue
        pool_bytes = pool.n_bufs * pool.buf_words * 4
        pool_mu[space] = max(1, math.ceil(pool_bytes / params.mu_bytes))

    sections: list[Section] = []
    section_of: dict[int, int] = {}
    charged_pools: set[str] = set()
    cur: list[int] = []
    acc = {"cu": 0, "mu": 0, "ag": 0, "vec_buf": 0, "scal_buf": 0}
    cur_pools: set[str] = set()

    def ctx_cost(cid: int) -> dict:
        cm = by_ctx[cid]
        new_pools = [p for p in cm.pools
                     if p not in charged_pools and p not in cur_pools]
        return {"cu": cm.cu, "mu": cm.mu + sum(pool_mu.get(p, 0)
                                               for p in new_pools),
                "ag": cm.ag, "vec_buf": cm.vec_buf,
                "scal_buf": cm.scal_buf}

    def flush() -> None:
        nonlocal cur, acc, cur_pools
        if not cur:
            return
        sections.append(Section(
            id=len(sections), context_ids=tuple(cur), cu=acc["cu"],
            mu=acc["mu"], ag=acc["ag"], vec_buf=acc["vec_buf"],
            scal_buf=acc["scal_buf"]))
        for cid in cur:
            section_of[cid] = sections[-1].id
        charged_pools.update(cur_pools)
        cur, cur_pools = [], set()
        acc = {k: 0 for k in acc}

    for cid in g.topo_order():
        cost = ctx_cost(cid)
        over = any(cost[k] > budget[k] for k in budget)
        if over:
            raise PlacementError(
                f"context '{by_ctx[cid].name}' alone exceeds the machine "
                f"({cost} vs {budget}); no section split can place it")
        if cur and any(acc[k] + cost[k] > budget[k] for k in budget):
            flush()
            # cost stays valid across the flush: ctx_cost excludes pools in
            # charged_pools | cur_pools, and flush only moves cur_pools
            # into charged_pools (the exclusion union is unchanged)
        for k in acc:
            acc[k] += cost[k]
        cur_pools.update(by_ctx[cid].pools)
        cur.append(cid)
    flush()

    if len(sections) == 1:
        scale = scale_outer_parallelism(rep, params, target=target)
        replicas, critical = scale["outer"], scale["critical"]
        utilization = scale["utilization"]
    else:
        # the fabric is time-multiplexed; the busiest section sets pressure
        replicas, critical = 1, "CU"
        peak = {"CU": 0.0, "MU": 0.0, "AG": 0.0}
        for s in sections:
            peak["CU"] = max(peak["CU"], s.cu / params.n_cu)
            peak["MU"] = max(peak["MU"], s.mu / params.n_mu)
            peak["AG"] = max(peak["AG"], s.ag / max(params.n_ag, 1))
        critical = max(peak, key=peak.get)
        utilization = peak

    placement = Placement(
        sections=sections, replicas=replicas, critical=critical,
        utilization=dict(utilization), params=params, target=target,
        report=rep, section_of=section_of)
    placement.validate(g)
    return placement


@register_pass("place")
def _place_marker(prog, ctx):
    """Marker stage: placement consumes the lowered DFG, which does not
    exist while the IR pipeline runs, so this entry is an IR identity —
    its presence in the spec tells the compiler driver to run
    :func:`place_graph` after lowering (and the front-end cache to key on
    the machine parameters)."""
    ctx.stat("place_requested", 1)
    return prog
