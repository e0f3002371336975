"""VectorVM — the vectorized dataflow-threads executor (TPU execution model).

This is the Revet->TPU adaptation's core claim made executable: *threads are
records in dense queues; control flow is stream compaction + merging on full
vectors*. Each context processes up to ``VLEN`` tokens per tick:

* element-wise body ops run on whole windows (barrier lanes masked) — the
  analogue of the VPU executing a 128-lane vector;
* filter outputs compact surviving lanes (``kernels/stream_compact`` is the
  Pallas kernel for this hot spot);
* reductions use windowed segmented reduction with a carried accumulator
  (``kernels/segment_reduce``);
* the merge heads follow exactly the TokenVM protocols, but move data-*runs*
  per step instead of single tokens.

The lane-level primitives behind all four bullets live behind the pluggable
:class:`~repro_torch.core.backend.ExecutorBackend` (``core/backend.py``):
``backend="numpy"`` is the bit-exact TokenVM-validated oracle,
``backend="torch"`` (the default) dispatches through ``kernels/ops.py`` onto
the CUDA kernels (their plain torch versions for ``TorchBackend("cpu")``). The scheduler —
heads, queues, back-pressure, memory — is backend-agnostic; both backends
must produce identical outputs *and* identical ``stats`` token counts
(``tests/test_backends.py`` enforces this on every app).

The scheduler runs in *supersteps*: each tick snapshots the set of ready
contexts (tokens waiting and output room available) and fires them all,
instead of probing every context one at a time.

Queues are finite (the paper's deadlock-avoidance/retiming buffers, §V-D(b));
allocation back-pressure is modeled faithfully: a context stalls when its
pool's free list is empty, which produces the allocator-driven load balancing
of Fig. 14.

A cycle-approximate cost model runs alongside: a context firing k lanes costs
``ceil(k/LANES)`` issue slots on its (virtual) CU; the busiest context bounds
throughput (pipeline parallelism across contexts is free, as on the spatial
array). This replaces the paper's cycle-accurate simulator.

**Request batching** (DESIGN.md §7): one VM can serve ``n_requests`` fused
``main()`` invocations in a single launch. Every queue carries a hidden
request-id payload column; DRAM arrays are sized ``n_requests *`` the
compiled per-request size and every DRAM access is rebased by
``rid * per_request_size`` (bounds stay per-request, so an out-of-range
address can never touch a neighboring request's slice). Lanes from all
requests interleave freely in the same windows — that is the point: control
overhead (ticks, window dispatch, kernel launches) amortizes across the
batch. Lane-attributable stats are de-interleaved per request
(:meth:`VectorVM.request_stats`).
"""
from __future__ import annotations

import collections
from dataclasses import dataclass, field

import numpy as np

from . import ir
from .backend import (ExecutorBackend, _w32, make_backend,
                      segment_emit_pattern, wrap_dram_init)
from .dfg import (DFG, BodyOp, Context, CounterHead, ForwardMergeHead,
                  FwdBwdMergeHead, SingleHead, SourceHead, ZipHead,
                  head_links)

VLEN = 128          # TPU lane count (vs 16 on the paper's vRDA)
MACHINE_LANES = 16  # the vRDA's lanes — used by the cycle cost model

_DTYPE_MASK = {"i8": 0xFF, "i16": 0xFFFF, "i32": None}
_I64 = np.int64
_WRAP = np.uint32   # wrap-to-32-bit helper dtype

# reserved register carrying each lane's request id through every window;
# it rides as the last payload column of every queue and is never visible
# to compiled programs (IR variable names cannot start with "__")
RID = "__rid"

# stats attributable to individual lanes, hence to individual requests in a
# batched launch; scheduling counters (ticks, link_tokens) are shared by the
# whole launch and stay aggregate-only
LANE_STATS = ("body_ops", "dram_reads", "dram_writes", "sram_reads",
              "sram_writes", "atomics", "allocs", "frees")


class VectorDeadlock(RuntimeError):
    pass


class _Queue:
    """Compacting array FIFO of SLTF tokens: kinds[n] (0=data, k>0=Ω_k) and a
    [n, nvars] payload block."""

    __slots__ = ("kinds", "vals", "start", "end", "cap", "nvars")

    def __init__(self, nvars: int, cap: int):
        self.cap = cap
        self.nvars = nvars
        self.kinds = np.zeros(cap, _I64)
        self.vals = np.zeros((cap, nvars), _I64)
        self.start = 0
        self.end = 0

    def __len__(self) -> int:
        return self.end - self.start

    @property
    def room(self) -> int:
        return self.cap - len(self)

    def _compact(self, need: int) -> None:
        if self.end + need <= self.cap:
            return
        n = len(self)
        self.kinds[:n] = self.kinds[self.start:self.end]
        self.vals[:n] = self.vals[self.start:self.end]
        self.start, self.end = 0, n
        if self.end + need > self.cap:
            raise VectorDeadlock("queue overflow (capacity too small)")

    def push(self, kinds: np.ndarray, vals: np.ndarray | None) -> None:
        k = len(kinds)
        if k == 0:
            return
        self._compact(k)
        self.kinds[self.end:self.end + k] = kinds
        if self.nvars:
            self.vals[self.end:self.end + k] = vals
        self.end += k

    def peek(self, n: int) -> tuple[np.ndarray, np.ndarray]:
        n = min(n, len(self))
        return (self.kinds[self.start:self.start + n],
                self.vals[self.start:self.start + n])

    def pop(self, n: int) -> None:
        self.start += n


@dataclass
class _FBState:
    """One loop-header *session*: the wave protocol for one group in flight.
    Batched launches key sessions by request id (the group's rid), so
    independent requests' groups circulate in the loop concurrently — their
    lanes share windows — while each request's own groups stay serial.

    Modes: ``drain`` (waves circulating) -> ``wait`` (empty wave seen; the
    release barrier is *held* until every earlier-arrived session has
    released, so barrier order on every downstream link stays program order
    — concurrent sessions must not let completion order leak into the
    stream) -> ``echo`` (release emitted, awaiting its round trip)."""
    mode: str = "drain"        # "drain" | "wait" | "echo"
    pending: int = 0
    got_data: bool = False


@dataclass
class _CounterState:
    active: bool = False
    base: np.ndarray | None = None     # one payload row
    cur: int = 0
    hi: int = 0
    step: int = 1


@dataclass
class _RedState:
    acc: int = 0
    group_open: bool = False


class VectorVM:
    def __init__(self, g: DFG, dram_init: dict[str, np.ndarray] | None = None,
                 queue_cap: int = 1 << 16, vlen: int = VLEN,
                 pool_override: dict[str, int] | None = None,
                 backend: str | ExecutorBackend | None = "torch",
                 n_requests: int = 1):
        if n_requests < 1:
            raise ValueError(f"n_requests must be >= 1, got {n_requests}")
        self.g = g
        self.vlen = vlen
        self.backend = make_backend(backend)
        self.n_requests = int(n_requests)
        # every queue carries one extra payload column: the lane's request id
        self.queues: dict[int, _Queue] = {
            lid: _Queue(len(l.vars) + 1, queue_cap)
            for lid, l in g.links.items()}
        self.source = _Queue(len(getattr(g, "source_vars", ())) + 1,
                             max(64, self.n_requests + 1))
        # per-request logical size; the backing array is n_requests * that,
        # request r owning the window [r*size, (r+1)*size)
        self._dram_lim: dict[str, int] = {
            name: d.size for name, d in g.dram.items()}
        self.dram: dict[str, np.ndarray] = {
            name: np.zeros(d.size * self.n_requests, _I64)
            for name, d in g.dram.items()}
        if dram_init:
            for name, arr in dram_init.items():
                a = wrap_dram_init(arr, g.dram[name].dtype)
                self.dram[name][: a.size] = a
        self.pools: dict[str, np.ndarray] = {}
        self.free_lists: dict[str, collections.deque] = {}
        for name, pool in g.pools.items():
            n_bufs = (pool_override or {}).get(name, pool.n_bufs)
            self.pools[name] = np.zeros(n_bufs * pool.buf_words, _I64)
            self.free_lists[name] = collections.deque(range(n_bufs))
        self._fb: dict[int, dict[int, _FBState]] = {
            c.id: {} for c in g.contexts.values()
            if isinstance(c.head, FwdBwdMergeHead)}
        # cross-request group mixing in loops is only legal when no consumer
        # attributes pre-loop structure to values (see loop_mixing_hazards);
        # the analysis depends only on the immutable graph, so memoize it on
        # the DFG for the continuous-serving path (one VM per step_batch)
        if self.n_requests > 1:
            hazards = getattr(g, "_mixing_hazards", None)
            if hazards is None:
                hazards = g._mixing_hazards = loop_mixing_hazards(g)
            self._parallel_loops = not hazards
        else:
            self._parallel_loops = False
        self._cs = {c.id: _CounterState() for c in g.contexts.values()
                    if isinstance(c.head, CounterHead)}
        self._red: dict[tuple[int, int], _RedState] = {}
        # round-robin replicate steering: ctx id (solo) or (ctx id, rid)
        # (batched — steering must stay batch-invariant per request)
        self._rr: dict = {}
        for c in g.contexts.values():
            for oi, o in enumerate(c.outs):
                if o.kind == "reduce":
                    self._red[(c.id, oi)] = _RedState(o.reduce_init)
        self.stats: collections.Counter = collections.Counter()
        self.ctx_lane_cycles: collections.Counter = collections.Counter()
        self.ctx_busy_cycles: collections.Counter = collections.Counter()
        # open-stream serving state (admit_request/close_source): the source
        # stays open until the closing Ω1 barrier is pushed, so new requests
        # can join a launch already in flight (§III-B(d) applied across
        # requests — see api.WaveSession)
        self._order: list[Context] = list(g.contexts.values())
        self.source_closed = False
        # per-request attribution (batched launches only; the single-request
        # path keeps its historical zero-overhead accounting)
        self._rid_counters: dict[str, np.ndarray] = {}
        self._rid_ctx_lanes: dict[int, np.ndarray] = {}

    # ------------------------------------------------------------------ memory
    def _mask_arr(self, space: str, v: np.ndarray) -> np.ndarray:
        m = _DTYPE_MASK[self.g.dram[space].dtype]
        return _w32(v) if m is None else (v & m)

    def _attr(self, key: str, rids: np.ndarray, weight: int = 1) -> None:
        """Attribute ``len(rids)`` counted events (times ``weight``) to their
        requests. Only called on batched launches, and only with data-lane
        rids (barrier lanes carry best-effort ids and are never counted)."""
        if len(rids) == 0:
            return
        arr = self._rid_counters.get(key)
        if arr is None:
            arr = self._rid_counters[key] = np.zeros(self.n_requests, _I64)
        arr += np.bincount(rids, minlength=self.n_requests) * weight

    # ------------------------------------------------------------------- body
    def _exec_body(self, ctx: Context, kinds: np.ndarray,
                   regs: dict[str, np.ndarray]) -> bool:
        """Vector-execute ctx.body over a window. ``regs`` maps register ->
        int64 [k]. Barrier lanes compute garbage that is never read.
        Returns False if an allocation stalled (caller must shrink window)."""
        data = kinds == 0
        n = len(kinds)
        be = self.backend
        rid = regs[RID]
        batched = self.n_requests > 1
        for op in ctx.body:
            k = op.op
            if k == "const":
                regs[op.dst] = np.full(n, op.imm, _I64)
            elif k == "mov":
                regs[op.dst] = regs[op.srcs[0]].copy()
            elif k == "select":
                c, a, b = (regs[s] for s in op.srcs)
                regs[op.dst] = be.select(c, a, b)
            elif k == "not":
                regs[op.dst] = be.logical_not(regs[op.srcs[0]])
            elif k == "neg":
                regs[op.dst] = be.neg(regs[op.srcs[0]])
            elif k in ir.BINOPS:
                regs[op.dst] = be.binop(k, regs[op.srcs[0]],
                                        regs[op.srcs[1]])
            elif k == "sram_load":
                pool = self.g.pools[op.space]
                mem = self.pools[op.space]
                addr = regs[op.srcs[0]] * pool.buf_words + regs[op.srcs[1]]
                ok = data & (addr >= 0) & (addr < mem.size)
                out = np.zeros(n, _I64)
                out[ok] = mem[addr[ok]]
                regs[op.dst] = out
                self.stats["sram_reads"] += int(ok.sum())
                if batched:
                    self._attr("sram_reads", rid[ok])
            elif k == "sram_store":
                pool = self.g.pools[op.space]
                mem = self.pools[op.space]
                addr = regs[op.srcs[0]] * pool.buf_words + regs[op.srcs[1]]
                ok = data & (addr >= 0) & (addr < mem.size)
                if op.pred is not None:
                    ok &= regs[op.pred] != 0
                # in-order scatter: later lanes win on duplicate addresses
                mem[addr[ok]] = _w32(regs[op.srcs[2]])[ok]
                self.stats["sram_writes"] += int(ok.sum())
                if batched:
                    self._attr("sram_writes", rid[ok])
            elif k == "dram_load":
                a = self.dram[op.space]
                lim = self._dram_lim[op.space]
                addr = regs[op.srcs[0]]
                # bounds are per-request: a stray address must read zeros,
                # never a neighboring request's slice
                ok = data & (addr >= 0) & (addr < lim)
                if batched:
                    addr = addr + rid * lim
                out = np.zeros(n, _I64)
                out[ok] = a[addr[ok]]
                regs[op.dst] = out
                self.stats["dram_reads"] += int(ok.sum())
                if batched:
                    self._attr("dram_reads", rid[ok])
            elif k == "dram_store":
                a = self.dram[op.space]
                lim = self._dram_lim[op.space]
                addr = regs[op.srcs[0]]
                ok = data & (addr >= 0) & (addr < lim)
                if batched:
                    addr = addr + rid * lim
                if op.pred is not None:
                    ok &= regs[op.pred] != 0
                a[addr[ok]] = self._mask_arr(op.space, regs[op.srcs[1]][ok])
                self.stats["dram_writes"] += int(ok.sum())
                if batched:
                    self._attr("dram_writes", rid[ok])
            elif k == "atomic_add":
                regs[op.dst] = self._atomic_add(op.space, regs[op.srcs[0]],
                                                regs[op.srcs[1]], data, rid)
            elif k == "alloc":
                fl = self.free_lists[op.space]
                need = int(data.sum())
                if need > len(fl):
                    # callers pre-check via _alloc_limit
                    raise VectorDeadlock(
                        f"internal: unchecked alloc stall in {ctx.name}")
                ptrs = np.zeros(n, _I64)
                for i in np.nonzero(data)[0]:
                    ptrs[i] = fl.popleft()
                regs[op.dst] = ptrs
                self.stats["allocs"] += need
                if batched:
                    self._attr("allocs", rid[data])
            elif k == "free":
                fl = self.free_lists[op.space]
                for p in regs[op.srcs[0]][data]:
                    fl.append(int(p))
                self.stats["frees"] += int(data.sum())
                if batched:
                    self._attr("frees", rid[data])
            elif k == "rr_counter":
                seq = np.zeros(n, _I64)
                idxs = np.nonzero(data)[0]
                if batched:
                    # replicate steering is per-request: each request's lanes
                    # see the same round-robin sequence as in a solo run,
                    # keeping its copy routing batch-invariant
                    rids_d = rid[idxs]
                    for r in np.unique(rids_d):
                        m = idxs[rids_d == r]
                        base = self._rr.get((ctx.id, int(r)), 0)
                        seq[m] = (base + np.arange(len(m))) % op.imm
                        self._rr[(ctx.id, int(r))] = base + len(m)
                else:
                    base = self._rr.get(ctx.id, 0)
                    seq[idxs] = (base + np.arange(len(idxs))) % op.imm
                    self._rr[ctx.id] = base + len(idxs)
                regs[op.dst] = seq
            else:
                raise NotImplementedError(k)
        self.stats["body_ops"] += len(ctx.body) * int(data.sum())
        if batched and ctx.body:
            self._attr("body_ops", rid[data], weight=len(ctx.body))
        return True

    def _atomic_add(self, space: str, addr: np.ndarray, delta: np.ndarray,
                    data: np.ndarray, rid: np.ndarray) -> np.ndarray:
        """Vectorized fetch-and-add with *sequential-within-window* semantics:
        lane i observes the sum of all earlier lanes' deltas on its address."""
        a = self.dram[space]
        lim = self._dram_lim[space]
        n = len(addr)
        old = np.zeros(n, _I64)
        ok = data & (addr >= 0) & (addr < lim)
        if self.n_requests > 1:
            addr = addr + rid * lim
            self._attr("atomics", rid[ok])
        idxs = np.nonzero(ok)[0]
        if len(idxs) == 0:
            return old
        sub_addr = addr[idxs]
        sub_delta = delta[idxs]
        order = np.argsort(sub_addr, kind="stable")
        sa, sd = sub_addr[order], sub_delta[order]
        seg_start = np.r_[True, sa[1:] != sa[:-1]]
        csum = np.cumsum(sd) - sd                     # exclusive global prefix
        seg_id = np.cumsum(seg_start) - 1
        seg_base = csum[seg_start]                    # prefix at segment start
        prefix = csum - seg_base[seg_id]              # exclusive prefix / addr
        cur = a[sa]
        olds = cur + prefix
        old[idxs[order]] = olds
        np.add.at(a, sub_addr, sub_delta)
        a[np.unique(sub_addr)] = self._mask_arr(
            space, a[np.unique(sub_addr)])
        self.stats["atomics"] += len(idxs)
        return old

    # ------------------------------------------------------------------- tail
    # the two payload-assembly seams _route_window dispatches through —
    # the replicated executor overrides them with column-fill forms (same
    # values, fewer temporaries); everything else about routing is shared
    def _payload(self, regs: dict[str, np.ndarray], values, n: int,
                 rid: np.ndarray) -> np.ndarray:
        return np.stack([regs[v] for v in values] + [rid], axis=1)

    def _barrier_payload(self, n: int, nvars: int,
                         rid: np.ndarray) -> np.ndarray:
        return np.stack([np.zeros(n, _I64)] * (nvars - 1) + [rid], axis=1)

    def _route_window(self, ctx: Context, kinds: np.ndarray,
                      regs: dict[str, np.ndarray],
                      barrier_delta_map=None) -> None:
        """Send a processed window through every output (vectorized tail)."""
        n = len(kinds)
        data = kinds == 0
        rid = regs[RID]
        self.ctx_lane_cycles[ctx.id] += n
        self.ctx_busy_cycles[ctx.id] += max(
            -(-n // MACHINE_LANES), 1) if n else 0
        if self.n_requests > 1 and bool(data.any()):
            lanes = self._rid_ctx_lanes.get(ctx.id)
            if lanes is None:
                lanes = self._rid_ctx_lanes[ctx.id] = \
                    np.zeros(self.n_requests, _I64)
            lanes += np.bincount(rid[data], minlength=self.n_requests)
        be = self.backend
        for oi, o in enumerate(ctx.outs):
            q = self.queues[o.link]
            if o.kind == "reduce":
                self._reduce_out(ctx, oi, o, kinds, regs)
                continue
            if o.kind == "discard":
                keep = ~data
            elif o.kind == "filter" and bool(data.any()):
                keep = ~data | (regs[o.pred] != 0)
            else:
                # pass output, or barrier-only window: barriers reach all outs
                keep = None
            if o.values and bool(data.any()):
                # the request-id column rides every payload so compaction
                # and barrier lowering keep lane->request attribution
                # aligned (it is all-zero on single-request launches)
                payload = self._payload(regs, o.values, n, rid)
            elif self.n_requests > 1:
                # barrier-only / valueless windows still carry rid stamps
                payload = self._barrier_payload(n, q.nvars, rid)
            else:
                payload = None    # single-request fast path: zeros suffice
            out_kinds = kinds
            if keep is not None:
                out_kinds, payload = be.compact(keep, out_kinds, payload)
            if o.lower_barrier:
                out_kinds, payload = be.lower_barriers(out_kinds, payload)
            if payload is None:
                payload = np.zeros((len(out_kinds), q.nvars), _I64)
            q.push(out_kinds, payload)
            self.stats["link_tokens", o.link] += len(out_kinds)

    def _reduce_out(self, ctx, oi, o, kinds, regs) -> None:
        """Windowed segmented reduction with carried accumulator
        (= kernels/segment_reduce semantics), dispatched to the backend."""
        st = self._red[(ctx.id, oi)]
        vals = regs[o.values[0]] if o.values else None
        group_open_in = st.group_open
        out_kinds, out_vals, st.acc, st.group_open = \
            self.backend.segment_reduce(kinds, vals, o.reduce_op,
                                        o.reduce_init, st.acc, group_open_in)
        if self.n_requests > 1:
            # the emission pattern is a pure function of (kinds, group_open);
            # recompute it host-side so each emitted token inherits the
            # request id of the barrier that closed its group (empty groups
            # included); skipped on single-request launches (rid is 0)
            emit, lower, _open, _seg, _bar = \
                segment_emit_pattern(kinds, group_open_in)
            bar_rids = regs[RID][kinds > 0]
            keep2 = np.empty(2 * len(bar_rids), bool)
            keep2[0::2] = emit
            keep2[1::2] = lower
            out_rids = np.repeat(bar_rids, 2)[keep2]
            assert len(out_rids) == len(out_kinds), \
                f"{ctx.name}: reduce emission pattern diverged from backend"
        else:
            out_rids = np.zeros(len(out_kinds), _I64)
        q = self.queues[o.link]
        cols = ([out_vals] if q.nvars > 1 else []) + [out_rids]
        q.push(out_kinds, np.stack(cols, axis=1))
        self.stats["link_tokens", o.link] += len(out_kinds)

    # ------------------------------------------------------------------- heads
    def _min_out_room(self, ctx: Context) -> int:
        rooms = [self.queues[o.link].room for o in ctx.outs]
        return min(rooms) if rooms else 1 << 30

    def _fire(self, ctx: Context) -> bool:
        room = self._min_out_room(ctx)
        if room <= 0:
            return False
        h = ctx.head
        if isinstance(h, SourceHead):
            return self._fire_window(ctx, self.source,
                                     getattr(self.g, "source_vars", ()), room)
        if isinstance(h, SingleHead):
            return self._fire_window(ctx, self.queues[h.link],
                                     self.g.links[h.link].vars, room)
        if isinstance(h, ZipHead):
            return self._fire_zip(ctx, h, room)
        if isinstance(h, ForwardMergeHead):
            return self._fire_merge(ctx, h, room)
        if isinstance(h, FwdBwdMergeHead):
            return self._fire_fwdbwd(ctx, h, room)
        if isinstance(h, CounterHead):
            return self._fire_counter(ctx, h, room)
        raise TypeError(type(h))

    def _fire_window(self, ctx, q: _Queue, vars, room: int) -> bool:
        n = min(self.vlen, len(q), room)
        if n == 0:
            return False
        kinds, vals = q.peek(n)
        n = self._alloc_limit(ctx, kinds)
        if n == 0:
            return False
        kinds, vals = q.peek(n)
        regs = {v: vals[:, i].copy() for i, v in enumerate(vars)}
        regs[RID] = vals[:, -1].copy()
        assert self._exec_body(ctx, kinds, regs)
        self._route_window(ctx, kinds.copy(), regs)
        q.pop(n)
        return True

    def _alloc_limit(self, ctx, kinds) -> int:
        """Shrink a window so its allocations fit the free lists *before* any
        side effect runs (allocation back-pressure, Fig. 14)."""
        alloc_ops = [op for op in ctx.body if op.op == "alloc"]
        if not alloc_ops:
            return len(kinds)
        per_pool: dict[str, int] = {}
        for op in alloc_ops:
            per_pool[op.space] = per_pool.get(op.space, 0) + 1
        avail = min(len(self.free_lists[p]) // cnt
                    for p, cnt in per_pool.items())
        data_pos = np.nonzero(kinds == 0)[0]
        if avail >= len(data_pos):
            return len(kinds)
        if avail == 0:
            # let leading barriers through even when no allocation fits
            return int(data_pos[0]) if len(data_pos) else len(kinds)
        return int(data_pos[avail])  # stop before the first un-servable lane

    def _fire_zip(self, ctx, h: ZipHead, room) -> bool:
        qs = [self.queues[l] for l in h.links]
        links = [self.g.links[l] for l in h.links]
        n = min([len(q) for q in qs] + [self.vlen, room])
        if n == 0:
            return False
        peeked = [q.peek(n) for q in qs]
        # aligned prefix: identical kind sequences (backend run selection)
        ref = peeked[0][0][:n]
        L = self.backend.first_mismatch(ref, [k[:n] for k, _ in peeked[1:]])
        if L == 0:
            raise VectorDeadlock(f"zip structural mismatch in {ctx.name}")
        L = self._alloc_limit(ctx, ref[:L])
        if L == 0:
            return False
        kinds = ref[:L].copy()
        regs = {}
        for (ks, vals), link in zip(peeked, links):
            for i, v in enumerate(link.vars):
                regs[v] = vals[:L, i].copy()
        # aligned lanes belong to the same thread on every zipped link, so
        # any link's request-id column works; take the first
        regs[RID] = peeked[0][1][:L, -1].copy()
        assert self._exec_body(ctx, kinds, regs)
        self._route_window(ctx, kinds, regs)
        for q in qs:
            q.pop(L)
        return True

    def _fire_merge(self, ctx, h: ForwardMergeHead, room) -> bool:
        qa, qb = self.queues[h.a], self.queues[h.b]
        vars_a = self.g.links[h.a].vars
        budget = min(self.vlen, room)
        out_kinds: list[np.ndarray] = []
        out_vals: list[np.ndarray] = []
        emitted = 0
        while emitted < budget:
            ka, va = qa.peek(budget - emitted)
            kb, vb = qb.peek(budget - emitted)
            ra = self.backend.data_run(ka)
            rb = self.backend.data_run(kb)
            if ra:
                out_kinds.append(ka[:ra].copy())
                out_vals.append(va[:ra].copy())
                qa.pop(ra)
                emitted += ra
                continue
            if rb:
                out_kinds.append(kb[:rb].copy())
                out_vals.append(vb[:rb].copy())
                qb.pop(rb)
                emitted += rb
                continue
            if len(ka) and len(kb):
                if ka[0] != kb[0]:
                    raise VectorDeadlock(
                        f"merge barrier mismatch in {ctx.name}")
                row = np.zeros((1, len(vars_a) + 1), _I64)
                row[0, -1] = va[0, -1]    # barrier keeps its request id
                out_kinds.append(ka[:1].copy())
                out_vals.append(row)
                qa.pop(1)
                qb.pop(1)
                emitted += 1
                continue
            break
        if emitted == 0:
            return False
        kinds = np.concatenate(out_kinds)
        vals = np.concatenate(out_vals)
        regs = {v: vals[:, i].copy() for i, v in enumerate(vars_a)}
        regs[RID] = vals[:, -1].copy()
        if self._alloc_limit(ctx, kinds) < len(kinds):
            raise VectorDeadlock(f"alloc stall inside merge {ctx.name}; "
                                 "size the pool above the merge fan-in")
        assert self._exec_body(ctx, kinds, regs)
        self._route_window(ctx, kinds, regs)
        return True

    def _fire_fwdbwd(self, ctx, h: FwdBwdMergeHead, room) -> bool:
        """Natural-loop header with per-request wave *sessions* (§III-B(d)).

        Each group in flight is one :class:`_FBState` session keyed by the
        group barrier's request id. In a batched launch with
        ``_parallel_loops``, sessions of different requests overlap: their
        lanes recirculate in shared windows and each session's wave markers
        (stamped with its rid) are dispatched to its own state. Per-request
        token order is FIFO-preserved everywhere, so each session sees
        exactly the serial protocol. Forward intake stalls at the first
        token whose request already has an active session (a request's own
        groups never overlap); in serial mode (single request, or a graph
        with mixing hazards) *any* active session stalls intake — which is
        exactly the historical one-group-at-a-time protocol."""
        states = self._fb[ctx.id]
        qf, qb = self.queues[h.fwd], self.queues[h.back]
        vars_f = self.g.links[h.fwd].vars
        progress = False
        budget = min(self.vlen, room)
        while budget > 0:
            # -- ordered releases: the oldest completed session emits its
            # held group barrier once every earlier session has emitted
            released = False
            for rid_, st_ in states.items():
                if st_.mode == "echo":
                    continue
                if st_.mode == "wait":
                    self._route_window(ctx,
                                       np.array([st_.pending + 1], _I64),
                                       _empty_regs(vars_f, rid_))
                    st_.mode = "echo"
                    budget -= 1
                    progress = released = True
                break    # a draining session blocks all later releases
            if released:
                continue
            # -- backedge next: drain recirculating data so loop threads
            # retire (and free buffers) before new groups pile in
            kb, vb = qb.peek(budget)
            brun = self.backend.data_run(kb)
            if brun:
                done = self._process_run(ctx, vars_f, kb[:brun], vb[:brun])
                if done:
                    for r in np.unique(vb[:done, -1]):
                        st = states.get(int(r))
                        if st is not None:
                            st.got_data = True
                    qb.pop(done)
                    budget -= done
                    progress = True
                    continue
            elif len(kb):
                # wave marker / echo for the session it is stamped with
                lvl = int(kb[0])
                rid = int(vb[0, -1])
                st = states.get(rid)
                if st is None:
                    raise VectorDeadlock(
                        f"{ctx.name}: backedge barrier Ω{lvl} for request "
                        f"{rid} with no open loop session")
                if st.mode == "drain":
                    if lvl != 1:
                        raise VectorDeadlock(
                            f"{ctx.name}: bad backedge barrier")
                    qb.pop(1)
                    if st.got_data:
                        self._route_window(ctx, np.array([1], _I64),
                                           _empty_regs(vars_f, rid))
                        st.got_data = False
                        budget -= 1
                    else:
                        st.mode = "wait"    # release held for program order
                    progress = True
                    continue
                if st.mode == "wait":
                    raise VectorDeadlock(
                        f"{ctx.name}: backedge barrier Ω{lvl} for request "
                        f"{rid} while its release is still held")
                # echo: the released barrier came around; session closes
                if lvl != st.pending + 1:
                    raise VectorDeadlock(
                        f"{ctx.name}: expected Ω{st.pending + 1} echo, "
                        f"got {lvl}")
                qb.pop(1)
                del states[rid]
                progress = True
                continue
            # -- forward intake
            k, v = qf.peek(budget)
            if len(k) == 0:
                return progress
            run = self.backend.data_run(k)
            if run:
                admit = run
                if states:
                    if self._parallel_loops:
                        # stall at the first lane whose request has a group
                        # mid-flight (its data belongs to the *next* group)
                        active = np.fromiter(states, _I64, len(states))
                        blocked = np.isin(v[:run, -1], active)
                        hit = np.nonzero(blocked)[0]
                        admit = int(hit[0]) if len(hit) else run
                    else:
                        admit = 0
                if admit == 0:
                    return progress
                done = self._process_run(ctx, vars_f, k[:admit], v[:admit])
                if done == 0:
                    return progress
                qf.pop(done)
                budget -= done
                progress = True
                continue
            # group barrier: open a session for its request (unless that
            # request — or, serially, any request — still has one open)
            rid = int(v[0, -1])
            if (rid in states) if self._parallel_loops else bool(states):
                return progress
            self._route_window(ctx, np.array([1], _I64),
                               _empty_regs(vars_f, rid))
            states[rid] = _FBState(mode="drain", pending=int(k[0]))
            qf.pop(1)
            budget -= 1
            progress = True
        return progress

    def _process_run(self, ctx, vars, kinds, vals) -> int:
        """Execute a run (alloc-limited). Returns tokens actually consumed."""
        n = self._alloc_limit(ctx, kinds)
        if n == 0:
            return 0
        kinds, vals = kinds[:n], vals[:n]
        regs = {v: vals[:, i].copy() for i, v in enumerate(vars)}
        regs[RID] = vals[:, -1].copy()
        assert self._exec_body(ctx, kinds, regs)
        self._route_window(ctx, kinds.copy(), regs)
        return n

    def _fire_counter(self, ctx, h: CounterHead, room) -> bool:
        st = self._cs[ctx.id]
        q = self.queues[h.link]
        vars_in = self.g.links[h.link].vars
        budget = min(self.vlen, room)
        progress = False
        while budget > 0:
            if st.active:
                remaining = max(0, -(-(st.hi - st.cur) // st.step)) \
                    if st.step > 0 else 0
                emit = min(remaining, budget)
                if emit > 0:
                    emit = self._alloc_limit(ctx, np.zeros(emit, _I64))
                    if emit == 0:
                        return progress
                    idx = st.cur + st.step * np.arange(emit, dtype=_I64)
                    kinds = np.zeros(emit, _I64)
                    regs = {v: np.repeat(st.base[i], emit)
                            for i, v in enumerate(vars_in)}
                    regs[h.ivar] = idx
                    regs[RID] = np.repeat(st.base[-1], emit)
                    assert self._exec_body(ctx, kinds, regs)
                    self._route_window(ctx, kinds, regs)
                    st.cur += st.step * emit
                    budget -= emit
                    progress = True
                if st.cur >= st.hi or st.step <= 0:
                    st.active = False
                    if h.add_level:
                        # the group-close barrier carries the expanding
                        # thread's request id (reduce heads key empty-group
                        # emissions to it)
                        self._route_window(ctx, np.array([1], _I64),
                                           _empty_regs(list(vars_in)
                                                       + [h.ivar],
                                                       int(st.base[-1])))
                        budget -= 1
                        progress = True
                continue
            k, v = q.peek(1)
            if len(k) == 0:
                return progress
            if k[0] == 0:
                row = v[0]
                named = dict(zip(vars_in, row))
                st.base = row.copy()
                st.cur = int(named[h.lo])
                st.hi = int(named[h.hi])
                st.step = int(named[h.step]) or 1
                st.active = True
                q.pop(1)
                progress = True
            else:
                lvl = int(k[0]) + (1 if h.add_level else 0)
                self._route_window(ctx, np.array([lvl], _I64),
                                   _empty_regs(list(vars_in) + [h.ivar],
                                               int(v[0, -1])))
                q.pop(1)
                budget -= 1
                progress = True
        return progress

    # --------------------------------------------------------------- scheduler
    def _ready(self, ctx: Context) -> bool:
        """Conservative readiness: True whenever ``_fire`` *might* progress.

        Must never return False when ``_fire`` would return True — the
        superstep scheduler only fires the ready set, so a false negative
        would strand tokens. False positives merely waste one probe."""
        if self._min_out_room(ctx) <= 0:
            return False
        h = ctx.head
        if isinstance(h, SourceHead):
            return len(self.source) > 0
        if isinstance(h, SingleHead):
            return len(self.queues[h.link]) > 0
        if isinstance(h, ZipHead):
            return all(len(self.queues[l]) > 0 for l in h.links)
        if isinstance(h, ForwardMergeHead):
            return len(self.queues[h.a]) > 0 or len(self.queues[h.b]) > 0
        if isinstance(h, FwdBwdMergeHead):
            return (len(self.queues[h.fwd]) > 0
                    or len(self.queues[h.back]) > 0
                    or any(st.mode == "wait"
                           for st in self._fb[ctx.id].values()))
        if isinstance(h, CounterHead):
            return self._cs[ctx.id].active or len(self.queues[h.link]) > 0
        return True

    def _superstep(self, order: list[Context]) -> bool:
        """One batched tick: snapshot the ready set, then fire all of it.

        Firing all ready contexts against a tick-start snapshot (instead of
        probing every context one at a time) skips the idle majority of the
        graph each tick — on deep pipelines most contexts are waiting on
        upstream barriers at any moment."""
        ready = [ctx for ctx in order if self._ready(ctx)]
        progress = False
        for ctx in ready:
            if self._fire(ctx):
                progress = True
        return progress

    def run(self, max_ticks: int = 1_000_000, **params) -> dict[str, np.ndarray]:
        return self.run_batch([params], max_ticks=max_ticks)

    def run_batch(self, params_list: list[dict],
                  max_ticks: int = 1_000_000) -> dict[str, np.ndarray]:
        """Run one fused launch: request r's ``main()`` parameter tuple is
        ``params_list[r]`` and its DRAM slice is ``[r*size, (r+1)*size)`` of
        every array (see :meth:`request_dram`). All requests' thread groups
        interleave in the same superstep schedule — one source window admits
        up to ``vlen`` requests at once. Returns the fused DRAM image."""
        if len(params_list) != self.n_requests:
            raise ValueError(
                f"run_batch: got {len(params_list)} parameter sets for a VM "
                f"constructed with n_requests={self.n_requests}")
        src_vars = getattr(self.g, "source_vars", ())
        rows = np.zeros((len(params_list), len(src_vars) + 1), _I64)
        for r, params in enumerate(params_list):
            rows[r, : len(src_vars)] = [ir.wrap32(int(params[p]))
                                        for p in src_vars]
            rows[r, -1] = r
        self.source.push(np.zeros(len(params_list), _I64), rows)
        return self.finish_stream(max_ticks=max_ticks)

    # ----------------------------------------------------- open-stream serving
    # The bit-identity contract of request batching is schedule-independent:
    # streams are FIFO and per-request DRAM slices are disjoint, so pushing a
    # request's source row *while the wave is already running* is just
    # another valid schedule of the same closed batch.  These four methods
    # expose that: an async engine admits requests one at a time into a live
    # launch, and only the final Ω1 barrier fixes the wave's membership.

    def admit_request(self, rid: int, params: dict) -> None:
        """Push one request's ``main()`` parameter row onto the still-open
        source stream. Its thread group starts on the next superstep, merging
        into lanes freed by earlier requests (§III-B(d) across requests).
        The caller owns rid assignment and must have initialised the rid's
        DRAM slice before calling."""
        if self.source_closed:
            raise RuntimeError("admit_request after close_source")
        self._check_rid(rid)
        src_vars = getattr(self.g, "source_vars", ())
        row = np.zeros((1, len(src_vars) + 1), _I64)
        row[0, : len(src_vars)] = [ir.wrap32(int(params[p]))
                                   for p in src_vars]
        row[0, -1] = rid
        self.source.push(np.zeros(1, _I64), row)

    def close_source(self) -> None:
        """Seal the wave: push the single Ω1 barrier that every request's
        thread groups drain behind. After this, quiescence with tokens in
        flight is a real deadlock rather than an idle open wave."""
        if self.source_closed:
            return
        src_vars = getattr(self.g, "source_vars", ())
        self.source.push(np.ones(1, _I64),
                         np.zeros((1, len(src_vars) + 1), _I64))
        self.source_closed = True

    def advance(self, max_ticks: int = 1) -> bool:
        """Drive up to ``max_ticks`` supersteps; stop early when a superstep
        makes no progress. Returns True when the VM is idle (quiesced for
        now — with an open source that just means it is waiting for more
        admissions, not that it is done)."""
        for _ in range(max_ticks):
            progress = self._superstep(self._order)
            self.stats["ticks"] += 1
            if not progress:
                return True
        return not self._superstep_would_progress()

    def _superstep_would_progress(self) -> bool:
        return any(self._ready(ctx) for ctx in self._order)

    def finish_stream(self, max_ticks: int = 1_000_000) -> dict[str, np.ndarray]:
        """Close the source (if still open) and run the wave to quiescence.
        Raises :class:`VectorDeadlock` on tick exhaustion or stranded tokens.
        Returns the fused DRAM image."""
        self.close_source()
        for _tick in range(max_ticks):
            progress = self._superstep(self._order)
            self.stats["ticks"] += 1
            if not progress:
                break
        else:
            raise VectorDeadlock("tick limit exceeded")
        stuck = {lid: len(q) for lid, q in self.queues.items()
                 if len(q) and self.g.contexts[self.g.links[lid].dst].outs}
        if stuck:
            raise VectorDeadlock(f"quiescent with tokens in flight: {stuck}")
        return self.dram

    # ------------------------------------------------------- request splitting
    def request_dram(self, rid: int) -> dict[str, np.ndarray]:
        """De-interleave request ``rid``'s DRAM image out of the fused arrays
        (shaped exactly like a single-request run's DRAM dict)."""
        self._check_rid(rid)
        return {name: self.dram[name][rid * sz: (rid + 1) * sz].copy()
                for name, sz in self._dram_lim.items()}

    def request_stats(self, rid: int) -> collections.Counter:
        """Lane-attributable stats (:data:`LANE_STATS`) for one request.
        Matches what a sequential single-request run of the same request
        reports for those keys; scheduling counters (ticks, link_tokens) are
        launch-global and excluded. Zero entries are omitted, so summing over
        requests reproduces the aggregate ``stats`` restricted to
        :data:`LANE_STATS`."""
        self._check_rid(rid)
        if self.n_requests == 1:
            return collections.Counter(
                {k: int(self.stats[k]) for k in LANE_STATS
                 if self.stats.get(k)})
        return collections.Counter(
            {k: int(arr[rid]) for k, arr in sorted(self._rid_counters.items())
             if arr[rid]})

    def request_cycles(self, rid: int) -> int:
        """Cost-model cycles attributable to one request: the issue slots its
        lanes occupy on the busiest context. For a single-request launch this
        is the exact :meth:`estimated_cycles`; in a batch it is the request's
        share (a lower bound — barrier-only slots stay launch-global)."""
        self._check_rid(rid)
        if self.n_requests == 1:
            return self.estimated_cycles()
        return max((-(-int(arr[rid]) // MACHINE_LANES)
                    for arr in self._rid_ctx_lanes.values()), default=0)

    def _check_rid(self, rid: int) -> None:
        if not 0 <= rid < self.n_requests:
            raise IndexError(f"request id {rid} out of range "
                             f"[0, {self.n_requests})")

    # ------------------------------------------------------------- cost model
    def estimated_cycles(self) -> int:
        """Cycle-approximate runtime: the busiest context bounds the pipeline
        (spatial execution overlaps everything else)."""
        return max(self.ctx_busy_cycles.values(), default=0)

    def lane_occupancy(self) -> float:
        """Useful lanes / issued lane-slots — the anti-divergence metric that
        SIMT masking loses and dataflow threads keep (§VI-B(b))."""
        issued = sum(max(-(-n // MACHINE_LANES), 1) * MACHINE_LANES
                     for n in self.ctx_lane_cycles.values())
        useful = sum(self.ctx_lane_cycles.values())
        return useful / issued if issued else 1.0


def _empty_regs(vars, rid: int = 0) -> dict[str, np.ndarray]:
    regs = {v: np.zeros(1, _I64) for v in vars}
    regs[RID] = np.full(1, rid, _I64)
    return regs


# ---------------------------------------------------------------------------
# Replicated execution (core/place.py drives this)
# ---------------------------------------------------------------------------

class ReplicatedVectorVM(VectorVM):
    """Execute a *placed* program with R data-parallel graph replicas.

    The placement stage (``core/place.py``) computes the §VI-B(a) outer
    replication factor R: the spatial fabric holds R copies of the graph,
    each contributing ``VLEN`` lanes per firing — the lane-replication
    execution model Capstan's vector RDA assumes.  This executor models
    exactly that: every window is up to ``R * VLEN`` lanes wide (lane slice
    ``[r*VLEN, (r+1)*VLEN)`` standing for replica ``r``'s copy of the
    context), and batched requests shard across replicas round-robin by
    request id (``replica_of``).  Because the base VM's windows already
    interleave requests freely and every program admitted to batching is
    schedule-independent, widening the windows is *semantics-preserving*:
    outputs and per-request :data:`LANE_STATS` are bit-identical to the
    unreplicated fused path (asserted in ``tests/test_place.py`` and per
    cell in ``benchmarks/place_bench.py``).

    On top of the wider windows the replicated scheduler vectorizes the two
    head protocols whose one-token-at-a-time processing cannot fill R·VLEN
    lanes (the base :class:`VectorVM` keeps the simple per-token forms — it
    is the TokenVM-validated oracle this executor is verified against):

    * **counter heads** drain many input rows per firing, assembling each
      row's expansion *and* its group-close barrier into one window
      (contexts with allocations keep the base path — allocation
      back-pressure must stall *between* expansions);
    * **merge heads** consume runs of equal barrier pairs in one step
      instead of one pair per probe (with B requests the barrier streams
      arrive B-deep);
    * window payloads are assembled by column fill (:meth:`_payload`)
      rather than ``np.stack`` — the same values, fewer temporaries.

    Per-replica accounting: :meth:`replica_stats` aggregates
    :data:`LANE_STATS` over the replica's requests; :meth:`replica_cycles`
    is the replica's share of the busiest context's issue slots.  The
    whole-launch cost model (:meth:`estimated_cycles`) divides by the lanes
    a window actually spans, so R replicas genuinely model R× issue width.
    """

    def __init__(self, g: DFG, dram_init: dict[str, np.ndarray] | None = None,
                 n_replicas: int | None = None, placement=None, **kw):
        if n_replicas is None:
            n_replicas = placement.replicas if placement is not None else 1
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        kw.setdefault("vlen", n_replicas * VLEN)
        super().__init__(g, dram_init, **kw)
        self.n_replicas = int(n_replicas)
        self.placement = placement
        self._ctx_has_alloc = {c.id: any(op.op == "alloc" for op in c.body)
                               for c in g.contexts.values()}
        # payload scratch buffers, one per column count: at R*VLEN lanes the
        # per-window np.empty/np.zeros in the payload seams dominates window
        # assembly (the ip2int R-curve cliff) — every consumer of a payload
        # copies it (queue push, backend compact), so one buffer per width
        # can back every window
        self._payload_bufs: dict[int, np.ndarray] = {}

    # -------------------------------------------------------- replica views
    def replica_of(self, rid: int) -> int:
        """Which replica serves request ``rid`` (round-robin sharding —
        batch-invariant, so growing the batch never re-shards a request)."""
        self._check_rid(rid)
        return rid % self.n_replicas

    def replica_requests(self, replica: int) -> list[int]:
        if not 0 <= replica < self.n_replicas:
            raise IndexError(f"replica {replica} out of range "
                             f"[0, {self.n_replicas})")
        return list(range(replica, self.n_requests, self.n_replicas))

    def replica_stats(self, replica: int) -> collections.Counter:
        """Aggregate :data:`LANE_STATS` over the replica's requests."""
        out: collections.Counter = collections.Counter()
        for rid in self.replica_requests(replica):
            out.update(self.request_stats(rid))
        return out

    def replica_cycles(self, replica: int) -> int:
        """Issue slots the replica's lanes occupy on its busiest context."""
        rids = self.replica_requests(replica)
        if not rids:
            return 0
        if self.n_requests == 1:
            return self.estimated_cycles()
        return max(
            (-(-int(sum(arr[r] for r in rids)) // MACHINE_LANES)
             for arr in self._rid_ctx_lanes.values()), default=0)

    # ---------------------------------------------------------- fast payload
    def _pooled(self, n: int, ncols: int) -> np.ndarray:
        """A reusable ``[n, ncols]`` scratch block.  Valid until the next
        same-width request — callers hand it straight to ``_Queue.push`` /
        ``backend.compact``, both of which copy."""
        buf = self._payload_bufs.get(ncols)
        if buf is None or len(buf) < n:
            buf = self._payload_bufs[ncols] = np.empty(
                (max(n, self.vlen), ncols), _I64)
        return buf[:n]

    def _payload(self, regs: dict[str, np.ndarray], values, n: int,
                 rid: np.ndarray) -> np.ndarray:
        out = self._pooled(n, len(values) + 1)
        for i, v in enumerate(values):
            out[:, i] = regs[v]
        out[:, -1] = rid
        return out

    def _barrier_payload(self, n: int, nvars: int,
                         rid: np.ndarray) -> np.ndarray:
        out = self._pooled(n, nvars)
        out[:, :-1] = 0
        out[:, -1] = rid
        return out

    # ------------------------------------------------- vectorized counters
    def _fire_counter(self, ctx, h: CounterHead, room) -> bool:
        """Drain many counter inputs per firing: each data row's expansion,
        its group-close barrier, and any pass-through barriers assemble into
        one window, in exactly the base path's emission order — one
        ``R*VLEN``-wide firing instead of one window per input row."""
        if self._ctx_has_alloc[ctx.id]:
            return super()._fire_counter(ctx, h, room)
        st = self._cs[ctx.id]
        q = self.queues[h.link]
        vars_in = self.g.links[h.link].vars
        ncols = len(vars_in)
        budget = min(self.vlen, room)
        kparts: list[np.ndarray] = []
        pparts: list[np.ndarray] = []
        iparts: list[np.ndarray] = []
        total = 0
        consumed = False
        while total < budget:
            if st.active:
                remaining = max(0, -(-(st.hi - st.cur) // st.step)) \
                    if st.step > 0 else 0
                emit = min(remaining, budget - total)
                if emit > 0:
                    idx = st.cur + st.step * np.arange(emit, dtype=_I64)
                    kparts.append(np.zeros(emit, _I64))
                    pparts.append(np.broadcast_to(st.base, (emit, ncols + 1)))
                    iparts.append(idx)
                    st.cur += st.step * emit
                    total += emit
                if st.cur >= st.hi or st.step <= 0:
                    st.active = False
                    if h.add_level:
                        row = np.zeros((1, ncols + 1), _I64)
                        row[0, -1] = st.base[-1]
                        kparts.append(np.ones(1, _I64))
                        pparts.append(row)
                        iparts.append(np.zeros(1, _I64))
                        total += 1
                    continue
                break                 # budget exhausted mid-expansion
            k, v = q.peek(1)
            if len(k) == 0:
                break
            if k[0] == 0:
                row = v[0]
                named = dict(zip(vars_in, row))
                st.base = row.copy()
                st.cur = int(named[h.lo])
                st.hi = int(named[h.hi])
                st.step = int(named[h.step]) or 1
                st.active = True
                q.pop(1)
                consumed = True
            else:
                lvl = int(k[0]) + (1 if h.add_level else 0)
                row = np.zeros((1, ncols + 1), _I64)
                row[0, -1] = v[0, -1]
                kparts.append(np.full(1, lvl, _I64))
                pparts.append(row)
                iparts.append(np.zeros(1, _I64))
                q.pop(1)
                total += 1
        if not kparts:
            return consumed
        kinds = np.concatenate(kparts)
        payload = np.concatenate([np.asarray(p) for p in pparts], axis=0)
        regs = {v: payload[:, i].copy() for i, v in enumerate(vars_in)}
        regs[h.ivar] = np.concatenate(iparts)
        regs[RID] = payload[:, -1].copy()
        assert self._exec_body(ctx, kinds, regs)
        self._route_window(ctx, kinds, regs)
        return True

    # ------------------------------------------------- batched merge pairs
    def _fire_merge(self, ctx, h: ForwardMergeHead, room) -> bool:
        """Base merge protocol, but runs of *equal barrier pairs* are
        consumed in one step (a B-request batch stacks B group barriers
        back to back on both inputs).  Allocating merge contexts keep the
        base ``VLEN`` window cap: the merge path *raises* on an alloc
        stall ("size the pool above the merge fan-in"), so widening the
        window to R*VLEN would raise the pool-size contract by R for a
        program that completes unreplicated."""
        qa, qb = self.queues[h.a], self.queues[h.b]
        vars_a = self.g.links[h.a].vars
        budget = min(VLEN if self._ctx_has_alloc[ctx.id] else self.vlen,
                     room)
        out_kinds: list[np.ndarray] = []
        out_vals: list[np.ndarray] = []
        emitted = 0
        while emitted < budget:
            ka, va = qa.peek(budget - emitted)
            kb, vb = qb.peek(budget - emitted)
            ra = self.backend.data_run(ka)
            rb = self.backend.data_run(kb)
            if ra:
                out_kinds.append(ka[:ra].copy())
                out_vals.append(va[:ra].copy())
                qa.pop(ra)
                emitted += ra
                continue
            if rb:
                out_kinds.append(kb[:rb].copy())
                out_vals.append(vb[:rb].copy())
                qb.pop(rb)
                emitted += rb
                continue
            if len(ka) and len(kb):
                m = min(len(ka), len(kb))
                pair = (ka[:m] > 0) & (ka[:m] == kb[:m])
                stop = np.nonzero(~pair)[0]
                nb = int(stop[0]) if len(stop) else m
                if nb == 0:
                    raise VectorDeadlock(
                        f"merge barrier mismatch in {ctx.name}")
                rows = np.zeros((nb, len(vars_a) + 1), _I64)
                rows[:, -1] = va[:nb, -1]   # barriers keep their request id
                out_kinds.append(ka[:nb].copy())
                out_vals.append(rows)
                qa.pop(nb)
                qb.pop(nb)
                emitted += nb
                continue
            break
        if emitted == 0:
            return False
        kinds = np.concatenate(out_kinds)
        vals = np.concatenate(out_vals)
        regs = {v: vals[:, i].copy() for i, v in enumerate(vars_a)}
        regs[RID] = vals[:, -1].copy()
        if self._alloc_limit(ctx, kinds) < len(kinds):
            raise VectorDeadlock(f"alloc stall inside merge {ctx.name}; "
                                 "size the pool above the merge fan-in")
        assert self._exec_body(ctx, kinds, regs)
        self._route_window(ctx, kinds, regs)
        return True


# ---------------------------------------------------------------------------
# Batch-mixing safety analysis
# ---------------------------------------------------------------------------

def loop_mixing_hazards(g: DFG) -> list[str]:
    """Static reasons why cross-request group mixing in loops is unsafe.

    When loop sessions of different requests overlap, tokens *downstream of a
    loop header* interleave across requests while per-request order is
    preserved. That is invisible to order-insensitive consumers (element-wise
    bodies, filters, forward merges — which only align identical barrier
    sequences — and counters, whose sub-group structure is created locally
    per input token). It corrupts exactly two patterns:

    * a **value-carrying reduce** that segments structure created *upstream*
      of the loop (input depth <= the loop's backedge depth): lanes of
      request s that interleave before request r's group barrier would fold
      into r's accumulator;
    * a **zip of loop-ordered and program-ordered streams** whose values are
      actually consumed: session completion order need not match program
      order, so pairs would misalign.

    Valueless instances of both (the lowered ``foreach.join`` completion
    pattern) only count tokens per group, which is order-independent — they
    stay safe. Returns a list of human-readable hazards; empty means a
    batched VM may run loop sessions of different requests concurrently."""
    hazards: list[str] = []
    succ: dict[int, set[int]] = {cid: set() for cid in g.contexts}
    for c in g.contexts.values():
        for o in c.outs:
            dst = g.links[o.link].dst
            if dst is not None:
                succ[c.id].add(dst)
    for head_ctx in g.contexts.values():
        if not isinstance(head_ctx.head, FwdBwdMergeHead):
            continue
        bdepth = g.links[head_ctx.head.back].depth
        cone: set[int] = set()
        stack = [head_ctx.id]
        while stack:
            x = stack.pop()
            for y in succ[x]:
                if y not in cone:
                    cone.add(y)
                    stack.append(y)
        for cid in sorted(cone):
            c = g.contexts[cid]
            in_depth = max((g.links[l].depth for l in head_links(c.head)),
                           default=0)
            for o in c.outs:
                if o.kind == "reduce" and in_depth <= bdepth \
                        and _link_values_read(g, o.link):
                    hazards.append(
                        f"{c.name}: value-carrying reduce over pre-loop "
                        f"structure (depth {in_depth} <= {bdepth}) "
                        f"downstream of loop {head_ctx.name}")
            if isinstance(c.head, ZipHead):
                inside = [g.links[l].src == head_ctx.id
                          or g.links[l].src in cone
                          for l in c.head.links]
                if any(inside) and not all(inside) \
                        and (c.body or any(o.values for o in c.outs)):
                    hazards.append(
                        f"{c.name}: zip joins loop-ordered and "
                        f"program-ordered streams and consumes values "
                        f"(downstream of loop {head_ctx.name})")
    return hazards


def _link_values_read(g: DFG, link_id: int) -> bool:
    """Do any of this link's payload vars feed computation at the consumer?"""
    link = g.links[link_id]
    if not link.vars or link.dst is None:
        return False
    c = g.contexts[link.dst]
    reads: set[str] = set()
    for op in c.body:
        reads.update(op.srcs)
        if op.pred:
            reads.add(op.pred)
    for o in c.outs:
        reads.update(o.values)
        if o.pred:
            reads.add(o.pred)
    return bool(set(link.vars) & reads)
