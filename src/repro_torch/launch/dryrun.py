"""Multi-pod dry-run: run every (architecture × input shape)'s step
sharded over the production meshes, on ``DTensor``s of ``meta`` shards,
and extract the roofline raw material.  It touches no device.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

``main`` first initialises a ``"fake"`` process group of the mesh's size
(256 or 512 ranks, this process rank 0; no communication happens), as the
reference sets ``XLA_FLAGS`` for 512 host devices first, and destroys it
after each mesh.  Each argument leaf is laid out by its sharding, the
step (the models' own ``train_step`` / ``prefill_step`` / ``serve_step``)
runs on those DTensors under ``set_act_mesh(mesh)``, and each output is
redistributed to its ``out_shardings`` entry, as ``jax.jit`` forces it.
Per cell this writes ``artifacts/dryrun_torch/<mesh>/<arch>__<shape>.json``
with:
  * ``memory_analysis``: per-device argument and output bytes, summed from
    each leaf's shard (``to_local()``);
  * ``traced_flops``: the step's FLOPs at global shapes
    (``torch.utils.flop_counter.FlopCounterMode`` over the sharded step,
    each op on a ``per_shard`` region's shards counted once a shard:
    :class:`GlobalFlops`), and ``roofline.compute_s`` from them;
  * ``collective_bytes``: the per-device output bytes of every collective
    DTensor issued (:class:`CollectiveBytes`), by the reference's kinds,
    with ``total``; ``collective_ops``, their numbers (equal in sum to
    ``CommDebugMode``'s); ``roofline.collective_s`` = total / (devices x
    ``LINK_BW``), the reference's formula.  The layers run as a Python
    loop, so every layer's collectives are counted as they run (the
    reference scales its while bodies by the layer count);
  * the analytic ``model_flops`` and ``tokens``, as the reference;
  * ``departures``: the reference's keys that have no counterpart without
    a compiled, partitioned program.

A leaf whose sharding cannot be laid out (an axis the mesh lacks, a dim
that does not divide), an op DTensor has no sharding rule for, a
collective the counter cannot name, or a train step that reduces no
gradient fails its cell: that is a sharding bug, as a failed
``.lower().compile()`` is in the reference.
"""
from __future__ import annotations

import argparse
import functools
import json
import math
import os
import time
import traceback
import weakref
from array import array

import torch
from torch.utils._pytree import tree_leaves as tree_leaves_any
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from ..configs import ARCHS, get_config
from ..configs.base import SHAPES, cells_for
from ..distributed import sharding as sh
from ..models import transformer as _T
from ..models.params import leaves, unflatten
from ..models.zoo import get_model
from ..optim import adamw
from .mesh import make_production_mesh
from .train import loss_and_grads

ARTIFACTS = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                         "artifacts", "dryrun_torch")

# NVIDIA H100 80GB HBM3, dense bf16 tensor-core peak at a 700 W power limit
# (NVIDIA's data sheet, SXM part), per device
PEAK_FLOPS = 989e12
HBM_BYTES = 80e9             # the same card's memory ("80 GB")
# the same card's NVLink 4: 900 GB/s both directions, 450 GB/s each way
# (NVIDIA's H100 SXM data sheet), per device
LINK_BW = 4.5e11
# the same card's HBM3: 3.35 TB/s (NVIDIA's H100 SXM data sheet), per device
HBM_BW = 3.35e12

MESH_RANKS = {"single": 256, "multi": 512}

# where the port's record parts from the reference's: each reference key
# the port has no counterpart for, or counts its own way
DEPARTURES = [
    {"key": "memory_analysis.generated_code_size_in_bytes",
     "kind": "no counterpart", "why": "no compiled program"},
    {"key": "cost_analysis, hlo_size_chars", "kind": "no counterpart",
     "why": "no HLO"},
    {"key": "lower_s, compile_s", "kind": "no counterpart",
     "why": "trace_s in their place"},
    {"key": "memory_analysis.output_size_in_bytes (in part)",
     "kind": "counted otherwise",
     "why": "XLA's also counts the output tuple's index table, 8 bytes an "
            "output leaf; the port's is the outputs' shards alone"},
    {"key": "memory_analysis.temp_size_in_bytes",
     "kind": "counted otherwise",
     "why": "the eager step's peak of live storages on rank 0's shards "
            "that are neither arguments nor outputs (LiveBytes), op by op: "
            "no fusion, and no argument donated (XLA reuses the train "
            "step's params and optimiser state and the decode step's "
            "cache for the outputs)"},
    {"key": "hlo_flops", "kind": "counted otherwise",
     "why": "flop_registry's products on rank 0's shards (ShardCost), "
            "every layer counted where XLA's cost_analysis counts a while "
            "body once; element-wise work uncounted"},
    {"key": "hlo_bytes, roofline.memory_s", "kind": "counted otherwise",
     "why": "each op's tensor inputs and outputs on rank 0's shards "
            "(ShardCost), views free, every layer counted: no fusion, so "
            "an upper bound on a fused program's bytes"},
]


def _opt_cfg():
    return adamw.OptConfig(lr=3e-4, warmup_steps=100, total_steps=10_000)


def build_train_step(zoo, impl: str = "chunked", microbatch: int = 1):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "lr", "grad_norm"})``: loss and grads
    (``launch.train.loss_and_grads``), then ``adamw.apply``.  With
    ``microbatch`` > 1 the batch splits along dim 0 (:func:`microbatches`);
    grads accumulate in float32 in microbatch order and, like the loss,
    are divided by the count."""
    ocfg = _opt_cfg()

    def train_step(params, opt_state, batch):
        if microbatch > 1:
            loss = None
            acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   for p in leaves(params)]
            for part in microbatches(batch, microbatch):
                li, g = loss_and_grads(zoo, params, part, impl)
                acc = [a + b.to(torch.float32)
                       for a, b in zip(acc, leaves(g))]
                loss = li if loss is None else loss + li
            loss = loss / microbatch
            grads = unflatten(params, [a / microbatch for a in acc])
        else:
            loss, grads = loss_and_grads(zoo, params, batch, impl)
        params, opt_state, metrics = adamw.apply(params, grads, opt_state,
                                                 ocfg)
        return params, opt_state, {"loss": loss, **metrics}

    return train_step


def microbatches(batch: dict, microbatch: int) -> list[dict]:
    """``batch``'s rows in ``microbatch`` parts, part ``i`` the rows ``i``,
    ``i + microbatch``, ...: on a ``DTensor`` each device's own rows split
    alike, so the batch stays sharded along dim 0 and no data moves (parts
    of whole consecutive rows would each lie on a few devices).  Where a
    device's rows do not split into ``microbatch`` parts, the batch is
    made whole first."""
    split = {}
    for k, t in batch.items():
        rows = t.shape[0] // microbatch
        split[k] = sh.whole_heads(t, rows, 0).reshape(
            (rows, microbatch) + tuple(t.shape[1:]))
    return [{k: t[:, i] for k, t in split.items()}
            for i in range(microbatch)]


def build_prefill_step(zoo, max_len: int, impl: str = "chunked"):
    def prefill_step(params, batch):
        return zoo.prefill(params, batch, max_len, impl=impl)
    return prefill_step


def build_serve_step(zoo):
    def serve_step(params, token, cache, position):
        return zoo.decode_step(params, token, cache, position)
    return serve_step


def _abstract_batch(zoo, shape) -> dict:
    meta = torch.device("meta")
    return {k: torch.empty(s, dtype=dt, device=meta)
            for k, (s, dt) in zoo.batch_specs(shape).items()}


def cell_program(arch: str, shape_name: str, mesh, impl: str = "chunked",
                 microbatch: int = 1, kv_int8: bool = False):
    """One cell's step at global shapes: ``(fn, args, in_shardings,
    out_shardings)``, the arguments as meta tensors, each sharding tree of
    the structure of ``args`` (a tuple) or of ``fn``'s result.
    ``shape_name`` names one of ``SHAPES``, or is a ``ShapeConfig``."""
    cfg = get_config(arch)
    zoo = get_model(cfg)
    shape = (SHAPES[shape_name] if isinstance(shape_name, str)
             else shape_name)
    pspec = zoo.spec()
    params_abs = zoo.abstract_params()
    params_shard = sh.param_shardings(pspec, mesh)
    rep = sh.replicated(mesh)

    if shape.kind == "train":
        opt_abs = adamw.abstract_state(params_abs)
        opt_shard = {"m": sh.zero_shardings(pspec, mesh),
                     "v": sh.zero_shardings(pspec, mesh), "step": rep}
        batch_abs = _abstract_batch(zoo, shape)
        batch_shard = sh.batch_shardings(batch_abs, mesh)
        fn = build_train_step(zoo, impl, microbatch=microbatch)
        return (fn, (params_abs, opt_abs, batch_abs),
                (params_shard, opt_shard, batch_shard),
                (params_shard, opt_shard, rep))
    if shape.kind == "prefill":
        batch_abs = _abstract_batch(zoo, shape)
        batch_shard = sh.batch_shardings(batch_abs, mesh)
        cache_abs = zoo.abstract_cache(shape.global_batch, shape.seq_len)
        cache_shard = sh.cache_shardings(cache_abs, mesh)
        fn = build_prefill_step(zoo, shape.seq_len, impl)
        return (fn, (params_abs, batch_abs), (params_shard, batch_shard),
                (rep, cache_shard, rep))
    # decode / long_decode: one new token against a seq_len KV cache
    if kv_int8:
        if cfg.family not in ("dense", "vlm"):
            raise ValueError(f"--kv-int8: dense-family only, not "
                             f"{cfg.family}")
        meta = torch.device("meta")
        b = shape.global_batch
        dec = {"token": torch.empty((b, 1), dtype=torch.int32, device=meta),
               "cache": _T.abstract_cache_q8(
                   cfg, b, shape.seq_len + (cfg.n_patches
                                            if cfg.family == "vlm" else 0)),
               "position": torch.empty((b,), dtype=torch.int32,
                                       device=meta)}

        def fn(p, t, c, pos):
            return _T.decode_step_q8(p, t, c, pos, cfg)
    else:
        dec = zoo.decode_input_specs(shape)
        fn = build_serve_step(zoo)
    cache_shard = sh.cache_shardings(dec["cache"], mesh)
    tok_shard = sh.batch_shardings({"token": dec["token"]}, mesh)["token"]
    pos_shard = sh.batch_shardings(
        {"position": dec["position"]}, mesh)["position"]
    return (fn, (params_abs, dec["token"], dec["cache"], dec["position"]),
            (params_shard, tok_shard, cache_shard, pos_shard),
            (rep, cache_shard, pos_shard))


def _pairs(tree, shardings) -> list:
    """(tensor, NamedSharding) for every leaf of ``tree``; ``shardings`` has
    its structure, or is one sharding for a whole subtree."""
    if isinstance(tree, (tuple, list)):
        return [x for t, s in zip(tree, shardings) for x in _pairs(t, s)]
    if isinstance(tree, dict):
        if isinstance(shardings, sh.NamedSharding):
            return [(t, shardings) for t in leaves(tree)]
        if set(tree) != set(shardings):
            raise ValueError(f"leaves {sorted(tree)} against shardings "
                             f"{sorted(shardings)}")
        return [x for k in tree for x in _pairs(tree[k], shardings[k])]
    return [(tree, shardings)]


class _Reach(TorchDispatchMode):
    """Follows which of ``sources`` (tensors) each tensor of a trace
    derives from: every op's outputs derive from the union of its tensor
    inputs' sources (an in-place op's output is one of its inputs).  A
    bitmask per tensor, keyed by id and checked by a weak reference, so a
    reused id never inherits a dead tensor's sources.  A ``DTensor`` is
    followed through its local shard as well, so that a redistribution
    (collectives on the shards, then a new ``DTensor`` around the result)
    keeps its sources."""

    def __init__(self, sources):
        super().__init__()
        self.mask = {}
        for i, t in enumerate(sources):
            self._mark(t, 1 << i)

    def _mark(self, t, m: int) -> None:
        for x in (t, getattr(t, "_local_tensor", None)):
            if isinstance(x, torch.Tensor):
                if m:
                    self.mask[id(x)] = (weakref.ref(x), m)
                else:
                    self.mask.pop(id(x), None)

    def of(self, tensors) -> int:
        m = 0
        for a in tensors:
            for x in (a, getattr(a, "_local_tensor", None)):
                if isinstance(x, torch.Tensor):
                    e = self.mask.get(id(x))
                    if e is not None and e[0]() is x:
                        m |= e[1]
        return m

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        m = self.of(tree_leaves_any((args, kwargs)))
        out = func(*args, **kwargs)
        for o in tree_leaves_any(out):
            self._mark(o, m)
        return out


class ShardFlops(TorchDispatchMode):
    """The FLOPs that ``FlopCounterMode`` (above it) counts once but that
    every shard computes: an op on the plain shards of a
    ``sharding.per_shard`` region, or on tensors derived from them (its
    backward too, whose products take a saved shard), runs on one
    device's shards, so it adds ``n - 1`` more counts, ``n`` the region's
    shards.  :meth:`mark` is the region hook; tensors are followed as in
    :class:`_Reach`, by id, checked by a weak reference."""

    def __init__(self):
        super().__init__()
        self.shards = {}
        self.flops = 0

    def mark(self, tensors, n: int) -> None:
        for t in tensors:
            if isinstance(t, torch.Tensor) and n > 1:
                self.shards[id(t)] = (weakref.ref(t), n)

    def _of(self, t) -> int:
        e = self.shards.get(id(t))
        return e[1] if e is not None and e[0]() is t else 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        n = max((self._of(a) for a in tree_leaves_any((args, kwargs))
                 if isinstance(a, torch.Tensor)), default=1)
        if n > 1:
            self.mark(tree_leaves_any(out), n)
            count = flop_registry.get(func._overloadpacket)
            if count is not None:
                self.flops += (n - 1) * count(*args, **kwargs, out_val=out)
        return out


class GlobalFlops:
    """The FLOPs at global shapes of what runs in its context (:meth:`total`):
    ``FlopCounterMode``, which counts an op on ``DTensor``s at its global
    shape, above :class:`ShardFlops`, installed as the ``per_shard`` region
    hook (``sharding.set_per_shard_hook``) while the context lasts.  Below
    it, a mode sees the ops on the shards that ops on DTensors lower to."""

    def __init__(self):
        self.counter = FlopCounterMode(display=False)
        self.shards = ShardFlops()
        self._hook = None

    def __enter__(self):
        self._hook = sh.set_per_shard_hook(self.shards.mark)
        self.shards.__enter__()
        self.counter.__enter__()
        return self

    def __exit__(self, *exc):
        try:
            self.counter.__exit__(*exc)
            self.shards.__exit__(*exc)
        finally:
            sh.set_per_shard_hook(self._hook)

    def total(self) -> int:
        return self.counter.get_total_flops() + self.shards.flops


# each functional collective (``torch.ops._c10d_functional`` and its
# legacy and autograd twins; DTensor's own all-to-all) under the name of
# the HLO op the reference's parser counts
COLLECTIVE_KINDS = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d_functional",
                          "_c10d_functional_autograd", "_dtensor", "c10d")
# ops of those namespaces that move no data between devices
_NOT_COLLECTIVES = {"wait_tensor", "_wrap_tensor_autograd"}


def _storages(tensors) -> set:
    """The ids of the storages of ``tensors`` (the Python object of a
    storage lives as long as the storage, so an id is its own while it
    does)."""
    return {id(t.untyped_storage()) for t in tensors
            if isinstance(t, torch.Tensor)}


def _passes_through(func) -> bool:
    """A collective namespace's op that moves no data: on a device it
    returns its input (on meta a new tensor of its shape)."""
    return (getattr(func, "namespace", None) in _COLLECTIVE_NAMESPACES
            and func._opname in _NOT_COLLECTIVES)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _read_bytes(t) -> int:
    """The bytes an op reads of input ``t``: its elements, but no more than
    its storage holds (a broadcast view reads its storage once)."""
    return min(_nbytes(t), t.untyped_storage().nbytes())


class _ShardMode(TorchDispatchMode):
    """A mode that sees only the ops on the local shards: as
    ``CommDebugMode``, it passes an op on ``DTensor``s through
    (``NotImplemented``) to the ops DTensor lowers it to, and it leaves
    out the ops DTensor's sharding propagation runs on fake tensors.
    :meth:`observe` sees each of the others after it ran.  Below
    :class:`GlobalFlops` in the stack: above it, ``FlopCounterMode`` would
    count the shards' ops instead of the ops on DTensors."""

    def __enter__(self):
        from torch._guards import active_fake_mode
        self._fake = active_fake_mode()
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._guards import active_fake_mode
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if active_fake_mode() is self._fake:
            self.observe(func, args, kwargs, out)
        return out

    def observe(self, func, args, kwargs, out) -> None:
        raise NotImplementedError


class CollectiveBytes(_ShardMode):
    """Sums the per-device output bytes of every collective that runs in
    its context, by the reference's kinds (``all-reduce``, ``all-gather``,
    ``reduce-scatter``, ``all-to-all``, ``collective-permute``), as the
    reference's ``_collective_bytes`` sums the output shapes of the
    partitioned HLO's collectives, on the local shards.  An op of a
    collective namespace it cannot map raises."""

    def __init__(self):
        super().__init__()
        self.bytes: dict[str, int] = {}
        self.ops: dict[str, int] = {}

    def observe(self, func, args, kwargs, out) -> None:
        if getattr(func, "namespace", None) not in _COLLECTIVE_NAMESPACES \
                or _passes_through(func):
            return
        kind = COLLECTIVE_KINDS.get(func._opname)
        if kind is None:
            raise RuntimeError(f"collective {func} has no kind")
        n = sum(_nbytes(o) for o in tree_leaves_any(out)
                if isinstance(o, torch.Tensor))
        self.bytes[kind] = self.bytes.get(kind, 0) + n
        self.ops[kind] = self.ops.get(kind, 0) + 1

    def totals(self) -> dict:
        """The reference's ``_collective_bytes`` dict: each kind seen, and
        ``total``."""
        return {**self.bytes, "total": sum(self.bytes.values())}


class LiveBytes(_ShardMode):
    """The bytes of the storages that the ops on one device's shards
    allocate, followed until each dies: a storage is added when a
    non-aliasing op returns it, and taken away when its last reference
    goes (a weak reference's callback on the storage, whose Python object
    lives as long as the storage: views, autograd's saved tensors and
    remat keep it alive as they keep its memory).  Nothing scans the live
    set, so the cost is one entry an allocation.  Every allocation and
    free is logged, so that :meth:`temp_bytes` can leave out the storages
    that turn out to be outputs; ``peak`` counts them all.  A storage that
    existed before (an argument) is never added, an in-place op on it
    allocates nothing."""

    def __init__(self):
        super().__init__()
        self._serial = {}           # id(storage) -> serial of its entry
        self._refs = {}             # id(storage) -> weak reference
        self._users = [0]           # serial -> storages that hold it
        self.sizes = [0]            # serial -> bytes
        self._log = array("q")      # +serial allocated, -serial freed
        self.live = 0
        self.peak = 0

    @property
    def allocations(self) -> int:
        return len(self.sizes) - 1

    def _hold(self, st, serial: int) -> None:
        key = id(st)
        self._serial[key] = serial
        self._refs[key] = weakref.ref(st, functools.partial(self._drop, key))
        self._users[serial] += 1

    def _drop(self, key, _ref) -> None:
        serial = self._serial.pop(key)
        del self._refs[key]
        self._users[serial] -= 1
        if not self._users[serial]:
            self.live -= self.sizes[serial]
            self._log.append(-serial)

    def observe(self, func, args, kwargs, out) -> None:
        outs = [o for o in tree_leaves_any(out)
                if isinstance(o, torch.Tensor)]
        if _passes_through(func):
            # the new meta storage stands for its input's
            src = [a for a in tree_leaves_any(args)
                   if isinstance(a, torch.Tensor)]
            serial = self._serial.get(id(src[0].untyped_storage()))
            if serial is not None:
                for o in outs:
                    st = o.untyped_storage()
                    if id(st) not in self._serial:
                        self._hold(st, serial)
            return
        # a view or an in-place op returns an input's storage
        ins = _storages(tree_leaves_any((args, kwargs)))
        for o in outs:
            st = o.untyped_storage()
            if id(st) in ins or id(st) in self._serial:
                continue
            self.sizes.append(st.nbytes())
            self._users.append(0)
            serial = len(self.sizes) - 1
            self._hold(st, serial)
            self._log.append(serial)
            self.live += self.sizes[serial]
            self.peak = max(self.peak, self.live)

    def temp_bytes(self, outputs) -> int:
        """The highest sum, over what ran, of live storages that are not
        storages of ``outputs``: XLA's ``temp_size_in_bytes``, arguments
        and outputs counted apart (an output ``DTensor`` by its shard)."""
        skip = {self._serial.get(id(getattr(t, "_local_tensor", t)
                                    .untyped_storage())) for t in outputs}
        live = peak = 0
        for e in self._log:
            if abs(e) in skip:
                continue
            live += self.sizes[e] if e > 0 else -self.sizes[-e]
            peak = max(peak, live)
        return peak


class ShardCost(_ShardMode):
    """The FLOPs and bytes of the ops on one device's shards: ``flops`` by
    ``flop_registry``'s formulas (the products), as ``FlopCounterMode``
    counts them but on the shards; ``bytes`` each op's distinct tensor
    inputs and its outputs once (an in-place op's mutated argument read
    and written), an op that returns a view none, a collective as any
    other op.  A ``per_shard`` region's ops run on the shards already and
    count as they are."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0

    def observe(self, func, args, kwargs, out) -> None:
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out)
        if _passes_through(func):
            return
        inputs = [a for a in tree_leaves_any((args, kwargs))
                  if isinstance(a, torch.Tensor)]
        outs = [o for o in tree_leaves_any(out)
                if isinstance(o, torch.Tensor)]
        in_place = any(r.alias_info is not None and r.alias_info.is_write
                       for r in func._schema.returns)
        # a view (``_unsafe_view`` declares no alias) moves nothing
        if not in_place and _storages(outs) & _storages(inputs):
            return
        seen, n = set(), 0
        for a in inputs:
            if id(a) not in seen:
                seen.add(id(a))
                n += _read_bytes(a)
        self.bytes += n + sum(_nbytes(o) for o in outs)


def _map_pairs(tree, shardings, fn):
    """``tree`` with each leaf ``t`` replaced by ``fn(t, sharding)``;
    ``shardings`` as in :func:`_pairs`."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_pairs(t, s, fn)
                          for t, s in zip(tree, shardings))
    if isinstance(tree, dict):
        if isinstance(shardings, sh.NamedSharding):
            return {k: _map_pairs(v, shardings, fn) for k, v in tree.items()}
        return {k: _map_pairs(tree[k], shardings[k], fn) for k in tree}
    return fn(tree, shardings)


def _lay_out(t, s):
    """``t`` in the layout of ``s``: a ``DTensor`` redistributed to its
    placements (the collectives ``jax.jit``'s ``out_shardings`` forces),
    a plain tensor laid out as :meth:`NamedSharding.distribute` does."""
    if sh.is_dtensor(t):
        return t.redistribute(t.device_mesh, s.placements())
    return s.distribute(t)


def lay_out(tree, shardings):
    """Every leaf of ``tree`` in the layout of its sharding (``shardings``
    of ``tree``'s structure, or one sharding for a whole subtree): a plain
    tensor laid out (each rank keeps its own shard), a ``DTensor``
    redistributed."""
    return _map_pairs(tree, shardings, _lay_out)


def call_sharded(fn, args, out_shardings, mesh, act_hints: bool = True):
    """``fn(*args)`` under ``set_act_mesh(mesh)`` (unless ``act_hints`` is
    off), its outputs laid out by ``out_shardings``: a cell's step as the
    reference's ``jax.jit(fn, out_shardings=...)`` runs it, on arguments
    already laid out (:func:`lay_out`).  A tensor the step makes meets the
    DTensors as ``Replicate`` (DTensor's ``implicit_replication``)."""
    from torch.distributed.tensor.experimental import implicit_replication
    sh.set_act_mesh(mesh if act_hints else None)
    try:
        with implicit_replication():
            return lay_out(fn(*args), out_shardings)
    finally:
        sh.set_act_mesh(None)


def sharded_bytes(tree, shardings, keep=None) -> int:
    """Bytes of one device's shards of every leaf (of leaf ``i`` only where
    bit ``i`` of ``keep`` is set, when given): each leaf laid out by its
    sharding (:func:`lay_out`: a meta leaf becomes a ``DTensor`` of meta
    shards where the mesh has a ``DeviceMesh``), ``to_local()``'s size
    summed, each shard checked against the sharding's ``local_shape``."""
    total = 0
    for i, (t, s) in enumerate(_pairs(tree, shardings)):
        if keep is not None and not keep >> i & 1:
            continue
        d = _lay_out(t, s)
        local = d.to_local() if sh.is_dtensor(d) else d
        if tuple(local.shape) != s.local_shape(t.shape):
            raise ValueError(f"{tuple(t.shape)} under {s.spec}: shard "
                             f"{tuple(local.shape)}, expected "
                             f"{s.local_shape(t.shape)}")
        total += local.numel() * local.element_size()
    return total


def trace_cell(arch: str, shape_name: str, mesh, impl: str = "chunked",
               microbatch: int = 1, act_hints: bool = True,
               kv_int8: bool = False) -> dict:
    """Run one cell's step sharded: each argument laid out on ``mesh`` by
    its sharding (a ``DTensor`` of meta shards where the mesh has a
    ``DeviceMesh``), the step called on them under ``set_act_mesh(mesh)``
    (unless ``act_hints`` is off), each output redistributed to its
    ``out_shardings`` entry.  Returns the per-device argument and output
    bytes, the peak of its temporaries on rank 0's shards
    (:class:`LiveBytes`), that peak with the outputs counted, and the
    storages it allocated, the FLOPs at global
    shapes, rank 0's FLOPs and bytes (:class:`ShardCost`), the
    collectives' per-device bytes and op counts by kind (equal in number
    to ``CommDebugMode``'s, or this raises), and the seconds it took."""
    from torch.distributed.tensor.debug import CommDebugMode
    fn, args, in_shard, out_shard = cell_program(
        arch, shape_name, mesh, impl, microbatch=microbatch, kv_int8=kv_int8)
    t0 = time.perf_counter()
    all_bytes = sharded_bytes(args, in_shard)
    dargs = lay_out(args, in_shard)
    comm, coll, flops = CommDebugMode(), CollectiveBytes(), GlobalFlops()
    live, cost = LiveBytes(), ShardCost()
    reach = _Reach([t for t, _ in _pairs(dargs, in_shard)])
    # the modes on the shards below GlobalFlops, so that they see the ops
    # on the shards that every op on DTensors lowers to, and it does not
    with comm, coll, live, cost, flops, reach, torch.no_grad():
        out = call_sharded(fn, dargs, out_shard, mesh, act_hints)
    n_ops = sum(coll.ops.values())
    if n_ops != comm.get_total_counts():
        raise RuntimeError(f"{n_ops} collectives counted ({coll.ops}), "
                           f"CommDebugMode counts "
                           f"{comm.get_total_counts()}: "
                           f"{dict(comm.get_comm_counts())}")
    # jit drops the arguments no output depends on (``keep_unused=False``
    # after dead-code elimination), so XLA's argument bytes count only the
    # leaves the step's outputs derive from
    outs = _pairs(out, out_shard)
    arg_bytes = sharded_bytes(args, in_shard, reach.of(t for t, _ in outs))
    return {"argument_size_in_bytes": arg_bytes,
            "unused_argument_bytes": all_bytes - arg_bytes,
            "output_size_in_bytes": sharded_bytes(out, out_shard),
            "temp_size_in_bytes": live.temp_bytes(t for t, _ in outs),
            "live_peak_bytes": live.peak,
            "output_leaves": len(outs),
            "allocations": live.allocations,
            "traced_flops": flops.total(),
            "hlo_flops": cost.flops,
            "hlo_bytes": cost.bytes,
            "collective_bytes": coll.totals(),
            "collective_ops": dict(coll.ops),
            "trace_s": time.perf_counter() - t0}


def analyze_cell(arch: str, shape_name: str, mesh_kind: str,
                 impl: str = "chunked", save: bool = True,
                 microbatch: int = 1, act_hints: bool = True,
                 kv_int8: bool = False, outdir: str | None = None,
                 mesh=None) -> dict:
    """One cell's record on the production mesh of ``mesh_kind`` (or on
    ``mesh``, e.g. a host mesh), saved as JSON unless ``save`` is off."""
    if mesh is None:
        mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    n_chips = math.prod(mesh.shape.values())
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    tr = trace_cell(arch, shape_name, mesh, impl, microbatch=microbatch,
                    act_hints=act_hints, kv_int8=kv_int8)

    # analytic terms
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        model_flops = 6 * cfg.active_params() * tokens
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        model_flops = 2 * cfg.active_params() * tokens
    else:
        tokens = shape.global_batch          # one token per sequence
        model_flops = 2 * cfg.active_params() * tokens

    flops = tr["traced_flops"]
    coll = tr["collective_bytes"]
    if shape.kind == "train" and n_chips > 1 and not (
            coll.get("all-reduce") or coll.get("reduce-scatter")):
        raise RuntimeError(f"a train step on {n_chips} devices reduced no "
                           f"gradient: {coll}")
    out = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "chips": n_chips,
        "trace_s": tr["trace_s"],
        "memory_analysis": {
            "argument_size_in_bytes": tr["argument_size_in_bytes"],
            "output_size_in_bytes": tr["output_size_in_bytes"],
            "temp_size_in_bytes": tr["temp_size_in_bytes"]},
        "unused_argument_bytes": tr["unused_argument_bytes"],
        "model_flops": model_flops,
        "tokens": tokens,
        "traced_flops": flops,
        "hlo_flops": tr["hlo_flops"],
        "hlo_bytes": tr["hlo_bytes"],
        "collective_bytes": coll,
        "collective_ops": tr["collective_ops"],
        # the reference's formulas: memory_s and collective_s divide a
        # per-device count by the device count
        "roofline": {"compute_s": flops / (n_chips * PEAK_FLOPS),
                     "memory_s": tr["hlo_bytes"] / (n_chips * HBM_BW),
                     "collective_s": coll["total"] / (n_chips * LINK_BW)},
        "departures": DEPARTURES,
    }
    if save:
        d = os.path.join(outdir or ARTIFACTS, mesh_kind)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, f"{arch}__{shape_name}.json"), "w") as f:
            json.dump(out, f, indent=1)
    return out


def _table(records: list[dict]) -> str:
    """A markdown table of cell records, one row an (arch, shape), the
    meshes side by side ("single; multi"; one value where they agree)."""
    by_cell: dict = {}
    for r in records:
        by_cell.setdefault((r["arch"], r["shape"]), {})[r["mesh"]] = r

    def both(cell, get):
        vals = [str(get(cell[m])) if m in cell else "-"
                for m in ("single", "multi")]
        return vals[0] if vals[0] == vals[1] else "; ".join(vals)

    def mem(r, key):
        return r["memory_analysis"][key]

    def fits(r):
        need = sum(mem(r, k) for k in ("argument_size_in_bytes",
                                       "temp_size_in_bytes",
                                       "output_size_in_bytes"))
        return "yes" if need <= HBM_BYTES else "no"

    def kinds(r):
        c = r["collective_bytes"]
        return ", ".join(f"{k} {c[k]}" for k in sorted(c) if k != "total")

    cols = [("argument bytes / device",
             lambda r: mem(r, "argument_size_in_bytes")),
            ("temp bytes / device", lambda r: mem(r, "temp_size_in_bytes")),
            ("output bytes / device",
             lambda r: mem(r, "output_size_in_bytes")),
            ("traced_flops", lambda r: r["traced_flops"]),
            ("model_flops", lambda r: r["model_flops"]),
            ("compute_s", lambda r: r["roofline"]["compute_s"]),
            ("hlo_flops / device", lambda r: r["hlo_flops"]),
            ("hlo_bytes / device", lambda r: r["hlo_bytes"]),
            ("memory_s", lambda r: r["roofline"]["memory_s"]),
            ("collective bytes / device",
             lambda r: r["collective_bytes"]["total"]),
            ("by kind", kinds),
            ("collective_s", lambda r: r["roofline"]["collective_s"]),
            ("argument + temp + output fit 80 GB", fits),
            ("trace_s", lambda r: r["trace_s"])]
    rows = ["| arch | shape | " + " | ".join(c for c, _ in cols) + " |",
            "|---|---|" + "---|" * len(cols)]
    for (arch, shape), cell in by_cell.items():
        rows.append(f"| {arch} | {shape} | "
                    + " | ".join(both(cell, get) for _, get in cols) + " |")
    return "\n".join(rows)


def main(argv=None) -> None:
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--impl", default="chunked")
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--kv-int8", action="store_true")
    ap.add_argument("--no-act-hints", action="store_true")
    ap.add_argument("--outdir", default=None)
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = [(a, s) for a in ARCHS for s in cells_for(get_config(a))]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells = [(args.arch, args.shape)]

    failures, records = [], []
    for mesh_kind in meshes:
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=MESH_RANKS[mesh_kind])
        try:
            for arch, shape in cells:
                tag = f"{mesh_kind}/{arch}/{shape}"
                path = os.path.join(args.outdir or ARTIFACTS, mesh_kind,
                                    f"{arch}__{shape}.json")
                if args.skip_existing and os.path.exists(path):
                    print(f"[skip] {tag}")
                    with open(path) as f:
                        records.append(json.load(f))
                    continue
                try:
                    r = analyze_cell(arch, shape, mesh_kind, impl=args.impl,
                                     microbatch=args.microbatch,
                                     act_hints=not args.no_act_hints,
                                     kv_int8=args.kv_int8,
                                     outdir=args.outdir)
                    records.append(r)
                    print(f"[ok] {tag}: trace={r['trace_s']}s "
                          f"flops={r['traced_flops']:.3e} "
                          f"hlo_flops={r['hlo_flops']:.3e} "
                          f"hlo_bytes={r['hlo_bytes']:.3e} "
                          f"coll={r['collective_bytes']}B "
                          f"mem={r['memory_analysis']}", flush=True)
                except Exception as e:
                    failures.append((tag, str(e)))
                    print(f"[FAIL] {tag}: {e}", flush=True)
                    traceback.print_exc()
        finally:
            dist.destroy_process_group()
    if records:
        print(_table(records))
    if failures:
        raise SystemExit(f"{len(failures)} cells failed: "
                         + ", ".join(t for t, _ in failures))
    print("dry-run complete: all cells traced")


if __name__ == "__main__":
    main()
