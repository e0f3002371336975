"""Sharding rules: logical parameter axes + batch/cache layouts -> mesh.

Mesh axes: ("data", "model") single-pod, ("pod", "data", "model") multi-pod.
The pod axis extends data parallelism across pods (gradients all-reduce over
pod×data; the dry-run proves the pod axis shards).

All rules are **divisibility-aware**: a dimension is only sharded when its
size divides the mesh axis; otherwise it falls back (KV caches fall back from
heads->model to seq->model; everything else falls back to replication).
This is what lets one rule set serve 10 architectures × 4 shapes, including
global_batch=1 long-context cells.

The rules read only a mesh's ``axis_names`` and ``shape``
(``launch.mesh.Mesh``, or any object with both).  A ``PartitionSpec`` is a
tuple with one entry per tensor dim: ``None``, a mesh axis name, or a tuple
of names (sharded over their product, the first axis major, as in JAX).  A
``NamedSharding`` turns one into ``torch.distributed.tensor`` placements
over the mesh's ``DeviceMesh``: ``Shard(d)`` for the mesh axis that shards
dim ``d``, ``Replicate()`` for the rest.  ``torch.distributed.tensor`` is
imported only where a tensor is laid out.

The models run on DTensors as they run on plain tensors (a launcher runs
the step under DTensor's ``implicit_replication``, so that a tensor made
inside it meets a DTensor as ``Replicate``), through a few helpers that
leave a plain tensor as it is: ``whole_heads``/``merged_heads`` (a view
that splits a sharded dim), ``reduce_partial``/``reduce_lookup`` (pending
sums), ``grad_laid_out_as`` (a gradient's layout) and ``per_shard`` (a
function computed on each device's shards), with the activation hints
(``act_hint``) under an active mesh.
"""
from __future__ import annotations

import math
import sys
from dataclasses import dataclass
from typing import Optional

import torch

from ..models.params import P, tree_map

# logical param axis -> mesh axis (tensor/expert parallelism)
PARAM_RULES: dict[str, Optional[str]] = {
    "vocab": "model",
    "ff": "model",
    "q_heads": "model",
    "kv_heads": "model",
    "experts": "model",
    "expert_ff": "data",     # 2nd axis for MoE expert weights (FSDP-style)
    "inner": "model",
    "embed": None,
    "embed2": None,
    "layers": None,
    "sublayers": None,
    "state": None,
    "conv": None,
}


class PartitionSpec(tuple):
    """``PartitionSpec(None, "model")``: a tuple of per-dim entries."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


PS = PartitionSpec


def _names(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclass(frozen=True, eq=False)
class NamedSharding:
    """``spec`` laid over ``mesh``."""
    mesh: object
    spec: PartitionSpec

    def placements(self) -> list:
        """One placement per mesh axis, in the mesh's axis order.  Raises on
        an axis the mesh lacks, an axis used twice, or a tuple out of the
        mesh's axis order (its first axis must be the major one)."""
        from torch.distributed.tensor import Replicate, Shard
        axes = tuple(self.mesh.axis_names)
        dim_of: dict[str, int] = {}
        for d, entry in enumerate(self.spec):
            names = _names(entry)
            for a in names:
                if a not in axes:
                    raise ValueError(f"{self.spec}: no mesh axis {a!r} in "
                                     f"{axes}")
                if a in dim_of:
                    raise ValueError(f"{self.spec}: axis {a!r} used twice")
                dim_of[a] = d
            if list(names) != sorted(names, key=axes.index):
                raise ValueError(f"{self.spec}: {names} out of the mesh's "
                                 f"axis order {axes}")
        return [Shard(dim_of[a]) if a in dim_of else Replicate()
                for a in axes]

    def local_shape(self, shape) -> tuple[int, ...]:
        """Each device's shard of a ``shape`` tensor.  A sharded dim must
        divide by its axes' product, as a jitted argument's must in JAX."""
        if len(self.spec) > len(shape):
            raise ValueError(f"{self.spec} has more entries than {shape}")
        out = list(shape)
        for d, entry in enumerate(self.spec):
            n = axis_size(self.mesh, entry) if entry else 1
            if out[d] % n:
                raise ValueError(f"dim {d} of {tuple(shape)} does not divide "
                                 f"by {n} ({self.spec})")
            out[d] //= n
        return tuple(out)

    def distribute(self, t):
        """``t`` laid out on the mesh: a ``DTensor`` over the mesh's
        ``DeviceMesh`` (each rank keeps its own shard of ``t``, so every rank
        passes the whole of it); on a one-device mesh without a
        ``DeviceMesh``, ``t`` on the mesh's device (a meta tensor stays on
        meta)."""
        self.local_shape(t.shape)
        placements = self.placements()
        dm = getattr(self.mesh, "device_mesh", None)
        if dm is None:
            if math.prod(self.mesh.shape.values()) != 1:
                raise ValueError(f"a mesh of {dict(self.mesh.shape)} has no "
                                 "DeviceMesh to lay a tensor out on")
            return t if t.is_meta else t.to(self.mesh.device)
        from torch.distributed.tensor import distribute_tensor
        return distribute_tensor(t, dm, placements, src_data_rank=None)


def data_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    return int(math.prod(mesh.shape[a] for a in axes))


def _div(n: int, mesh, axes) -> bool:
    return n % axis_size(mesh, axes) == 0


def param_pspec(p: P, mesh) -> PartitionSpec:
    """PartitionSpec for one parameter, dropping non-divisible shardings."""
    spec = []
    for dim, ax in zip(p.shape, p.axes):
        rule = PARAM_RULES.get(ax) if ax else None
        spec.append(rule if rule and _div(dim, mesh, rule) else None)
    return PS(*spec)


def param_shardings(spec_tree, mesh):
    return tree_map(lambda p: NamedSharding(mesh, param_pspec(p, mesh)),
                    spec_tree)


def zero_pspec(p: P, mesh) -> PartitionSpec:
    """ZeRO: optimizer moments additionally shard their largest still-
    replicated dim over the data axes (state is only needed shard-wise at
    the update)."""
    base = list(param_pspec(p, mesh))
    dax = data_axes(mesh)
    if not dax:
        return PS(*base)
    used = {a for s in base if s
            for a in ((s,) if isinstance(s, str) else s)}
    if used & set(dax):
        return PS(*base)   # param already shards over the data axes
    # choose the largest dim that is currently unsharded and divisible
    cands = [(dim, i) for i, (dim, s) in enumerate(zip(p.shape, base))
             if s is None and _div(dim, mesh, dax)]
    if cands:
        _, i = max(cands)
        base[i] = dax if len(dax) > 1 else dax[0]
    return PS(*base)


def zero_shardings(spec_tree, mesh):
    return tree_map(lambda p: NamedSharding(mesh, zero_pspec(p, mesh)),
                    spec_tree)


# -- activations / batches -----------------------------------------------------

def batch_pspec(shape: tuple[int, ...], mesh,
                seq_dim: Optional[int] = None,
                seq_shard: bool = False) -> PartitionSpec:
    """Batch dim 0 over (pod, data) when divisible; optional sequence
    sharding over model (sequence parallelism) for long-context cells."""
    dax = data_axes(mesh)
    spec: list = [None] * len(shape)
    if dax and shape[0] % axis_size(mesh, dax) == 0 and shape[0] > 1:
        spec[0] = dax if len(dax) > 1 else dax[0]
    if seq_shard and seq_dim is not None and \
            shape[seq_dim] % mesh.shape["model"] == 0:
        spec[seq_dim] = "model"
    return PS(*spec)


def batch_shardings(batch_specs: dict, mesh, seq_shard: bool = False):
    """``{name: NamedSharding}`` of a batch of tensors (meta ones in the
    dry-run) by their ``shape``."""
    out = {}
    for k, sd in batch_specs.items():
        seq_dim = 1 if len(sd.shape) >= 2 else None
        out[k] = NamedSharding(mesh, batch_pspec(tuple(sd.shape), mesh,
                                                 seq_dim=seq_dim,
                                                 seq_shard=seq_shard))
    return out


# -- KV / recurrent caches -------------------------------------------------------

# name -> (batch_dim, head_dim, seq_dim, width_dim) — None if absent
_CACHE_LAYOUT = {
    "k": (1, 2, 3, None), "v": (1, 2, 3, None),
    "ks": (1, 2, 3, None), "vs": (1, 2, 3, None),
    "xk": (1, 2, 3, None), "xv": (1, 2, 3, None),
    "attn_k": (1, 2, 3, None), "attn_v": (1, 2, 3, None),
    "h": (1, None, None, 2),           # ssm state [L, B, Di, N]
    "conv": (1, None, None, 3),        # ssm conv  [L, B, K-1, Di]
    "rec_h": (2, None, None, 3),       # [G, R, B, W]
    "rec_conv": (2, None, None, 4),    # [G, R, B, K-1, W]
    "tail_h": (1, None, None, 2),
    "tail_conv": (1, None, None, 3),
}


def cache_pspec(name: str, shape: tuple[int, ...], mesh) -> PartitionSpec:
    bdim, hdim, sdim, wdim = _CACHE_LAYOUT[name]
    dax = data_axes(mesh)
    spec: list = [None] * len(shape)
    if dax and shape[bdim] % axis_size(mesh, dax) == 0 and shape[bdim] > 1:
        spec[bdim] = dax if len(dax) > 1 else dax[0]
    m = mesh.shape["model"]
    if hdim is not None and shape[hdim] % m == 0:
        spec[hdim] = "model"
    elif sdim is not None and shape[sdim] % m == 0:
        spec[sdim] = "model"               # fallback: shard the KV sequence
    elif wdim is not None and shape[wdim] % m == 0:
        spec[wdim] = "model"               # recurrent widths
    return PS(*spec)


def cache_shardings(cache_specs: dict, mesh):
    return {k: NamedSharding(mesh, cache_pspec(k, tuple(v.shape), mesh))
            for k, v in cache_specs.items()}


def replicated(mesh):
    return NamedSharding(mesh, PS())


# -- activation sharding hints (set by the dry-run / launchers) -----------------
#
# Models are mesh-agnostic; when a launcher installs an active mesh, the
# layers can request activation reshardings with plain axis tuples. Outside a
# launcher (unit tests, host runs) these are no-ops.

_ACT_MESH = None


def set_act_mesh(mesh) -> None:
    global _ACT_MESH
    _ACT_MESH = mesh


def act_mesh_axis(name: str) -> int:
    """Size of a mesh axis under the active mesh (1 if none)."""
    if _ACT_MESH is None or name not in _ACT_MESH.shape:
        return 1
    return int(_ACT_MESH.shape[name])


def _dtensor_type():
    """``DTensor`` once ``torch.distributed.tensor`` is imported, else None
    (before that no tensor can be one, and nothing imports it here)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return getattr(mod, "DTensor", None)


def is_dtensor(x) -> bool:
    dtensor = _dtensor_type()
    return dtensor is not None and isinstance(x, dtensor)


def whole_heads(x, n_heads: int, dim: int = -1):
    """``x`` ready for a view that splits its dim ``dim`` into ``n_heads``
    heads: a ``DTensor`` whose shards of that dim are not whole heads is
    first replicated along it (an all-gather), since DTensor cannot split
    an unevenly sharded dim; any other tensor is returned as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    dim %= x.ndim
    split = [i for i, pl in enumerate(x.placements)
             if isinstance(pl, Shard) and pl.dim == dim]
    ways = math.prod(x.device_mesh.size(i) for i in split)
    if n_heads % ways == 0:
        return x
    placements = [Replicate() if i in split else pl
                  for i, pl in enumerate(x.placements)]
    return x.redistribute(x.device_mesh, placements)


class _GradAs(torch.autograd.Function):
    """``fn(t)``, its gradient ``grad_fn(g)`` on the way back (``g`` as it
    is without one): the gradient of a redistribution need not take the
    layout its input had, and DTensor cannot always make it so."""

    @staticmethod
    def forward(ctx, t, fn, grad_fn):
        ctx.grad_fn = grad_fn
        return fn(t)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.grad_fn is None else ctx.grad_fn(g)), None, None


def merged_heads(x, n_heads: int):
    """``x``, whose last dim merges ``n_heads`` heads, as it is, but for
    its gradient on the way back: on a ``DTensor`` that gradient goes
    through :func:`whole_heads` before the backward of the merge splits the
    heads again (DTensor cannot split an unevenly sharded dim there
    either)."""
    if not is_dtensor(x):
        return x
    return _GradAs.apply(x, lambda t: t.view_as(t),
                         lambda g: whole_heads(g, n_heads))


def grad_laid_out_as(x):
    """``x`` as it is, but for its gradient on the way back: on a
    ``DTensor`` it is laid out as ``x`` is, for the backward of the view
    that made ``x`` (DTensor's split of a dim sharded more ways than its
    outer part has rows gives shards of the wrong shape)."""
    if not is_dtensor(x):
        return x
    mesh, placements = x.device_mesh, tuple(x.placements)
    return _GradAs.apply(x, lambda t: t.view_as(t),
                         lambda g: g.redistribute(mesh, placements))


def _reduced(x):
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh,
                          [Replicate() if pl.is_partial() else pl
                           for pl in x.placements])


def reduce_partial(x):
    """``x`` with every pending sum over a mesh axis (a ``Partial``
    placement of a ``DTensor``, such as a gather from a sharded dim leaves)
    reduced to ``Replicate``: an all-reduce, whose gradient is the
    incoming one as it is (the card's torch cannot make every layout a
    pending sum again).  Any other tensor is returned as it is."""
    if not is_dtensor(x) or not any(pl.is_partial() for pl in x.placements):
        return x
    return _GradAs.apply(x, _reduced, None)


def reduce_lookup(x):
    """:func:`reduce_partial` of a vocab-parallel lookup's output (rows
    gathered where a device's vocab shard holds them, zero elsewhere: a
    masked pending sum).  Its gradient on the way back is reduced first,
    since DTensor cannot turn a pending sum into a masked one; any tensor
    that is not a ``DTensor`` is returned as it is."""
    if not is_dtensor(x):
        return x
    return _GradAs.apply(x, _reduced, reduce_partial)


# called as ``hook(local_args, n)`` as each :func:`per_shard` region starts,
# where one is set (:func:`set_per_shard_hook`): the plain shards it computes
# on, and how many shards of its first argument the mesh holds
_PER_SHARD_HOOK = None


def set_per_shard_hook(hook):
    """Install ``hook`` (None removes it); returns the one it replaces."""
    global _PER_SHARD_HOOK
    old, _PER_SHARD_HOOK = _PER_SHARD_HOOK, hook
    return old


def per_shard(fn, args, dims, out_dims):
    """``fn(*args)`` where the args are ``DTensor``s: computed on each
    device's own shards and laid back out as ``DTensor``s, for a function
    that is independent along some dims of its first argument (the
    attention's batch and heads, a scan's batch and channels, a scatter's
    rows).  DTensor would flatten two sharded dims into one for the
    products inside (which the card's torch refuses), or move data at each
    step of a scan; the shards need neither.

    ``dims[i]`` maps each of those dims of ``args[0]`` to the matching dim
    of ``args[i]`` (absent where it has none); ``out_dims`` does the same
    for each output.  On a mesh axis that shards ``args[0]`` along a mapped
    dim, every argument is sharded along its matching dim (redistributed
    if it is not: a counted collective) and replicated where it has none;
    an output with no matching dim is a pending sum over that axis; a plain
    argument beside a ``DTensor`` first counts as replicated.  A mesh axis
    that shards ``args[0]`` along another dim moves to the last mapped dim
    it divides and no other axis shards (an all-to-all), or else makes it
    whole.  Plain tensors run ``fn(*args)`` as it is."""
    first = args[0]
    if not is_dtensor(first):
        return fn(*args)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = first.device_mesh
    first = reduce_partial(first)
    lead = [pl.dim if isinstance(pl, Shard) else None
            for pl in first.placements]
    for i, d in enumerate(lead):
        if d is not None and d not in dims[0]:
            free = [f for f in dims[0] if f not in lead
                    and first.shape[f] % mesh.size(i) == 0]
            lead[i] = free[-1] if free else None

    def layout(dim_map, pending):
        return [Shard(dim_map[d]) if d is not None and d in dim_map
                else Partial() if d is not None and pending else Replicate()
                for d in lead]

    def whole(a):
        if not isinstance(a, torch.Tensor) or is_dtensor(a):
            return a
        return DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim,
                                  run_check=False)

    # an argument whole on an axis that splits the first into shards gets
    # a pending sum of the shards' gradients there
    local = [a.redistribute(mesh, layout(m, False)).to_local(
                 grad_placements=layout(m, True))
             if is_dtensor(a) else a
             for a, m in zip(map(whole, (first,) + tuple(args[1:])), dims)]
    if _PER_SHARD_HOOK is not None:
        _PER_SHARD_HOOK(local, math.prod(
            mesh.size(i) for i, d in enumerate(lead) if d is not None))
    out = fn(*local)
    single = not isinstance(out, tuple)
    outs = tuple(DTensor.from_local(o, mesh, layout(m, True),
                                    run_check=False)
                 for o, m in zip((out,) if single else out, out_dims))
    return outs[0] if single else outs


def act_hint(x, *axes):
    """Redistribute ``x`` under the active mesh; each entry of ``axes`` is a
    mesh-axis name, a tuple of names, or None.  Non-divisible entries are
    dropped.  Only a ``DTensor`` on the active mesh's ``DeviceMesh`` moves:
    any other tensor (every plain one), and every tensor when no mesh is
    active, is returned as it is."""
    if _ACT_MESH is None:
        return x
    dm = getattr(_ACT_MESH, "device_mesh", None)
    if dm is None:          # no DeviceMesh: no tensor can be laid out on it
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor) or x.device_mesh != dm:
        return x
    spec = []
    for dim, ax in zip(x.shape, axes):
        if ax is None:
            spec.append(None)
            continue
        names = tuple(a for a in ((ax,) if isinstance(ax, str) else ax)
                      if a in _ACT_MESH.shape)
        if names and dim % axis_size(_ACT_MESH, names) == 0 and dim > 1:
            spec.append(names if len(names) > 1 else names[0])
        else:
            spec.append(None)
    target = NamedSharding(_ACT_MESH, PS(*spec)).placements()
    # the axes where a whole tensor only needs slicing first (no data
    # moves), so that what the others move is already sliced
    sliced = [t if p.is_replicate() and t.is_shard() else p
              for p, t in zip(x.placements, target)]
    if sliced != list(x.placements) and sliced != target:
        x = x.redistribute(dm, sliced)
    return x.redistribute(dm, target)
