"""Parameter specs: shapes + logical axes, made concrete as torch tensors.

Every model in the zoo declares its parameters as a nested dict of ``P``
specs.  From one spec tree we derive:
* ``abstract(spec)`` — meta tensors of each leaf's shape and dtype (the
  dry-run: no allocation);
* ``init(spec, seed, device)`` — concrete initialization;
* ``n_params(spec)`` — the parameter count;
* ``pspec_tree(spec, rules)`` — a ``PartitionSpec`` tree;
* ``from_numpy(tree, device)`` — a tree of numpy arrays (e.g. the JAX
  reference's parameters, bfloat16 included) as torch tensors.

``init`` draws exactly the numbers the reference draws (one numpy generator
per leaf, seeded ``seed * 1_000_003 + i``, fan-in scaled, float32) and
rounds them to the leaf's dtype at the end (round to nearest even, as the
reference does), so the same seed gives bit-identical weights in both
frameworks.  Leaf ``i`` is the ``i``-th leaf in sorted-key order, the order
in which ``jax.tree.flatten`` walks a dict.

Logical axes (``vocab, embed, q_heads, kv_heads, ff, ...``) map onto mesh
axes in ``distributed/sharding.py``.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclass(frozen=True)
class P:
    """One parameter: shape + per-dim logical axis names (None = replicated)."""
    shape: tuple[int, ...]
    axes: tuple[Optional[str], ...]
    dtype: str = "bfloat16"
    init: str = "normal"         # normal | zeros | ones

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def resolve_device(device, who: str) -> torch.device:
    """``None`` means ``cuda``; a host without CUDA raises rather than fall
    back to the CPU.  Pass ``"cpu"`` to run there on purpose."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{who}: no CUDA device on this host (torch {torch.__version__});"
            " pass device='cpu' to run on the CPU")
    return dev


def tree_map(fn: Callable, tree):
    """Apply ``fn`` to every leaf (anything that is not a dict)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def leaves(tree) -> list:
    """Leaves in sorted-key order (``jax.tree.flatten``'s order for dicts)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree]


def unflatten(like, flat: list):
    """``like``'s structure with its leaves replaced by ``flat``, taken in
    :func:`leaves` order; dict keys keep ``like``'s order."""
    return _unflatten(like, iter(flat))


def _unflatten(node, it):
    # a module-level function: a nested one that calls itself is a
    # reference cycle, which would keep ``flat``'s tensors alive until the
    # garbage collector runs
    if isinstance(node, dict):
        done = {k: _unflatten(node[k], it) for k in sorted(node)}
        return {k: done[k] for k in node}
    return next(it)


def stack(spec, n: int, axis_name: Optional[str] = "layers"):
    """Prepend a stacking dim (one slice per layer) to every leaf."""
    return tree_map(
        lambda p: P((n,) + p.shape, (axis_name,) + p.axes, p.dtype, p.init),
        spec)


def abstract(spec):
    """Each leaf as an empty tensor of its shape and dtype on ``meta``."""
    meta = torch.device("meta")
    return tree_map(
        lambda p: torch.empty(p.shape, dtype=_DTYPES[p.dtype], device=meta),
        spec)


def _draw(p: P, rng: np.random.Generator) -> np.ndarray:
    if p.init == "zeros":
        return np.zeros(p.shape, np.float32)
    if p.init == "ones":
        return np.ones(p.shape, np.float32)
    fan_in = p.shape[-2] if len(p.shape) >= 2 else p.shape[-1]
    return rng.standard_normal(p.shape).astype(np.float32) \
        / np.sqrt(max(fan_in, 1))


def init(spec, seed: int = 0, device=None):
    """Concrete init on ``device`` (``None``: the card).  Leaf ``i`` in
    sorted-key order draws from ``default_rng(seed * 1_000_003 + i)``."""
    dev = resolve_device(device, "params.init")
    count = itertools.count()

    def walk(node):
        if isinstance(node, dict):      # sorted walk numbers the leaves
            done = {k: walk(node[k]) for k in sorted(node)}
            return {k: done[k] for k in node}
        a = _draw(node, np.random.default_rng(seed * 1_000_003 + next(count)))
        return torch.from_numpy(a).to(_DTYPES[node.dtype]).to(dev)

    return walk(spec)


def n_params(spec) -> int:
    return sum(int(np.prod(p.shape)) for p in leaves(spec))


def pspec_tree(spec, rules: dict[str, Optional[str]]):
    """Logical axes -> ``sharding.PartitionSpec`` via ``rules``
    (divisibility-aware filtering happens in distributed/sharding.py)."""
    from ..distributed.sharding import PartitionSpec

    def one(p: P) -> PartitionSpec:
        return PartitionSpec(*(rules.get(a) if a else None for a in p.axes))

    return tree_map(one, spec)


def from_numpy(tree, device=None):
    """A tree of numpy arrays as torch tensors on ``device`` (``None``: the
    card).  bfloat16 arrays (``ml_dtypes``, which ``torch.from_numpy``
    cannot take) cross as their 16-bit patterns."""
    dev = resolve_device(device, "params.from_numpy")

    def one(a) -> torch.Tensor:
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16)
                                 .copy()).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a))
        return t.to(dev)

    return tree_map(one, tree)
