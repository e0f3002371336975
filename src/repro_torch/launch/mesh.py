"""Meshes: the production meshes over a process group, and host meshes.

Functions, not module-level constants, so importing this module touches
no process group: the dry-run initialises a ``"fake"`` group of the
mesh's size first (as the reference sets ``XLA_FLAGS`` first), and a
production mesh is built over whatever group is already initialised.

Single pod: 16 x 16 = 256 devices, axes (data, model).
Multi-pod:  2 x 16 x 16 = 512 devices, axes (pod, data, model) — the pod
axis carries cross-pod data parallelism (gradient all-reduce crosses pods).

A ``Mesh`` is what the sharding rules read (``axis_names`` and a ``shape``
dict in axis order, as a ``jax.sharding.Mesh``), plus the
``torch.distributed`` ``DeviceMesh`` that lays tensors out, where there is
one: a mesh of one device outside a process group has none.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from ..models.params import resolve_device


@dataclass(frozen=True, eq=False)
class Mesh:
    axis_names: tuple[str, ...]
    shape: dict[str, int]
    device: torch.device            # this process's device
    device_mesh: Optional[object] = None   # a DeviceMesh, or None


def _device_mesh(device_type: str, dims: tuple[int, ...],
                 axes: tuple[str, ...]):
    """A ``DeviceMesh`` of ``dims`` over the initialised process group,
    whose world size must equal the mesh's size."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    n = math.prod(dims)
    if not dist.is_initialized():
        raise RuntimeError(
            f"a {'x'.join(map(str, dims))} mesh needs an initialised process "
            f"group of {n} ranks (torch.distributed.init_process_group)")
    if dist.get_world_size() != n:
        raise RuntimeError(
            f"a {'x'.join(map(str, dims))} mesh needs {n} ranks; the "
            f"process group has {dist.get_world_size()}")
    return DeviceMesh(device_type, torch.arange(n).reshape(dims),
                      mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The 16x16 (or 2x16x16) mesh over the initialised process group;
    raises unless its world size is the mesh's size.  Its devices are CUDA
    cards under NCCL, CPU ranks under any other backend (the dry-run's
    ``"fake"`` group)."""
    import torch.distributed as dist
    dims = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    device_type = ("cuda" if dist.is_initialized()
                   and dist.get_backend() == "nccl" else "cpu")
    dm = _device_mesh(device_type, dims, axes)
    return Mesh(axes, dict(zip(axes, dims)), torch.device(device_type), dm)


def make_host_mesh(data: int = 1, model: int = 1, device=None) -> Mesh:
    """A small mesh over real local devices: CUDA cards (``device=None``)
    unless the caller passes ``"cpu"``.  Raises without a CUDA device or
    with fewer devices than ``data * model``; never falls back to the CPU.
    One device needs no process group (the mesh has no ``DeviceMesh``);
    more need one initialised with a rank per device."""
    import torch.distributed as dist
    dev = resolve_device(device, "make_host_mesh")
    n = data * model
    if dev.type == "cuda":
        have = torch.cuda.device_count()
    else:   # a CPU rank is a process of the group
        have = dist.get_world_size() if dist.is_initialized() else 1
    if have < n:
        raise RuntimeError(f"make_host_mesh({data}, {model}): {n} "
                           f"{dev.type} devices needed, {have} here")
    axes = ("data", "model")
    dm = None if n == 1 else _device_mesh(dev.type, (data, model), axes)
    return Mesh(axes, {"data": data, "model": model}, dev, dm)
