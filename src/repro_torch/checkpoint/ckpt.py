"""Checkpointing: per-step save/restore of a tree of tensors.

Format: one directory per step — ``leaf_<i>.npy`` per tree leaf plus a
``manifest.json`` carrying the flattened key paths, shapes, dtypes and step.
It is the reference's format (``repro.checkpoint.ckpt``): the leaves are
flattened in the same order under the same path strings (dict keys sorted,
list and tuple items by index, joined with ``/``), so a checkpoint written
by either package loads in the other.  Restore takes the structure of a
``like`` tree and a target device (the reference's target sharding tree:
on one card, a device or a tree of devices).

Writes are atomic (tmp dir + rename) and a retention policy keeps the last K
checkpoints — the crash-restart loop in fault_tolerance.py relies on both.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile

import numpy as np
import torch

from ..models.params import resolve_device

# numpy's .npy format can't represent bfloat16 or fp8: store them as raw
# same-width uints and record the logical dtype (the reference's names)
# (torch dtype, its same-width signed torch view, the unsigned .npy dtype)
_RAW = {"bfloat16": (torch.bfloat16, torch.int16, np.uint16),
        "float8_e4m3fn": (torch.float8_e4m3fn, torch.int8, np.uint8),
        "float8_e5m2": (torch.float8_e5m2, torch.int8, np.uint8)}
_LOGICAL = {dt: name for name, (dt, _, _) in _RAW.items()}


def _flatten_with_paths(tree):
    """``(paths, leaves)`` in ``jax.tree_util.tree_flatten_with_path``'s
    order: dict keys sorted, list and tuple items in order; ``None`` is an
    empty subtree, anything else a leaf."""
    paths, leaves = [], []

    def walk(node, prefix):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], prefix + (str(k),))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, prefix + (str(i),))
        elif node is not None:
            paths.append("/".join(prefix))
            leaves.append(node)

    walk(tree, ())
    return paths, leaves


def _unflatten(like, leaves):
    """``like``'s structure with its leaves replaced, in flatten order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            done = {k: build(node[k]) for k in sorted(node)}
            return {k: done[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return None if node is None else next(it)

    return build(like)


def _to_numpy(leaf: torch.Tensor) -> tuple[np.ndarray, str]:
    """A tensor as a numpy array ``.npy`` can hold, and its logical
    dtype."""
    t = leaf.detach().cpu().contiguous()
    if t.dtype in _LOGICAL:
        logical = _LOGICAL[t.dtype]
        _, signed, unsigned = _RAW[logical]
        return t.view(signed).numpy().view(unsigned), logical
    arr = t.numpy()
    return arr, str(arr.dtype)


def _to_tensor(arr: np.ndarray, logical: str) -> torch.Tensor:
    if logical in _RAW:
        dt, _, unsigned = _RAW[logical]
        bits = np.ascontiguousarray(arr, unsigned).view(f"i{arr.itemsize}")
        return torch.from_numpy(bits.copy()).view(dt)
    return torch.from_numpy(np.array(arr))


def save(ckpt_dir: str, step: int, tree, keep: int = 3) -> str:
    paths, leaves = _flatten_with_paths(tree)
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    manifest = {"step": step, "leaves": []}
    for i, (p, leaf) in enumerate(zip(paths, leaves)):
        arr, logical = _to_numpy(leaf)
        np.save(os.path.join(tmp, f"leaf_{i}.npy"), arr)
        manifest["leaves"].append(
            {"path": p, "shape": list(arr.shape), "dtype": logical})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _retain(ckpt_dir, keep)
    return final


def _retain(ckpt_dir: str, keep: int) -> None:
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d))


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    return int(steps[-1].split("_")[1]) if steps else None


def restore(ckpt_dir: str, step: int, like_tree, devices=None):
    """Load into the structure of ``like_tree`` (a tree of tensors), each
    leaf cast to its ``like`` leaf's dtype.  ``devices`` places them: one
    device for every leaf, or a tree of devices of ``like_tree``'s
    structure; ``None`` is the card (raises without one) — pass ``"cpu"``
    to restore there."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    paths, leaves = _flatten_with_paths(like_tree)
    by_path = {e["path"]: i for i, e in enumerate(manifest["leaves"])}
    if isinstance(devices, (dict, list, tuple)):
        dev_leaves = _flatten_with_paths(devices)[1]
    else:
        dev_leaves = [devices] * len(leaves)
    out = []
    for p, like, dev in zip(paths, leaves, dev_leaves):
        if p not in by_path:
            raise KeyError(f"checkpoint missing leaf '{p}'")
        entry = manifest["leaves"][by_path[p]]
        arr = np.load(os.path.join(d, f"leaf_{by_path[p]}.npy"))
        want_shape = tuple(like.shape)
        if tuple(arr.shape) != want_shape:
            raise ValueError(
                f"leaf '{p}': checkpoint {arr.shape} != model {want_shape}")
        t = _to_tensor(arr, entry["dtype"]).to(like.dtype)
        out.append(t.to(resolve_device(dev, "ckpt.restore")))
    return _unflatten(like_tree, out)
