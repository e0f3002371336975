"""hash_probe — open-addressing hash lookup (the Table III hash_table app's
hot loop), written by hand for Hopper.

Each key hashes to ``_mix(uint32(key)) % n_slots`` and walks up to
``max_probes`` slots of a table padded to ``2 * n_slots`` (so that probes
never wrap): a slot holding the key answers, an EMPTY (0) slot or the end of
the table stops.  On a CUDA tensor :func:`hash_probe` launches
``csrc/hash_probe.cu`` (which replaces the TPU kernel
``repro/kernels/hash_probe.py::_probe_kernel``); on a CPU tensor it runs
:func:`hash_probe_plain`, the same walk as a torch loop over the probes (the
reference's ``ops._hash_lookup_xla``).  There is no fallback from one to the
other; the two agree bit for bit.  Unlike the reference kernel, any N is
taken (the reference asserts blocks of 256 keys), and any table size (the
reference sends tables above 2^20 entries to XLA).

Bound: bytes, keys in and two words out per key, plus each 32-byte sector
of the tables that the probes touch, read once, at 3.35 TB/s on an H100 SXM.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

EMPTY = 0
_MIX = 0x45D9F3B


def _check(keys, table_k, table_v, n_slots, max_probes) -> None:
    for name, t in (("keys", keys), ("table_k", table_k),
                    ("table_v", table_v)):
        if t.dtype != torch.int32 or t.dim() != 1:
            raise TypeError(f"hash_probe: {name} must be int32 [N], got "
                            f"{t.dtype} {tuple(t.shape)}")
    if table_v.shape != table_k.shape:
        raise ValueError("hash_probe: table_k and table_v differ in shape: "
                         f"{tuple(table_k.shape)}, {tuple(table_v.shape)}")
    if not 1 <= n_slots <= min(table_k.shape[0], (1 << 32) - 1):
        raise ValueError(f"hash_probe: n_slots {n_slots} must lie in [1, "
                         f"table length {table_k.shape[0]}]")
    if max_probes < 0:
        raise ValueError(f"hash_probe: max_probes {max_probes} < 0")
    if not keys.device == table_k.device == table_v.device:
        raise ValueError("hash_probe: inputs on different devices")


def _mix(keys: torch.Tensor) -> torch.Tensor:
    """The reference's ``_mix`` on ``uint32(keys)``, in int64 (torch has no
    full uint32 multiply): every step stays below 2^59."""
    x = keys.long() & 0xFFFFFFFF
    x = x ^ (x >> 16)
    x = (x * _MIX) & 0xFFFFFFFF
    return x ^ (x >> 16)


def hash_probe_plain(keys, table_k, table_v, n_slots: int,
                     max_probes: int = 16):
    """Plain torch version of the kernel, on any device: all keys step
    through the ``max_probes`` probes together, each retiring at its first
    hit or stop, as the reference's XLA loop."""
    _check(keys, table_k, table_v, n_slots, max_probes)
    length = table_k.shape[0]
    h = _mix(keys) % n_slots
    val = torch.zeros_like(keys)
    found = torch.zeros(keys.shape, dtype=torch.bool, device=keys.device)
    done = torch.zeros_like(found)
    for p in range(max_probes):
        idx = h + p
        inside = idx < length
        idx = idx.clamp(max=length - 1)
        ck = table_k[idx]
        hit = inside & (ck == keys) & ~done
        val = torch.where(hit, table_v[idx], val)
        found |= hit
        done |= hit | ~inside | (ck == EMPTY)
    return val, found.to(torch.int32)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("hash_probe")
    p, ll = ctypes.c_void_p, ctypes.c_longlong
    lib.hash_probe_launch.argtypes = [p, p, p, ll, ll, ctypes.c_uint,
                                      ctypes.c_int, p, p]
    lib.hash_probe_launch.restype = ctypes.c_int
    return lib


def hash_probe(keys: torch.Tensor, table_k: torch.Tensor,
               table_v: torch.Tensor, n_slots: int, max_probes: int = 16):
    """keys [N] int32; table_k/table_v [L] int32 (L = 2 * n_slots for an
    n_slots table duplicated to avoid wrap) -> (values [N], found [N]),
    both int32, views of one buffer.

    A CUDA tensor launches the kernel (raising if it cannot: non-contiguous
    input), a CPU tensor runs :func:`hash_probe_plain`."""
    _check(keys, table_k, table_v, n_slots, max_probes)
    if keys.device.type == "cpu":
        return hash_probe_plain(keys, table_k, table_v, n_slots, max_probes)
    if keys.device.type != "cuda":
        raise ValueError(f"hash_probe: unsupported device {keys.device}")
    for name, t in (("keys", keys), ("table_k", table_k),
                    ("table_v", table_v)):
        if not t.is_contiguous():
            raise ValueError(f"hash_probe: {name} must be contiguous")
    lib = _lib()
    n = keys.shape[0]
    out = torch.empty(2 * n, dtype=torch.int32, device=keys.device)
    if keys.device.index == torch.cuda.current_device():
        err = _launch(lib, keys, table_k, table_v, n_slots, max_probes, out)
    else:
        with torch.cuda.device(keys.device):
            err = _launch(lib, keys, table_k, table_v, n_slots, max_probes,
                          out)
    hash_probe.launches += 1
    _build.check(lib, "hash_probe", err)
    return out[:n], out[n:]


def _launch(lib, keys, table_k, table_v, n_slots, max_probes, out):
    # the raw stream handle: ``current_stream()`` builds a Stream object,
    # the larger part of an eager call's host time at the app's size
    stream = torch._C._cuda_getCurrentRawStream(keys.device.index)
    return lib.hash_probe_launch(
        keys.data_ptr(), table_k.data_ptr(), table_v.data_ptr(),
        keys.shape[0], table_k.shape[0], n_slots, max_probes,
        out.data_ptr(), stream)


#: kernel launches so far (CUDA calls only; the plain path does not count)
hash_probe.launches = 0
