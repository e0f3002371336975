"""stream_compact — the filter primitive's hot loop, written by hand for
Hopper.

Compaction is how dataflow threads keep lanes dense under divergence (the
paper's filtering stage, §III-B(c)): the rows whose keep-mask is set pack to
the front, in order, with a count.  On a CUDA tensor :func:`stream_compact`
launches ``csrc/stream_compact.cu`` (which replaces the TPU kernel
``repro/kernels/stream_compact.py::_compact_kernel``); on a CPU tensor it
runs :func:`stream_compact_plain`, the same function in plain torch.  There
is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

_MAX_ROWS = (1 << 31) - 1            # row counts and offsets are int32


def _check(mask: torch.Tensor, vals: torch.Tensor) -> None:
    if mask.dtype != torch.int32 or vals.dtype != torch.int32:
        raise TypeError("stream_compact: mask and vals must be int32, got "
                        f"{mask.dtype} and {vals.dtype}")
    if mask.dim() != 1 or vals.dim() != 2 or vals.shape[0] != mask.shape[0]:
        raise ValueError("stream_compact: want mask [N] and vals [N, D], got "
                         f"{tuple(mask.shape)} and {tuple(vals.shape)}")
    if vals.shape[0] > _MAX_ROWS:
        raise ValueError(f"stream_compact: {vals.shape[0]} rows exceed the "
                         f"kernel's int32 counts ({_MAX_ROWS})")
    if mask.device != vals.device:
        raise ValueError("stream_compact: mask and vals on different devices")
    if not (mask.is_contiguous() and vals.is_contiguous()):
        raise ValueError("stream_compact: mask and vals must be contiguous")


def stream_compact_plain(mask: torch.Tensor, vals: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of the kernel, on any device."""
    keep = mask != 0
    kept = vals[keep]
    out = torch.zeros_like(vals)
    out[:kept.shape[0]] = kept
    return out, torch.tensor(kept.shape[0], dtype=torch.int32,
                             device=vals.device)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("stream_compact")
    lib.stream_compact_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int,
                                 ctypes.c_void_p])
    lib.stream_compact_launch.restype = ctypes.c_int
    lib.stream_compact_tile_rows.restype = ctypes.c_int
    return lib


def stream_compact(mask: torch.Tensor, vals: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """mask [N] int32, vals [N, D] int32 -> (compacted [N, D], count).

    ``compacted`` holds the rows of ``vals`` whose mask is nonzero, in input
    order, then zeros; ``count`` is a 0-d int32 tensor on the same device.
    A CUDA tensor launches the kernel (raising if it cannot), a CPU tensor
    runs :func:`stream_compact_plain`."""
    _check(mask, vals)
    if vals.device.type == "cpu":
        return stream_compact_plain(mask, vals)
    if vals.device.type != "cuda":
        raise ValueError(f"stream_compact: unsupported device {vals.device}")
    lib = _lib()
    n, d = vals.shape
    tile = lib.stream_compact_tile_rows()
    out = torch.empty_like(vals)
    count = torch.empty((), dtype=torch.int32, device=vals.device)
    scratch = torch.empty(max(1, -(-n // tile)), dtype=torch.int32,
                          device=vals.device)
    with torch.cuda.device(vals.device):
        err = lib.stream_compact_launch(
            mask.data_ptr(), vals.data_ptr(), out.data_ptr(),
            count.data_ptr(), scratch.data_ptr(), n, d,
            torch.cuda.current_stream().cuda_stream)
    stream_compact.launches += 1
    _build.check(lib, "stream_compact", err)
    return out, count


#: kernel launches so far (CUDA calls only; the plain path does not count)
stream_compact.launches = 0
