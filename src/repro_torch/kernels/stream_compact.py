"""stream_compact — the filter primitive's hot loop, written by hand for
Hopper.

Compaction is how dataflow threads keep lanes dense under divergence (the
paper's filtering stage, §III-B(c)): the rows whose keep-mask is set pack to
the front, in order, with a count.  On a CUDA tensor :func:`stream_compact`
launches ``csrc/stream_compact.cu`` (which replaces the TPU kernel
``repro/kernels/stream_compact.py::_compact_kernel``); on a CPU tensor it
runs :func:`stream_compact_plain`, the same function in plain torch.  There
is no fallback from one to the other.

The kernel is one launch: a window of at most :data:`TILE_ROWS` rows (every
window of the apps) is one block; a longer one walks tiles of that many
rows, each taking its output offset from its predecessors by a decoupled
look-back, after one memset of the tiles' status words.  Its output is one
int32 buffer (:func:`stream_compact_flat`): the rows, then the count.
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


#: rows per tile of the kernel (``kTile`` in ``csrc/stream_compact.cu``,
#: checked when the library loads): a window of at most this many rows is
#: one block with no scratch; a longer one takes tiles by a decoupled
#: look-back
TILE_ROWS = 4096


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("stream_compact")
    p = ctypes.c_void_p
    lib.stream_compact_launch.argtypes = (
        [p] * 3 + [ctypes.c_longlong, ctypes.c_int, p, p])
    lib.stream_compact_launch.restype = ctypes.c_int
    lib.stream_compact_tile_rows.restype = ctypes.c_int
    _build.check_constant(lib.stream_compact_tile_rows(), TILE_ROWS,
                          "stream_compact", "TILE_ROWS")
    return lib


def stream_compact_flat(mask: torch.Tensor, vals: torch.Tensor
                        ) -> torch.Tensor:
    """mask [N] int32, vals [N, D] int32 -> one int32 tensor [N*D + 1]: the
    rows of ``vals`` whose mask is nonzero, in input order, then zeros, as
    N*D values row-major, then their count.

    One buffer, so a caller brings the whole result to the host in one copy.
    A CUDA tensor launches the kernel (raising if it cannot), a CPU tensor
    runs :func:`stream_compact_plain`."""
    _check(mask, vals)
    if vals.device.type == "cpu":
        out, count = stream_compact_plain(mask, vals)
        return torch.cat([out.view(-1), count.view(1)])
    if vals.device.type != "cuda":
        raise ValueError(f"stream_compact: unsupported device {vals.device}")
    lib = _lib()
    n, d = vals.shape
    flat = torch.empty(n * d + 1, dtype=torch.int32, device=vals.device)
    # tile status words and the tile counter; zeroed by the launch itself
    scratch = (None if n <= TILE_ROWS else
               torch.empty(-(-n // TILE_ROWS) + 1, dtype=torch.int64,
                           device=vals.device))
    with torch.cuda.device(vals.device):
        err = lib.stream_compact_launch(
            mask.data_ptr(), vals.data_ptr(), flat.data_ptr(), n, d,
            None if scratch is None else scratch.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    stream_compact.launches += 1
    _build.check(lib, "stream_compact", err)
    return flat


def stream_compact(mask: torch.Tensor, vals: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """mask [N] int32, vals [N, D] int32 -> (compacted [N, D], count).

    ``compacted`` holds the rows of ``vals`` whose mask is nonzero, in input
    order, then zeros; ``count`` is a 0-d int32 tensor on the same device.
    Both are views of :func:`stream_compact_flat`'s buffer."""
    flat = stream_compact_flat(mask, vals)
    n, d = vals.shape
    return flat[:n * d].view(n, d), flat[n * d]


#: kernel launches so far (CUDA calls only; the plain path does not count;
#: a replayed CUDA graph adds its captured launches per replay:
#: ``core/device_vm.py``)
stream_compact.launches = 0
