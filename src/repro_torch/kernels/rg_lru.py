"""rg_lru — the RG-LRU diagonal gated scan (the recurrentgemma-9b path),
written by hand for Hopper.

    h_t = a_t ⊙ h_{t-1} + b_t

with ``a``/``b`` precomputed by the layer (``a = exp(-c·softplus(Λ)·r_t)``,
``b = √(1-a²)·(i_t⊙x_t)``).  On a CUDA tensor :func:`rg_lru` launches
``csrc/rg_lru.cu`` (which replaces the TPU kernel
``repro/kernels/rg_lru.py::_rglru_kernel``); on a CPU tensor it runs
:func:`rg_lru_plain`, the same recurrence as a torch loop over t.  There is
no fallback from one to the other.  Unlike the reference kernel, any B, S
and D are taken (the reference asserts whole chunks and whole d blocks).

Bound: bytes, ``(3·B·S·D + 2·B·D)·4`` (a, b, y once each, h0 and hT) at
3.35 TB/s on an H100 SXM; 2 flops per element.  The kernel keeps one
thread a channel and the rounded multiply-then-add of the plain loop, and
feeds it from a ring of shared-memory tiles of ``width`` channels filled
by ``cp.async`` (``STEPS`` and ``STAGES`` by width); :func:`plan` picks
the width.  See the source for the layout.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from . import _build

WIDTHS = (32, 16, 8, 4)                # channels a block, one instance each
#: steps a stage holds, and stages of the ring, by width
STEPS = {32: 32, 16: 64, 8: 64, 4: 64}
STAGES = {32: 10, 16: 6, 8: 6, 4: 6}
SMS = 132                              # streaming multiprocessors (H100 SXM)
SMEM_LIMIT = 232448                    # bytes of shared memory a block


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch: ``width`` channels a block of one warp, ``blocks``
    blocks, ``smem_bytes`` of dynamic shared memory a block (``stages``
    tiles of a and b and one y tile, ``steps`` x ``width`` floats each),
    ``in_flight_bytes`` of a and b that a block keeps loading while it
    walks a tile."""
    width: int
    steps: int
    stages: int
    blocks: int
    smem_bytes: int
    in_flight_bytes: int


def smem_bytes(width: int) -> int:
    return (STAGES[width] * 2 + 1) * STEPS[width] * width * 4


def plan(bsz: int, d: int) -> Plan:
    """The widest block that still gives the grid 3 blocks an SM, down to
    ``WIDTHS[-1]`` channels."""
    width = WIDTHS[0]
    while width > WIDTHS[-1] and bsz * -(-d // width) < 3 * SMS:
        width //= 2
    return Plan(width, STEPS[width], STAGES[width], bsz * -(-d // width),
                smem_bytes(width),
                (STAGES[width] - 1) * 2 * STEPS[width] * width * 4)


def _check(a, b, h0) -> None:
    if a.dim() != 3 or b.shape != a.shape:
        raise ValueError("rg_lru: want a and b [B, S, D], got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    bsz, _, d = a.shape
    if tuple(h0.shape) != (bsz, d):
        raise ValueError(f"rg_lru: want h0 {(bsz, d)}, got "
                         f"{tuple(h0.shape)}")
    ts = (a, b, h0)
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError("rg_lru: all inputs must be float32, got "
                        f"{sorted({str(t.dtype) for t in ts})}")
    if len({t.device for t in ts}) != 1:
        raise ValueError("rg_lru: inputs on different devices")


def rg_lru_plain(a, b, h0):
    """Plain torch version of the kernel, on any device: the recurrence as
    a loop over t, one rounded multiply and one rounded add per step (the
    kernel's order), float32."""
    _check(a, b, h0)
    h = h0.clone()
    y = torch.empty_like(a)
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        y[:, t] = h
    return y, h


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("rg_lru")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rg_lru_launch.argtypes = [p] * 5 + [i] * 4 + [p]
    lib.rg_lru_launch.restype = ctypes.c_int
    lib.rg_lru_config.argtypes = [i, i]
    for width in WIDTHS:
        for what, want in enumerate((STEPS[width], STAGES[width],
                                     smem_bytes(width))):
            _build.check_constant(lib.rg_lru_config(width, what), want,
                                  f"rg_lru width {width}",
                                  ("steps", "stages", "smem bytes")[what])
    return lib


def rg_lru(a, b, h0):
    """a/b [B, S, D]; h0 [B, D], all float32 -> (y [B, S, D], hT [B, D]).

    A CUDA tensor launches the kernel (raising if it cannot: B above
    65535, non-contiguous input), a CPU tensor runs :func:`rg_lru_plain`."""
    _build.refuse_grad("rg_lru", a, b, h0)
    _check(a, b, h0)
    if a.device.type == "cpu":
        return rg_lru_plain(a, b, h0)
    if a.device.type != "cuda":
        raise ValueError(f"rg_lru: unsupported device {a.device}")
    bsz, s, d = a.shape
    if bsz > 65535:
        raise ValueError(f"rg_lru: B = {bsz} exceeds 65535")
    for name, t in (("a", a), ("b", b), ("h0", h0)):
        if not t.is_contiguous():
            raise ValueError(f"rg_lru: {name} must be contiguous")
    lib = _lib()
    y = torch.empty_like(a)
    hT = torch.empty_like(h0)
    with torch.cuda.device(a.device):
        err = lib.rg_lru_launch(
            a.data_ptr(), b.data_ptr(), h0.data_ptr(), y.data_ptr(),
            hT.data_ptr(), bsz, s, d, plan(bsz, d).width,
            torch.cuda.current_stream().cuda_stream)
    rg_lru.launches += 1
    _build.check(lib, "rg_lru", err)
    return y, hT


#: kernel launches so far (CUDA calls only; the plain path does not count)
rg_lru.launches = 0
