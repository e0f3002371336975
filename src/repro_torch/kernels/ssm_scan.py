"""ssm_scan — the Mamba-1 selective-scan recurrence (the falcon-mamba-7b
path), written by hand for Hopper.

    h_t = exp(dt_t ⊙ A) · h_{t-1} + (dt_t · x_t) ⊗ B_t
    y_t = (h_t · C_t).sum(state) + D ⊙ x_t

On a CUDA tensor :func:`ssm_scan` launches ``csrc/ssm_scan.cu`` (which
replaces the TPU kernel ``repro/kernels/ssm_scan.py::_ssm_kernel``); on a
CPU tensor it runs :func:`ssm_scan_plain`, the same recurrence as a torch
loop over t.  There is no fallback from one to the other.  Unlike the
reference kernel, any S and Di are taken (the reference asserts whole
chunks and blocks), and N up to 32.

Bound: the larger of the bytes (x, dt, y, a, b, c, d, h0, hT once each, at
3.35 TB/s on an H100 SXM) and the B·S·Di·N exponentials at the special
function units' rate (16 per SM per clock, 132 SMs).  The kernel gives
each channel ``lanes`` threads of ``states`` state elements each; the
per-step partial sums over n wait in registers for ``lanes`` steps and
then one reduce-scatter across the lanes; exp(dt·A) is one ``ex2`` of
dt·A·log2(e); the chunk's inputs pass through a 2-stage ``cp.async``
ring (b and c transposed).  :func:`plan` picks the instance from N; see
the source for the layout.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from . import _build

MAX_STATE = 32                         # N: one lane group of a warp
BLOCK = 256                            # threads per block
CHUNK = 32                             # steps a stage holds
ROW = CHUNK + 4                        # floats a staged row of b or c
SMEM_LIMIT = 232448                    # bytes of shared memory a block
#: (lanes, states) of every instance the library holds
INSTANCES = ((8, 1), (8, 2), (8, 4))
#: the instance for N up to each bound
_BY_N = ((8, (8, 1)), (16, (8, 2)), (32, (8, 4)))


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch: ``lanes`` threads a channel, ``states`` state elements a
    thread, ``channels`` channels a block of ``BLOCK`` threads, ``blocks``
    blocks, ``smem_bytes`` of dynamic shared memory a block (two stages,
    each of dt and x as ``CHUNK`` rows of channels + 4 floats and of b and
    c as a row of ``ROW`` floats per padded state; two y tiles of
    ``CHUNK`` x (channels + 4))."""
    lanes: int
    states: int
    channels: int
    blocks: int
    smem_bytes: int


def smem_bytes(lanes: int, states: int) -> int:
    channels, padded = BLOCK // lanes, lanes * states
    stage = 2 * CHUNK * (channels + 4) + 2 * padded * ROW
    return (2 * stage + 2 * CHUNK * (channels + 4)) * 4


def plan(bsz: int, di: int, n: int, lanes: int | None = None,
         states: int | None = None) -> Plan:
    """The launch for B = ``bsz``, Di = ``di`` and N = ``n``: the instance
    for N unless ``lanes`` and ``states`` name one of ``INSTANCES``."""
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"ssm_scan: state size N = {n} not in "
                         f"1..{MAX_STATE}")
    if lanes is None:
        lanes, states = next(shape for bound, shape in _BY_N if n <= bound)
    if (lanes, states) not in INSTANCES or lanes * states < n:
        raise ValueError(f"ssm_scan: no instance of {lanes} lanes x "
                         f"{states} states for N = {n}")
    channels = BLOCK // lanes
    return Plan(lanes, states, channels, bsz * -(-di // channels),
                smem_bytes(lanes, states))


def _check(x, dt, a, b, c, d, h0) -> None:
    if x.dim() != 3 or dt.shape != x.shape:
        raise ValueError("ssm_scan: want x and dt [B, S, Di], got "
                         f"{tuple(x.shape)}, {tuple(dt.shape)}")
    bsz, s, di = x.shape
    if a.dim() != 2 or a.shape[0] != di:
        raise ValueError(f"ssm_scan: want a [Di={di}, N], got "
                         f"{tuple(a.shape)}")
    n = a.shape[1]
    for name, t, want in (("b", b, (bsz, s, n)), ("c", c, (bsz, s, n)),
                          ("d", d, (di,)), ("h0", h0, (bsz, di, n))):
        if tuple(t.shape) != want:
            raise ValueError(f"ssm_scan: want {name} {want}, got "
                             f"{tuple(t.shape)}")
    ts = (x, dt, a, b, c, d, h0)
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError("ssm_scan: all inputs must be float32, got "
                        f"{sorted({str(t.dtype) for t in ts})}")
    if len({t.device for t in ts}) != 1:
        raise ValueError("ssm_scan: inputs on different devices")


def ssm_scan_plain(x, dt, a, b, c, d, h0):
    """Plain torch version of the kernel, on any device: the recurrence as
    a loop over t, in the kernel's order of operations, float32."""
    _check(x, dt, a, b, c, d, h0)
    h = h0.clone()
    y = torch.empty_like(x)
    for t in range(x.shape[1]):
        dtt = dt[:, t, :, None]                       # [B, Di, 1]
        da = torch.exp(dtt * a)                       # [B, Di, N]
        h = da * h + (dtt * x[:, t, :, None]) * b[:, t, None, :]
        y[:, t] = (h * c[:, t, None, :]).sum(-1) + d * x[:, t]
    return y, h


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("ssm_scan")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ssm_scan_launch.argtypes = [p] * 9 + [i] * 6 + [p]
    lib.ssm_scan_launch.restype = ctypes.c_int
    lib.ssm_scan_smem_bytes.argtypes = [i, i]
    _build.check_constant(lib.ssm_scan_chunk(), CHUNK, "ssm_scan", "CHUNK")
    for shape in INSTANCES:
        _build.check_constant(lib.ssm_scan_smem_bytes(*shape),
                              smem_bytes(*shape), f"ssm_scan {shape}",
                              "shared memory bytes")
    return lib


def _launch(x, dt, a, b, c, d, h0, p: Plan):
    """Launch the kernel with plan ``p`` (uncounted; :func:`ssm_scan`
    counts).  Inputs already checked, on one CUDA device."""
    ins = {"x": x, "dt": dt, "a": a, "b": b, "c": c, "d": d, "h0": h0}
    for name, t in ins.items():
        if not t.is_contiguous():
            raise ValueError(f"ssm_scan: {name} must be contiguous")
    bsz, s, di = x.shape
    lib = _lib()
    y = torch.empty_like(x)
    hT = torch.empty_like(h0)
    with torch.cuda.device(x.device):
        err = lib.ssm_scan_launch(
            *(t.data_ptr() for t in ins.values()), y.data_ptr(),
            hT.data_ptr(), bsz, s, di, a.shape[1], p.lanes, p.states,
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, "ssm_scan", err)
    return y, hT


def ssm_scan(x, dt, a, b, c, d, h0):
    """x/dt [B, S, Di]; a [Di, N]; b/c [B, S, N]; d [Di]; h0 [B, Di, N],
    all float32 -> (y [B, S, Di], hT [B, Di, N]).

    A CUDA tensor launches the kernel (raising if it cannot: N above
    ``MAX_STATE``, B above 65535, non-contiguous input), a CPU tensor runs
    :func:`ssm_scan_plain`."""
    _build.refuse_grad("ssm_scan", x, dt, a, b, c, d, h0)
    _check(x, dt, a, b, c, d, h0)
    if x.device.type == "cpu":
        return ssm_scan_plain(x, dt, a, b, c, d, h0)
    if x.device.type != "cuda":
        raise ValueError(f"ssm_scan: unsupported device {x.device}")
    bsz, _, di = x.shape
    p = plan(bsz, di, a.shape[1])
    if bsz > 65535:
        raise ValueError(f"ssm_scan: B = {bsz} exceeds 65535")
    out = _launch(x, dt, a, b, c, d, h0, p)
    ssm_scan.launches += 1
    return out


#: kernel launches so far (CUDA calls only; the plain path does not count)
ssm_scan.launches = 0
