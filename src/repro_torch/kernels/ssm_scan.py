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
function units' rate (16 per SM per clock, 132 SMs).  See the source for
the layout.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

MAX_STATE = 32                         # N: one lane group of a warp


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
    lib.ssm_scan_launch.argtypes = [p] * 9 + [i] * 4 + [p]
    lib.ssm_scan_launch.restype = ctypes.c_int
    return lib


def ssm_scan(x, dt, a, b, c, d, h0):
    """x/dt [B, S, Di]; a [Di, N]; b/c [B, S, N]; d [Di]; h0 [B, Di, N],
    all float32 -> (y [B, S, Di], hT [B, Di, N]).

    A CUDA tensor launches the kernel (raising if it cannot: N above
    ``MAX_STATE``, B above 65535, non-contiguous input), a CPU tensor runs
    :func:`ssm_scan_plain`."""
    _check(x, dt, a, b, c, d, h0)
    if x.device.type == "cpu":
        return ssm_scan_plain(x, dt, a, b, c, d, h0)
    if x.device.type != "cuda":
        raise ValueError(f"ssm_scan: unsupported device {x.device}")
    bsz, s, di = x.shape
    n = a.shape[1]
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"ssm_scan: state size N = {n} not in "
                         f"1..{MAX_STATE}")
    if bsz > 65535:
        raise ValueError(f"ssm_scan: B = {bsz} exceeds 65535")
    ins = {"x": x, "dt": dt, "a": a, "b": b, "c": c, "d": d, "h0": h0}
    for name, t in ins.items():
        if not t.is_contiguous():
            raise ValueError(f"ssm_scan: {name} must be contiguous")
    lib = _lib()
    y = torch.empty_like(x)
    hT = torch.empty_like(h0)
    with torch.cuda.device(x.device):
        err = lib.ssm_scan_launch(
            *(t.data_ptr() for t in ins.values()), y.data_ptr(),
            hT.data_ptr(), bsz, s, di, n,
            torch.cuda.current_stream().cuda_stream)
    ssm_scan.launches += 1
    _build.check(lib, "ssm_scan", err)
    return y, hT


#: kernel launches so far (CUDA calls only; the plain path does not count)
ssm_scan.launches = 0
