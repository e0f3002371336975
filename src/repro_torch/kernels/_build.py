"""Build and load the hand-written CUDA kernels of ``kernels/csrc``.

Each ``csrc/<name>.cu`` (``stream_compact``, ``segment_reduce``,
``hash_probe``, ``flash_attention``, ``decode_attention``, ``ssm_scan``,
``rg_lru``, ``moe_dispatch``) is one shared library with a plain C interface,
compiled for Hopper (``sm_90a``) by ``nvcc`` at first CUDA use into
``build/repro_torch_kernels/`` at the repository root, and loaded with
``ctypes``.  Pointers and the stream pass as ``c_void_p``; every entry point
returns ``cudaGetLastError()`` and the Python wrapper raises if it is not 0.

Nothing here runs at import: the CPU tests import every module, and a host
without ``nvcc`` only fails when a kernel is first asked for.  A library is
rebuilt when it is older than its source or a header of ``csrc``.  All
stale sources compile at once, one ``nvcc`` process each.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = (Path(__file__).resolve().parents[3] / "build"
             / "repro_torch_kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
#: compiler output of the last successful build of each library, when it
#: printed anything (e.g. with ``extra_flags=("-Xptxas", "-v")``)
build_log: dict[str, str] = {}


def nvcc() -> str:
    """Path of the CUDA compiler: ``$NVCC``, then ``PATH``, then the
    toolkit's default location."""
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError("repro_torch kernels: no nvcc found (set $NVCC or put "
                       "the CUDA toolkit on PATH)")


def sources() -> dict[str, Path]:
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}.so"


def _stale(name: str, src: Path) -> bool:
    so = library_path(name)
    if not so.exists():
        return True
    newest = max(p.stat().st_mtime for p in [src, *CSRC.glob("*.cuh")])
    return so.stat().st_mtime < newest


def build_all(force: bool = False, extra_flags: tuple[str, ...] = ()
              ) -> dict[str, float]:
    """Compile every stale (or, with ``force``, every) source in parallel.
    Returns ``{name: seconds}`` for the sources it compiled; raises with the
    compiler's output if any of them fails."""
    todo = {n: s for n, s in sources().items() if force or _stale(n, s)}
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cc = nvcc()
    procs = {}
    for name, src in todo.items():
        tmp = BUILD_DIR / f"{name}.{os.getpid()}.tmp.so"
        cmd = [cc, *NVCC_FLAGS, *extra_flags, "-I", str(CSRC), "-o", str(tmp),
               str(src)]
        procs[name] = (tmp, time.perf_counter(),
                       subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True))
    seconds, failed = {}, []
    for name, (tmp, t0, proc) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"--- nvcc {todo[name].name} "
                          f"(exit {proc.returncode}) ---\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            if log.strip():
                build_log[name] = log
            os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("repro_torch kernel build failed:\n" +
                           "\n".join(failed))
    return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it first if it is
    missing or stale."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all()
            lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
            lib.repro_error_string.argtypes = [ctypes.c_int]
            lib.repro_error_string.restype = ctypes.c_char_p
        return lib


def check_constant(built: int, wrapper: int, what: str, name: str) -> None:
    """Raise if a library's constant ``name`` (a tile size, a stage count)
    is not the one its wrapper assumes."""
    if built != wrapper:
        raise RuntimeError(f"{what}: the library's {name} is {built}, the "
                           f"wrapper's is {wrapper}")


def refuse_grad(what: str, *tensors) -> None:
    """Raise when autograd would have to differentiate through a kernel:
    grad is enabled and an input requires grad.  The kernels have no
    backward, and their outputs are written through ``ctypes`` into fresh
    tensors that autograd cannot see, so a gradient would silently drop;
    the reference's ``jax.grad`` through a Pallas kernel fails as well.
    Checked on every device, the plain CPU path included, so that the CPU
    and the card agree."""
    import torch
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what}: the hand-written kernel has no backward; train "
            "through impl='chunked' or 'naive' (the MoE's 'scatter'), or "
            "call it under torch.no_grad()")


def check(lib: ctypes.CDLL, what: str, err: int) -> None:
    """Raise if an entry point returned a CUDA error."""
    if err:
        msg = lib.repro_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
