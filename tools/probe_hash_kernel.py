"""Measurements of the hash probe on the card:
``python3 tools/probe_hash_kernel.py`` from the repository root (one CUDA
card, ``nvcc``; about a minute).

What it measures, each time from a CUDA graph (``chip_smoke.graph_ms``)
beside the card's name and power limit, every table at load 0.5 built by
``chip_smoke._hash_table`` and probed by 2^24 keys (half hits, half
misses) unless a line says otherwise:

* the card's random-read rate: a gather of 2^24 int32 at uniform random
  indices from a 2^26-int32 array (256 MB), from a 2^22-int32 window
  (16 MB, which stays in L2), and at sequential indices (the same bytes);
* the first version of ``csrc/hash_probe.cu`` (kept below as
  ``FIRST_HASH`` with its wrapper), the present source, and the present
  source without its evict-first hints (a text edit of a copy), each held
  bit for bit to ``hash_probe_plain``, over tables of 2^16 to 2^25 slots:
  where the L2 cliff lies; and the first version's knock-outs at 2^24
  slots, each computing a wrong result whose time alone is read: no
  table_v read, stop after probe 0, no output stores, keys read with
  ``__ldcs`` and outputs written with ``__stcs``;
* eager calls (CUDA events, host issue included) of the first version's
  wrapper and the present one at the hash_table app's 16x tables, and the
  host's microseconds for each wrapper and its steps.

Variants build into ``build/probes/`` (gitignored).  One JSON object a
line on stdout; the last is the whole record, also written to
``build/probes/probe_hash_kernel.json``.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402

PROBES = ROOT / "build" / "probes"

# The first version of csrc/hash_probe.cu, with a switch for each knock-out.
FIRST_HASH = r"""
#include "common.cuh"
namespace repro {
namespace {
__device__ __forceinline__ unsigned mix(unsigned x) {
  x ^= x >> 16;
  x *= 0x45D9F3Bu;
  x ^= x >> 16;
  return x;
}
__global__ void __launch_bounds__(kThreads) hash_first(
    const int* __restrict__ keys, const int* __restrict__ table_k,
    const int* __restrict__ table_v, long long n, long long table_len,
    unsigned n_slots, int max_probes, int* __restrict__ vals,
    int* __restrict__ found) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads
                      + threadIdx.x;
  if (i >= n) return;
#if KO_STREAM
  const int key = __ldcs(keys + i);
#else
  const int key = keys[i];
#endif
  const long long h = mix(static_cast<unsigned>(key)) % n_slots;
  int v = 0, f = 0;
#if KO_PROBE0
  for (int p = 0; p < 1 && p < max_probes && h + p < table_len; ++p) {
#else
  for (int p = 0; p < max_probes && h + p < table_len; ++p) {
#endif
    const int ck = table_k[h + p];
    if (ck == key) {
#if KO_NO_V
      v = ck;
#else
      v = table_v[h + p];
#endif
      f = 1;
      break;
    }
    if (ck == 0) break;
  }
#if KO_NO_STORE
  if ((v ^ f) == 0x7fffffff) vals[i] = 1;
#elif KO_STREAM
  __stcs(vals + i, v);
  __stcs(found + i, f);
#else
  vals[i] = v;
  found[i] = f;
#endif
}
}  // namespace
}  // namespace repro
extern "C" int hash_first_launch(const void* keys, const void* table_k,
                                 const void* table_v, long long n,
                                 long long table_len, unsigned n_slots,
                                 int max_probes, void* vals, void* found,
                                 void* stream) {
  if (n == 0) return cudaSuccess;
  const long long blocks = (n + repro::kThreads - 1) / repro::kThreads;
  repro::hash_first<<<static_cast<unsigned>(blocks), repro::kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(keys), static_cast<const int*>(table_k),
      static_cast<const int*>(table_v), n, table_len, n_slots, max_probes,
      static_cast<int*>(vals), static_cast<int*>(found));
  return cudaGetLastError();
}
"""

FIRST_KNOCKOUTS = {
    "as it was": (),
    "no table_v read": ("-DKO_NO_V=1",),
    "stop after probe 0": ("-DKO_PROBE0=1",),
    "no output stores": ("-DKO_NO_STORE=1",),
    "keys __ldcs, outputs __stcs": ("-DKO_STREAM=1",),
}

# out[i] = src[idx[i]]: the card's rate for the indices it is given
GATHER = r"""
#include "common.cuh"
__global__ void gather(const int* __restrict__ idx,
                       const int* __restrict__ src, int* __restrict__ out,
                       long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  if (i < n) out[i] = src[__ldcs(idx + i)];
}
extern "C" int gather_launch(const void* idx, const void* src, void* out,
                             long long n, void* stream) {
  gather<<<static_cast<unsigned>((n + 255) / 256), 256, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(idx), static_cast<const int*>(src),
      static_cast<int*>(out), n);
  return cudaGetLastError();
}
"""


def _replace(*pairs):
    def edit(text: str) -> str:
        for old, new in pairs:
            cs.require(old in text, f"hash_probe.cu has no {old!r}")
            text = text.replace(old, new)
        return text
    return edit


# other versions of the present source (launched as hash_probe_launch)
VARIANTS = {
    "present without evict-first hints": _replace(
        ("const int key = __ldcs(keys + i);", "const int key = keys[i];"),
        ("  __stcs(out + i, v);\n  __stcs(out + n + i, f);",
         "  out[i] = v;\n  out[n + i] = f;")),
}

CLIFF_SLOTS = (1 << 16, 1 << 20, 1 << 22, 1 << 23, 1 << 24, 1 << 25)


def probe_sources() -> dict[str, tuple[str, tuple[str, ...]]]:
    """Every probe's source text and extra flags, by name; raises if an edit
    no longer finds its text (no card needed)."""
    from repro_torch.kernels import _build as kb
    src = (kb.CSRC / "hash_probe.cu").read_text()
    jobs = {f"first_{i}": (FIRST_HASH, flags)
            for i, flags in enumerate(FIRST_KNOCKOUTS.values())}
    jobs["gather"] = (GATHER, ())
    for i, edit in enumerate(VARIANTS.values()):
        jobs[f"var_{i}"] = (edit(src), ())
    return jobs


def _build(jobs: dict[str, tuple[str, tuple[str, ...]]]) -> dict:
    """Compile each ``name: (source text, extra flags)`` into
    ``build/probes/<name>.so``, all at once; returns the loaded libraries
    and each one's ``-Xptxas -v`` lines."""
    from repro_torch.kernels import _build as kb
    PROBES.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (text, flags) in jobs.items():
        src = PROBES / f"hash_{name}.cu"
        src.write_text(text)
        cmd = [kb.nvcc(), *kb.NVCC_FLAGS, "-Xptxas", "-v", *flags, "-I",
               str(kb.CSRC), "-o", str(PROBES / f"hash_{name}.so"), str(src)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    out = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        cs.require(proc.returncode == 0, f"probe {name} build:\n{log}")
        out[name] = (ctypes.CDLL(str(PROBES / f"hash_{name}.so")),
                     [ln.strip() for ln in log.splitlines()
                      if "Used" in ln or "spill" in ln])
    return out


def _stream():
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("probe_hash_kernel: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build as kb
    from repro_torch.kernels import hash_probe as hp
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    kb.build_all(force=True, extra_flags=("-Xptxas", "-v"))
    record = {"card": smi, "ptxas": cs.ptxas_by_function(
        kb.build_log.get("hash_probe", ""))}
    cs.emit({"card": smi, "ptxas": record["ptxas"]})
    libs = _build(probe_sources())
    record["probe_ptxas"] = {k: v[1] for k, v in libs.items()}
    vp, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    for name, (lib, _) in libs.items():
        if name.startswith("first"):
            lib.hash_first_launch.argtypes = [vp] * 3 + [ll, ll,
                                                         ctypes.c_uint, i32,
                                                         vp, vp, vp]
        elif name == "gather":
            lib.gather_launch.argtypes = [vp, vp, vp, ll, vp]
        else:
            lib.hash_probe_launch.argtypes = [vp] * 3 + [
                ll, ll, ctypes.c_uint, i32, vp, vp]

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(cs.SEED + 13)
    mp = cs.HASH_MAX_PROBES

    def line(key, rec):
        record.setdefault(key, []).append(rec)
        cs.emit({key: rec, "card": smi})

    # -- the card's random-read rate
    n = 1 << 24
    src = torch.randint(0, 1 << 30, (1 << 26,), generator=gen, device=dev,
                        dtype=torch.int32)
    dst = torch.empty(n, dtype=torch.int32, device=dev)
    gather = libs["gather"][0]
    for what, idx in (
            ("uniform over 2^26 int32 (256 MB)",
             torch.randint(0, 1 << 26, (n,), generator=gen, device=dev,
                           dtype=torch.int32)),
            ("uniform over 2^22 int32 (16 MB)",
             torch.randint(0, 1 << 22, (n,), generator=gen, device=dev,
                           dtype=torch.int32)),
            ("sequential", torch.arange(n, device=dev, dtype=torch.int32))):
        def call(idx=idx):
            cs.require(gather.gather_launch(idx.data_ptr(), src.data_ptr(),
                                            dst.data_ptr(), n,
                                            _stream()) == 0, "gather")
        call()
        torch.cuda.synchronize()
        cs.require(torch.equal(dst, src[idx.long()]), f"gather {what}")
        ms = cs.graph_ms(call, 20)
        line("gather", {"indices": what, "n": n, "graph_ms": ms,
                        "reads_per_s": n / ms * 1e3,
                        "sector_bytes_per_s": 32 * n / ms * 1e3,
                        "bytes_per_s": 12 * n / ms * 1e3})
        del idx
    del src, dst

    # -- first version, present source and its variant over the tables
    def first_call(lib, q, tk, tv, n_slots, out):
        return lambda: cs.require(lib.hash_first_launch(
            q.data_ptr(), tk.data_ptr(), tv.data_ptr(), q.numel(),
            tk.numel(), n_slots, mp, out.data_ptr(),
            out.data_ptr() + 4 * q.numel(), _stream()) == 0, "first launch")

    def present_call(lib, q, tk, tv, n_slots, out):
        return lambda: cs.require(lib.hash_probe_launch(
            q.data_ptr(), tk.data_ptr(), tv.data_ptr(), q.numel(),
            tk.numel(), n_slots, mp, out.data_ptr(), _stream()) == 0,
            "present launch")

    def timed(what, call, out, want, n_keys, exact=True):
        out.fill_(-1)
        call()
        torch.cuda.synchronize()
        same = (torch.equal(out[:n_keys], want[0]) and
                torch.equal(out[n_keys:], want[1]))
        cs.require(same or not exact, f"{what} differs from plain")
        return {"bit_for_bit": same, "graph_ms": cs.graph_ms(call, 20)}

    for n_slots in CLIFF_SLOTS:
        keys, tk, tv = cs._hash_table(gen, n_slots, 0.5, dev)
        q = cs._hash_queries(gen, keys, 1 << 24, dev)
        del keys
        want = hp.hash_probe_plain(q, tk, tv, n_slots, mp)
        bound, counts = cs._hash_bound(q, tk, n_slots, want[1])
        n = q.numel()
        out = torch.empty(2 * n, dtype=torch.int32, device=dev)
        rec = {"n": n, "n_slots": n_slots, "used_bytes": 8 * min(
            tk.numel(), n_slots + mp), "bound_ms": bound, **counts}
        rows = {"first version": timed(
            "first", first_call(libs["first_0"][0], q, tk, tv, n_slots, out),
            out, want, n),
            "present": timed("present", present_call(
                hp._lib(), q, tk, tv, n_slots, out), out, want, n)}
        for i, what in enumerate(VARIANTS):
            rows[what] = timed(what, present_call(
                libs[f"var_{i}"][0], q, tk, tv, n_slots, out), out, want, n)
        if n_slots == 1 << 24:
            for i, what in enumerate(FIRST_KNOCKOUTS):
                if i:
                    rows[f"first version, {what}"] = timed(
                        what, first_call(libs[f"first_{i}"][0], q, tk, tv,
                                         n_slots, out), out, want, n,
                        exact=False)
        for row in rows.values():
            row["of_bound"] = bound / row["graph_ms"]
        line("table", {**rec, "graph": rows})
        del out, want, q, tk, tv

    # -- eager calls at the app's 16x tables: the wrappers' host cost
    import numpy as np
    from repro_torch.apps import ALL_APPS
    from repro_torch.serve.traffic import HASH_TABLE_16X
    app = ALL_APPS["hash_table"](**HASH_TABLE_16X)
    q, tk, tv = [torch.from_numpy(app.dram_init[k].astype(np.int32)).to(dev)
                 for k in ("queries", "table_k", "table_v")]
    n_slots = app.statics["n_slots"]
    first = libs["first_0"][0]

    def first_wrapper(keys=q, table_k=tk, table_v=tv, max_probes=mp):
        """The first version's wrapper, line for line."""
        hp._check(keys, table_k, table_v, n_slots, max_probes)
        if keys.device.type == "cpu":
            return None
        if keys.device.type != "cuda":
            raise ValueError(f"hash_probe: unsupported device {keys.device}")
        for name, t in (("keys", keys), ("table_k", table_k),
                        ("table_v", table_v)):
            if not t.is_contiguous():
                raise ValueError(f"hash_probe: {name} must be contiguous")
        vals = torch.empty_like(keys)
        found = torch.empty_like(keys)
        with torch.cuda.device(keys.device):
            err = first.hash_first_launch(
                keys.data_ptr(), table_k.data_ptr(), table_v.data_ptr(),
                keys.shape[0], table_k.shape[0], n_slots, max_probes,
                vals.data_ptr(), found.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        cs.require(err == 0, "first wrapper")
        return vals, found

    def present():
        return hp.hash_probe(q, tk, tv, n_slots)

    want = hp.hash_probe_plain(q, tk, tv, n_slots)
    for fn in (first_wrapper, present):
        cs.require(all(torch.equal(g, w) for g, w in zip(fn(), want)),
                   f"{fn.__name__} at the app's tables")
    eager = {"first version": [], "present": []}
    for fn, what in ((first_wrapper, "first version"), (present, "present"),
                     (present, "present"), (first_wrapper, "first version")):
        eager[what].append(cs.time_ms(fn, 300))
    graph = {"first version": cs.graph_ms(first_wrapper, 300),
             "present": cs.graph_ms(present, 300)}

    def device_context():
        with torch.cuda.device(q.device):
            pass

    host = {}                             # host microseconds a call
    out = torch.empty(2 * q.numel(), dtype=torch.int32, device=dev)
    for what, fn in (
            ("first version's wrapper", first_wrapper),
            ("present wrapper", present),
            ("torch.empty [2N]", lambda: torch.empty(
                2 * q.numel(), dtype=torch.int32, device=dev)),
            ("torch.empty_like x2", lambda: (torch.empty_like(q),
                                             torch.empty_like(q))),
            ("two views of one buffer", lambda: (out[:q.numel()],
                                                 out[q.numel():])),
            ("torch.cuda.device context", device_context),
            ("current_device", torch.cuda.current_device),
            ("current_stream().cuda_stream",
             lambda: torch.cuda.current_stream().cuda_stream),
            ("raw current stream",
             lambda: torch._C._cuda_getCurrentRawStream(0))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            fn()
        host[what] = (time.perf_counter() - t0) / 2000 * 1e6
        torch.cuda.synchronize()
    line("app_16x", {"n": q.numel(), "n_slots": n_slots,
                     "eager_ms": eager, "graph_ms": graph,
                     "host_us": host})

    (PROBES / "probe_hash_kernel.json").write_text(
        json.dumps(record, indent=1))
    print(smi, flush=True)
    cs.emit(record)
    return 0


if __name__ == "__main__":
    sys.exit(main())
