"""Knock-out and layout probes of the two recurrence kernels on the card:
``python3 tools/probe_scan_kernels.py`` from the repository root (one
CUDA card, ``nvcc``; about a minute).

What it measures, each time from a CUDA graph (``chip_smoke.graph_ms``)
at the main path's shapes, beside the card's name and power limit:

* ``ssm_scan``'s first version (one lane a state element, a shuffle tree
  a step; kept below as ``FIRST_SSM``) as it was and with one part knocked
  out at a time: the shuffle tree, the per-step shared loads (values read
  once before the loop), accurate ``expf`` (``__expf``), the per-step
  store of y.  A knock-out computes a wrong y; only its time is read.
* the present ``ssm_scan`` in every (lanes, states) instance the library
  holds, at N 16 and N 32, against the plain version (``SSM_TOL``); two
  knock-outs of it built from a copy of its source: ``expf`` for ``ex2``
  (the cost of an accurate expf), no lane sum, no ex2, no copies after
  the first stage, no y store; and other versions of it (``SSM_VARIANTS``:
  the loop over buffers unrolled twice, stages of 64 steps, blocks of 128
  threads), each held to the plain version;
* ``rg_lru`` at each block width, and at its planned width built from
  copies of its source with 3, 6 or 10 stages, 32 or 64 steps a stage,
  and three knock-outs: the chain (each step independent of h), the y
  store, the wait for the copies.  Each version that computes the scan is
  held bit for bit to the plain one.

Variants build into ``build/probes/`` (gitignored).  One JSON object a
line on stdout; the last is the whole record, also written to
``build/probes/probe_scan_kernels.json``.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402

PROBES = ROOT / "build" / "probes"

# The first version of csrc/ssm_scan.cu (G = 16 lanes a channel only), with
# a switch for each knock-out.
FIRST_SSM = r"""
#include "common.cuh"
namespace repro {
namespace {
constexpr int kBlock = 256;
constexpr int kChunk = 64;
constexpr int G = 16;
__global__ void __launch_bounds__(kBlock) ssm_first(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ a, const float* __restrict__ b,
    const float* __restrict__ c, const float* __restrict__ dskip,
    const float* __restrict__ h0, float* __restrict__ y,
    float* __restrict__ hT, int seq, int di, int n) {
  constexpr int kCh = kBlock / G;
  __shared__ float xs[kChunk][kCh];
  __shared__ float dts[kChunk][kCh];
  __shared__ float ys[kChunk][kCh];
  __shared__ float bs[kChunk][G];
  __shared__ float cs[kChunk][G];
  const int tid = threadIdx.x, lane = tid % G, ch = tid / G;
  const int d0 = blockIdx.x * kCh, dch = d0 + ch;
  const long long row0 = static_cast<long long>(blockIdx.y) * seq;
  const long long state = (static_cast<long long>(blockIdx.y) * di + dch) * n
                          + lane;
  const bool live = dch < di && lane < n;
  float av = 0.f, h = 0.f, dsk = 0.f;
  if (live) { av = a[static_cast<long long>(dch) * n + lane]; h = h0[state]; }
  if (dch < di) dsk = dskip[dch];
  for (int t0 = 0; t0 < seq; t0 += kChunk) {
    const int steps = min(kChunk, seq - t0);
    for (int i = tid; i < kChunk * kCh; i += kBlock) {
      const int t = i / kCh, cc = i % kCh;
      float xv = 0.f, dv = 0.f;
      if (t < steps && d0 + cc < di) {
        const long long off = (row0 + t0 + t) * di + d0 + cc;
        xv = x[off]; dv = dt[off];
      }
      xs[t][cc] = xv; dts[t][cc] = dv;
    }
    for (int i = tid; i < kChunk * G; i += kBlock) {
      const int t = i / G, k = i % G;
      float bv = 0.f, cv = 0.f;
      if (t < steps && k < n) {
        const long long off = (row0 + t0 + t) * n + k;
        bv = b[off]; cv = c[off];
      }
      bs[t][k] = bv; cs[t][k] = cv;
    }
    __syncthreads();
#if KO_SHARED
    const float dtt0 = dts[0][ch], xt0 = xs[0][ch], b0 = bs[0][lane],
                c0 = cs[0][lane];
#endif
#pragma unroll 4
    for (int t = 0; t < steps; ++t) {
#if KO_SHARED
      const float dtt = dtt0 + t * 1e-7f, xt = xt0, bt = b0, ct = c0;
#else
      const float dtt = dts[t][ch], xt = xs[t][ch], bt = bs[t][lane],
                  ct = cs[t][lane];
#endif
#if KO_EXP
      const float da = __expf(dtt * av);
#else
      const float da = expf(dtt * av);
#endif
      h = da * h + (dtt * xt) * bt;
      float part = h * ct;
#if !KO_SHUFFLE
#pragma unroll
      for (int o = G / 2; o > 0; o >>= 1)
        part += __shfl_xor_sync(kFull, part, o, G);
#endif
#if KO_STORE
      if (lane == 0 && t == steps - 1) ys[t][ch] = part + dsk * xt;
#else
      if (lane == 0) ys[t][ch] = part + dsk * xt;
#endif
    }
    __syncthreads();
    for (int i = tid; i < steps * kCh; i += kBlock) {
      const int t = i / kCh, cc = i % kCh;
      if (d0 + cc < di) y[(row0 + t0 + t) * di + d0 + cc] = ys[t][cc];
    }
  }
  if (live) hT[state] = h;
}
}  // namespace
}  // namespace repro
extern "C" int ssm_first_launch(const void* x, const void* dt, const void* a,
                                const void* b, const void* c, const void* d,
                                const void* h0, void* y, void* hT, int batch,
                                int seq, int di, int n, void* stream) {
  const dim3 grid((di + repro::kBlock / repro::G - 1) /
                  (repro::kBlock / repro::G), batch);
  repro::ssm_first<<<grid, repro::kBlock, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(c), static_cast<const float*>(d),
      static_cast<const float*>(h0), static_cast<float*>(y),
      static_cast<float*>(hT), seq, di, n);
  return cudaGetLastError();
}
"""

FIRST_KNOCKOUTS = {
    "as it was": (),
    "no shuffle tree": ("-DKO_SHUFFLE=1",),
    "no per-step shared loads": ("-DKO_SHARED=1",),
    "__expf for expf": ("-DKO_EXP=1",),
    "no per-step y store": ("-DKO_STORE=1",),
    "no shuffle tree, no shared loads": ("-DKO_SHUFFLE=1", "-DKO_SHARED=1"),
}

# other versions of the present sources, as text replacements of a copy
_G_LOOP = "    for (int g = 0; g < steps; g += L) {"
SSM_VARIANTS = {
    "g loop unrolled twice": (
        (_G_LOOP, "#pragma unroll 2\n" + _G_LOOP),),
    "stages of 64 steps": (
        ("constexpr int kChunk = 32;", "constexpr int kChunk = 64;"),),
    "blocks of 128 threads": (
        ("constexpr int kBlock = 256;", "constexpr int kBlock = 128;"),),
}
SSM_VARIANT_SHAPES = ((8, 2),)
SSM_KNOCKOUTS = {
    "expf for ex2": (("ex2(dtt * a2[k])", "expf(dtt * a2[k])"),),
    "no lane sum": (("reduce_scatter<L>(part, lane)", "part[0]"),),
    "no ex2 (a multiply-add)": (
        ("ex2(dtt * a2[k])", "fmaf(dtt, a2[k], 1.f)"),),
    "no copies after the first stage": (
        ("    if (ci + 1 < chunks)\n      stage_chunk",
         "    if (false)\n      stage_chunk"),),
    "no y store": (
        ("  using C = Cfg<L, K>;\n  if (vec) {",
         "  using C = Cfg<L, K>;\n  if (true) return;\n  if (vec) {"),),
}
RG_VARIANTS = {
    "3 stages": ("kStages = W == 32 ? 10 : 6;", "kStages = 3;"),
    "6 stages": ("kStages = W == 32 ? 10 : 6;", "kStages = 6;"),
    "10 stages": ("kStages = W == 32 ? 10 : 6;", "kStages = 10;"),
    "32 steps a stage": ("kSteps = W == 32 ? 32 : 64;", "kSteps = 32;"),
    "64 steps a stage": ("kSteps = W == 32 ? 32 : 64;", "kSteps = 64;"),
    "no chain (steps independent)": (
        "h = __fadd_rn(__fmul_rn(ra[u], h), rb[u]);",
        "h = __fadd_rn(__fmul_rn(ra[u], rb[u]), 1.f);"),
    "no y store": (
        "*reinterpret_cast<float4*>(y + (row0 + t0 + t) * d + d0 + q) =\n"
        "              *reinterpret_cast<const float4*>(ys + t * W + q);",
        ";"),
    "no wait for the copies": ("cp_async_wait<kStages - 2>();", ""),
}


def probe_sources() -> dict[str, tuple[str, tuple[str, ...]]]:
    """Every probe's source text and extra flags, by name; raises if an edit
    no longer finds its text (no card needed)."""
    from repro_torch.kernels import _build as kb
    ssm_src = (kb.CSRC / "ssm_scan.cu").read_text()
    rg_src = (kb.CSRC / "rg_lru.cu").read_text()
    jobs = {f"first_{i}": (FIRST_SSM, flags)
            for i, flags in enumerate(FIRST_KNOCKOUTS.values())}
    for tag, table in (("ssm_ko", SSM_KNOCKOUTS), ("ssm_var", SSM_VARIANTS)):
        for i, edits in enumerate(table.values()):
            text = ssm_src
            for old, new in edits:
                cs.require(old in text, f"ssm_scan.cu has no {old!r}")
                text = text.replace(old, new)
            jobs[f"{tag}_{i}"] = (text, ())
    for i, (old, new) in enumerate(RG_VARIANTS.values()):
        cs.require(old in rg_src, f"rg_lru.cu has no {old!r}")
        jobs[f"rg_var_{i}"] = (rg_src.replace(old, new), ())
    return jobs


def _build(jobs: dict[str, tuple[str, tuple[str, ...]]]) -> dict:
    """Compile each ``name: (source text, extra flags)`` into
    ``build/probes/<name>.so``, all at once; returns the loaded libraries
    and each one's ``-Xptxas -v`` lines."""
    from repro_torch.kernels import _build as kb
    PROBES.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (text, flags) in jobs.items():
        src = PROBES / f"{name}.cu"
        src.write_text(text)
        cmd = [kb.nvcc(), *kb.NVCC_FLAGS, "-Xptxas", "-v", *flags, "-I",
               str(kb.CSRC), "-o", str(PROBES / f"{name}.so"), str(src)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    out = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        cs.require(proc.returncode == 0, f"probe {name} build:\n{log}")
        out[name] = (ctypes.CDLL(str(PROBES / f"{name}.so")),
                     [ln.strip() for ln in log.splitlines()
                      if "Used" in ln or "spill" in ln])
    return out


def _ptr_args(ins, outs, *ints):
    """A launch's arguments but the stream (taken at each call, so that a
    graph capture records the launch)."""
    return ([ctypes.c_void_p(t.data_ptr()) for t in (*ins, *outs)]
            + [ctypes.c_int(i) for i in ints])


def _stream():
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("probe_scan_kernels: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build as kb
    from repro_torch.kernels import rg_lru as rg
    from repro_torch.kernels import ssm_scan as sc
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    kb.build_all(force=True, extra_flags=("-Xptxas", "-v"))
    record = {"card": smi, "ptxas": {
        name: cs.ptxas_by_function(kb.build_log.get(name, ""))
        for name in ("ssm_scan", "rg_lru")}}
    cs.emit({"ptxas": record["ptxas"]})

    jobs = probe_sources()
    libs = _build(jobs)
    record["probe_ptxas"] = {k: v[1] for k, v in libs.items()}

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(cs.SEED + 11)
    clock = cs._sm_clock_hz()

    # ssm_scan: the first version and its knock-outs, at the path shape
    first = {}
    ins = cs._ssm_inputs(gen, *cs.SSM_PATH, True, dev)
    bsz, s, di, n = cs.SSM_PATH
    y, hT = torch.empty_like(ins[0]), torch.empty_like(ins[6])
    for i, what in enumerate(FIRST_KNOCKOUTS):
        lib = libs[f"first_{i}"][0]
        args = _ptr_args(ins, (y, hT), bsz, s, di, n)

        def call(lib=lib, args=args):
            cs.require(lib.ssm_first_launch(*args, _stream()) == 0,
                       "first launch")
        first[what] = cs.graph_ms(call, 50)
    record["ssm_first_version_ms"] = first
    cs.emit({"ssm_first_version_graph_ms": first})

    # the present ssm_scan in every instance, and its knock-outs
    layouts = []
    for n_state in (16, 32):
        for shape in (cs.SSM_PATH[:3], cs.SSM_LARGE[:3]):
            ins = cs._ssm_inputs(gen, *shape, n_state, False, dev)
            want = sc.ssm_scan_plain(*ins) if shape[1] <= 512 else None
            for lanes, states in sc.INSTANCES:
                if lanes * states < n_state:
                    continue
                p = sc.plan(shape[0], shape[2], n_state, lanes, states)
                rec = {"b": shape[0], "s": shape[1], "di": shape[2],
                       "n": n_state, "lanes": lanes, "states": states,
                       "blocks": p.blocks, "smem_bytes": p.smem_bytes,
                       "planned": p == sc.plan(shape[0], shape[2], n_state)}
                if want is not None:
                    got = sc._launch(*ins, p)
                    rec["err_over_scale"] = max(
                        float((g - w).abs().max()) / float(w.abs().max())
                        for g, w in zip(got, want))
                    cs.require(rec["err_over_scale"] <= cs.SSM_TOL,
                               f"ssm_scan {rec}")
                rec["graph_ms"] = cs.graph_ms(
                    lambda ins=ins, p=p: sc._launch(*ins, p),
                    20 if shape[1] <= 512 else 3)
                rec["bound_ms"] = cs._ssm_bound(*shape, n_state,
                                                clock)["bound_ms"]
                layouts.append(rec)
                cs.emit({"ssm_layout": rec})
    record["ssm_layouts"] = layouts
    ko = {}
    ins = cs._ssm_inputs(gen, *cs.SSM_PATH, True, dev)
    p = sc.plan(bsz, di, n)
    y, hT = torch.empty_like(ins[0]), torch.empty_like(ins[6])
    args = _ptr_args(ins, (y, hT), bsz, s, di, n, p.lanes, p.states)
    ko["as it is"] = cs.graph_ms(lambda: sc._launch(*ins, p), 50)
    for i, what in enumerate(SSM_KNOCKOUTS):
        lib = libs[f"ssm_ko_{i}"][0]

        def call(lib=lib):
            cs.require(lib.ssm_scan_launch(*args, _stream()) == 0,
                       "ssm knock-out")
        ko[what] = cs.graph_ms(call, 50)
    record["ssm_knockouts_ms"] = ko
    cs.emit({"ssm_knockout_graph_ms": ko})

    # other versions of the present source, each held to the plain version
    variants = []
    for shape in (cs.SSM_PATH, cs.SSM_LARGE):
        ins = cs._ssm_inputs(gen, *shape, False, dev)
        want = sc.ssm_scan_plain(*ins) if shape[1] <= 512 else None
        b_, s_, d_, n_ = shape
        y, hT = torch.empty_like(ins[0]), torch.empty_like(ins[6])
        for i, what in enumerate(SSM_VARIANTS):
            lib = libs[f"ssm_var_{i}"][0]
            for lanes, states in SSM_VARIANT_SHAPES:
                args = _ptr_args(ins, (y, hT), b_, s_, d_, n_, lanes, states)

                def call(lib=lib, args=args):
                    cs.require(lib.ssm_scan_launch(*args, _stream()) == 0,
                               "ssm variant")
                rec = {"b": b_, "s": s_, "variant": what, "lanes": lanes,
                       "states": states}
                if want is not None:
                    call()
                    torch.cuda.synchronize()
                    rec["err_over_scale"] = max(
                        float((g - w).abs().max()) / float(w.abs().max())
                        for g, w in zip((y, hT), want))
                    cs.require(rec["err_over_scale"] <= cs.SSM_TOL,
                               f"ssm variant {rec}")
                rec["graph_ms"] = cs.graph_ms(call, 20 if s_ <= 512 else 3)
                variants.append(rec)
                cs.emit({"ssm_variant": rec})
    record["ssm_variants"] = variants

    # rg_lru at each width; its variants at the planned width
    rows = []
    for shape in (cs.RG_PATH, cs.RG_LARGE):
        ins = cs._rg_inputs(gen, *shape, False, dev)
        want = rg.rg_lru_plain(*ins)
        b_, s_, d_ = shape
        planned = rg.plan(b_, d_).width
        runs = [("as it is", width, rg._lib()) for width in rg.WIDTHS]
        runs += [(what, planned, libs[f"rg_var_{i}"][0])
                 for i, what in enumerate(RG_VARIANTS)]
        for what, width, lib in runs:
            y, hT = torch.empty_like(ins[0]), torch.empty_like(ins[2])
            args = _ptr_args(ins, (y, hT), b_, s_, d_, width)

            def call(lib=lib, args=args):
                cs.require(lib.rg_lru_launch(*args, _stream()) == 0,
                           "rg launch")
            call()
            torch.cuda.synchronize()
            same = torch.equal(y, want[0]) and torch.equal(hT, want[1])
            cs.require(same or what.startswith("no "),
                       f"rg_lru {what} width {width} differs from plain")
            rec = {"b": b_, "s": s_, "d": d_, "variant": what,
                   "width": width, "blocks": b_ * -(-d_ // width),
                   "planned": what == "as it is" and width == planned,
                   "bit_for_bit": same,
                   "graph_ms": cs.graph_ms(call, 50 if s_ <= 512 else 5)}
            rows.append(rec)
            cs.emit({"rg_layout": rec})
    record["rg_layouts"] = rows
    (PROBES / "probe_scan_kernels.json").write_text(
        json.dumps(record, indent=1))
    print(smi, flush=True)
    cs.emit(record)
    return 0


if __name__ == "__main__":
    sys.exit(main())
