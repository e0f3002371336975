// ssm_scan — the Mamba-1 selective-scan recurrence, on Hopper.
//
// Replaces the TPU kernel src/repro/kernels/ssm_scan.py::_ssm_kernel
// (launched by ssm_scan, wrapped by ops.ssm(impl="pallas")).  That kernel
// walks (batch, d_inner blocks, sequence chunks) with the chunk axis in
// order, carries the [Bd, N] state across chunks in VMEM scratch, and steps
// the recurrence inside a chunk with d_inner as the vector lanes.  Here
// blocks run in no order, so one block owns its channels over the whole
// sequence and the chunk axis becomes a loop inside it: the state never
// leaves registers.
//
// Contract: all float32, row-major.  x/dt [B, S, Di], a [Di, N],
// b/c [B, S, N], d [Di], h0 [B, Di, N]; any S and Di, 1 <= N <= 32.
//   h_t = exp(dt_t * a) * h_{t-1} + (dt_t * x_t) * b_t     (per d, n)
//   y_t = sum_n h_t * c_t + d * x_t                         (per d)
// out: y [B, S, Di], hT [B, Di, N] (the state after the last step; h0 when
// S = 0).  The arithmetic is the reference kernel's, step for step, with
// expf (not __expf) so that it stays at float32 rounding; only the sum over
// n runs in another order (a shuffle tree).
//
// Layout: 256 threads per block.  Each channel d gets a group of G lanes
// (G = 8, 16 or 32, the least power of two >= N, lanes n >= N idle), one
// state element h[d, n] per lane, so a block covers 256 / G channels and
// (B = 1, Di = 8192, N = 16) launches 512 blocks.  b_t and c_t are shared by
// every channel of a batch row: a chunk of kChunk steps of them is staged
// in shared memory with the block's x and dt columns (read coalesced along
// d).  Each step the group sums h * c with xor shuffles, and lane 0 puts
// y_t into a shared tile, written back coalesced once per chunk.
//
// Bound: the bytes (x, dt and y, plus a, b, c, d, h0 and hT, each once, at
// 3.35 TB/s) or the B*S*Di*N exponentials on the special-function units
// (16 per SM per clock), whichever is larger; at (1, 512, 8192, 16) the two
// are close.  Every step also pays a shuffle tree and two shared-memory
// broadcasts per lane, so this first version sits well above both.
#include "common.cuh"

namespace repro {
namespace {

constexpr int kBlock = 256;
constexpr int kChunk = 64;     // steps of x, dt, b, c staged at a time

template <int G>
__global__ void __launch_bounds__(kBlock) ssm_scan_kernel(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ a, const float* __restrict__ b,
    const float* __restrict__ c, const float* __restrict__ dskip,
    const float* __restrict__ h0, float* __restrict__ y,
    float* __restrict__ hT, int seq, int di, int n) {
  constexpr int kCh = kBlock / G;          // channels per block
  __shared__ float xs[kChunk][kCh];
  __shared__ float dts[kChunk][kCh];
  __shared__ float ys[kChunk][kCh];
  __shared__ float bs[kChunk][G];
  __shared__ float cs[kChunk][G];

  const int tid = threadIdx.x;
  const int lane = tid % G;                // state index n
  const int ch = tid / G;                  // channel within the block
  const int d0 = blockIdx.x * kCh;
  const int dch = d0 + ch;
  const long long row0 = static_cast<long long>(blockIdx.y) * seq;
  const long long state = (static_cast<long long>(blockIdx.y) * di + dch) * n
                          + lane;
  const bool live = dch < di && lane < n;

  float av = 0.f, h = 0.f, dsk = 0.f;      // idle lanes keep h = 0
  if (live) {
    av = a[static_cast<long long>(dch) * n + lane];
    h = h0[state];
  }
  if (dch < di) dsk = dskip[dch];

  for (int t0 = 0; t0 < seq; t0 += kChunk) {
    const int steps = min(kChunk, seq - t0);
    for (int i = tid; i < kChunk * kCh; i += kBlock) {
      const int t = i / kCh, cc = i % kCh;
      float xv = 0.f, dv = 0.f;
      if (t < steps && d0 + cc < di) {
        const long long off = (row0 + t0 + t) * di + d0 + cc;
        xv = x[off];
        dv = dt[off];
      }
      xs[t][cc] = xv;
      dts[t][cc] = dv;
    }
    for (int i = tid; i < kChunk * G; i += kBlock) {
      const int t = i / G, k = i % G;
      float bv = 0.f, cv = 0.f;
      if (t < steps && k < n) {
        const long long off = (row0 + t0 + t) * n + k;
        bv = b[off];
        cv = c[off];
      }
      bs[t][k] = bv;
      cs[t][k] = cv;
    }
    __syncthreads();
#pragma unroll 4
    for (int t = 0; t < steps; ++t) {
      const float dtt = dts[t][ch], xt = xs[t][ch];
      const float da = expf(dtt * av);
      h = da * h + (dtt * xt) * bs[t][lane];
      float part = h * cs[t][lane];
#pragma unroll
      for (int o = G / 2; o > 0; o >>= 1)
        part += __shfl_xor_sync(kFull, part, o, G);
      if (lane == 0) ys[t][ch] = part + dsk * xt;
    }
    __syncthreads();   // ys complete; xs..cs free for the next chunk
    for (int i = tid; i < steps * kCh; i += kBlock) {
      const int t = i / kCh, cc = i % kCh;
      if (d0 + cc < di) y[(row0 + t0 + t) * di + d0 + cc] = ys[t][cc];
    }
  }
  if (live) hT[state] = h;
}

template <int G>
cudaError_t launch(const float* x, const float* dt, const float* a,
                   const float* b, const float* c, const float* d,
                   const float* h0, float* y, float* hT, int batch, int seq,
                   int di, int n, cudaStream_t s) {
  constexpr int kCh = kBlock / G;
  const dim3 grid((di + kCh - 1) / kCh, batch);
  ssm_scan_kernel<G><<<grid, kBlock, 0, s>>>(x, dt, a, b, c, d, h0, y, hT,
                                             seq, di, n);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// Entry point for ctypes.  Returns a cudaError_t code (0 = launched).
extern "C" int ssm_scan_launch(const void* x, const void* dt, const void* a,
                               const void* b, const void* c, const void* d,
                               const void* h0, void* y, void* hT, int batch,
                               int seq, int di, int n, void* stream) {
  if (n < 1 || n > 32 || batch > 65535 || seq < 0)
    return cudaErrorInvalidValue;
  if (batch <= 0 || di <= 0) return cudaSuccess;
  const auto* xp = static_cast<const float*>(x);
  const auto* dtp = static_cast<const float*>(dt);
  const auto* ap = static_cast<const float*>(a);
  const auto* bp = static_cast<const float*>(b);
  const auto* cp = static_cast<const float*>(c);
  const auto* dp = static_cast<const float*>(d);
  const auto* hp = static_cast<const float*>(h0);
  auto* yp = static_cast<float*>(y);
  auto* tp = static_cast<float*>(hT);
  auto s = static_cast<cudaStream_t>(stream);
  if (n <= 8)
    return repro::launch<8>(xp, dtp, ap, bp, cp, dp, hp, yp, tp, batch, seq,
                            di, n, s);
  if (n <= 16)
    return repro::launch<16>(xp, dtp, ap, bp, cp, dp, hp, yp, tp, batch, seq,
                             di, n, s);
  return repro::launch<32>(xp, dtp, ap, bp, cp, dp, hp, yp, tp, batch, seq,
                           di, n, s);
}
