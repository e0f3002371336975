// rg_lru — the RG-LRU diagonal gated scan (recurrentgemma-9b), on Hopper.
//
// Replaces the TPU kernel src/repro/kernels/rg_lru.py::_rglru_kernel
// (launched by rg_lru, wrapped by ops.rg_lru_scan(impl="pallas")).  That
// kernel walks (batch, d blocks of 512, sequence chunks of 128) with the
// chunk axis in order and carries the [Bd] state across chunks in VMEM
// scratch.  Here blocks run in no order, so one thread owns one (b, d)
// channel for the whole sequence and the chunk axis becomes a loop: the
// state never leaves a register.
//
// Contract: all float32, row-major.  a/b [B, S, D], h0 [B, D]; any B, S, D.
//   h_t = a_t * h_{t-1} + b_t                               (per b, d)
// out: y [B, S, D] (every h_t), hT [B, D] (h after the last step; h0 when
// S = 0).  Each step rounds the product and then the sum (no FMA
// contraction), as the plain torch loop does, so the two agree bit for bit.
//
// Layout: kBlock = 32 threads per block, one warp on 32 consecutive d, so
// every load of a[b, t, :] and b[b, t, :] and every store of y is one
// 128-byte transaction; the grid is (ceil(D / 32), B), so the served shape
// (B = 1, D = 4096) spreads 128 warps over the 132 SMs instead of packing
// them into a few large blocks.  The loads do not depend on h, only the
// multiply-add chain does: the loop runs kUnroll steps at a time and
// issues the next group's 2 * kUnroll loads before it walks the current
// group's chain (registers double-buffered).
//
// Bound: bytes, (3*B*S*D + 2*B*D) * 4 at 3.35 TB/s; 2 flops per element.
// At the served shape only 4096 channels exist, one warp per SM, and the
// loads in flight (2 * kUnroll * 128 bytes per warp) are far fewer than
// the memory system needs to reach its rate, so this design sits well above
// its bound there.  A chunked three-pass scan (per-chunk products and local
// states, a carry across chunks, a fix-up) would fill the card; later work.
#include "common.cuh"

namespace repro {
namespace {

constexpr int kBlock = 32;
constexpr int kUnroll = 8;

__global__ void __launch_bounds__(kBlock) rg_lru_kernel(
    const float* __restrict__ a, const float* __restrict__ b,
    const float* __restrict__ h0, float* __restrict__ y,
    float* __restrict__ hT, int seq, int d) {
  const int ch = blockIdx.x * kBlock + threadIdx.x;
  if (ch >= d) return;
  const long long row = blockIdx.y;
  const long long stride = d;
  const long long off = row * seq * stride + ch;
  const float* ap = a + off;
  const float* bp = b + off;
  float* yp = y + off;
  float h = h0[row * stride + ch];

  const int full = seq / kUnroll * kUnroll;
  float ca[kUnroll], cb[kUnroll];
  if (full > 0) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      ca[u] = ap[u * stride];
      cb[u] = bp[u * stride];
    }
  }
  for (int t0 = 0; t0 < full; t0 += kUnroll) {
    float na[kUnroll], nb[kUnroll];
    const bool more = t0 + kUnroll < full;
    if (more) {
      const long long nxt = static_cast<long long>(t0 + kUnroll) * stride;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        na[u] = ap[nxt + u * stride];
        nb[u] = bp[nxt + u * stride];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      h = __fadd_rn(__fmul_rn(ca[u], h), cb[u]);
      yp[static_cast<long long>(t0 + u) * stride] = h;
    }
    if (more) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        ca[u] = na[u];
        cb[u] = nb[u];
      }
    }
  }
  for (int t = full; t < seq; ++t) {
    const long long at = static_cast<long long>(t) * stride;
    h = __fadd_rn(__fmul_rn(ap[at], h), bp[at]);
    yp[at] = h;
  }
  hT[row * stride + ch] = h;
}

}  // namespace
}  // namespace repro

// Entry point for ctypes.  Returns a cudaError_t code (0 = launched).
extern "C" int rg_lru_launch(const void* a, const void* b, const void* h0,
                             void* y, void* hT, int batch, int seq, int d,
                             void* stream) {
  if (batch > 65535 || seq < 0) return cudaErrorInvalidValue;
  if (batch <= 0 || d <= 0) return cudaSuccess;
  const dim3 grid((d + repro::kBlock - 1) / repro::kBlock, batch);
  repro::rg_lru_kernel<<<grid, repro::kBlock, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(h0), static_cast<float*>(y),
      static_cast<float*>(hT), seq, d);
  return cudaGetLastError();
}
