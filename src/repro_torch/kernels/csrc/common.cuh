// Shared pieces of the hand-written Hopper kernels: tile geometry, the
// in-order local prefix of a per-row flag, and the single-block exclusive
// scan that turns per-tile counts into per-tile output offsets.
//
// Every kernel of this package walks its rows in tiles of kTile rows: a
// block of kThreads threads takes kItems rows per thread, one row per thread
// per step, so neighbouring threads touch neighbouring rows.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

constexpr int kThreads = 256;              // threads per block
constexpr int kItems = 4;                  // steps per tile
constexpr int kTile = kThreads * kItems;   // rows per tile
constexpr int kWarps = kThreads / 32;
constexpr int kScanThreads = 1024;         // 32 warps: one warp scans them
constexpr unsigned kFull = 0xffffffffu;

inline int tiles_for(long long n) {
  return n > 0 ? static_cast<int>((n + kTile - 1) / kTile) : 1;
}

// For one step of a tile: how many rows of this block before the calling
// thread have ``flag`` set (stable order: warp, then lane), and how many
// rows of the whole step have it.  ``warp_counts`` is kWarps ints of shared
// memory; every thread of the block must call this.
__device__ __forceinline__ int step_prefix(bool flag, int* warp_counts,
                                           int* step_total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned ballot = __ballot_sync(kFull, flag);
  if (lane == 0) warp_counts[warp] = __popc(ballot);
  __syncthreads();
  int before = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int c = warp_counts[w];
    before += w < warp ? c : 0;
    total += c;
  }
  __syncthreads();   // warp_counts is rewritten by the next step
  *step_total = total;
  return before + __popc(ballot & ((1u << lane) - 1u));
}

// Exclusive scan of counts[0, nb) in place, by one block of kScanThreads
// threads walking the array in chunks; the grand total goes to *total.
static __global__ void exclusive_scan_kernel(int* __restrict__ counts, int nb,
                                             int* __restrict__ total) {
  __shared__ int warp_sums[kScanThreads / 32];
  __shared__ int carry;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) carry = 0;
  __syncthreads();
  for (int base = 0; base < nb; base += kScanThreads) {
    const int i = base + tid;
    const int v = i < nb ? counts[i] : 0;
    int x = v;                                   // inclusive scan in the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) {                             // scan the 32 warp sums
      int w = warp_sums[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, w, o);
        if (lane >= o) w += y;
      }
      warp_sums[lane] = w;
    }
    __syncthreads();
    const int before = carry + (warp ? warp_sums[warp - 1] : 0) + x - v;
    if (i < nb) counts[i] = before;
    __syncthreads();                             // everyone has read carry
    if (tid == kScanThreads - 1) carry = before + v;
    __syncthreads();
  }
  if (tid == 0) *total = carry;
}

}  // namespace repro

// Error text for a code returned by an entry point (ctypes cannot reach
// the runtime's own function without linking to it).
extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
