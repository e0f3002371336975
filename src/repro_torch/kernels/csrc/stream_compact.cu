// stream_compact — stable stream compaction of int32 rows on Hopper.
//
// Replaces the TPU kernel src/repro/kernels/stream_compact.py::_compact_kernel
// (launched by compact_blocks, assembled across blocks by ops._assemble).
// The TPU kernel builds a one-hot matrix per 256-row block and gathers with
// an f32 matmul on the MXU, splitting int32 payloads into two 16-bit halves.
// None of that carries over: here the rows stay int32 and move by a direct
// scatter, and there is no block cap.
//
// Contract: mask [n] int32, vals [n, d] int32 row-major.  out [n, d] holds
// the rows whose mask is nonzero, in input order, then zeros; *count is
// their number.  The VM's window compaction rides its kinds column as
// column 0 of vals, so one call compacts kinds and payload together.
//
// Three launches on the caller's stream, no allocation:
//   1. count   — survivors per tile of kTile rows (__syncthreads_count);
//   2. scan    — exclusive scan of the tile counts (one block); the total
//                goes to count;
//   3. scatter — each tile recomputes its local prefix (warp ballot/popc)
//                and writes its kept rows to offset + local; the tile that
//                owns output row j >= count zeroes it.
//
// Bound: bytes.  The function must read mask (4n bytes) and vals (4nd) and
// write out (4nd), so at 3.35 TB/s it needs at least 4n(1 + 2d) / 3.35e12 s;
// it does a handful of integer operations per row.  This design reads the
// mask twice (count and scatter) and the tile counts twice; a later version
// can fuse the passes with a decoupled look-back.
#include "common.cuh"

namespace repro {

static __global__ void compact_count_kernel(const int* __restrict__ mask,
                                            long long n,
                                            int* __restrict__ tile_counts) {
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  int c = 0;
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const long long i = base + it * kThreads + threadIdx.x;
    c += __syncthreads_count(i < n && mask[i] != 0);
  }
  if (threadIdx.x == 0) tile_counts[blockIdx.x] = c;
}

static __global__ void compact_scatter_kernel(
    const int* __restrict__ mask, const int* __restrict__ vals, long long n,
    int d, const int* __restrict__ tile_offsets,
    const int* __restrict__ count, int* __restrict__ out) {
  __shared__ int warp_counts[kWarps];
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  const long long total = *count;
  long long next = tile_offsets[blockIdx.x];   // output row of next survivor
  for (int it = 0; it < kItems; ++it) {
    const long long i = base + it * kThreads + threadIdx.x;
    const bool keep = i < n && mask[i] != 0;
    int step_total;
    const int local = step_prefix(keep, warp_counts, &step_total);
    if (keep) {
      const long long row = next + local;
      const int* src = vals + i * d;
      int* dst = out + row * d;
      for (int c = 0; c < d; ++c) dst[c] = src[c];
    }
    if (i < n && i >= total) {                 // rows past the count are 0
      int* dst = out + i * d;
      for (int c = 0; c < d; ++c) dst[c] = 0;
    }
    next += step_total;
  }
}

}  // namespace repro

extern "C" int stream_compact_tile_rows() { return repro::kTile; }

// scratch: tiles_for(n) ints.  Returns cudaGetLastError() after the launches.
extern "C" int stream_compact_launch(const void* mask, const void* vals,
                                     void* out, void* count, void* scratch,
                                     long long n, int d, void* stream) {
  using namespace repro;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = tiles_for(n);
  int* tiles = static_cast<int*>(scratch);
  compact_count_kernel<<<nb, kThreads, 0, s>>>(
      static_cast<const int*>(mask), n, tiles);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  exclusive_scan_kernel<<<1, kScanThreads, 0, s>>>(tiles, nb,
                                                   static_cast<int*>(count));
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  compact_scatter_kernel<<<nb, kThreads, 0, s>>>(
      static_cast<const int*>(mask), static_cast<const int*>(vals), n, d,
      tiles, static_cast<const int*>(count), static_cast<int*>(out));
  return cudaGetLastError();
}
