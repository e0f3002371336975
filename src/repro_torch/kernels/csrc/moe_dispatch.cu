// moe_dispatch — MoE token dispatch into expert-capacity slots, on Hopper.
//
// Replaces the TPU kernel src/repro/kernels/moe_dispatch.py::_dispatch_kernel
// (launched by moe_dispatch, wrapped by ops.moe_dispatch_combine(impl=
// "pallas")).  That kernel builds, per (expert, block of 256 rows), a
// one-hot [C, 256] matrix of "row a goes to slot c" and multiplies it into
// the rows on the MXU with a float32 accumulator: a gather written as a
// matmul so that it runs on the TPU's matrix unit.  On Hopper a kept
// (expert, position) slot has exactly one writer, so the dispatch is a copy
// of rows: no matmul, no accumulator, no atomics, and the result is the
// rows' bits.
//
// Contract: tokens [A, D] (row_bytes = D * element size), expert/pos [A]
// int32, out [E, C, D], all contiguous.  Row a is kept when 0 <= expert[a]
// < E and 0 <= pos[a] < C; it lands in out[expert[a], pos[a], :].  Every
// other slot is zero.  Kept (expert, pos) pairs must be unique (the
// positions of ops.moe_dispatch_combine come from one cumsum, so they are).
// Any A, D, E, C.
//
// Three steps on the caller's stream, one entry point:
//  1. memset the [E*C] int32 slot map to -1;
//  2. moe_dispatch_slot_map_kernel: one thread per row writes a into
//     map[e * C + pos] for each kept row;
//  3. moe_dispatch_fill_kernel: one warp per slot copies its row (or writes
//     zeros), 16 bytes a lane when rows and pointers allow, else 4 or 2.
// So every byte of out is written exactly once and every kept row is read
// exactly once; the dropped rows are never read.
//
// Bound: bytes, kept_rows * row_bytes read + E * C * row_bytes written (plus
// 8 bytes of index per row and 4 of map per slot) at 3.35 TB/s.  One warp
// per slot row gives E*C warps (5120 at olmoe's 512-token prefill, more than
// the card holds at once), each lane with up to 4 independent 16-byte loads
// in flight.
#include "common.cuh"

namespace repro {
namespace {

constexpr int kFillThreads = 256;                 // 8 warps, 8 slots a block
constexpr int kRowsPerBlock = kFillThreads / 32;

__global__ void moe_dispatch_slot_map_kernel(
    const int* __restrict__ expert, const int* __restrict__ pos, int rows,
    int n_experts, int capacity, int* __restrict__ map) {
  const int a = blockIdx.x * blockDim.x + threadIdx.x;
  if (a >= rows) return;
  const int e = expert[a], p = pos[a];
  if (e >= 0 && e < n_experts && p >= 0 && p < capacity)
    map[static_cast<long long>(e) * capacity + p] = a;
}

// Unit: the copy word (uint4, unsigned, unsigned short); words = row_bytes /
// sizeof(Unit).  The loop unrolls by 4 so that a lane has up to 4 loads in
// flight before its first store.
template <typename Unit>
__global__ void __launch_bounds__(kFillThreads) moe_dispatch_fill_kernel(
    const Unit* __restrict__ tokens, const int* __restrict__ map,
    long long slots, long long words, Unit* __restrict__ out) {
  const long long slot = static_cast<long long>(blockIdx.x) * kRowsPerBlock
                         + (threadIdx.x >> 5);
  if (slot >= slots) return;
  const int lane = threadIdx.x & 31;
  const int src = map[slot];
  Unit* dst = out + slot * words;
  if (src < 0) {
    const Unit zero{};
    for (long long w = lane; w < words; w += 32) dst[w] = zero;
    return;
  }
  const Unit* row = tokens + static_cast<long long>(src) * words;
  long long w = lane;
  for (; w + 3 * 32 < words; w += 4 * 32) {
    const Unit v0 = row[w], v1 = row[w + 32], v2 = row[w + 64],
               v3 = row[w + 96];
    dst[w] = v0;
    dst[w + 32] = v1;
    dst[w + 64] = v2;
    dst[w + 96] = v3;
  }
  for (; w < words; w += 32) dst[w] = row[w];
}

template <typename Unit>
cudaError_t launch_fill(const void* tokens, const int* map, long long slots,
                        long long row_bytes, void* out, cudaStream_t st) {
  const long long blocks = (slots + kRowsPerBlock - 1) / kRowsPerBlock;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  moe_dispatch_fill_kernel<Unit>
      <<<static_cast<unsigned>(blocks), kFillThreads, 0, st>>>(
          static_cast<const Unit*>(tokens), map, slots,
          row_bytes / static_cast<long long>(sizeof(Unit)),
          static_cast<Unit*>(out));
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// Entry point for ctypes.  ``map`` is caller-allocated scratch of E*C
// int32.  Returns a cudaError_t code (0 = launched).
extern "C" int moe_dispatch_launch(const void* tokens, const void* expert,
                                   const void* pos, void* map, void* out,
                                   int rows, long long row_bytes,
                                   int n_experts, int capacity,
                                   void* stream) {
  if (rows < 0 || row_bytes < 0 || n_experts < 0 || capacity < 0 ||
      row_bytes % 2)
    return cudaErrorInvalidValue;
  const long long slots = static_cast<long long>(n_experts) * capacity;
  if (slots == 0 || row_bytes == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(map, 0xff, slots * sizeof(int), st);
  if (err != cudaSuccess) return err;
  if (rows > 0) {
    const int blocks = (rows + repro::kThreads - 1) / repro::kThreads;
    repro::moe_dispatch_slot_map_kernel<<<blocks, repro::kThreads, 0, st>>>(
        static_cast<const int*>(expert), static_cast<const int*>(pos), rows,
        n_experts, capacity, static_cast<int*>(map));
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const uintptr_t align = reinterpret_cast<uintptr_t>(tokens) |
                          reinterpret_cast<uintptr_t>(out);
  const int* m = static_cast<const int*>(map);
  if (row_bytes % 16 == 0 && align % 16 == 0)
    return repro::launch_fill<uint4>(tokens, m, slots, row_bytes, out, st);
  if (row_bytes % 4 == 0 && align % 4 == 0)
    return repro::launch_fill<unsigned>(tokens, m, slots, row_bytes, out, st);
  return repro::launch_fill<unsigned short>(tokens, m, slots, row_bytes, out,
                                            st);
}
