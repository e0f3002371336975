// segment_reduce — one SLTF reduce window (innermost ragged dimension) on
// Hopper, int32-exact, with the carried accumulator.
//
// Replaces the TPU kernel src/repro/kernels/segment_reduce.py::_segred_kernel
// (launched by segment_reduce_blocks, driven by ops._pallas_segred_add).  The
// TPU kernel sums one-hot segment matrices on the MXU in f32, so it covers
// add only, through 16-bit halves, at most 256 tokens per call, with the
// accumulator carried from grid step to grid step in VMEM.  Blocks of a GPU
// grid run in no order, so nothing is carried between them here: segment ids
// come from a global exclusive scan of the barrier mask, and per-segment
// values from int32 atomics, which are exact for every reduce op of the IR
// (add wraps mod 2^32; min, max, and, or, xor are order-free).
//
// Semantics (core/backend.py::segment_reduce_window_np, bit for bit): kinds
// [n] (0 = data, k > 0 = barrier Omega_k), vals [n] or null (no
// contributions).  Barrier j closes segment j; the tail after the last
// barrier is segment nbar.  Segment s starts from init once some earlier
// barrier has emitted, else from the carried acc.  Barrier j emits a data
// token carrying its segment's value iff it is Omega_1 or its segment is open
// (has data, or s == 0 and the incoming group is open), then Omega_{k-1} iff
// k > 1.  The new carry is (value, open) of segment nbar.
//
// Four launches on the caller's stream, no allocation; the slots are then
// packed by the stream_compact kernel (its own library):
//   1. prepare — barriers per tile; segment arrays to the op's identity;
//                first_emit to 0 (incoming group open) or INT_MAX;
//   2. scan    — exclusive scan of the barrier counts -> tile offsets, nbar;
//   3. scatter — segment id of every token (offset + ballot prefix); data
//                tokens fold their value into seg_val by atomic and mark
//                seg_has; barriers store their level in bar_kind; one
//                atomicMin per warp records the first segment that emits
//                (segment ids rise with the lane, so its first such lane);
//   4. emit    — per segment s <= nbar: its start, its value, its two slots
//                [data, lowered barrier] (keep flag + (kind, value) row), and
//                the carry from s == nbar.
//
// Bound: bytes.  The function must read kinds and vals (8n bytes) and write
// the m emitted (kind, value) pairs and the carry (8m + 8), so at 3.35 TB/s
// it needs at least (8n + 8m + 8) / 3.35e12 s.  This design also writes and
// reads three segment arrays and 2n slot rows, and serialises atomics on a
// long segment; a later version can reduce within warps first.
#include <limits.h>

#include "common.cuh"

namespace repro {

enum ReduceOp { kAdd = 0, kMin = 1, kMax = 2, kAnd = 3, kOr = 4, kXor = 5 };

__device__ __forceinline__ int reduce_identity(int op) {
  switch (op) {
    case kMin: return INT_MAX;
    case kMax: return INT_MIN;
    case kAnd: return -1;
    default: return 0;                          // add, or, xor
  }
}

__device__ __forceinline__ int reduce_combine(int op, int a, int b) {
  switch (op) {
    case kAdd: return static_cast<int>(static_cast<unsigned>(a) +
                                       static_cast<unsigned>(b));
    case kMin: return a < b ? a : b;
    case kMax: return a > b ? a : b;
    case kAnd: return a & b;
    case kOr: return a | b;
    default: return a ^ b;
  }
}

__device__ __forceinline__ void reduce_atomic(int op, int* p, int v) {
  switch (op) {
    case kAdd:
      atomicAdd(reinterpret_cast<unsigned*>(p), static_cast<unsigned>(v));
      break;
    case kMin: atomicMin(p, v); break;
    case kMax: atomicMax(p, v); break;
    case kAnd: atomicAnd(p, v); break;
    case kOr: atomicOr(p, v); break;
    default: atomicXor(p, v); break;
  }
}

static __global__ void segred_prepare_kernel(
    const int* __restrict__ kinds, long long n, int op, int group_open,
    int* __restrict__ tile_bars, int* __restrict__ seg_val,
    int* __restrict__ seg_has, int* __restrict__ first_emit) {
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  const int ident = reduce_identity(op);
  int c = 0;
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const long long i = base + it * kThreads + threadIdx.x;
    if (i < n) {
      seg_val[i] = ident;
      seg_has[i] = 0;
    }
    c += __syncthreads_count(i < n && kinds[i] > 0);
  }
  if (threadIdx.x == 0) {
    tile_bars[blockIdx.x] = c;
    if (blockIdx.x == 0) {                       // segment n, the last one
      seg_val[n] = ident;
      seg_has[n] = 0;
      *first_emit = group_open ? 0 : INT_MAX;
    }
  }
}

static __global__ void segred_scatter_kernel(
    const int* __restrict__ kinds, const int* __restrict__ vals, long long n,
    int op, const int* __restrict__ tile_offsets, int* __restrict__ seg_val,
    int* __restrict__ seg_has, int* __restrict__ bar_kind,
    int* __restrict__ first_emit) {
  __shared__ int warp_counts[kWarps];
  const int lane = threadIdx.x & 31;
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  int next = tile_offsets[blockIdx.x];         // barriers before this step
  for (int it = 0; it < kItems; ++it) {
    const long long i = base + it * kThreads + threadIdx.x;
    const int k = i < n ? kinds[i] : 0;
    const bool bar = i < n && k > 0;
    int step_bars;
    const int seg = next + step_prefix(bar, warp_counts, &step_bars);
    const bool data = i < n && k <= 0;
    if (data) {
      if (vals != nullptr) reduce_atomic(op, seg_val + seg, vals[i]);
      seg_has[seg] = 1;
    } else if (bar) {
      bar_kind[seg] = k;
    }
    // a segment with data emits at its barrier, and so does Omega_1
    const unsigned emits = __ballot_sync(kFull, data || (bar && k == 1));
    if (emits != 0u && lane == __ffs(emits) - 1) atomicMin(first_emit, seg);
    next += step_bars;
  }
}

static __global__ void segred_emit_kernel(
    long long n, int op, int init, int acc, int group_open,
    const int* __restrict__ nbar_ptr, const int* __restrict__ seg_val,
    const int* __restrict__ seg_has, const int* __restrict__ bar_kind,
    const int* __restrict__ first_emit, int* __restrict__ slot_keep,
    int* __restrict__ slot_rows, int* __restrict__ carry) {
  const long long s = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (s > n) return;
  const long long nbar = *nbar_ptr;
  int keep0 = 0, keep1 = 0, kind1 = 0, value = 0;
  if (s <= nbar) {
    const bool open = seg_has[s] != 0 || (s == 0 && group_open);
    const int start = *first_emit < s ? init : acc;
    value = reduce_combine(op, start, seg_val[s]);
    if (s == nbar) {
      carry[0] = value;
      carry[1] = open ? 1 : 0;
    } else {
      const int bk = bar_kind[s];
      keep0 = (bk == 1 || open) ? 1 : 0;
      keep1 = bk > 1 ? 1 : 0;
      kind1 = bk - 1;
    }
  }
  if (s < n) {                                 // slots 2s and 2s + 1
    slot_keep[2 * s] = keep0;
    slot_keep[2 * s + 1] = keep1;
    slot_rows[4 * s + 0] = 0;                  // data token: kind 0
    slot_rows[4 * s + 1] = keep0 ? value : 0;
    slot_rows[4 * s + 2] = keep1 ? kind1 : 0;  // lowered barrier, value 0
    slot_rows[4 * s + 3] = 0;
  }
}

}  // namespace repro

extern "C" int segment_reduce_tile_rows() { return repro::kTile; }

// Scratch, all int32: tile_bars [tiles_for(n)], seg_val/seg_has/bar_kind
// [n + 1], nbar [1], first_emit [1].  Outputs: slot_keep [2n],
// slot_rows [2n, 2], carry [2] (value, open).  vals may be null.
extern "C" int segment_reduce_launch(
    const void* kinds, const void* vals, long long n, int op, int init,
    int acc, int group_open, void* tile_bars, void* seg_val, void* seg_has,
    void* bar_kind, void* nbar, void* first_emit, void* slot_keep,
    void* slot_rows, void* carry, void* stream) {
  using namespace repro;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = tiles_for(n);
  segred_prepare_kernel<<<nb, kThreads, 0, s>>>(
      static_cast<const int*>(kinds), n, op, group_open,
      static_cast<int*>(tile_bars), static_cast<int*>(seg_val),
      static_cast<int*>(seg_has), static_cast<int*>(first_emit));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  exclusive_scan_kernel<<<1, kScanThreads, 0, s>>>(
      static_cast<int*>(tile_bars), nb, static_cast<int*>(nbar));
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  segred_scatter_kernel<<<nb, kThreads, 0, s>>>(
      static_cast<const int*>(kinds), static_cast<const int*>(vals), n, op,
      static_cast<const int*>(tile_bars), static_cast<int*>(seg_val),
      static_cast<int*>(seg_has), static_cast<int*>(bar_kind),
      static_cast<int*>(first_emit));
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long segs = n + 1;
  const int eb = static_cast<int>((segs + kThreads - 1) / kThreads);
  segred_emit_kernel<<<eb, kThreads, 0, s>>>(
      n, op, init, acc, group_open, static_cast<const int*>(nbar),
      static_cast<const int*>(seg_val), static_cast<const int*>(seg_has),
      static_cast<const int*>(bar_kind), static_cast<const int*>(first_emit),
      static_cast<int*>(slot_keep), static_cast<int*>(slot_rows),
      static_cast<int*>(carry));
  return cudaGetLastError();
}
