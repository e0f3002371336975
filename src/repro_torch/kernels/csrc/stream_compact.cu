// stream_compact — stable stream compaction of int32 rows on Hopper, in one
// launch.
//
// Replaces the TPU kernel src/repro/kernels/stream_compact.py::_compact_kernel
// (launched by compact_blocks, assembled across blocks by ops._assemble).
// The TPU kernel builds a one-hot matrix per 256-row block and gathers with
// an f32 matmul on the MXU, splitting int32 payloads into two 16-bit halves.
// None of that carries over: here the rows stay int32 and move by a gather
// through shared memory, and there is no block cap.
//
// Contract: mask [n] int32, vals [n, d] int32 row-major.  out is n*d + 1
// ints: the rows whose mask is nonzero, in input order, then zeros, as
// n*d values, then their count.  The VM's window compaction rides its kinds
// column as column 0 of vals, so one call compacts kinds and payload.
//
// A tile is kTile = 4096 rows, 16 consecutive rows a thread: the mask (and,
// where d == 1, the values) comes in as four 16-byte loads a thread, a
// thread's kept rows are a bit mask, their ranks a warp shuffle scan and a
// block scan of the per-warp counts.  Each kept row goes to shared memory
// at its rank: its value where d == 1, else its tile-local index; the
// block then writes its output rows in order, so the stores are coalesced
// and, for d > 1, only the reads of vals gather.
//
// n <= kTile (every window of the apps, VLEN 128): one block, one tile, no
// scratch, no memset, one kernel.
//
// n > kTile: a single pass with a decoupled look-back (Merrill & Garland,
// "Single-pass Parallel Prefix Scan with Decoupled Look-back", 2016).  A
// block takes its next tile from an atomicAdd on a counter, never from
// blockIdx, so a tile waits only on tiles that some running block already
// holds, and the grid (at most the blocks that fit on the card at once)
// loops until the tiles run out.  Per tile: count the kept rows, publish
// the count as the tile's aggregate, then warp 0 looks back over the
// predecessors 32 at a time (an aggregate adds on, the nearest inclusive
// prefix ends the walk), publishes the tile's inclusive prefix and the
// block writes its rows.  Status and count share one 64-bit word (status
// in bits 32-33: 1 aggregate, 2 inclusive; the count in bits 0-31), so one
// store and one load, each single-copy atomic, and nothing else needs
// ordering: relaxed at GPU scope.  The words and the counter are zeroed by
// one cudaMemsetAsync on the caller's stream before the launch: a CUDA
// graph that captured the call replays the memset too, so no replay reads
// the last one's flags.
//
// Rows past the count, without waiting for the count: after tile t
// (rows [b, e), prefix p, kept c) the count is at most u_t = p + c + n - e,
// and u_(t-1) = p + n - b, so u falls tile by tile from n to the count.
// Tile t zeroes output rows [u_t, u_(t-1)), as many as it dropped, right
// after its look-back; the tiles' ranges tile [count, n) exactly, with no
// wait at the end and no memset of the output (which would write every
// kept row twice: chip_smoke.py times that memset at 2^24 rows,
// "zero_fill_ms").
//
// Bound: bytes.  The function must read mask (4n bytes) and vals (4nd) and
// write out (4nd + 4), so at 3.35 TB/s it needs at least 4n(1 + 2d) /
// 3.35e12 s; it does a handful of integer operations per row.  This design
// reads the mask once and vals once and writes each output value once; it
// also writes and reads an 8-byte status word per tile (0.01% of the bytes
// at d = 1).
#include "common.cuh"

namespace repro {

constexpr int kTile = kScanTile;
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kInclusive = 2ull << 32;

__device__ __forceinline__ int status_of(unsigned long long w) {
  return static_cast<int>(w >> 32);
}

// Rank a thread's kept rows (bit i of ``keep``: tile-local row
// threadIdx.x * kScanItems + i): the rank of its first kept row in the tile,
// and the tile's kept count.  Every thread of the block calls it.
__device__ __forceinline__ void rank_rows(unsigned keep, int* warp_tot,
                                          int* rank, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = __popc(keep);
  int x = c;                                     // inclusive scan in the warp
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  int before = x - c, all = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int t = warp_tot[w];
    before += w < warp ? t : 0;
    all += t;
  }
  *rank = before;
  *total = all;
}

// Write the tile's cnt kept rows to output rows [prefix, prefix + cnt) in
// output order, so the stores coalesce.  stage holds, by rank, the kept
// values themselves (kRow1: d == 1) or their tile-local rows.
template <bool kRow1>
__device__ __forceinline__ void copy_rows(const int* __restrict__ vals,
                                          int d, long long base,
                                          long long prefix, int cnt,
                                          const int* stage,
                                          int* __restrict__ out) {
  if (kRow1) {
    for (int r = threadIdx.x; r < cnt; r += kThreads)
      out[prefix + r] = stage[r];
  } else if (d <= 32) {                          // cnt * d < 2^31
    int* dst = out + prefix * d;
    for (int e = threadIdx.x; e < cnt * d; e += kThreads) {
      const int r = e / d, c = e - r * d;
      dst[e] = __ldg(vals + (base + stage[r]) * d + c);
    }
  } else {
    for (int r = 0; r < cnt; ++r) {
      const int* s = vals + (base + stage[r]) * d;
      int* dst = out + (prefix + r) * d;
      for (int c = threadIdx.x; c < d; c += kThreads) dst[c] = __ldg(s + c);
    }
  }
}

// Warp 0 of tile t > 0's block: publish the tile's count, look back over
// its predecessors 32 at a time (lane l reads tile j - l), publish its
// inclusive prefix.  Returns the rows kept before the tile.
__device__ __forceinline__ int look_back(unsigned long long* status, int t,
                                         int cnt) {
  const int lane = threadIdx.x & 31;
  if (lane == 0) store_relaxed(status + t, kAggregate | unsigned(cnt));
  int prefix = 0;
  for (int j = t - 1;; j -= 32) {
    const int i = j - lane;
    unsigned long long w;
    do {                                         // tile 0 is inclusive, so
      w = i >= 0 ? load_relaxed(status + i) : kInclusive;   // i < 0 lanes
    } while (__any_sync(kFull, status_of(w) == 0));         // are past it
    const unsigned inc = __ballot_sync(kFull, status_of(w) == 2);
    const int stop = inc ? __ffs(inc) - 1 : 31;  // nearest inclusive lane
    prefix += __reduce_add_sync(
        kFull, lane <= stop ? static_cast<int>(static_cast<unsigned>(w)) : 0);
    if (inc) break;
  }
  if (lane == 0)
    store_relaxed(status + t, kInclusive | unsigned(prefix + cnt));
  return prefix;
}

template <bool kOneTile, bool kRow1>
static __global__ void __launch_bounds__(kThreads) compact_kernel(
    const int* __restrict__ mask, const int* __restrict__ vals, long long n,
    int d, bool vec, int* __restrict__ out,
    unsigned long long* __restrict__ status, unsigned* __restrict__ next,
    int n_tiles) {
  __shared__ int stage[kTile];
  __shared__ int warp_tot[kWarps];
  __shared__ int s_tile, s_prefix;
  const int local0 = threadIdx.x * kScanItems;
  for (;;) {
    int t = 0;
    if (!kOneTile) {
      if (threadIdx.x == 0) s_tile = static_cast<int>(atomicAdd(next, 1u));
      __syncthreads();
      t = s_tile;
      if (t >= n_tiles) return;
    }
    const long long base = static_cast<long long>(t) * kTile;
    const long long end = base + kTile < n ? base + kTile : n;
    unsigned keep = 0;                           // bit i: row local0 + i
    int x[kScanItems];
#pragma unroll
    for (int q = 0; q < kScanItems / 4; ++q) {
      const int4 m = load4(mask, base + local0 + 4 * q, n, vec);
      keep |= (m.x != 0 ? 1u : 0u) << (4 * q);
      keep |= (m.y != 0 ? 2u : 0u) << (4 * q);
      keep |= (m.z != 0 ? 4u : 0u) << (4 * q);
      keep |= (m.w != 0 ? 8u : 0u) << (4 * q);
      if (kRow1) {                               // the values come with the
        const int4 v = load4(vals, base + local0 + 4 * q, n, vec);   // mask
        x[4 * q] = v.x, x[4 * q + 1] = v.y, x[4 * q + 2] = v.z;
        x[4 * q + 3] = v.w;
      }
    }
    int rank, cnt;
    rank_rows(keep, warp_tot, &rank, &cnt);
#pragma unroll
    for (int i = 0; i < kScanItems; ++i)
      if ((keep >> i) & 1u) stage[rank++] = kRow1 ? x[i] : local0 + i;
    if (threadIdx.x < 32) {
      int prefix = 0;
      if (!kOneTile) {
        if (t > 0)
          prefix = look_back(status, t, cnt);
        else if (threadIdx.x == 0)
          store_relaxed(status, kInclusive | unsigned(cnt));
      }
      if (threadIdx.x == 0) {
        s_prefix = prefix;
        if (t == n_tiles - 1) out[n * d] = prefix + cnt;
      }
    }
    __syncthreads();                             // stage, s_prefix are out
    const int prefix = s_prefix;
    copy_rows<kRow1>(vals, d, base, prefix, cnt, stage, out);
    // the tile's share of the rows past the count: as many as it dropped
    zero_fill(out, (prefix + cnt + n - end) * d, (prefix + n - base) * d,
              threadIdx.x, kThreads);
    if (kOneTile) return;
    __syncthreads();                   // stage, warp_tot, s_tile, s_prefix
  }
}

template <bool kRow1>
cudaError_t launch(const int* mask, const int* vals, int* out, long long n,
                   int d, void* scratch, cudaStream_t s) {
  const bool vec = (reinterpret_cast<uintptr_t>(mask) & 15) == 0 &&
                   (!kRow1 || (reinterpret_cast<uintptr_t>(vals) & 15) == 0);
  if (n <= kTile) {
    compact_kernel<true, kRow1><<<1, kThreads, 0, s>>>(
        mask, vals, n, d, vec, out, nullptr, nullptr, 1);
    return cudaGetLastError();
  }
  const int n_tiles = static_cast<int>((n + kTile - 1) / kTile);
  auto* status = static_cast<unsigned long long*>(scratch);
  cudaError_t e = cudaMemsetAsync(
      scratch, 0, (n_tiles + 1) * sizeof(unsigned long long), s);
  if (e != cudaSuccess) return e;
  static int fits[64];
  const int fit = resident_blocks(
      reinterpret_cast<const void*>(compact_kernel<false, kRow1>), fits);
  if (fit <= 0) {
    e = cudaGetLastError();
    return e != cudaSuccess ? e : cudaErrorInvalidConfiguration;
  }
  const int grid = n_tiles < fit ? n_tiles : fit;
  compact_kernel<false, kRow1><<<grid, kThreads, 0, s>>>(
      mask, vals, n, d, vec, out, status,
      reinterpret_cast<unsigned*>(status + n_tiles), n_tiles);
  return cudaGetLastError();
}

}  // namespace repro

extern "C" int stream_compact_tile_rows() { return repro::kTile; }

// out: n*d + 1 ints.  scratch: ceil(n / kTile) + 1 u64 (tile status words,
// then the tile counter) when n > kTile, else unused (may be null).
// Returns cudaGetLastError() after the launch.
extern "C" int stream_compact_launch(const void* mask, const void* vals,
                                     void* out, long long n, int d,
                                     void* scratch, void* stream) {
  using namespace repro;
  const int* m = static_cast<const int*>(mask);
  const int* v = static_cast<const int*>(vals);
  int* o = static_cast<int*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return d == 1 ? launch<true>(m, v, o, n, d, scratch, s)
                : launch<false>(m, v, o, n, d, scratch, s);
}
