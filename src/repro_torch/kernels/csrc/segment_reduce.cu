// segment_reduce — one SLTF reduce window (innermost ragged dimension) on
// Hopper, int32-exact, with the carried accumulator, in one launch.
//
// Replaces the TPU kernel src/repro/kernels/segment_reduce.py::_segred_kernel
// (launched by segment_reduce_blocks, driven by ops._pallas_segred_add).  The
// TPU kernel sums one-hot segment matrices on the MXU in f32, so it covers
// add only, through 16-bit halves, at most 256 tokens per call, with the
// accumulator carried from grid step to grid step in VMEM.  Here every op
// of the IR runs in int32 (add wraps mod 2^32), there is no cap, and the
// carry crosses tiles by a decoupled look-back instead of a sequential grid.
//
// Semantics (core/backend.py::segment_reduce_window_np, bit for bit): kinds
// [n] (k > 0 = barrier Omega_k, else data), vals [n] or null (no
// contributions).  As a sequential machine over a state (v, o, slots): a
// data token folds its value into v and sets o; a barrier Omega_k emits a
// data token (0, v) if k == 1 or o, then the lowered barrier (k - 1, 0) if
// k > 1, each at the next slot; an emitting barrier resets v to init; o
// clears.  The window starts from (acc, group_open, 0); its carry is the
// final (v, o) and its count the final slots.
//
// Output: one int32 buffer of 4n + 3: out_kinds [2n], out_vals [2n] (the
// emitted tokens, then zeros), count, carry (v, o).  Each emitted token is
// written once, straight to its final slot: the compaction is fused, and no
// value is combined by an atomic.
//
// The algebra.  An aggregate summarises a run of tokens as a function of
// the state in front of it, in three words (a, cnt, f), f holding bits
//   HB (1)  the run holds a barrier;
//   D  (2)  its first barrier's data emission depends on the incoming o
//           (that barrier is Omega_k>1 with no data before it in the run):
//           the run emits cnt slots if o is clear, cnt + 1 if set;
//   EI (4)  some barrier of the run emits a data token whatever the
//           incoming state (an Omega_1, data before the first barrier, or
//           a later barrier closing a segment with data);
//   H  (8)  the run's tail (after its last barrier, or all of it if none)
//           holds data;
// and a, the fold of the tail's values from the op's identity.  A data
// token x is (x, 0, H); a barrier Omega_k is (identity, 1, HB | (k > 1 ? D
// : 0) | (k == 1 ? EI : 0)).
// Applying G to a state S = (v, o, slots):
//   G has HB: slots += cnt + (o && D); v = ((EI || o) ? init : v) (+) a;
//             o = H                       (a segment after an emitting
//                                          barrier starts from init; with
//                                          no emission the carry flows on)
//   else:     v = v (+) a; o = o || H.
// Composing A then B (associative; the CPU tests check it):
//   B has HB: cnt = A.cnt + B.cnt + (A.H && B.D); D = A.HB ? A.D : (A.H ? 0 :
//             B.D); EI = A.EI || B.EI || A.H; H = B.H; a = B.a; HB set
//   else:     cnt, D, EI, HB of A; H = A.H || B.H; a = A.a (+) B.a.
// (+) is exact in int32 for all six ops and their identities (0, INT_MAX,
// INT_MIN, -1, 0, 0).  The state that picks init or acc as a segment's
// start is v itself: a barrier that does not emit follows an empty segment,
// so v still holds whatever the last emission (or the window's acc) left.
//
// Within a tile (kTile = 4096 tokens, 16 consecutive a thread, loaded as
// 16-byte vectors): each thread composes its 16 tokens (in selects, not
// branches: neighbouring lanes hold different kinds of token), a warp
// shuffle scan and one over the 8 warp totals give each thread its
// exclusive aggregate; the tile's exclusive state, applied through it,
// starts a thread's walk over its tokens, which emits each token's slots
// as the sequential machine does.  Emitted tokens land in shared memory at
// their tile-local slot and leave in order, coalesced, in chunks of 4096
// slots (a tile emits up to 8192).
//
// n <= kTile (every window of the apps): one block, one tile, no scratch,
// no memset, one kernel.
//
// n > kTile: a single pass with a decoupled look-back (Merrill & Garland,
// 2016).  A block takes its next tile from an atomicAdd on a counter, so a
// tile waits only on tiles that a running block holds, and the grid (at
// most the blocks that fit on the card at once) loops until the tiles run
// out.  A tile publishes its aggregate, looks back (the whole block, 256
// tiles a step, a thread each, composing aggregates until the nearest
// inclusive state; at 2^20 tokens this beat a walk of one warp, 32 tiles
// a step, which stream_compact keeps: its step is a sum, not seven
// shuffled compositions), publishes its inclusive state (v, o, slots),
// then emits: no tile waits for its predecessor's emission.  The status
// word is 64 bits: status in bits 32-33 (1 aggregate, 2 inclusive), the
// flags f (or o, as H) in bits 34-37, cnt (or slots) in bits 0-31.  The
// value word (a, or v) does not fit, so each tile has two, one per status,
// each written once before its status word goes out with st.release; a
// reader loads the value only after an ld.acquire of the status showed
// it.  Words and counter are zeroed by one cudaMemsetAsync on the caller's
// stream before the launch, so a replayed CUDA graph resets them too.  The
// block of the last tile writes count and carry.
//
// Slots past the count, without waiting for the count: after tile t
// (tokens [b, e), slots s before it, s' after it) the count is at most
// u_t = s' + 2(n - e), two slots a token to come, and u_(t-1) = s + 2(n - b),
// so u falls tile by tile from 2n to the count.  Tile t zeroes slots
// [u_t, u_(t-1)) of both arrays right after its look-back; the tiles'
// ranges tile [count, 2n) exactly, with no wait at the end and no memset
// of the output.
//
// Bound: bytes.  The function must read kinds and vals (8n bytes) and write
// its whole output, the m emitted (kind, value) pairs and the zeros past
// them (16n + 12 bytes), so at 3.35 TB/s it needs at least (24n + 12) /
// 3.35e12 s.  This design reads each input once and writes each output
// word once, plus 16 bytes of status per tile.
#include <limits.h>

#include "common.cuh"

namespace repro {

constexpr int kTile = kScanTile;
constexpr int kStage = 4096;                     // emitted slots per chunk
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kInclusive = 2ull << 32;
constexpr int kHB = 1, kD = 2, kEI = 4, kH = 8;

enum ReduceOp { kAdd = 0, kMin = 1, kMax = 2, kAnd = 3, kOr = 4, kXor = 5 };

template <int Op>
__device__ __forceinline__ int identity() {
  return Op == kMin ? INT_MAX : Op == kMax ? INT_MIN : Op == kAnd ? -1 : 0;
}

template <int Op>
__device__ __forceinline__ int combine(int a, int b) {
  if (Op == kAdd)
    return static_cast<int>(static_cast<unsigned>(a) +
                            static_cast<unsigned>(b));
  if (Op == kMin) return a < b ? a : b;
  if (Op == kMax) return a > b ? a : b;
  if (Op == kAnd) return a & b;
  if (Op == kOr) return a | b;
  return a ^ b;
}

struct Agg {
  int a, cnt, f;
};

struct State {
  int v, o, slots;
};

template <int Op>
__device__ __forceinline__ Agg ident_agg() {
  return Agg{identity<Op>(), 0, 0};
}

// A then B
template <int Op>
__device__ __forceinline__ Agg compose(const Agg& A, const Agg& B) {
  if (B.f & kHB) {
    const int d = (A.f & kHB) ? (A.f & kD) : ((A.f & kH) ? 0 : (B.f & kD));
    const int ei = ((A.f | B.f) & kEI) || (A.f & kH) ? kEI : 0;
    return Agg{B.a, A.cnt + B.cnt + ((A.f & kH) && (B.f & kD) ? 1 : 0),
               kHB | d | ei | (B.f & kH)};
  }
  return Agg{combine<Op>(A.a, B.a), A.cnt,
             (A.f & (kHB | kD | kEI)) | ((A.f | B.f) & kH)};
}

template <int Op>
__device__ __forceinline__ State apply(const Agg& g, State s, int init) {
  if (g.f & kHB) {
    s.slots += g.cnt + (s.o && (g.f & kD) ? 1 : 0);
    s.v = combine<Op>((g.f & kEI) || s.o ? init : s.v, g.a);
    s.o = (g.f & kH) ? 1 : 0;
  } else {
    s.v = combine<Op>(s.v, g.a);
    s.o = s.o || (g.f & kH) ? 1 : 0;
  }
  return s;
}

__device__ __forceinline__ Agg shfl_up(const Agg& x, int o) {
  return Agg{__shfl_up_sync(kFull, x.a, o), __shfl_up_sync(kFull, x.cnt, o),
             __shfl_up_sync(kFull, x.f, o)};
}

__device__ __forceinline__ Agg shfl_down(const Agg& x, int o) {
  return Agg{__shfl_down_sync(kFull, x.a, o),
             __shfl_down_sync(kFull, x.cnt, o),
             __shfl_down_sync(kFull, x.f, o)};
}

__device__ __forceinline__ unsigned long long word(unsigned long long status,
                                                   int flags, int count) {
  return status | (static_cast<unsigned long long>(flags) << 34) |
         static_cast<unsigned>(count);
}

__device__ __forceinline__ int status_of(unsigned long long w) {
  return static_cast<int>((w >> 32) & 3);
}

// One warp's share of a look-back step: its nearest inclusive lane (32:
// none), the composite of its lanes before that one, and that lane's state.
struct Part {
  int stop;
  Agg run;
  State inc;
};

// The whole block of tile t > 0, after the tile's aggregate is out: look
// back over its predecessors kThreads at a time (thread i reads tile
// j - i) until the nearest inclusive state, and return the state in front
// of the tile.  ``part`` holds each warp's share of a step; two steps
// alternate, so one barrier a step.
template <int Op>
__device__ State look_back(const unsigned long long* status,
                           const int* agg_val, const int* inc_val, int t,
                           int init, Part (*part)[kWarps]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Agg run = ident_agg<Op>();                     // tiles after the inclusive
  for (int j = t - 1, step = 0;; j -= kThreads, step ^= 1) {
    const int i = j - threadIdx.x;               // tile 0 is inclusive, so
    unsigned long long w = kInclusive;           // i < 0 threads are past it
    if (i >= 0)
      while (status_of(w = load_acquire(status + i)) == 0) {
      }
    const unsigned inc = __ballot_sync(kFull, status_of(w) == 2);
    const int stop = inc ? __ffs(inc) - 1 : 32;  // nearest inclusive lane
    Agg x = ident_agg<Op>();
    if (lane < stop)
      x = Agg{load_relaxed(agg_val + i),
              static_cast<int>(static_cast<unsigned>(w)),
              static_cast<int>((w >> 34) & 15)};
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {           // lanes stop-1 .. 0, the
      const Agg y = shfl_down(x, o);             // higher lane (the earlier
      if (lane + o < 32) x = compose<Op>(y, x);  // tile) first
    }
    // (a warp wholly past tile 0 has stop 0, and the walk never reaches it)
    if (lane == stop && i >= 0)
      part[step][warp].inc = State{load_relaxed(inc_val + i),
                                   (w >> 34) & kH ? 1 : 0,
                                   static_cast<int>(static_cast<unsigned>(w))};
    if (lane == 0) {
      part[step][warp].stop = stop;
      part[step][warp].run = x;
    }
    __syncthreads();
    Agg window = ident_agg<Op>();
#pragma unroll
    for (int w8 = 0; w8 < kWarps; ++w8) {        // nearest warp first, each
      const Part& q = part[step][w8];            // one earlier than the last
      window = compose<Op>(q.run, window);
      if (q.stop < 32) return apply<Op>(compose<Op>(window, run), q.inc, init);
    }
    run = compose<Op>(window, run);
  }
}

template <int Op, bool kOneTile>
static __global__ void __launch_bounds__(kThreads, 4) segred_kernel(
    const int* __restrict__ kinds, const int* __restrict__ vals, long long n,
    int init, int acc, int group_open, bool vec, int* __restrict__ out,
    unsigned long long* __restrict__ status, int* __restrict__ agg_val,
    int* __restrict__ inc_val, unsigned* __restrict__ next, int n_tiles) {
  __shared__ int stage_k[kStage], stage_v[kStage];
  __shared__ Agg warp_tot[kWarps], warp_ex[kWarps], s_tile_agg;
  __shared__ Part part[2][kWarps];
  __shared__ int s_tile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int local0 = threadIdx.x * kScanItems;
  const long long n2 = 2 * n;
  int* out_k = out;
  int* out_v = out + n2;
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
    const long long left = n - base - local0;
    const int nv = left <= 0 ? 0 : left >= kScanItems ? kScanItems
                                                       : static_cast<int>(left);
    int k[kScanItems], x[kScanItems];
#pragma unroll
    for (int q = 0; q < kScanItems / 4; ++q) {
      const int4 kq = load4(kinds, base + local0 + 4 * q, n, vec);
      const int4 xq = vals != nullptr
                          ? load4(vals, base + local0 + 4 * q, n, vec)
                          : make_int4(identity<Op>(), identity<Op>(),
                                      identity<Op>(), identity<Op>());
      k[4 * q] = kq.x, k[4 * q + 1] = kq.y, k[4 * q + 2] = kq.z;
      k[4 * q + 3] = kq.w;
      x[4 * q] = xq.x, x[4 * q + 1] = xq.y, x[4 * q + 2] = xq.z;
      x[4 * q + 3] = xq.w;
    }
    // the thread's aggregate: its tokens composed in order, as selects
    Agg mine = ident_agg<Op>();
#pragma unroll
    for (int i = 0; i < kScanItems; ++i) {
      if (i >= nv) continue;
      const bool bar = k[i] > 0;
      const bool em = k[i] == 1 || (mine.f & kH);   // emits when o is clear
      const bool first = bar && !(mine.f & kHB);
      mine.cnt += bar ? (em ? 1 : 0) + (k[i] > 1 ? 1 : 0) : 0;
      mine.f = bar ? (mine.f & (kD | kEI)) | kHB | (first && !em ? kD : 0) |
                         (em ? kEI : 0)
                   : mine.f | kH;
      mine.a = bar ? identity<Op>() : combine<Op>(mine.a, x[i]);
    }
    Agg incl = mine;                             // inclusive scan in the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const Agg y = shfl_up(incl, o);
      if (lane >= o) incl = compose<Op>(y, incl);
    }
    Agg lane_ex = shfl_up(incl, 1);
    if (lane == 0) lane_ex = ident_agg<Op>();
    if (lane == 31) warp_tot[warp] = incl;
    __syncthreads();
    if (warp == 0) {                             // scan the 8 warp totals
      Agg w = lane < kWarps ? warp_tot[lane] : ident_agg<Op>();
#pragma unroll
      for (int o = 1; o < kWarps; o <<= 1) {
        const Agg y = shfl_up(w, o);
        if (lane >= o) w = compose<Op>(y, w);
      }
      Agg ex = shfl_up(w, 1);
      if (lane == 0) ex = ident_agg<Op>();
      if (lane < kWarps) warp_ex[lane] = ex;
      if (lane == kWarps - 1) {
        s_tile_agg = w;
        if (!kOneTile && t > 0) {                // publish the aggregate
          agg_val[t] = w.a;
          store_release(status + t, word(kAggregate, w.f, w.cnt));
        }
      }
    }
    __syncthreads();
    const Agg tile = s_tile_agg;
    State in{acc, group_open, 0};
    if (!kOneTile && t > 0)
      in = look_back<Op>(status, agg_val, inc_val, t, init, part);
    const State after = apply<Op>(tile, in, init);
    if (!kOneTile && threadIdx.x == 0) {         // publish the inclusive state
      inc_val[t] = after.v;
      store_release(status + t, word(kInclusive, after.o ? kH : 0,
                                     after.slots));
    }
    // the tile's share of the slots past the count: two a token, less the
    // ones it emitted
    const long long z_lo = after.slots + 2 * (n - end);
    const long long z_hi = in.slots + 2 * (n - base);
    zero_fill(out_k, z_lo, z_hi, threadIdx.x, kThreads);
    zero_fill(out_v, z_lo, z_hi, threadIdx.x, kThreads);
    const State start =
        apply<Op>(lane_ex, apply<Op>(warp_ex[warp], in, init), init);
    const int t0 = in.slots, tile_cnt = after.slots - t0;
    for (int c0 = 0; c0 < tile_cnt; c0 += kStage) {
      const int lo = t0 + c0;                    // slots [lo, lo + kStage)
      State s = start;
#pragma unroll
      for (int i = 0; i < kScanItems; ++i) {     // the sequential machine
        if (i >= nv) continue;
        const bool bar = k[i] > 0;
        const bool emit = bar && (k[i] == 1 || s.o);
        const bool lower = k[i] > 1;
        int r = s.slots - lo;
        if (emit && r >= 0 && r < kStage) stage_k[r] = 0, stage_v[r] = s.v;
        r += emit ? 1 : 0;
        if (lower && r >= 0 && r < kStage)
          stage_k[r] = k[i] - 1, stage_v[r] = 0;
        s.slots += (emit ? 1 : 0) + (lower ? 1 : 0);
        s.v = bar ? (emit ? init : s.v) : combine<Op>(s.v, x[i]);
        s.o = bar ? 0 : 1;
      }
      __syncthreads();
      const int m = tile_cnt - c0 < kStage ? tile_cnt - c0 : kStage;
      for (int e = threadIdx.x; e < m; e += kThreads) {
        out_k[lo + e] = stage_k[e];
        out_v[lo + e] = stage_v[e];
      }
      __syncthreads();
    }
    if (t == n_tiles - 1 && threadIdx.x == 0) {
      out[2 * n2] = after.slots;
      out[2 * n2 + 1] = after.v;
      out[2 * n2 + 2] = after.o;
    }
    if (kOneTile) return;
    __syncthreads();                     // warp_tot, warp_ex, part, s_tile
  }
}

template <int Op>
cudaError_t launch(const int* kinds, const int* vals, long long n, int init,
                   int acc, int group_open, int* out, void* scratch,
                   cudaStream_t s) {
  const bool vec = (reinterpret_cast<uintptr_t>(kinds) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(vals) & 15) == 0;
  if (n <= kTile) {
    segred_kernel<Op, true><<<1, kThreads, 0, s>>>(
        kinds, vals, n, init, acc, group_open, vec, out, nullptr, nullptr,
        nullptr, nullptr, 1);
    return cudaGetLastError();
  }
  const int n_tiles = static_cast<int>((n + kTile - 1) / kTile);
  // per tile: a status word (u64), then the aggregate's and the inclusive
  // state's values (int each); then the tile counter
  auto* status = static_cast<unsigned long long*>(scratch);
  int* agg_val = reinterpret_cast<int*>(status + n_tiles);
  int* inc_val = agg_val + n_tiles;
  auto* next = reinterpret_cast<unsigned*>(inc_val + n_tiles);
  cudaError_t e = cudaMemsetAsync(
      scratch, 0, (2 * n_tiles + 1) * sizeof(unsigned long long), s);
  if (e != cudaSuccess) return e;
  static int fits[64];
  const int fit = resident_blocks(
      reinterpret_cast<const void*>(segred_kernel<Op, false>), fits);
  if (fit <= 0) {
    e = cudaGetLastError();
    return e != cudaSuccess ? e : cudaErrorInvalidConfiguration;
  }
  const int grid = n_tiles < fit ? n_tiles : fit;
  segred_kernel<Op, false><<<grid, kThreads, 0, s>>>(
      kinds, vals, n, init, acc, group_open, vec, out, status, agg_val,
      inc_val, next, n_tiles);
  return cudaGetLastError();
}

// The device-carry entry, for a window inside a captured tick loop: at
// most kTile lanes (one block), the valid count n, the carry (acc, o) and a
// request id per token all read from the device, so that nothing of the
// call is a host value.  Each emitted token carries the rid of the barrier
// that emits it.  out: out_kinds [2w], out_vals [2w], out_rids [2w] (the
// emitted tokens, then zeros), count; the carry is written back in place
// after every thread has read it.  With n = 0 the tile's aggregate is the
// identity, so the carry comes back unchanged.  Emissions go straight to
// global memory at their slots: a window of the apps emits at most 256.
template <int Op>
static __global__ void __launch_bounds__(kThreads) segred_carry_kernel(
    const int* __restrict__ kinds, const int* __restrict__ vals,
    const int* __restrict__ rids, const int* __restrict__ n_ptr, int w,
    int init, int* __restrict__ carry, int* __restrict__ out) {
  __shared__ Agg warp_tot[kWarps], warp_ex[kWarps], s_tile_agg;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int local0 = threadIdx.x * kScanItems;
  const int n = min(max(*n_ptr, 0), w);
  const State in{carry[0], carry[1] != 0 ? 1 : 0, 0};
  const int left = n - local0;
  const int nv = left <= 0 ? 0 : left >= kScanItems ? kScanItems : left;
  int k[kScanItems], x[kScanItems], r[kScanItems];
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    const bool live = i < nv;
    k[i] = live ? kinds[local0 + i] : 0;
    x[i] = live && vals != nullptr ? vals[local0 + i] : identity<Op>();
    r[i] = live ? rids[local0 + i] : 0;
  }
  Agg mine = ident_agg<Op>();                    // as in segred_kernel
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    if (i >= nv) continue;
    const bool bar = k[i] > 0;
    const bool em = k[i] == 1 || (mine.f & kH);
    const bool first = bar && !(mine.f & kHB);
    mine.cnt += bar ? (em ? 1 : 0) + (k[i] > 1 ? 1 : 0) : 0;
    mine.f = bar ? (mine.f & (kD | kEI)) | kHB | (first && !em ? kD : 0) |
                       (em ? kEI : 0)
                 : mine.f | kH;
    mine.a = bar ? identity<Op>() : combine<Op>(mine.a, x[i]);
  }
  Agg incl = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const Agg y = shfl_up(incl, o);
    if (lane >= o) incl = compose<Op>(y, incl);
  }
  Agg lane_ex = shfl_up(incl, 1);
  if (lane == 0) lane_ex = ident_agg<Op>();
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    Agg t = lane < kWarps ? warp_tot[lane] : ident_agg<Op>();
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      const Agg y = shfl_up(t, o);
      if (lane >= o) t = compose<Op>(y, t);
    }
    Agg ex = shfl_up(t, 1);
    if (lane == 0) ex = ident_agg<Op>();
    if (lane < kWarps) warp_ex[lane] = ex;
    if (lane == kWarps - 1) s_tile_agg = t;
  }
  __syncthreads();
  const State after = apply<Op>(s_tile_agg, in, init);
  const long long w2 = 2 * static_cast<long long>(w);
  int* out_k = out;
  int* out_v = out + w2;
  int* out_r = out + 2 * w2;
  zero_fill(out_k, after.slots, w2, threadIdx.x, kThreads);
  zero_fill(out_v, after.slots, w2, threadIdx.x, kThreads);
  zero_fill(out_r, after.slots, w2, threadIdx.x, kThreads);
  State s = apply<Op>(lane_ex, apply<Op>(warp_ex[warp], in, init), init);
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {         // the sequential machine
    if (i >= nv) continue;
    const bool bar = k[i] > 0;
    const bool emit = bar && (k[i] == 1 || s.o);
    const bool lower = k[i] > 1;
    if (emit) out_k[s.slots] = 0, out_v[s.slots] = s.v, out_r[s.slots] = r[i];
    const int q = s.slots + (emit ? 1 : 0);
    if (lower) out_k[q] = k[i] - 1, out_v[q] = 0, out_r[q] = r[i];
    s.slots = q + (lower ? 1 : 0);
    s.v = bar ? (emit ? init : s.v) : combine<Op>(s.v, x[i]);
    s.o = bar ? 0 : 1;
  }
  if (threadIdx.x == 0) {                        // every thread read carry
    out[3 * w2] = after.slots;                   // before the first barrier
    carry[0] = after.v;
    carry[1] = after.o;
  }
}

template <int Op>
cudaError_t launch_carry(const int* kinds, const int* vals, const int* rids,
                         const int* n, int w, int init, int* carry, int* out,
                         cudaStream_t s) {
  segred_carry_kernel<Op><<<1, kThreads, 0, s>>>(kinds, vals, rids, n, w,
                                                 init, carry, out);
  return cudaGetLastError();
}

}  // namespace repro

extern "C" int segment_reduce_tile_rows() { return repro::kTile; }

// The device-carry entry.  kinds, rids [w] and vals [w] (or null), w <=
// kTile; n: one int (the valid lanes, clamped to [0, w]); carry: two ints
// (acc, group_open), updated in place; out: 6w + 1 ints (out_kinds,
// out_vals, out_rids [2w] each, then count).  Returns cudaGetLastError()
// after the launch; cudaErrorInvalidValue for w outside [1, kTile].
extern "C" int segment_reduce_carry_launch(const void* kinds,
                                           const void* vals, const void* rids,
                                           const void* n, int w, int op,
                                           int init, void* carry, void* out,
                                           void* stream) {
  using namespace repro;
  if (w < 1 || w > kTile) return cudaErrorInvalidValue;
  const int* k = static_cast<const int*>(kinds);
  const int* v = static_cast<const int*>(vals);
  const int* r = static_cast<const int*>(rids);
  const int* nn = static_cast<const int*>(n);
  int* c = static_cast<int*>(carry);
  int* o = static_cast<int*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (op) {
    case kAdd: return launch_carry<kAdd>(k, v, r, nn, w, init, c, o, s);
    case kMin: return launch_carry<kMin>(k, v, r, nn, w, init, c, o, s);
    case kMax: return launch_carry<kMax>(k, v, r, nn, w, init, c, o, s);
    case kAnd: return launch_carry<kAnd>(k, v, r, nn, w, init, c, o, s);
    case kOr: return launch_carry<kOr>(k, v, r, nn, w, init, c, o, s);
    case kXor: return launch_carry<kXor>(k, v, r, nn, w, init, c, o, s);
    default: return cudaErrorInvalidValue;
  }
}

// out: 4n + 3 ints (out_kinds [2n], out_vals [2n], count, carry (v, o)).
// scratch: 2 * ceil(n / kTile) + 1 u64 when n > kTile, else unused (may be
// null).  vals may be null.  Returns cudaGetLastError() after the launch.
extern "C" int segment_reduce_launch(const void* kinds, const void* vals,
                                     long long n, int op, int init, int acc,
                                     int group_open, void* out, void* scratch,
                                     void* stream) {
  using namespace repro;
  const int* k = static_cast<const int*>(kinds);
  const int* v = static_cast<const int*>(vals);
  int* o = static_cast<int*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (op) {
    case kAdd: return launch<kAdd>(k, v, n, init, acc, group_open, o,
                                   scratch, s);
    case kMin: return launch<kMin>(k, v, n, init, acc, group_open, o,
                                   scratch, s);
    case kMax: return launch<kMax>(k, v, n, init, acc, group_open, o,
                                   scratch, s);
    case kAnd: return launch<kAnd>(k, v, n, init, acc, group_open, o,
                                   scratch, s);
    case kOr: return launch<kOr>(k, v, n, init, acc, group_open, o,
                                 scratch, s);
    case kXor: return launch<kXor>(k, v, n, init, acc, group_open, o,
                                   scratch, s);
    default: return cudaErrorInvalidValue;
  }
}
