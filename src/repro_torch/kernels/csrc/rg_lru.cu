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
// Bound: bytes, (3*B*S*D + 2*B*D) * 4 at 3.35 TB/s; 2 flops per element.
// The multiply-add chain is short (512 steps of about 8 clocks is 2 us at
// the served shape, against a 7.5 us bound), so the first version's limit
// was the feed: one warp of 32 channels a block, 128 blocks at the served
// (B 1, D 4096) on 132 SMs, and 2 * 8 steps of loads in flight a warp,
// about 262 KB on the card.  Knock-outs on the card
// (tools/probe_scan_kernels.py) show what holds this design: neither the
// chain nor the wait for the copies, but the warp's own issue of copies,
// loads and y stores per tile, which tiles of more steps amortise.
//
// Layout: one warp a block, the first W lanes each owning one channel (W
// = 32, 16, 8 or 4: the wrapper's plan, rg_lru.py::plan, takes the widest
// that gives every SM 3 blocks, so the served shape runs 512 blocks of 8
// channels, about one warp on each of an SM's 4 sub-partitions, and
// (4, 4096, 4096) 512 blocks of 32).  A ring of kStages shared-memory
// stages holds tiles of kSteps steps x W channels of a and of b (64 steps
// and 6 stages up to W 16; 32 steps and 10 stages at W 32, where the
// card's bytes are the limit), filled by cp.async: 16 bytes a copy when D
// is a multiple of 4 and the pointers 16-byte aligned, else 4; the tile's
// rows past S and channels past D are copied as zeros.  kStages - 1 tiles
// are in flight while the warp walks one: 20 KB a block at W 8, 72 KB at W
// 32.  The walk reads a whole tile's a and b into registers, then runs the
// chain with no test in it and puts each h into a shared y tile, which the
// warp writes out whole (16 bytes a store where it copied 16) while the
// next tiles load.  A chunked scan (per-chunk products, a carry across
// chunks, a fix-up) would use more threads but round in another order and
// give up the bit-for-bit contract.
#include "common.cuh"

namespace repro {
namespace {

constexpr int kWarp = 32;

// Steps a stage holds and stages of the ring, by block width.  Narrow
// blocks (the served shape: about one warp an SM sub-partition) take tiles
// of 64 steps, which halve the waits, barriers and copy issue per step;
// 32-channel blocks (large B * D, where the card's bytes are the limit)
// tiles of 32 steps and 10 stages.
template <int W>
struct RgCfg {
  static constexpr int kSteps = W == 32 ? 32 : 64;
  static constexpr int kStages = W == 32 ? 10 : 6;
  static constexpr int kTile = kSteps * W;            // floats of a or b
  static constexpr int kSmem = (kStages * 2 * kTile + kTile) * 4;
  static_assert(W % 4 == 0 && W <= kWarp, "width");
};

// Copy tile [t0, t0 + kSteps) x [d0, d0 + W) of a and b into stage st.
template <int W, bool kVec>
__device__ __forceinline__ void load_tile(float* st,
                                          const float* __restrict__ a,
                                          const float* __restrict__ b,
                                          long long row0, int t0, int steps,
                                          int d0, int d) {
  constexpr int kTile = RgCfg<W>::kTile, kSteps = RgCfg<W>::kSteps;
  if constexpr (kVec) {
    constexpr int kQ = W / 4;
    for (int i = threadIdx.x; i < kSteps * kQ; i += kWarp) {
      const int t = i / kQ, q = 4 * (i % kQ);
      const bool ok = t < steps && d0 + q < d;   // d % 4 == 0: whole quads
      const long long off = ok ? (row0 + t0 + t) * d + d0 + q : 0;
      cp_async16(smem_u32(st + t * W + q), a + off, ok ? 16 : 0);
      cp_async16(smem_u32(st + kTile + t * W + q), b + off, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kSteps * W; i += kWarp) {
      const int t = i / W, cc = i % W;
      const bool ok = t < steps && d0 + cc < d;
      const long long off = ok ? (row0 + t0 + t) * d + d0 + cc : 0;
      cp_async4(smem_u32(st + t * W + cc), a + off, ok ? 4 : 0);
      cp_async4(smem_u32(st + kTile + t * W + cc), b + off, ok ? 4 : 0);
    }
  }
}

template <int W, bool kVec>
__global__ void __launch_bounds__(kWarp) rg_lru_kernel(
    const float* __restrict__ a, const float* __restrict__ b,
    const float* __restrict__ h0, float* __restrict__ y,
    float* __restrict__ hT, int seq, int d) {
  constexpr int kTile = RgCfg<W>::kTile, kSteps = RgCfg<W>::kSteps;
  constexpr int kStages = RgCfg<W>::kStages;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* ys = smem + kStages * 2 * kTile;              // [kSteps][W]

  const int tid = threadIdx.x;
  const int d0 = blockIdx.x * W;
  const int ch = d0 + tid;
  const bool live = tid < W && ch < d;
  const long long row0 = static_cast<long long>(blockIdx.y) * seq;
  const long long state = static_cast<long long>(blockIdx.y) * d + ch;
  float h = live ? h0[state] : 0.f;

  const int tiles = (seq + kSteps - 1) / kSteps;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < tiles)
      load_tile<W, kVec>(smem + s * 2 * kTile, a, b, row0, s * kSteps,
                         min(kSteps, seq - s * kSteps), d0, d);
    cp_async_commit();
  }
  for (int tile = 0; tile < tiles; ++tile) {
    cp_async_wait<kStages - 2>();            // this tile has landed
    __syncthreads();
    // the stage of tile - 1 is free: every lane passed the barrier after
    // its walk
    const int nxt = tile + kStages - 1;
    if (nxt < tiles)
      load_tile<W, kVec>(smem + (nxt % kStages) * 2 * kTile, a, b, row0,
                         nxt * kSteps, min(kSteps, seq - nxt * kSteps), d0,
                         d);
    cp_async_commit();

    const int t0 = tile * kSteps;
    const int steps = min(kSteps, seq - t0);
    if (tid < W) {
      const float* as = smem + (tile % kStages) * 2 * kTile + tid;
      if (steps == kSteps) {          // a whole tile: no test in the chain
        float ra[kSteps], rb[kSteps];
#pragma unroll
        for (int u = 0; u < kSteps; ++u) {
          ra[u] = as[u * W];
          rb[u] = as[kTile + u * W];
        }
#pragma unroll
        for (int u = 0; u < kSteps; ++u) {
          h = __fadd_rn(__fmul_rn(ra[u], h), rb[u]);
          ys[u * W + tid] = h;
        }
      } else {
        for (int u = 0; u < steps; ++u) {
          h = __fadd_rn(__fmul_rn(as[u * W], h), as[kTile + u * W]);
          ys[u * W + tid] = h;
        }
      }
    }
    __syncthreads();                          // the y tile is complete
    if constexpr (kVec) {
      constexpr int kQ = W / 4;
      for (int i = tid; i < steps * kQ; i += kWarp) {
        const int t = i / kQ, q = 4 * (i % kQ);
        if (d0 + q < d)
          *reinterpret_cast<float4*>(y + (row0 + t0 + t) * d + d0 + q) =
              *reinterpret_cast<const float4*>(ys + t * W + q);
      }
    } else {
      for (int i = tid; i < steps * W; i += kWarp) {
        const int t = i / W, cc = i % W;
        if (d0 + cc < d) y[(row0 + t0 + t) * d + d0 + cc] = ys[t * W + cc];
      }
    }
  }
  if (live) hT[state] = h;
}

template <int W, bool kVec>
cudaError_t launch(const float* a, const float* b, const float* h0, float* y,
                   float* hT, int batch, int seq, int d, cudaStream_t s) {
  static bool smem_set = false;      // past 48 KB needs the opt-in, once
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        rg_lru_kernel<W, kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        RgCfg<W>::kSmem);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  const dim3 grid((d + W - 1) / W, batch);
  rg_lru_kernel<W, kVec><<<grid, kWarp, RgCfg<W>::kSmem, s>>>(
      a, b, h0, y, hT, seq, d);
  return cudaGetLastError();
}

template <int W>
cudaError_t launch_width(const float* a, const float* b, const float* h0,
                         float* y, float* hT, int batch, int seq, int d,
                         bool vec, cudaStream_t s) {
  return vec ? launch<W, true>(a, b, h0, y, hT, batch, seq, d, s)
             : launch<W, false>(a, b, h0, y, hT, batch, seq, d, s);
}

}  // namespace
}  // namespace repro

// Steps a stage holds, stages of the ring and dynamic shared memory of the
// instance of ``width`` channels a block (the wrapper's plan must agree),
// or -1 if there is no such instance.
extern "C" int rg_lru_config(int width, int what) {
  int cfg[3];
  switch (width) {
#define REPRO_RG_CFG(w)                                          \
  case w:                                                        \
    cfg[0] = repro::RgCfg<w>::kSteps;                            \
    cfg[1] = repro::RgCfg<w>::kStages;                           \
    cfg[2] = repro::RgCfg<w>::kSmem;                             \
    break;
    REPRO_RG_CFG(32)
    REPRO_RG_CFG(16)
    REPRO_RG_CFG(8)
    REPRO_RG_CFG(4)
#undef REPRO_RG_CFG
    default: return -1;
  }
  return what >= 0 && what < 3 ? cfg[what] : -1;
}

// Entry point for ctypes.  Returns a cudaError_t code (0 = launched).
extern "C" int rg_lru_launch(const void* a, const void* b, const void* h0,
                             void* y, void* hT, int batch, int seq, int d,
                             int width, void* stream) {
  if (batch > 65535 || seq < 0 || rg_lru_config(width, 0) < 0)
    return cudaErrorInvalidValue;
  if (batch <= 0 || d <= 0) return cudaSuccess;
  const auto aligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  const bool vec = d % 4 == 0 && aligned(a) && aligned(b) && aligned(y);
  const auto* ap = static_cast<const float*>(a);
  const auto* bp = static_cast<const float*>(b);
  const auto* hp = static_cast<const float*>(h0);
  auto* yp = static_cast<float*>(y);
  auto* tp = static_cast<float*>(hT);
  auto s = static_cast<cudaStream_t>(stream);
  switch (width) {
    case 32:
      return repro::launch_width<32>(ap, bp, hp, yp, tp, batch, seq, d, vec,
                                     s);
    case 16:
      return repro::launch_width<16>(ap, bp, hp, yp, tp, batch, seq, d, vec,
                                     s);
    case 8:
      return repro::launch_width<8>(ap, bp, hp, yp, tp, batch, seq, d, vec,
                                    s);
    default:
      return repro::launch_width<4>(ap, bp, hp, yp, tp, batch, seq, d, vec,
                                    s);
  }
}
