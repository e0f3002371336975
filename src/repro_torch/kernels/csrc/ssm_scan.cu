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
// S = 0).  The steps are the reference kernel's but for exp(dt * a), which
// is 2^(dt * a2) with a2 = a * log2(e) rounded once, on the special-function
// unit (ex2.approx: relative error about 2^-22, the size of expf's own;
// results below 2^-126 flush to 0).  FMA contraction and the order of the
// sum over n differ too; the card holds y and hT within 2e-5 of the largest
// |plain| value, as it held the first version.
//
// Bound: the bytes (x, dt and y, plus a, b, c, d, h0 and hT, each once, at
// 3.35 TB/s) or the B*S*Di*N exponentials on the special-function units
// (16 per SM per clock), whichever is larger; at (1, 512, 8192, 16) the two
// are close.  Neither is what held the first version (one lane a state, a
// shuffle tree and four shared loads a step): knock-outs on the card
// (tools/probe_scan_kernels.py) showed its shared loads and shuffles, the
// shared-memory pipe, in the way, and accurate expf, nine instructions,
// costing little there.  Here the pipe and the issue slots are both spent
// with care: per element and step about eight instructions, one ex2, and
// under one shared-memory access.
//
// Layout.  Each channel d gets a group of L lanes and each lane K state
// elements, n = k * L + lane (N <= L * K; lanes past N idle at h = 0), so a
// block of 256 threads covers C = 256 / L channels.  Per step a lane updates
// its K states and sums their h * c; that partial goes into a register
// buffer of L steps.  Every L steps one reduce-scatter across the L lanes
// (L/2 + L/4 + ... + 1 = L - 1 shuffles and adds) leaves the sum over n of
// step t0 + l in lane l: under one shuffle a step, where a tree per step
// took log2(L).  A stage holds kChunk steps: dt and x as they lie in memory
// ([t][channel], rows of C + 4 floats, 16-byte cp.async copies; a lane's
// loads of them are broadcasts to its group), and b and c transposed,
// [n][t] (rows of kChunk + 4 floats, so that eight consecutive rows fall
// in distinct banks; 4-byte copies, a warp taking a patch of 4 steps x 8
// states, whole 32-byte sectors and 32 distinct banks), so that one 16-byte
// load gives a lane four steps of its state.  Two stages make a cp.async
// ring: the next chunk's copies are in flight while the block steps through
// this one.  Steps past S and channels past Di are copied as zeros: dt = b
// = 0 leaves h as it is.  Each chunk's y goes into one of two shared tiles
// (rows of C + 4 floats: 16-byte aligned, and a warp's writes of L steps x
// 32 / L channels meet in no bank) and out along d, 16 bytes a store, while
// the block steps through the next chunk: one barrier a chunk.
//
// (L, K) is the wrapper's plan (ssm_scan.py::plan): L = 8 and K = 1, 2 or
// 4 for N up to 8, 16 or 32, so that the served (1, 512, 8192, 16) runs 256
// blocks of 32 channels.  Other shapes the probes timed: 16 x 1 and 32 x 1
// (more threads, more shuffles and loads per element) lost everywhere;
// 4 x 4 won at (4, 4096, 8192, 16) by a tenth and lost at the served shape
// (128 blocks), and spilled.
#include "common.cuh"

namespace repro {
namespace {

constexpr int kBlock = 256;
constexpr int kChunk = 32;          // steps staged at a time
constexpr int kStride = kChunk + 4; // floats per staged row

template <int L, int K>
struct Cfg {
  static constexpr int kCh = kBlock / L;           // channels per block
  static constexpr int kNp = L * K;                // states, padded
  static constexpr int kRowX = kCh + 4;            // floats a dt or x row
  static constexpr int kStage = 2 * kChunk * kRowX + 2 * kNp * kStride;
  // y tile rows: 16-byte aligned for the stores, and 4 (mod 32) floats
  // apart, so that a warp's writes of L steps x 32 / L channels meet in no
  // bank
  static constexpr int kYStride = kCh + 4;
  static constexpr int kYTile = kChunk * kYStride;
  static constexpr int kSmem = (2 * kStage + 2 * kYTile) * 4;
  static_assert(kCh % 8 == 0 && kNp % 8 == 0 && kChunk % L == 0, "tiles");
};

__device__ __forceinline__ float lane4(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// v[i] summed over the L lanes of a group for every i, lane l keeping
// index l: at each level a lane sends the half it does not keep to its
// partner and adds the partner's copy of the half it keeps.  One level per
// template instance, so that every index is a constant and v stays in
// registers.
template <int L, int O = L / 2>
__device__ __forceinline__ float reduce_scatter(float (&v)[L], int lane) {
  if constexpr (O == 0) {
    return v[0];
  } else {
    const bool up = lane & O;
#pragma unroll
    for (int i = 0; i < O; ++i) {
      const float send = up ? v[i] : v[i + O];
      const float keep = up ? v[i + O] : v[i];
      v[i] = keep + __shfl_xor_sync(kFull, send, O);
    }
    return reduce_scatter<L, O / 2>(v, lane);
  }
}

// 2^z on the special-function unit (relative error about 2^-22; results
// below 2^-126 flush to 0)
__device__ __forceinline__ float ex2(float z) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(z));
  return r;
}

constexpr float kLog2e = 1.44269502f;

// Copy chunk [t0, t0 + kChunk) of the block's inputs into stage ``st``,
// zeros past the sequence, Di and N: dt and x as they lie, [t][channel],
// 16 bytes a copy where ``vec`` (Di a multiple of 4, dt and x aligned);
// b and c transposed, [n][t], 4 bytes a copy.
template <int L, int K>
__device__ __forceinline__ void stage_chunk(
    float* st, const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ b, const float* __restrict__ c,
    long long row0, int t0, int steps, int d0, int di, int n, bool vec) {
  using C = Cfg<L, K>;
  constexpr int kQ = C::kCh / 4;             // quads of a dt or x row
  for (int i = threadIdx.x; i < kChunk * kQ; i += kBlock) {
    const int t = i / kQ, q = 4 * (i % kQ);
    float* sdt = st + t * C::kRowX + q;
    float* sx = sdt + kChunk * C::kRowX;
    const long long off = (row0 + t0 + t) * di + d0 + q;
    if (vec) {                               // a quad is whole or past Di
      const bool ok = t < steps && d0 + q < di;
      cp_async16(smem_u32(sdt), dt + (ok ? off : 0), ok ? 16 : 0);
      cp_async16(smem_u32(sx), x + (ok ? off : 0), ok ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = t < steps && d0 + q + e < di;
        cp_async4(smem_u32(sdt + e), dt + (ok ? off + e : 0), ok ? 4 : 0);
        cp_async4(smem_u32(sx + e), x + (ok ? off + e : 0), ok ? 4 : 0);
      }
    }
  }
  const int w = threadIdx.x >> 5, wl = threadIdx.x & 31;
  const int pt = wl & 3, pr = wl >> 2;       // a patch: 4 steps x 8 states
  constexpr int kTq = kChunk / 4, kWarps = kBlock / 32;
  float* bs = st + 2 * kChunk * C::kRowX;
  static_assert(kTq * (C::kNp / 8) % kWarps == 0, "patches");
#pragma unroll
  for (int i = 0; i < kTq * (C::kNp / 8) / kWarps; ++i) {
    const int p = w + i * kWarps;
    const int t = (p % kTq) * 4 + pt, r = (p / kTq) * 8 + pr;
    const bool ok = t < steps && r < n;
    const long long off = ok ? (row0 + t0 + t) * n + r : 0;
    cp_async4(smem_u32(bs + r * kStride + t), b + off, ok ? 4 : 0);
    cp_async4(smem_u32(bs + (C::kNp + r) * kStride + t), c + off,
              ok ? 4 : 0);
  }
}

// Write a y tile's first ``steps`` rows to y[t0...], along d: 16 bytes a
// store where ``vec`` (4 channels, whole ones only), else 4.
template <int L, int K>
__device__ __forceinline__ void store_y(float* __restrict__ y,
                                        const float* yt, long long row0,
                                        int t0, int steps, int d0, int di,
                                        bool vec) {
  using C = Cfg<L, K>;
  if (vec) {
    constexpr int kQ = C::kCh / 4;
    for (int i = threadIdx.x; i < steps * kQ; i += kBlock) {
      const int t = i / kQ, cc = 4 * (i % kQ);
      if (d0 + cc < di)
        *reinterpret_cast<float4*>(y + (row0 + t0 + t) * di + d0 + cc) =
            *reinterpret_cast<const float4*>(yt + t * C::kYStride + cc);
    }
  } else {
    for (int i = threadIdx.x; i < steps * C::kCh; i += kBlock) {
      const int t = i / C::kCh, cc = i % C::kCh;
      if (d0 + cc < di)
        y[(row0 + t0 + t) * di + d0 + cc] = yt[t * C::kYStride + cc];
    }
  }
}

template <int L, int K>
__global__ void __launch_bounds__(kBlock) ssm_scan_kernel(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ a, const float* __restrict__ b,
    const float* __restrict__ c, const float* __restrict__ dskip,
    const float* __restrict__ h0, float* __restrict__ y,
    float* __restrict__ hT, int seq, int di, int n, bool vec) {
  using C = Cfg<L, K>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* ys = smem + 2 * C::kStage;          // 2 x [kChunk][kYStride]

  const int lane = threadIdx.x % L;
  const int ch = threadIdx.x / L;
  const int d0 = blockIdx.x * C::kCh;
  const int dch = d0 + ch;
  const long long row0 = static_cast<long long>(blockIdx.y) * seq;
  const long long state0 = (static_cast<long long>(blockIdx.y) * di + dch)
                           * n;

  // exp(dt * a) = 2^(dt * a2) with a2 = a * log2(e): one multiply and one
  // ex2, where expf issues nine instructions
  float a2[K], h[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int s = k * L + lane;
    const bool live = dch < di && s < n;
    a2[k] = live ? a[static_cast<long long>(dch) * n + s] * kLog2e : 0.f;
    h[k] = live ? h0[state0 + s] : 0.f;
  }
  const float dsk = dch < di ? dskip[dch] : 0.f;

  // One barrier a chunk.  At the top of chunk ci, after it: chunk ci has
  // landed, every thread has left chunk ci - 1, so its stage takes the
  // copies of chunk ci + 1 and its y tile (the other of two) goes out.
  const int chunks = (seq + kChunk - 1) / kChunk;
  if (chunks > 0)
    stage_chunk<L, K>(smem, x, dt, b, c, row0, 0, min(kChunk, seq), d0, di,
                      n, vec);
  cp_async_commit();
  for (int ci = 0; ci < chunks; ++ci) {
    const int t0 = ci * kChunk;
    const int steps = min(kChunk, seq - t0);
    cp_async_wait<0>();                      // chunk ci has landed
    __syncthreads();
    if (ci + 1 < chunks)
      stage_chunk<L, K>(smem + ((ci + 1) & 1) * C::kStage, x, dt, b, c, row0,
                        t0 + kChunk, min(kChunk, seq - t0 - kChunk), d0, di,
                        n, vec);
    cp_async_commit();
    if (ci > 0)
      store_y<L, K>(y, ys + ((ci - 1) & 1) * C::kYTile, row0, t0 - kChunk,
                    kChunk, d0, di, vec);

    const float* st = smem + (ci & 1) * C::kStage;
    float* yt = ys + (ci & 1) * C::kYTile;
    const float* dts = st + ch;              // column ch, rows kRowX apart
    const float* xs = dts + kChunk * C::kRowX;
    const float* bs = st + 2 * kChunk * C::kRowX + lane * kStride;
    const float* cs = bs + C::kNp * kStride;
    for (int g = 0; g < steps; g += L) {
      float part[L];
#pragma unroll
      for (int q = 0; q < L; q += 4) {
        constexpr int R = C::kRowX;
        const float* dq = dts + (g + q) * R;
        const float* xq = xs + (g + q) * R;
        const float4 d4 = make_float4(dq[0], dq[R], dq[2 * R], dq[3 * R]);
        const float4 x4 = make_float4(xq[0], xq[R], xq[2 * R], xq[3 * R]);
        float4 b4[K], c4[K];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          b4[k] = *reinterpret_cast<const float4*>(bs + k * L * kStride + g
                                                   + q);
          c4[k] = *reinterpret_cast<const float4*>(cs + k * L * kStride + g
                                                   + q);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float dtt = lane4(d4, j);
          const float dx = dtt * lane4(x4, j);
          float p = 0.f;
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const float da = ex2(dtt * a2[k]);
            h[k] = da * h[k] + dx * lane4(b4[k], j);
            p = k == 0 ? h[k] * lane4(c4[k], j)
                       : fmaf(h[k], lane4(c4[k], j), p);
          }
          part[q + j] = p;
        }
      }
      const float yv = reduce_scatter<L>(part, lane);
      const int t = g + lane;
      if (t < steps)
        yt[t * C::kYStride + ch] = yv + dsk * xs[t * C::kRowX];
    }
  }
  if (chunks > 0) {
    __syncthreads();                         // the last y tile is complete
    const int t0 = (chunks - 1) * kChunk;
    store_y<L, K>(y, ys + ((chunks - 1) & 1) * C::kYTile, row0, t0,
                  seq - t0, d0, di, vec);
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int s = k * L + lane;
    if (dch < di && s < n) hT[state0 + s] = h[k];
  }
}

template <int L, int K>
cudaError_t launch(const float* x, const float* dt, const float* a,
                   const float* b, const float* c, const float* d,
                   const float* h0, float* y, float* hT, int batch, int seq,
                   int di, int n, cudaStream_t s) {
  using C = Cfg<L, K>;
  static bool smem_set = false;      // past 48 KB needs the opt-in, once
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssm_scan_kernel<L, K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        C::kSmem);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  // rows of x, dt and y move 16 bytes at a time when Di is a multiple of 4
  // and the three are 16-byte aligned
  const auto aligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  const bool vec = di % 4 == 0 && aligned(x) && aligned(dt) && aligned(y);
  const dim3 grid((di + C::kCh - 1) / C::kCh, batch);
  ssm_scan_kernel<L, K><<<grid, kBlock, C::kSmem, s>>>(
      x, dt, a, b, c, d, h0, y, hT, seq, di, n, vec);
  return cudaGetLastError();
}

using LaunchFn = cudaError_t (*)(const float*, const float*, const float*,
                                 const float*, const float*, const float*,
                                 const float*, float*, float*, int, int, int,
                                 int, cudaStream_t);

struct Instance {
  int lanes, states, smem;
  LaunchFn fn;
};

// The (L, K) the wrapper's plan may ask for.
constexpr Instance kInstances[] = {
    {8, 1, Cfg<8, 1>::kSmem, launch<8, 1>},
    {8, 2, Cfg<8, 2>::kSmem, launch<8, 2>},
    {8, 4, Cfg<8, 4>::kSmem, launch<8, 4>},
};

const Instance* find(int lanes, int states) {
  for (const Instance& i : kInstances)
    if (i.lanes == lanes && i.states == states) return &i;
  return nullptr;
}

}  // namespace
}  // namespace repro

// Steps a stage holds (the wrapper's plan must agree).
extern "C" int ssm_scan_chunk() { return repro::kChunk; }

// Dynamic shared memory of the (lanes, states) instance, or -1 if there is
// none.
extern "C" int ssm_scan_smem_bytes(int lanes, int states) {
  const repro::Instance* i = repro::find(lanes, states);
  return i ? i->smem : -1;
}

// Entry point for ctypes.  Returns a cudaError_t code (0 = launched).
extern "C" int ssm_scan_launch(const void* x, const void* dt, const void* a,
                               const void* b, const void* c, const void* d,
                               const void* h0, void* y, void* hT, int batch,
                               int seq, int di, int n, int lanes, int states,
                               void* stream) {
  const repro::Instance* inst = repro::find(lanes, states);
  if (inst == nullptr || n < 1 || n > lanes * states || batch > 65535 ||
      seq < 0)
    return cudaErrorInvalidValue;
  if (batch <= 0 || di <= 0) return cudaSuccess;
  return inst->fn(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(c), static_cast<const float*>(d),
      static_cast<const float*>(h0), static_cast<float*>(y),
      static_cast<float*>(hT), batch, seq, di, n,
      static_cast<cudaStream_t>(stream));
}
