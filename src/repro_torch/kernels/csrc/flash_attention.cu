// flash_attention — blockwise online-softmax attention forward on Hopper.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::_flash_kernel
// (launched by flash_attention, wrapped by ops.mha(impl="pallas")).  That
// kernel walks a grid (BH, q blocks, kv blocks) whose kv axis runs in order
// on one core and carries the running max, sum and accumulator from grid
// step to grid step in VMEM scratch.  GPU blocks run in no order, so here
// the kv axis is a loop inside the block and the carry lives in registers.
//
// Contract: q [BHq, Sq, D], k/v [BHkv, Skv, D] with BHq = G * BHkv,
// row-major, all float32 or all bfloat16, D in {16, 32, 64, 128, 256}.
// Query row bh reads kv row bh / G (GQA by index: the reference repeats kv
// heads before its kernel; here K/V are never copied).  out [BHq, Sq, D] in
// q's type:
//   out = softmax(q k^T * scale, masked) v, accumulated in float32,
// with scale = 1/sqrt(D) as the caller rounds it, the reference kernel's
// causal rule k_idx <= q_idx (top-left), masked scores -1e30 (never -inf),
// and out = acc / max(l, 1e-30), rounded to nearest even in bfloat16.  Any
// Sq and Skv: the ragged edge is masked (the reference asserts whole
// blocks).  Causal blocks skip the K/V tiles that lie wholly above their
// last row, and the grid issues the heaviest (last) query tiles first.
//
// Bound: operations.  The function needs 4*BHq*Sq*Skv*D flops (about half
// that when causal); bf16's tensor-core peak is 989 TFLOP/s, and the bytes
// (q and out per query row, k and v per kv row) are far below that at every
// path shape.
//
// bfloat16 instance (flash_fwd_mma): both products on the tensor cores,
// FlashAttention-2's shape built from mma.sync.m16n8k16 (bf16 in, f32
// accumulate).  A block of 4 warps owns 64 query rows, 16 per warp.  Q is
// staged once in shared memory; up to D = 128 each warp then keeps its
// 16 x D slice in registers as A fragments (D/4 registers), at D = 256 it
// reads them from shared memory at each use (the O accumulator alone is
// 128 registers there).  K/V stream through a 2-stage cp.async ring of
// tiles of 64 keys (32 at D = 256) in dynamic shared memory, rows padded by
// 16 bytes so that ldmatrix is conflict-free; the next tile's copy is in
// flight while the block computes on this one.  S = Q K^T takes K through
// ldmatrix (a row of K is a column of K^T: the "col" B operand); the
// online softmax runs on the accumulator fragments (each thread holds two
// rows; a row's max reduces over the 4 lanes of a quad by __shfl_xor_sync,
// its sum stays per thread until the end) in log2 units (ex2.approx, the
// scale times log2(e) folded in); P becomes A fragments in registers (the
// f32 C layout of an m16n8 pair is the A layout of one k16 step, so P never
// touches shared memory), and O += P V takes V through ldmatrix.trans.
// The reference multiplies a float32 P by V, so P is not rounded to one
// bf16: it splits into hi = bf16(P) and lo = bf16(P - hi), and O takes
// hi V + lo V, two products on the same V fragments (attn::split_p; about
// 16 bits of P; l sums the f32 P).  That doubles P V's tensor-core work.
// Two other shapes were tried on an H100, 8 warps of 16 rows and 4 warps
// of 32 rows (every K/V fragment feeding two mma, at the cost of registers
// and so of blocks per SM); neither was faster at the served shapes, so
// one shape serves every D.
//
// float32 instance (flash_fwd_f32): scalar float32 FMAs on the CUDA cores
// (at most 67 TFLOP/s), kept because tensor cores would mean TF32, which
// cannot hold the float32 contract (2e-5 against the plain version).  One
// block of 256 threads per (bh, tile of query rows); L threads per row
// (L = 4 up to D = 128, 64 rows a block; L = 8 at D = 256, 32 rows), each
// holding 1/L of the row's q and accumulator (dims c*4L + lane*4 .. +3 for
// chunk c); K/V tiles of float32 in static shared memory (64 keys for
// D <= 64, 32 for D = 128, 16 for D = 256: at most 32 KB); each thread
// forms its partial dot products for the tile, the L threads of a row sum
// them by log2(L) shuffles, and the row's online softmax rescales the
// accumulator once per tile.
#include <stdint.h>

#include "attention_common.cuh"
#include "common.cuh"

namespace repro {
namespace {

using attn::kNegInf;

// ---------------------------------------------------------------------------
// float32: scalar CUDA-core kernel
// ---------------------------------------------------------------------------

constexpr int kBlock = 256;                  // threads per block

// threads per query row, and query rows per block, at head dim D
__host__ __device__ constexpr int lanes_for(int d) {
  return d <= 128 ? 4 : 8;
}
__host__ __device__ constexpr int rows_for(int d) {
  return kBlock / lanes_for(d);
}

template <int D>
__global__ void __launch_bounds__(kBlock)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ out, int sq,
              int skv, int group, float scale, int causal) {
  constexpr int kLanes = lanes_for(D);
  constexpr int kRows = rows_for(D);
  constexpr int kKeys = D <= 64 ? 64 : D <= 128 ? 32 : 16;  // staged keys
  constexpr int kPer = D / kLanes;           // dims per thread
  constexpr int kChunks = kPer / 4;          // float4 chunks per thread
  constexpr int kSpan = 4 * kLanes;          // dims of one chunk of a row
  constexpr int kVecs = kKeys * D / 4;       // float4s per staged tile
  __shared__ __align__(16) float ks[kKeys][D];
  __shared__ __align__(16) float vs[kKeys][D];

  const int qtile = gridDim.x - 1 - blockIdx.x;      // heaviest first
  const long long bh = blockIdx.y;
  const long long kvh = bh / group;
  const int row = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const int qi = qtile * kRows + row;
  const bool row_ok = qi < sq;
  const float* kb = k + kvh * skv * D;
  const float* vb = v + kvh * skv * D;

  float qr[kPer], acc[kPer];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const float4 x = row_ok
        ? attn::load4(q + (bh * sq + qi) * D + c * kSpan + lane * 4)
        : make_float4(0.f, 0.f, 0.f, 0.f);
    qr[4 * c] = x.x; qr[4 * c + 1] = x.y;
    qr[4 * c + 2] = x.z; qr[4 * c + 3] = x.w;
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) acc[i] = 0.f;
  float m = kNegInf, l = 0.f;

  // keys past the block's last row are masked for every row when causal
  const int kv_end = causal ? min(skv, (qtile + 1) * kRows) : skv;
  for (int k0 = 0; k0 < kv_end; k0 += kKeys) {
    for (int i = threadIdx.x; i < kVecs; i += kBlock) {
      const int key = i / (D / 4), col = (i % (D / 4)) * 4;
      const int kk = k0 + key;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (kk < skv) {          // zeros past the edge: masked, never NaN
        kx = attn::load4(kb + static_cast<long long>(kk) * D + col);
        vx = attn::load4(vb + static_cast<long long>(kk) * D + col);
      }
      attn::store4(&ks[key][col], kx);
      attn::store4(&vs[key][col], vx);
    }
    __syncthreads();

    float s[kKeys];
    float tile_max = kNegInf;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const float4 kx =
            *reinterpret_cast<const float4*>(&ks[j][c * kSpan + lane * 4]);
        part = fmaf(qr[4 * c], kx.x, part);
        part = fmaf(qr[4 * c + 1], kx.y, part);
        part = fmaf(qr[4 * c + 2], kx.z, part);
        part = fmaf(qr[4 * c + 3], kx.w, part);
      }
#pragma unroll
      for (int o = 1; o < kLanes; o <<= 1)
        part += __shfl_xor_sync(kFull, part, o);
      const int kk = k0 + j;
      const bool ok = kk < skv && (!causal || kk <= qi);
      s[j] = ok ? part * scale : kNegInf;
      tile_max = fmaxf(tile_max, s[j]);
    }

    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
#pragma unroll
    for (int i = 0; i < kPer; ++i) acc[i] *= alpha;
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      const float p = expf(s[j] - m_new);
      psum += p;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const float4 vx =
            *reinterpret_cast<const float4*>(&vs[j][c * kSpan + lane * 4]);
        acc[4 * c] = fmaf(p, vx.x, acc[4 * c]);
        acc[4 * c + 1] = fmaf(p, vx.y, acc[4 * c + 1]);
        acc[4 * c + 2] = fmaf(p, vx.z, acc[4 * c + 2]);
        acc[4 * c + 3] = fmaf(p, vx.w, acc[4 * c + 3]);
      }
    }
    l = l * alpha + psum;
    m = m_new;
    __syncthreads();          // the next tile overwrites ks / vs
  }

  if (row_ok) {
    const float denom = fmaxf(l, 1e-30f);
    float* o = out + (bh * sq + qi) * D;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      attn::store4(o + c * kSpan + lane * 4,
                   make_float4(acc[4 * c] / denom, acc[4 * c + 1] / denom,
                               acc[4 * c + 2] / denom,
                               acc[4 * c + 3] / denom));
    }
  }
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       void* out, int bh, int group, int sq, int skv,
                       float scale, int causal, cudaStream_t s) {
  constexpr int kRows = rows_for(D);
  const dim3 grid((sq + kRows - 1) / kRows, bh);
  flash_fwd_f32<D><<<grid, kBlock, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), sq, skv, group,
      scale, causal);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores (mma.sync m16n8k16) fed by a cp.async ring
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
using attn::cp_async16;
using attn::cp_async_commit;
using attn::cp_async_wait;
using attn::ex2;
using attn::ldmatrix_x4;
using attn::ldmatrix_x4_trans;
using attn::mma_bf16;
using attn::pack_bf16;
using attn::split_p;
using attn::smem_u32;

template <int D>
struct MmaCfg {
  static constexpr int kWarps = 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kRows = 16 * kWarps;          // query rows per block
  static constexpr int kKeys = D <= 128 ? 64 : 32;   // keys per K/V tile
  static constexpr int kStride = D + 8;              // smem row (16-byte pad)
  static constexpr int kTile = kKeys * kStride;      // one K or V tile
  static constexpr bool kQRegs = D <= 128;           // Q fragments in regs
  static constexpr int kSmem =
      (kRows * kStride + 2 * 2 * kTile) * static_cast<int>(sizeof(bf16));
};

template <int D>
__global__ void __launch_bounds__(MmaCfg<D>::kThreads)
flash_fwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, bf16* __restrict__ out, int sq,
              int skv, int group, float scale, int causal) {
  using C = MmaCfg<D>;
  constexpr int kKSteps = D / 16;          // k16 steps of Q K^T
  constexpr int kSTiles = C::kKeys / 8;    // n8 tiles of S
  constexpr int kOTiles = D / 8;           // n8 tiles of O
  constexpr int kRowChunks = D / 8;        // 16-byte chunks of a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* kvs = qs + C::kRows * C::kStride;  // stage s: K, then V

  const int qtile = gridDim.x - 1 - blockIdx.x;      // heaviest first
  const long long bh = blockIdx.y;
  const long long kvh = bh / group;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = qtile * C::kRows;                 // the block's rows
  const int wrow0 = row0 + warp * 16;                // the warp's rows
  const bool warp_live = wrow0 < sq;
  const bf16* qb = q + bh * sq * D;
  const bf16* kb = k + kvh * skv * D;
  const bf16* vb = v + kvh * skv * D;

  // Q tile -> shared memory, rows past Sq zero
  for (int i = threadIdx.x; i < C::kRows * kRowChunks; i += C::kThreads) {
    const int r = i / kRowChunks, c = (i % kRowChunks) * 8;
    const int qi = row0 + r;
    const bool ok = qi < sq;
    cp_async16(smem_u32(qs + r * C::kStride + c),
               qb + static_cast<long long>(ok ? qi : 0) * D + c,
               ok ? 16 : 0);
  }
  cp_async_commit();

  // keys past the block's last row are masked for every row when causal
  const int kv_end = causal ? min(skv, row0 + C::kRows) : skv;
  const int n_tiles = (kv_end + C::kKeys - 1) / C::kKeys;

  auto load_tile = [&](int t) {
    bf16* ks = kvs + (t & 1) * 2 * C::kTile;
    bf16* vs = ks + C::kTile;
    const int k0 = t * C::kKeys;
    for (int i = threadIdx.x; i < C::kKeys * kRowChunks;
         i += C::kThreads) {
      const int r = i / kRowChunks, c = (i % kRowChunks) * 8;
      const int kk = k0 + r;
      const bool ok = kk < skv;      // zeros past the edge: never NaN
      const long long off = static_cast<long long>(ok ? kk : 0) * D + c;
      cp_async16(smem_u32(ks + r * C::kStride + c), kb + off, ok ? 16 : 0);
      cp_async16(smem_u32(vs + r * C::kStride + c), vb + off, ok ? 16 : 0);
    }
  };
  load_tile(0);
  cp_async_commit();

  // ldmatrix row addresses of this lane.  A (Q, 16x16): matrices rows
  // 0-7 / 8-15 x cols 0-7 / 8-15.  B from K (two n8 tiles x k16): keys
  // 0-7 / 8-15 x dims 0-7 / 8-15.  B from V (k16 x two n8 tiles, .trans):
  // keys 0-7 / 8-15 x dims 0-7 / 8-15.
  const int a_row = lane % 16, a_col = (lane / 16) * 8;
  const int bk_row = lane % 8 + (lane / 16) * 8, bk_col = (lane / 8) % 2 * 8;
  const int bv_row = lane % 8 + (lane / 8) % 2 * 8, bv_col = (lane / 16) * 8;
  const int gid = lane / 4, tig = lane % 4;    // C fragment: row, col pair

  uint32_t qf[C::kQRegs ? kKSteps : 1][4];
  const uint32_t q_addr =
      smem_u32(qs + (warp * 16 + a_row) * C::kStride + a_col);
  cp_async_wait<1>();                // Q has landed (tile 0 may not have)
  __syncthreads();
  if constexpr (C::kQRegs) {
#pragma unroll
    for (int kst = 0; kst < kKSteps; ++kst)
      ldmatrix_x4(qf[kst], q_addr + kst * 16 * sizeof(bf16));
  }

  float o[kOTiles][4];
#pragma unroll
  for (int n = 0; n < kOTiles; ++n)
    o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const float scale_log2 = scale * 1.4426950408889634f;

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) load_tile(t + 1);
    cp_async_commit();
    cp_async_wait<1>();              // tile t has landed
    __syncthreads();
    const bf16* ks = kvs + (t & 1) * 2 * C::kTile;
    const bf16* vs = ks + C::kTile;
    const int k0 = t * C::kKeys;
    // a warp skips a tile wholly above its last row (causal)
    if (warp_live && !(causal && k0 > wrow0 + 15)) {
      float s[kSTiles][4];
#pragma unroll
      for (int j = 0; j < kSTiles; ++j)
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const uint32_t k_addr =
          smem_u32(ks + bk_row * C::kStride + bk_col);
#pragma unroll
      for (int kst = 0; kst < kKSteps; ++kst) {
        uint32_t a[4];
        if constexpr (C::kQRegs) {
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = qf[kst][i];
        } else {
          ldmatrix_x4(a, q_addr + kst * 16 * sizeof(bf16));
        }
#pragma unroll
        for (int j2 = 0; j2 < kSTiles / 2; ++j2) {
          uint32_t b[4];
          ldmatrix_x4(b, k_addr + (j2 * 16 * C::kStride + kst * 16) *
                                      sizeof(bf16));
          mma_bf16(s[2 * j2], a, b[0], b[1]);
          mma_bf16(s[2 * j2 + 1], a, b[2], b[3]);
        }
      }

      // scale, mask (the ragged edge; causal keys past a row), row max
      const bool edge = k0 + C::kKeys > skv ||
                        (causal && k0 + C::kKeys - 1 > wrow0);
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < kSTiles; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * scale_log2;
          if (edge) {
            const int key = k0 + j * 8 + 2 * tig + (e & 1);
            const int qi = wrow0 + gid + (e >> 1) * 8;
            if (key >= skv || (causal && key > qi)) x = kNegInf;
          }
          s[j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
      float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        alpha[r] = ex2(m[r] - m_new);
        m[r] = m_new;
      }
#pragma unroll
      for (int j = 0; j < kSTiles; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ex2(s[j][e] - m[e >> 1]);
          s[j][e] = p;
          rs[e >> 1] += p;
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
      for (int n = 0; n < kOTiles; ++n) {
        o[n][0] *= alpha[0]; o[n][1] *= alpha[0];
        o[n][2] *= alpha[1]; o[n][3] *= alpha[1];
      }

      // O += P V: P's accumulators become A fragments in registers, as
      // two bf16 terms, each multiplied by the same V fragments
      const uint32_t v_addr = smem_u32(vs + bv_row * C::kStride + bv_col);
#pragma unroll
      for (int kk = 0; kk < C::kKeys / 16; ++kk) {
        uint32_t hi[4], lo[4];
        split_p(s[2 * kk], s[2 * kk + 1], hi, lo);
#pragma unroll
        for (int n2 = 0; n2 < D / 16; ++n2) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, v_addr + (kk * 16 * C::kStride + n2 * 16) *
                                            sizeof(bf16));
          mma_bf16(o[2 * n2], hi, b[0], b[1]);
          mma_bf16(o[2 * n2], lo, b[0], b[1]);
          mma_bf16(o[2 * n2 + 1], hi, b[2], b[3]);
          mma_bf16(o[2 * n2 + 1], lo, b[2], b[3]);
        }
      }
    }
    __syncthreads();                 // the next load overwrites this stage
  }

  if (warp_live) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(kFull, l[r], 1);
      l[r] += __shfl_xor_sync(kFull, l[r], 2);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = wrow0 + gid + r * 8;
      if (qi < sq) {
        const float den = fmaxf(l[r], 1e-30f);
        bf16* op = out + (bh * sq + qi) * D + 2 * tig;
#pragma unroll
        for (int n = 0; n < kOTiles; ++n)
          *reinterpret_cast<uint32_t*>(op + n * 8) =
              pack_bf16(o[n][2 * r] / den, o[n][2 * r + 1] / den);
      }
    }
  }
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       void* out, int bh, int group, int sq, int skv,
                       float scale, int causal, cudaStream_t s) {
  using C = MmaCfg<D>;
  static bool smem_set = false;      // past 48 KB needs the opt-in, once
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_mma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        C::kSmem);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  const dim3 grid((sq + C::kRows - 1) / C::kRows, bh);
  flash_fwd_mma<D><<<grid, C::kThreads, C::kSmem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), sq, skv, group,
      scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* out,
                     int bh, int group, int sq, int skv, int dtype,
                     float scale, int causal, cudaStream_t s) {
  return dtype == 1
      ? launch_mma<D>(q, k, v, out, bh, group, sq, skv, scale, causal, s)
      : launch_f32<D>(q, k, v, out, bh, group, sq, skv, scale, causal, s);
}

}  // namespace
}  // namespace repro

// bh is BHq, group G = BHq / BHkv; dtype: 0 float32, 1 bfloat16; scale is
// 1/sqrt(D) as the caller rounds it.  Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for a head dim without an instance).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int bh,
                                      int group, int sq, int skv, int d,
                                      int dtype, float scale, int causal,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bh <= 0 || sq <= 0) return cudaSuccess;
  if (group <= 0 || bh % group) return cudaErrorInvalidValue;
  switch (d) {
    case 16:
      return repro::launch_d<16>(q, k, v, out, bh, group, sq, skv, dtype,
                                 scale, causal, s);
    case 32:
      return repro::launch_d<32>(q, k, v, out, bh, group, sq, skv, dtype,
                                 scale, causal, s);
    case 64:
      return repro::launch_d<64>(q, k, v, out, bh, group, sq, skv, dtype,
                                 scale, causal, s);
    case 128:
      return repro::launch_d<128>(q, k, v, out, bh, group, sq, skv, dtype,
                                  scale, causal, s);
    case 256:
      return repro::launch_d<256>(q, k, v, out, bh, group, sq, skv, dtype,
                                  scale, causal, s);
    default:
      return cudaErrorInvalidValue;
  }
}
