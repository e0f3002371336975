// flash_attention — blockwise online-softmax attention forward on Hopper.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::_flash_kernel
// (launched by flash_attention, wrapped by ops.mha(impl="pallas")).  That
// kernel walks a grid (BH, q blocks, kv blocks) whose kv axis runs in order
// on one core and carries the running max, sum and accumulator from grid
// step to grid step in VMEM scratch.  GPU blocks run in no order, so here
// the kv axis is a loop inside the block and the carry lives in registers.
//
// Contract: q [BH, Sq, D], k/v [BH, Skv, D], row-major, all float32 or all
// bfloat16, D in {16, 32, 64, 128, 256}.  out [BH, Sq, D] in q's type:
//   out = softmax(q k^T / sqrt(D), masked) v, accumulated in float32,
// with the reference kernel's causal rule k_idx <= q_idx (top-left), masked
// scores -1e30 (never -inf), and out = acc / max(l, 1e-30).  Any Sq and
// Skv: the ragged edge is masked (the reference asserts whole blocks).
//
// Layout: one block of 256 threads per (bh, tile of query rows); L threads
// per row (L = 4 up to D = 128, 64 rows a block; L = 8 at D = 256, 32 rows
// a block, so that a thread still holds only 32 floats of q and 32 of the
// accumulator in registers), each holding 1/L of the row's q and
// accumulator (dims c*4L + lane*4 .. +3 for chunk c, so the L threads of a
// row read one contiguous 16L-byte run of a shared-memory K/V row).  The
// block stages K/V tiles of float32 in shared memory (64 keys for D <= 64,
// 32 for D = 128, 16 for D = 256: at most 32 KB, under the 48 KB of static
// shared memory); each thread forms its partial dot products for the tile,
// the L threads of a row sum them by log2(L) shuffles, and the row's online
// softmax rescales the accumulator once per tile.  Causal blocks skip the
// K/V tiles that lie wholly above their last row, and the grid issues the
// heaviest (last) query tiles first.
//
// Products are scalar float32 FMAs (QK^T and PV both inside the kernel).
// Bound: operations.  The function needs 4*BH*Sq*Skv*D flops (half that
// when causal); bf16's tensor-core peak is 989 TFLOP/s, and the bytes (q,
// k, v in, out back) are far below that at every path shape.  This design
// runs on the CUDA cores at float32 rate (67 TFLOP/s at most), so it stays
// an order of magnitude from the bf16 bound; wgmma, TMA and a producer warp
// are later work.
#include "attention_common.cuh"
#include "common.cuh"

namespace repro {
namespace {

using attn::kNegInf;

constexpr int kBlock = 256;                  // threads per block

// threads per query row, and query rows per block, at head dim D
__host__ __device__ constexpr int lanes_for(int d) {
  return d <= 128 ? 4 : 8;
}
__host__ __device__ constexpr int rows_for(int d) {
  return kBlock / lanes_for(d);
}

template <int D, typename T>
__global__ void __launch_bounds__(kBlock)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int sq,
                 int skv, float scale, int causal) {
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
  const int row = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const int qi = qtile * kRows + row;
  const bool row_ok = qi < sq;
  const T* kb = k + bh * skv * D;
  const T* vb = v + bh * skv * D;

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
    T* o = out + (bh * sq + qi) * D;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      attn::store4(o + c * kSpan + lane * 4,
                   make_float4(acc[4 * c] / denom, acc[4 * c + 1] / denom,
                               acc[4 * c + 2] / denom,
                               acc[4 * c + 3] / denom));
    }
  }
}

template <int D, typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* out,
                     int bh, int sq, int skv, float scale, int causal,
                     cudaStream_t s) {
  constexpr int kRows = rows_for(D);
  const dim3 grid((sq + kRows - 1) / kRows, bh);
  flash_fwd_kernel<D, T><<<grid, kBlock, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), sq, skv, scale,
      causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int bh, int sq, int skv, int d, float scale, int causal,
                   cudaStream_t s) {
  switch (d) {
    case 16:
      return launch_d<16, T>(q, k, v, out, bh, sq, skv, scale, causal, s);
    case 32:
      return launch_d<32, T>(q, k, v, out, bh, sq, skv, scale, causal, s);
    case 64:
      return launch_d<64, T>(q, k, v, out, bh, sq, skv, scale, causal, s);
    case 128:
      return launch_d<128, T>(q, k, v, out, bh, sq, skv, scale, causal, s);
    case 256:
      return launch_d<256, T>(q, k, v, out, bh, sq, skv, scale, causal, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro

// dtype: 0 float32, 1 bfloat16; scale is 1/sqrt(D) as the caller rounds
// it.  Returns cudaGetLastError() after the launch (cudaErrorInvalidValue
// for a head dim without an instance).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int bh,
                                      int sq, int skv, int d, int dtype,
                                      float scale, int causal,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bh <= 0 || sq <= 0) return cudaSuccess;
  if (dtype == 1)
    return repro::launch<__nv_bfloat16>(q, k, v, out, bh, sq, skv, d,
                                        scale, causal, s);
  return repro::launch<float>(q, k, v, out, bh, sq, skv, d, scale, causal,
                              s);
}
