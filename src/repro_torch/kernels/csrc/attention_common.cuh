// Pieces shared by the two attention kernels: 4- and 8-element loads and
// stores of float32 or bfloat16 rows, widened to float, the masked score of
// the reference kernels, and the Hopper (sm_80 and later) instructions of
// their tensor-core paths: ldmatrix, mma.sync m16n8k16, the split of P
// into two bf16 terms, and ex2 (cp.async is common.cuh's).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace repro {
namespace attn {

// The reference kernels' mask value: a masked score is -1e30, never -inf,
// so exp(-1e30 - m) is 0 after a real maximum and no row can give NaN.
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

// Rounds to nearest even, as torch's float -> bfloat16 cast does.
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(x.x, x.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(x.z, x.w);
  uint2 raw;
  raw.x = *reinterpret_cast<const unsigned*>(&a);
  raw.y = *reinterpret_cast<const unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = raw;
}

// 8 consecutive elements as raw bits (one 16-byte load for bfloat16, two
// for float32), so that a loop can issue several loads before it widens.
template <typename T> struct Raw8;
template <> struct Raw8<float> { float4 a, b; };
template <> struct Raw8<__nv_bfloat16> { uint4 a; };

__device__ __forceinline__ void load_raw8(const float* p, Raw8<float>& r) {
  r.a = reinterpret_cast<const float4*>(p)[0];
  r.b = reinterpret_cast<const float4*>(p)[1];
}

__device__ __forceinline__ void load_raw8(const __nv_bfloat16* p,
                                          Raw8<__nv_bfloat16>& r) {
  r.a = *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ void widen8(const Raw8<float>& r, float* x) {
  x[0] = r.a.x; x[1] = r.a.y; x[2] = r.a.z; x[3] = r.a.w;
  x[4] = r.b.x; x[5] = r.b.y; x[6] = r.b.z; x[7] = r.b.w;
}

__device__ __forceinline__ void widen8(const Raw8<__nv_bfloat16>& r,
                                       float* x) {
  const unsigned w[4] = {r.a.x, r.a.y, r.a.z, r.a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

template <typename T>
__device__ __forceinline__ void load8(const T* p, float* x) {
  Raw8<T> r;
  load_raw8(p, r);
  widen8(r, x);
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

using repro::cp_async16;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::smem_u32;

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, "
               "[%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
               "{%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a) : "memory");
}

// c[16x8 f32] += a[16x16 bf16, row] * b[16x8 bf16, col]
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
               "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
               : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0),
                 "r"(b1));
}

// two floats -> one register of two bf16 (lo in the low half), nearest even
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// P's two rows of an m16n8k16 A fragment, from the f32 accumulators of two
// m16n8 tiles s0 and s1 (the C layout of an m16n8 pair is the A layout of
// one k16 step), as two bf16 terms: hi = bf16(p) and lo = bf16(p - hi).
// hi + lo keeps about 16 bits of p, so P V by two products (hi V + lo V)
// holds the float32 P that the reference multiplies by V.
__device__ __forceinline__ void split_p(const float (&s0)[4],
                                        const float (&s1)[4],
                                        uint32_t (&hi)[4],
                                        uint32_t (&lo)[4]) {
  const float p[8] = {s0[0], s0[1], s0[2], s0[3], s1[0], s1[1], s1[2], s1[3]};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(p[2 * i], p[2 * i + 1]);
    const float2 hf = __bfloat1622float2(h);
    const __nv_bfloat162 l =
        __floats2bfloat162_rn(p[2 * i] - hf.x, p[2 * i + 1] - hf.y);
    hi[i] = *reinterpret_cast<const uint32_t*>(&h);
    lo[i] = *reinterpret_cast<const uint32_t*>(&l);
  }
}

// 2^x on the special-function unit, denormal results flushed to zero
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace attn
}  // namespace repro
