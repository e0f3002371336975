// Pieces shared by the two attention kernels: 4- and 8-element loads and
// stores of float32 or bfloat16 rows, widened to float, and the masked
// score of the reference kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

}  // namespace attn
}  // namespace repro
