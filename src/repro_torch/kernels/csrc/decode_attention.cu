// decode_attention — one query per row over a KV cache, on Hopper.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py::
// _decode_kernel (launched by decode_attention, wrapped by
// ops.decode_mha(impl="pallas")).  That kernel walks (BH, kv blocks) with
// the kv axis in order and carries an online softmax in VMEM scratch; it
// masks keys at or past each row's valid length.  Here one block owns one
// row and the kv axis becomes a loop inside it.
//
// Contract: q [BH, 1, D], k/v [BH, S, D], lengths [BH] int32, row-major,
// q/k/v all float32 or all bfloat16, D in {16, 32, 64, 128, 256}, any S.
//   out[r] = softmax over keys j < lengths[r] of q.k_j / sqrt(D), times v,
// accumulated in float32, in q's type.  As in the reference, a length past
// S means all S keys, and a length <= 0 masks every key (score -1e30), which
// weighs all S keys equally.
//
// Layout: 256 threads per row.  A group of D/8 lanes takes one key at a
// time, each lane 8 consecutive elements (one 16-byte load in bfloat16), so
// the groups of a warp read consecutive cache rows (at D = 256 a group is
// the whole warp, and the shuffle tree spans it); groups stride over the
// keys four at a time (all loads of the four keys issue before any math,
// to keep enough bytes in flight).  Each group sums its partial dots with
// shuffles and keeps its own running max, sum and 8-wide accumulator (an
// online softmax over the keys it saw).  At the end the block merges the
// groups' states through shared memory: the block max, the rescaled sum,
// and the rescaled weighted V sum, one thread per output element.
//
// Bound: bytes.  The function must read each row's K and V up to its valid
// length, 2*len*D elements per row, plus q and lengths, and write out; it
// does 4*D flops per key read, far below the ridge.  At 3.35 TB/s the least
// time is those bytes over the rate.  One block per row fills only BH of
// the 132 SMs; splitting the keys across blocks with a combine pass is
// later work.
#include "attention_common.cuh"
#include "common.cuh"

namespace repro {
namespace {

using attn::kNegInf;

constexpr int kBlock = 256;
constexpr int kElems = 8;        // elements per lane
constexpr int kUnroll = 4;       // keys per group per trip

template <int D, typename T>
__global__ void __launch_bounds__(kBlock)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ lengths,
              T* __restrict__ out, int s_len, float scale) {
  constexpr int kGroupLanes = D / kElems;            // 2, 4, 8, 16 or 32
  constexpr int kGroups = kBlock / kGroupLanes;
  __shared__ float m_s[kGroups], l_s[kGroups];
  __shared__ __align__(16) float acc_s[kGroups][D];

  const long long r = blockIdx.x;
  const int g = threadIdx.x / kGroupLanes, gl = threadIdx.x % kGroupLanes;
  const int col = gl * kElems;
  const int len = lengths[r];
  const bool none_valid = len <= 0;
  const int n_keys = none_valid ? s_len : min(len, s_len);
  const T* kb = k + r * s_len * D + col;
  const T* vb = v + r * s_len * D + col;

  float qr[kElems], acc[kElems];
  attn::load8(q + r * D + col, qr);
#pragma unroll
  for (int i = 0; i < kElems; ++i) acc[i] = 0.f;
  float m = kNegInf, l = 0.f;

  // every lane runs the same trips (the shuffles need the whole warp)
  for (int base = 0; base < n_keys; base += kGroups * kUnroll) {
    attn::Raw8<T> kr[kUnroll], vr[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = base + u * kGroups + g;
      if (j < n_keys) {
        attn::load_raw8(kb + static_cast<long long>(j) * D, kr[u]);
        attn::load_raw8(vb + static_cast<long long>(j) * D, vr[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = base + u * kGroups + g;
      float kx[kElems] = {};
      if (j < n_keys) attn::widen8(kr[u], kx);
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < kElems; ++i) part = fmaf(qr[i], kx[i], part);
#pragma unroll
      for (int o = kGroupLanes / 2; o > 0; o >>= 1)
        part += __shfl_xor_sync(kFull, part, o);
      if (j < n_keys) {
        const float sc = none_valid ? kNegInf : part * scale;
        if (sc > m) {
          const float alpha = expf(m - sc);
          l *= alpha;
#pragma unroll
          for (int i = 0; i < kElems; ++i) acc[i] *= alpha;
          m = sc;
        }
        const float p = expf(sc - m);
        float vx[kElems];
        attn::widen8(vr[u], vx);
        l += p;
#pragma unroll
        for (int i = 0; i < kElems; ++i) acc[i] = fmaf(p, vx[i], acc[i]);
      }
    }
  }

  if (gl == 0) {
    m_s[g] = m;
    l_s[g] = l;
  }
#pragma unroll
  for (int i = 0; i < kElems; ++i) acc_s[g][col + i] = acc[i];
  __syncthreads();

  if (threadIdx.x < D) {
    float mx = kNegInf;
    for (int h = 0; h < kGroups; ++h) mx = fmaxf(mx, m_s[h]);
    float lsum = 0.f, o = 0.f;
    for (int h = 0; h < kGroups; ++h) {
      const float w = expf(m_s[h] - mx);
      lsum = fmaf(l_s[h], w, lsum);
      o = fmaf(acc_s[h][threadIdx.x], w, o);
    }
    attn::store1(out + r * D + threadIdx.x, o / fmaxf(lsum, 1e-30f));
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* lengths, void* out, int bh, int s_len, int d,
                   float scale, cudaStream_t s) {
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const int* lp = static_cast<const int*>(lengths);
  T* op = static_cast<T*>(out);
  switch (d) {
    case 16:
      decode_kernel<16, T><<<bh, kBlock, 0, s>>>(qp, kp, vp, lp, op, s_len,
                                                 scale);
      break;
    case 32:
      decode_kernel<32, T><<<bh, kBlock, 0, s>>>(qp, kp, vp, lp, op, s_len,
                                                 scale);
      break;
    case 64:
      decode_kernel<64, T><<<bh, kBlock, 0, s>>>(qp, kp, vp, lp, op, s_len,
                                                 scale);
      break;
    case 128:
      decode_kernel<128, T><<<bh, kBlock, 0, s>>>(qp, kp, vp, lp, op, s_len,
                                                  scale);
      break;
    case 256:
      decode_kernel<256, T><<<bh, kBlock, 0, s>>>(qp, kp, vp, lp, op, s_len,
                                                  scale);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// dtype: 0 float32, 1 bfloat16; scale is 1/sqrt(D) as the caller rounds
// it.  Returns cudaGetLastError() after the launch (cudaErrorInvalidValue
// for a head dim without an instance).
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* lengths,
                                       void* out, int bh, int s_len, int d,
                                       int dtype, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bh <= 0) return cudaSuccess;
  if (dtype == 1)
    return repro::launch<__nv_bfloat16>(q, k, v, lengths, out, bh, s_len, d,
                                        scale, s);
  return repro::launch<float>(q, k, v, lengths, out, bh, s_len, d, scale, s);
}
