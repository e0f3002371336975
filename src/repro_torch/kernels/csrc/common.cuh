// Shared pieces of the hand-written Hopper kernels: the block size, the
// error text of an entry point, asynchronous copies into shared memory
// (cp.async), and the parts of the two tile scans
// (stream_compact, segment_reduce): tile geometry, 16-byte loads that stop
// at the window's end, the status words of a decoupled look-back (relaxed,
// or release/acquire where a payload word rides beside them), the size of a
// grid whose blocks loop over tiles, and the zero fill of an output's tail.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

constexpr int kThreads = 256;              // threads per block
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// A scan tile: each thread takes kScanItems consecutive rows.
constexpr int kScanItems = 16;
constexpr int kScanTile = kThreads * kScanItems;   // 4096 rows

// p[i, i + 4) as one int4, zeros past n; a 16-byte load when p + i is
// aligned (``vec``: p is 16-byte aligned, i is a multiple of 4) and whole.
__device__ __forceinline__ int4 load4(const int* __restrict__ p, long long i,
                                      long long n, bool vec) {
  if (vec && i + 3 < n) return __ldg(reinterpret_cast<const int4*>(p + i));
  int4 r;
  r.x = i < n ? __ldg(p + i) : 0;
  r.y = i + 1 < n ? __ldg(p + i + 1) : 0;
  r.z = i + 2 < n ? __ldg(p + i + 2) : 0;
  r.w = i + 3 < n ? __ldg(p + i + 3) : 0;
  return r;
}

// A tile's status word of the look-back: published with release semantics
// at GPU scope, read with acquire, so a reader that sees it also sees every
// write the publisher made before it (a separate payload word included).
__device__ __forceinline__ void store_release(unsigned long long* p,
                                              unsigned long long v) {
  asm volatile("st.release.gpu.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long load_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

// A status word that carries all its tile publishes: no other write of the
// publisher needs ordering, so relaxed (single-copy atomic) will do.
__device__ __forceinline__ void store_relaxed(unsigned long long* p,
                                              unsigned long long v) {
  asm volatile("st.relaxed.gpu.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long load_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

// A payload word written before a status word, read after it.
__device__ __forceinline__ int load_relaxed(const int* p) {
  int v;
  asm volatile("ld.relaxed.gpu.s32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

// Zero p[lo, hi), the grid's blocks striding over it, 16 bytes a store
// where p + i is 16-byte aligned.
__device__ __forceinline__ void zero_fill(int* __restrict__ p, long long lo,
                                          long long hi, long long first,
                                          long long stride) {
  long long head = lo;
  while (head < hi && (reinterpret_cast<uintptr_t>(p + head) & 15)) ++head;
  for (long long i = lo + first; i < head; i += stride) p[i] = 0;
  const long long quads = (hi - head) / 4;
  int4* q = reinterpret_cast<int4*>(p + head);
  for (long long i = first; i < quads; i += stride)
    q[i] = make_int4(0, 0, 0, 0);
  for (long long i = head + 4 * quads + first; i < hi; i += stride) p[i] = 0;
}

// Asynchronous copies global -> shared (sm_80 and later), each thread's
// copies committed in groups.  A src_bytes of 0 writes zeros, so the
// ragged edge of a tile needs no branch; src must still be a valid address.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes (dst and src 16-byte aligned), bypassing L1
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

// 4 bytes: one element, so that a copy can transpose a tile
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Blocks of ``kernel`` (kThreads threads, no dynamic shared memory) that fit
// on the current device at once, computed once per device.  A look-back
// grid takes at most this many blocks, each looping over tiles.  0 on a
// runtime error.
inline int resident_blocks(const void* kernel, int* cache) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cache[dev] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, 0) !=
            cudaSuccess)
      return 0;
    cache[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  return cache[dev];
}

}  // namespace repro

// Error text for a code returned by an entry point (ctypes cannot reach
// the runtime's own function without linking to it).
extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
