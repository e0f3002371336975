// hash_probe — open-addressing hash lookup (the hash_table app's hot loop),
// on Hopper.
//
// Replaces the TPU kernel src/repro/kernels/hash_probe.py::_probe_kernel
// (launched by hash_probe, wrapped by ops.hash_lookup).  That kernel keeps
// the whole padded table in VMEM and walks a block of 256 keys through all
// max_probes rounds as masked vector gathers.  Here one thread owns one key
// and walks its own chain, stopping at the first hit or EMPTY slot, so a key
// costs the probes its chain needs, not max_probes; the table stays in
// device memory and L2 (50 MB) holds the small ones.
//
// Contract: keys [N] int32; table_k / table_v [L] int32 (the reference
// duplicates an n_slots table to L = 2 * n_slots so that probes never wrap);
// out vals / found [N] int32.  h = mix(uint32(key)) % n_slots, with
//   mix(x) = x ^ (x >> 16); x *= 0x45D9F3B; x ^= x >> 16   (uint32)
// then for p < max_probes: slot h + p; a slot holding the key answers
// (val = table_v, found = 1) before an EMPTY (0) slot ends the walk, so key
// 0 is found at an empty slot, as in the reference.  The walk also ends at
// the end of the table (slot L): the kernel never reads past it, where the
// reference's jnp.take returns INT32_MIN for an out-of-range slot.
//
// Bound: bytes, 4 N keys in, 8 N words out, plus the table: read once when
// it fits L2, else one 32-byte sector of table_k per sector a chain touches
// and one of table_v per hit (count from the data).  One key per thread
// keeps a load of each thread in flight per probe; 256-thread blocks.
#include "common.cuh"

namespace repro {
namespace {

__device__ __forceinline__ unsigned mix(unsigned x) {
  x ^= x >> 16;
  x *= 0x45D9F3Bu;
  x ^= x >> 16;
  return x;
}

__global__ void __launch_bounds__(kThreads) hash_probe_kernel(
    const int* __restrict__ keys, const int* __restrict__ table_k,
    const int* __restrict__ table_v, long long n, long long table_len,
    unsigned n_slots, int max_probes, int* __restrict__ vals,
    int* __restrict__ found) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads
                      + threadIdx.x;
  if (i >= n) return;
  const int key = keys[i];
  const long long h = mix(static_cast<unsigned>(key)) % n_slots;
  int v = 0, f = 0;
  for (int p = 0; p < max_probes && h + p < table_len; ++p) {
    const int ck = table_k[h + p];
    if (ck == key) {
      v = table_v[h + p];
      f = 1;
      break;
    }
    if (ck == 0) break;
  }
  vals[i] = v;
  found[i] = f;
}

}  // namespace
}  // namespace repro

// Entry point for ctypes.  Returns a cudaError_t code (0 = launched).
extern "C" int hash_probe_launch(const void* keys, const void* table_k,
                                 const void* table_v, long long n,
                                 long long table_len, unsigned n_slots,
                                 int max_probes, void* vals, void* found,
                                 void* stream) {
  if (n < 0 || table_len < 0 || n_slots == 0 || max_probes < 0)
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const long long blocks = (n + repro::kThreads - 1) / repro::kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  repro::hash_probe_kernel<<<static_cast<unsigned>(blocks), repro::kThreads,
                             0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(keys), static_cast<const int*>(table_k),
      static_cast<const int*>(table_v), n, table_len, n_slots, max_probes,
      static_cast<int*>(vals), static_cast<int*>(found));
  return cudaGetLastError();
}
