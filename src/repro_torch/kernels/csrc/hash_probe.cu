// hash_probe — open-addressing hash lookup (the hash_table app's hot loop),
// on Hopper.
//
// Replaces the TPU kernel src/repro/kernels/hash_probe.py::_probe_kernel
// (launched by hash_probe, wrapped by ops.hash_lookup).  That kernel keeps
// the whole padded table in VMEM and walks a block of 256 keys through all
// max_probes rounds as masked vector gathers; the reference sends tables
// above 2^20 entries to an XLA gather loop.  Here one thread owns one key
// and walks its own chain, stopping at the first hit or EMPTY slot, so a key
// costs the probes its chain needs, not max_probes.  Hopper's counterpart of
// VMEM is its 50 MB L2, which holds every table the TPU kernel takes (2^20
// entries, 8 MB of both tables).  Keys are read and outputs written with
// evict-first hints, so that a long stream of queries does not push the
// table out of L2.
//
// Contract: keys [N] int32; table_k / table_v [L] int32 (the reference
// duplicates an n_slots table to L = 2 * n_slots so that probes never wrap);
// out [2N] int32: vals in out[0, N), found in out[N, 2N).
// h = mix(uint32(key)) % n_slots, with
//   mix(x) = x ^ (x >> 16); x *= 0x45D9F3B; x ^= x >> 16   (uint32)
// then for p < max_probes: slot h + p; a slot holding the key answers
// (val = table_v, found = 1) before an EMPTY (0) slot ends the walk, so key
// 0 is found at an empty slot, as in the reference.  The walk also ends at
// the end of the table (slot L): the kernel never reads past it, where the
// reference's jnp.take returns INT32_MIN for an out-of-range slot.
//
// Bound: bytes, 4 N keys in, 8 N words out, plus each 32-byte sector of
// table_k that a chain touches and of table_v that holds a hit, once (count
// from the data).  On a table larger than L2 this walk reads a sector from
// HBM once per query that lands on it, at the card's rate for random 32-byte
// reads, not once.
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
    unsigned n_slots, int max_probes, int* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads
                      + threadIdx.x;
  if (i >= n) return;
  const int key = __ldcs(keys + i);
  const long long h = mix(static_cast<unsigned>(key)) % n_slots;
  int v = 0, f = 0;
  for (int p = 0; p < max_probes && h + p < table_len; ++p) {
    const int ck = __ldg(table_k + h + p);
    if (ck == key) {
      v = __ldg(table_v + h + p);
      f = 1;
      break;
    }
    if (ck == 0) break;
  }
  __stcs(out + i, v);
  __stcs(out + n + i, f);
}

}  // namespace
}  // namespace repro

// Entry point for ctypes.  Returns a cudaError_t code (0 = launched).
extern "C" int hash_probe_launch(const void* keys, const void* table_k,
                                 const void* table_v, long long n,
                                 long long table_len, unsigned n_slots,
                                 int max_probes, void* out, void* stream) {
  if (n < 0 || table_len < 0 || n_slots == 0 || max_probes < 0)
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const long long blocks = (n + repro::kThreads - 1) / repro::kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  repro::hash_probe_kernel<<<static_cast<unsigned>(blocks), repro::kThreads,
                             0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(keys), static_cast<const int*>(table_k),
      static_cast<const int*>(table_v), n, table_len, n_slots, max_probes,
      static_cast<int*>(out));
  return cudaGetLastError();
}
