// decode_attention — one query per row over a KV cache, on Hopper, with
// the keys split over blocks.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py::
// _decode_kernel (launched by decode_attention, wrapped by
// ops.decode_mha(impl="pallas")).  That kernel walks (BH, kv blocks) with
// the kv axis in order and carries an online softmax in VMEM scratch; it
// masks keys at or past each row's valid length.  Here the kv axis is cut
// into chunks that blocks take in parallel, and a second pass merges them.
//
// Contract: q [BHq, 1, D], k/v [BHkv, S, D], lengths [BHkv] int32, with
// BHq = G * BHkv, row-major, q/k/v all float32 or all bfloat16, D in
// {16, 32, 64, 128, 256}, any S.  Query rows r*G .. r*G + G-1 read kv row r
// and share its length (GQA by index: K/V are never copied).
//   out[i] = softmax over keys j < lengths[i / G] of q_i.k_j * scale,
// times v, accumulated in float32, in q's type.  As in the reference, a
// length past S means all S keys, and a length <= 0 masks every key (score
// -1e30), which weighs all S keys equally.
//
// Bound: bytes.  The function must read each kv row's K and V up to its
// valid length, 2*len*D elements per kv row (once, for all G query rows),
// plus q and the output per query row and the lengths; it does 4*D*G flops
// per key, below the ridge at every G the models use.  At 3.35 TB/s the
// least time is those bytes over the rate.
//
// Pass 1, grid (n_split, BHkv): block (c, r) takes keys [c*chunk,
// (c+1)*chunk) of kv row r, cut at the row's valid length, for all G query
// rows of r, so each K/V element leaves device memory once.  Two designs:
//
// bfloat16 with 2 <= G <= 16 (decode_mma_kernel, 128 threads): the G
// query rows form one m16 tile (zero rows below them) on the tensor cores,
// flash_attention.cu's tile step: each of 4 warps copies every 4th tile
// of the chunk's keys into its own shared-memory slot (cp.async) and runs
// S = Q K^T and O += P V by mma.sync m16n8k16 with an online softmax in
// log2 units, P as two bf16 terms (hi V + lo V, as in flash, so P V keeps
// the reference's float32 P); the warps merge through shared memory.
//
// Otherwise (decode_split_kernel, 256 threads; float32, and bfloat16 at
// G = 1, where an m16 tile would waste 15 rows, or G > 16): it streams the
// chunk through a 2-stage cp.async ring of K/V tiles in dynamic shared
// memory (16 KB each of K and V a stage, the next tile in flight while the
// block computes on this one).  The threads form groups of D/8 lanes, each
// lane holding 8 consecutive elements; the groups split into head slots
// (min(G, groups)) and key slots (the rest): a group keeps kH of the G
// query rows (q, an 8-wide accumulator, a running max and sum each) in
// registers and walks its key slot's keys of each tile, four keys a trip
// (their dot products and shuffle trees overlap), every lane of a warp
// running the same trips (the shuffles need the whole warp).  At the end
// the block merges its key slots through shared memory (the tiles' space).
//
// Both write each query row's (m, l, acc[D]) for their chunk in float32,
// m in natural units — or, when n_split == 1, the output itself.
//
// Pass 2 (decode_combine_kernel), one thread per output element: M = max
// m_c, w_c = exp(m_c - M), out = sum(w_c acc_c) / max(sum(w_c l_c), 1e-30).
// A chunk with no keys is (-1e30, 0, 0): it weighs nothing after a real
// maximum, and adds 0 when every key is masked (the S keys then weigh 1
// each in the chunks that hold them).  decode_attention_split_plain in
// decode_attention.py is the same arithmetic in plain torch.
#include <type_traits>

#include "attention_common.cuh"
#include "common.cuh"

namespace repro {
namespace {

using attn::kNegInf;

constexpr int kBlock = 256;
constexpr int kElems = 8;        // elements per lane
constexpr int kUnroll = 4;       // keys per group per trip
constexpr int kTileBytes = 16384;  // one K (or V) tile of a stage

template <int D, typename T>
struct DecCfg {
  static constexpr int kGroupLanes = D / kElems;        // 2 .. 32
  static constexpr int kGroups = kBlock / kGroupLanes;  // 128 .. 8
  static constexpr int kTileKeys = kTileBytes / (D * int(sizeof(T)));
  static constexpr int kRowChunks = D * int(sizeof(T)) / 16;
  static constexpr int kSmem = 2 * 2 * kTileBytes;      // 2 stages of K, V
};

using bf16 = __nv_bfloat16;
using attn::cp_async16;
using attn::cp_async_commit;
using attn::cp_async_wait;
using attn::ex2;
using attn::ldmatrix_x4;
using attn::ldmatrix_x4_trans;
using attn::mma_bf16;
using attn::split_p;
using attn::smem_u32;

template <int D, typename T, int kH>
__global__ void __launch_bounds__(kBlock)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ lengths,
                    T* __restrict__ out, float* __restrict__ part_ml,
                    float* __restrict__ part_acc, int g_heads, int s_len,
                    int n_split, int chunk, float scale) {
  using C = DecCfg<D, T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tiles = reinterpret_cast<T*>(smem_raw);
  constexpr int kTileElems = C::kTileKeys * D;

  const int c = blockIdx.x;
  const long long r = blockIdx.y;
  const int len = lengths[r];
  const bool none_valid = len <= 0;
  const int n_keys = none_valid ? s_len : min(len, s_len);
  const int c0 = c * chunk;
  const int keys = max(0, min(c0 + chunk, n_keys) - c0);
  const T* kb = k + (r * s_len + c0) * D;
  const T* vb = v + (r * s_len + c0) * D;

  // lane groups: head slots x key slots (groups past both stay idle)
  const int gi = threadIdx.x / C::kGroupLanes;
  const int col = (threadIdx.x % C::kGroupLanes) * kElems;
  const int n_hs = min(g_heads, C::kGroups);
  const int n_ks = C::kGroups / n_hs;
  const int hs = gi % n_hs, ksl = gi / n_hs;
  const bool active = ksl < n_ks;

  float qr[kH][kElems], acc[kH][kElems], m[kH], l[kH];
#pragma unroll
  for (int i = 0; i < kH; ++i) {
    const int h = hs + n_hs * i;
    if (h < g_heads) {
      attn::load8(q + (r * g_heads + h) * D + col, qr[i]);
    } else {
#pragma unroll
      for (int e = 0; e < kElems; ++e) qr[i][e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < kElems; ++e) acc[i][e] = 0.f;
    m[i] = kNegInf;
    l[i] = 0.f;
  }

  auto load_tile = [&](int t) {
    T* ks = tiles + (t & 1) * 2 * kTileElems;
    T* vs = ks + kTileElems;
    const T* kt = kb + static_cast<long long>(t) * kTileElems;
    const T* vt = vb + static_cast<long long>(t) * kTileElems;
    const int n =
        min(C::kTileKeys, keys - t * C::kTileKeys) * C::kRowChunks;
    for (int i = threadIdx.x; i < n; i += kBlock) {
      const int e = i * (16 / int(sizeof(T)));     // 16 bytes a copy
      cp_async16(smem_u32(ks + e), kt + e, 16);
      cp_async16(smem_u32(vs + e), vt + e, 16);
    }
  };
  const int n_tiles = (keys + C::kTileKeys - 1) / C::kTileKeys;
  if (n_tiles > 0) load_tile(0);
  cp_async_commit();
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) load_tile(t + 1);
    cp_async_commit();
    cp_async_wait<1>();              // tile t has landed
    __syncthreads();
    const T* ks = tiles + (t & 1) * 2 * kTileElems;
    const T* vs = ks + kTileElems;
    const int tv = min(C::kTileKeys, keys - t * C::kTileKeys);
    // kUnroll keys per group per trip: their dot products and shuffle
    // trees are independent, so they overlap
    const int per_trip = n_ks * kUnroll;
    const int trips = (tv + per_trip - 1) / per_trip;   // same for all lanes
    for (int u = 0; u < trips; ++u) {
      int j[kUnroll];
      bool ok[kUnroll];
      float kx[kUnroll][kElems];
#pragma unroll
      for (int w = 0; w < kUnroll; ++w) {
        j[w] = ksl + n_ks * (u * kUnroll + w);
        ok[w] = active && j[w] < tv;
#pragma unroll
        for (int e = 0; e < kElems; ++e) kx[w][e] = 0.f;
        if (ok[w]) attn::load8(ks + j[w] * D + col, kx[w]);
      }
#pragma unroll
      for (int i = 0; i < kH; ++i) {
        float part[kUnroll];
#pragma unroll
        for (int w = 0; w < kUnroll; ++w) {
          part[w] = 0.f;
#pragma unroll
          for (int e = 0; e < kElems; ++e)
            part[w] = fmaf(qr[i][e], kx[w][e], part[w]);
        }
#pragma unroll
        for (int o = C::kGroupLanes / 2; o > 0; o >>= 1) {
#pragma unroll
          for (int w = 0; w < kUnroll; ++w)
            part[w] += __shfl_xor_sync(kFull, part[w], o);
        }
        if (hs + n_hs * i >= g_heads) continue;
        // the online softmax over this trip's valid keys, in key order
        float sc[kUnroll], mx = m[i];
#pragma unroll
        for (int w = 0; w < kUnroll; ++w) {
          sc[w] = none_valid ? kNegInf : part[w] * scale;
          if (ok[w]) mx = fmaxf(mx, sc[w]);
        }
        if (mx > m[i]) {
          const float alpha = expf(m[i] - mx);
          l[i] *= alpha;
#pragma unroll
          for (int e = 0; e < kElems; ++e) acc[i][e] *= alpha;
          m[i] = mx;
        }
#pragma unroll
        for (int w = 0; w < kUnroll; ++w) {
          if (!ok[w]) continue;
          const float p = expf(sc[w] - m[i]);
          float vx[kElems];
          attn::load8(vs + j[w] * D + col, vx);
          l[i] += p;
#pragma unroll
          for (int e = 0; e < kElems; ++e)
            acc[i][e] = fmaf(p, vx[e], acc[i][e]);
        }
      }
    }
    __syncthreads();                 // the next load overwrites this stage
  }

  // merge the key slots through shared memory (the tiles are done)
  float* acc_s = reinterpret_cast<float*>(smem_raw);   // [groups][kH][D]
  float* m_s = acc_s + C::kGroups * kH * D;             // [groups][kH]
  float* l_s = m_s + C::kGroups * kH;
  if (active) {
#pragma unroll
    for (int i = 0; i < kH; ++i) {
      if (col == 0) {
        m_s[gi * kH + i] = m[i];
        l_s[gi * kH + i] = l[i];
      }
#pragma unroll
      for (int e = 0; e < kElems; ++e)
        acc_s[(gi * kH + i) * D + col + e] = acc[i][e];
    }
  }
  __syncthreads();
  for (int x = threadIdx.x; x < g_heads * D; x += kBlock) {
    const int h = x / D, d = x % D;
    const int slot = h % n_hs, i = h / n_hs;
    float mx = kNegInf;
    for (int s = 0; s < n_ks; ++s)
      mx = fmaxf(mx, m_s[(slot + n_hs * s) * kH + i]);
    float lsum = 0.f, o = 0.f;
    for (int s = 0; s < n_ks; ++s) {
      const int at = (slot + n_hs * s) * kH + i;
      const float w = expf(m_s[at] - mx);
      lsum = fmaf(l_s[at], w, lsum);
      o = fmaf(acc_s[at * D + d], w, o);
    }
    const long long row = r * g_heads + h;
    if (n_split == 1) {
      attn::store1(out + row * D + d, o / fmaxf(lsum, 1e-30f));
    } else {
      const long long part = row * n_split + c;
      part_acc[part * D + d] = o;
      if (d == 0) {
        part_ml[2 * part] = mx;
        part_ml[2 * part + 1] = lsum;
      }
    }
  }
}

// bfloat16 with 2 <= G <= 16: the G query rows of a kv row form one m16
// tile on the tensor cores.  Each of 4 warps takes every 4th tile of the
// chunk's keys (64 a tile, 32 at D = 256) into its own slot of shared
// memory (cp.async, rows past the chunk's keys zero) and runs flash's tile
// step on it: S = Q K^T and O += P V by mma.sync m16n8k16, an online
// softmax in log2 units on the accumulator fragments, P split into two
// bf16 terms in registers (attn::split_p).  Keys past the chunk's valid
// ones score -inf (they are no keys: weight 0 even when every real key is
// masked at -1e30).  The warps' states then merge through shared memory
// into the chunk's (m, l, acc).
// -inf: the score of a slot past the chunk's keys, which is no key at all
__device__ __forceinline__ float no_key() {
  return -__int_as_float(0x7f800000);
}

template <int D>
struct DecMmaCfg {
  static constexpr int kWarps = 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kKeys = D <= 128 ? 64 : 32;   // keys per warp tile
  static constexpr int kStride = D + 8;              // smem row (16-byte pad)
  static constexpr int kTile = kKeys * kStride;      // one K or V tile
  static constexpr bool kQRegs = D <= 128;           // Q fragments in regs
  static constexpr int kSmem =
      (16 * kStride + kWarps * 2 * kTile) * static_cast<int>(sizeof(bf16));
  static_assert(kWarps * 16 * (D + 2) * 4 <= kSmem, "merge area");
};

template <int D>
__global__ void __launch_bounds__(DecMmaCfg<D>::kThreads)
decode_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v,
                  const int* __restrict__ lengths, bf16* __restrict__ out,
                  float* __restrict__ part_ml, float* __restrict__ part_acc,
                  int g_heads, int s_len, int n_split, int chunk,
                  float scale) {
  using C = DecMmaCfg<D>;
  constexpr int kKSteps = D / 16;          // k16 steps of Q K^T
  constexpr int kSTiles = C::kKeys / 8;    // n8 tiles of S
  constexpr int kOTiles = D / 8;           // n8 tiles of O
  constexpr int kRowChunks = D / 8;        // 16-byte chunks of a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + 16 * C::kStride + warp * 2 * C::kTile;   // this warp's
  bf16* vs = ks + C::kTile;

  const int c = blockIdx.x;
  const long long r = blockIdx.y;
  const int len = lengths[r];
  const bool none_valid = len <= 0;
  const int n_keys = none_valid ? s_len : min(len, s_len);
  const int c0 = c * chunk;
  const int keys = max(0, min(c0 + chunk, n_keys) - c0);
  const bf16* kb = k + (r * s_len + c0) * D;
  const bf16* vb = v + (r * s_len + c0) * D;

  // Q: the G query rows of kv row r, zero rows below them
  for (int i = threadIdx.x; i < 16 * kRowChunks; i += C::kThreads) {
    const int h = i / kRowChunks, col = (i % kRowChunks) * 8;
    const bool ok = h < g_heads;
    cp_async16(smem_u32(qs + h * C::kStride + col),
               q + (r * g_heads + (ok ? h : 0)) * D + col, ok ? 16 : 0);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // ldmatrix rows of this lane and the C fragment's row / column pair, as
  // in flash_attention.cu
  const int a_row = lane % 16, a_col = (lane / 16) * 8;
  const int bk_row = lane % 8 + (lane / 16) * 8, bk_col = (lane / 8) % 2 * 8;
  const int bv_row = lane % 8 + (lane / 8) % 2 * 8, bv_col = (lane / 16) * 8;
  const int gid = lane / 4, tig = lane % 4;
  const uint32_t q_addr = smem_u32(qs + a_row * C::kStride + a_col);
  uint32_t qf[C::kQRegs ? kKSteps : 1][4];
  if constexpr (C::kQRegs) {
#pragma unroll
    for (int kst = 0; kst < kKSteps; ++kst)
      ldmatrix_x4(qf[kst], q_addr + kst * 16 * sizeof(bf16));
  }

  float o[kOTiles][4];
#pragma unroll
  for (int n = 0; n < kOTiles; ++n)
    o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {no_key(), no_key()}, l[2] = {0.f, 0.f};
  const float scale_log2 = scale * 1.4426950408889634f;
  const uint32_t k_addr = smem_u32(ks + bk_row * C::kStride + bk_col);
  const uint32_t v_addr = smem_u32(vs + bv_row * C::kStride + bv_col);

  for (int t = warp; t * C::kKeys < keys; t += C::kWarps) {
    const int k0 = t * C::kKeys;
    for (int i = lane; i < C::kKeys * kRowChunks; i += 32) {
      const int row = i / kRowChunks, col = (i % kRowChunks) * 8;
      const bool ok = k0 + row < keys;
      const long long off = static_cast<long long>(ok ? k0 + row : 0) * D +
                            col;
      cp_async16(smem_u32(ks + row * C::kStride + col), kb + off,
                 ok ? 16 : 0);
      cp_async16(smem_u32(vs + row * C::kStride + col), vb + off,
                 ok ? 16 : 0);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncwarp();

    float s[kSTiles][4];
#pragma unroll
    for (int j = 0; j < kSTiles; ++j)
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
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

    const bool edge = k0 + C::kKeys > keys;
    float mx[2] = {no_key(), no_key()};
#pragma unroll
    for (int j = 0; j < kSTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = none_valid ? kNegInf : s[j][e] * scale_log2;
        if (edge && k0 + j * 8 + 2 * tig + (e & 1) >= keys) x = no_key();
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(kFull, mx[rr], 1));
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(kFull, mx[rr], 2));
      const float m_new = fmaxf(m[rr], mx[rr]);   // finite: a tile holds a key
      alpha[rr] = ex2(m[rr] - m_new);
      m[rr] = m_new;
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
    for (int rr = 0; rr < 2; ++rr) l[rr] = l[rr] * alpha[rr] + rs[rr];
#pragma unroll
    for (int n = 0; n < kOTiles; ++n) {
      o[n][0] *= alpha[0]; o[n][1] *= alpha[0];
      o[n][2] *= alpha[1]; o[n][3] *= alpha[1];
    }
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
    __syncwarp();                    // the next tile overwrites ks / vs
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    l[rr] += __shfl_xor_sync(kFull, l[rr], 1);
    l[rr] += __shfl_xor_sync(kFull, l[rr], 2);
  }

  // merge the warps' states through shared memory (Q and the tiles are done)
  __syncthreads();
  float* o_s = reinterpret_cast<float*>(smem_raw);     // [warps][16][D]
  float* m_s = o_s + C::kWarps * 16 * D;               // [warps][16]
  float* l_s = m_s + C::kWarps * 16;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = warp * 16 + gid + rr * 8;
    if (tig == 0) {
      m_s[row] = m[rr];
      l_s[row] = l[rr];
    }
#pragma unroll
    for (int n = 0; n < kOTiles; ++n) {
      o_s[row * D + n * 8 + 2 * tig] = o[n][2 * rr];
      o_s[row * D + n * 8 + 2 * tig + 1] = o[n][2 * rr + 1];
    }
  }
  __syncthreads();
  for (int x = threadIdx.x; x < g_heads * D; x += C::kThreads) {
    const int h = x / D, d = x % D;
    float mx = no_key();
#pragma unroll
    for (int w = 0; w < C::kWarps; ++w) mx = fmaxf(mx, m_s[w * 16 + h]);
    float lsum = 0.f, acc = 0.f;
    if (mx != no_key()) {            // else the chunk holds no key
#pragma unroll
      for (int w = 0; w < C::kWarps; ++w) {
        const float wt = ex2(m_s[w * 16 + h] - mx);
        lsum = fmaf(l_s[w * 16 + h], wt, lsum);
        acc = fmaf(o_s[(w * 16 + h) * D + d], wt, acc);
      }
    }
    const long long row = r * g_heads + h;
    if (n_split == 1) {
      attn::store1(out + row * D + d, acc / fmaxf(lsum, 1e-30f));
    } else {
      const long long part = row * n_split + c;
      part_acc[part * D + d] = acc;
      if (d == 0) {                  // m back in natural units
        part_ml[2 * part] =
            mx == no_key() ? kNegInf : mx * 0.6931471805599453f;
        part_ml[2 * part + 1] = lsum;
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kBlock)
decode_combine_kernel(const float* __restrict__ part_ml,
                      const float* __restrict__ part_acc,
                      T* __restrict__ out, long long n_out, int d,
                      int n_split) {
  const long long x = blockIdx.x * static_cast<long long>(kBlock) +
                      threadIdx.x;
  if (x >= n_out) return;
  const long long row = x / d;
  const int e = static_cast<int>(x % d);
  const float* ml = part_ml + 2 * row * n_split;
  float mx = kNegInf;
  for (int c = 0; c < n_split; ++c) mx = fmaxf(mx, ml[2 * c]);
  float lsum = 0.f, o = 0.f;
  for (int c = 0; c < n_split; ++c) {
    const float w = expf(ml[2 * c] - mx);
    lsum = fmaf(ml[2 * c + 1], w, lsum);
    o = fmaf(part_acc[(row * n_split + c) * d + e], w, o);
  }
  attn::store1(out + x, o / fmaxf(lsum, 1e-30f));
}

// pass 2, when there is more than one chunk
template <typename T>
cudaError_t launch_combine(const float* part_ml, const float* part_acc,
                           T* out, int bhkv, int g_heads, int d, int n_split,
                           cudaStream_t s) {
  if (n_split == 1) return cudaSuccess;
  const long long n_out = static_cast<long long>(bhkv) * g_heads * d;
  decode_combine_kernel<T><<<static_cast<unsigned>((n_out + kBlock - 1) /
                                                   kBlock),
                             kBlock, 0, s>>>(part_ml, part_acc, out, n_out,
                                             d, n_split);
  return cudaGetLastError();
}

template <int D, typename T, int kH>
cudaError_t launch_split(const T* q, const T* k, const T* v,
                         const int* lengths, T* out, float* part_ml,
                         float* part_acc, int bhkv, int g_heads, int s_len,
                         int n_split, float scale, cudaStream_t s) {
  using C = DecCfg<D, T>;
  static bool smem_set = false;      // past 48 KB needs the opt-in, once
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_split_kernel<D, T, kH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  const int chunk = (s_len + n_split - 1) / n_split;
  decode_split_kernel<D, T, kH><<<dim3(n_split, bhkv), kBlock, C::kSmem,
                                  s>>>(q, k, v, lengths, out, part_ml,
                                       part_acc, g_heads, s_len, n_split,
                                       chunk, scale);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return launch_combine<T>(part_ml, part_acc, out, bhkv, g_heads, D,
                           n_split, s);
}

template <int D>
cudaError_t launch_mma(const bf16* q, const bf16* k, const bf16* v,
                       const int* lengths, bf16* out, float* part_ml,
                       float* part_acc, int bhkv, int g_heads, int s_len,
                       int n_split, float scale, cudaStream_t s) {
  using C = DecMmaCfg<D>;
  static bool smem_set = false;      // past 48 KB needs the opt-in, once
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        C::kSmem);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  const int chunk = (s_len + n_split - 1) / n_split;
  decode_mma_kernel<D><<<dim3(n_split, bhkv), C::kThreads, C::kSmem, s>>>(
      q, k, v, lengths, out, part_ml, part_acc, g_heads, s_len, n_split,
      chunk, scale);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return launch_combine<bf16>(part_ml, part_acc, out, bhkv, g_heads, D,
                              n_split, s);
}

template <int D, typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v,
                     const void* lengths, void* out, float* part_ml,
                     float* part_acc, int bhkv, int g_heads, int s_len,
                     int n_split, int kh, float scale, cudaStream_t s) {
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const int* lp = static_cast<const int*>(lengths);
  T* op = static_cast<T*>(out);
  if constexpr (std::is_same<T, bf16>::value) {
    if (g_heads >= 2 && g_heads <= 16)
      return launch_mma<D>(qp, kp, vp, lp, op, part_ml, part_acc, bhkv,
                           g_heads, s_len, n_split, scale, s);
  }
  switch (kh) {
    case 1:
      return launch_split<D, T, 1>(qp, kp, vp, lp, op, part_ml, part_acc,
                                   bhkv, g_heads, s_len, n_split, scale, s);
    case 2:
      return launch_split<D, T, 2>(qp, kp, vp, lp, op, part_ml, part_acc,
                                   bhkv, g_heads, s_len, n_split, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* lengths, void* out, float* part_ml,
                   float* part_acc, int bhkv, int g_heads, int s_len, int d,
                   int n_split, int kh, float scale, cudaStream_t s) {
  switch (d) {
    case 16:
      return launch_d<16, T>(q, k, v, lengths, out, part_ml, part_acc, bhkv,
                             g_heads, s_len, n_split, kh, scale, s);
    case 32:
      return launch_d<32, T>(q, k, v, lengths, out, part_ml, part_acc, bhkv,
                             g_heads, s_len, n_split, kh, scale, s);
    case 64:
      return launch_d<64, T>(q, k, v, lengths, out, part_ml, part_acc, bhkv,
                             g_heads, s_len, n_split, kh, scale, s);
    case 128:
      return launch_d<128, T>(q, k, v, lengths, out, part_ml, part_acc,
                              bhkv, g_heads, s_len, n_split, kh, scale, s);
    case 256:
      return launch_d<256, T>(q, k, v, lengths, out, part_ml, part_acc,
                              bhkv, g_heads, s_len, n_split, kh, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro

// bhkv kv rows of g_heads query rows each; n_split chunks of
// ceil(s_len / n_split) keys per kv row; kh is the split kernel's instance
// (query rows a lane group keeps, 1 or 2, with kh * min(g_heads,
// 2048 / d) >= g_heads).  part_ml [BHq * n_split * 2] and part_acc
// [BHq * n_split * d] are float32 scratch, unused (may be null) when
// n_split == 1.  dtype: 0 float32, 1 bfloat16; scale is 1/sqrt(D) as the
// caller rounds it.  Returns cudaGetLastError() after the launches
// (cudaErrorInvalidValue for a head dim or kh without an instance).
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* lengths,
                                       void* out, void* part_ml,
                                       void* part_acc, int bhkv, int g_heads,
                                       int s_len, int d, int dtype,
                                       int n_split, int kh, float scale,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bhkv <= 0 || g_heads <= 0) return cudaSuccess;
  if (n_split < 1 || n_split > s_len) return cudaErrorInvalidValue;
  if (n_split > 1 && (part_ml == nullptr || part_acc == nullptr))
    return cudaErrorInvalidValue;
  float* ml = static_cast<float*>(part_ml);
  float* acc = static_cast<float*>(part_acc);
  if (dtype == 1)
    return repro::launch<__nv_bfloat16>(q, k, v, lengths, out, ml, acc, bhkv,
                                        g_heads, s_len, d, n_split, kh,
                                        scale, s);
  return repro::launch<float>(q, k, v, lengths, out, ml, acc, bhkv, g_heads,
                              s_len, d, n_split, kh, scale, s);
}
