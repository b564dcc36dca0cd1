// Causal attention of one slot's prefill chunk over the layer's page pool:
//
//   q      bf16 [C, H, D]            the chunk's queries, row i at cache
//                                    position start + i (rope applied)
//   k, v   bf16 or int8 [P, page, Hkv, D]   the layer's page pools
//   ks, vs f32 [P, page, Hkv]        int8 pools only: one scale per row and head
//   block  int32 [pps]               the slot's block-table row
//   out    bf16 [C, H, D]
//
// Query i attends keys 0 .. start + i, read through the block row; rows
// from n_valid on (bucket padding) come out 0.  It computes
// src/repro/models/attention.py::paged_chunk_attention, which the JAX
// package runs in jnp (it has no Pallas kernel); no copy of the cache is
// gathered.
//
// What bounds it on the H100: the chunk's K/V rows are read once per
// 64-query tile that needs them and used for 4*D operations per (query,
// key, head); below ~300 operations a byte (chunks of up to ~1,000 rows)
// the bytes bound it, above that the bf16 tensor-core rate, which only
// wgmma reaches.  int8 pools halve the bytes: codes and one float32 scale
// per row and head.
//
// Design: B3 (flash_attention.cu) over pages.  The contract is that a
// valid query's output over bf16 pools equals, bit for bit, what B3 gives
// the same query in a one-shot prefill over the same K/V rows, so a prompt
// gets the same K/V pages and logits however it is chunked, and a partial
// prefix hit over one-shot pages equals a cold one-shot run.
//  * One CTA of one warpgroup (128 threads) per (64-row query tile, head),
//    the tiles at absolute multiples of 64, as B3's: tile a holds positions
//    [64a, 64a + 64), of which those in [start, start + n_valid) are live;
//    the other rows are zero queries, computed and never stored.  A row
//    therefore meets B3's key blocks 0..a, key 64a unmasked in the last,
//    and the same per-block arithmetic (attention_tile.cuh).  Keys are not
//    split: a split and a combine would round differently from B3.  Tiles
//    with no live row only write their padding rows' zeros.
//  * Q and the K/V blocks are copied into B3's shared-memory layout (the
//    128-byte swizzle, the head dim zero-padded to 64 or 128) by 16-byte
//    cp.async copies, the swizzle computed here; each key's page comes from
//    the block row.  Keys after the tile's last live position are
//    zero-filled, never read, so stale page contents cannot reach the
//    sums.  K/V blocks stream through a 2-stage ring: block kb + 1's copies
//    are in flight while block kb computes.
//  * int8 pools: the codes are copied into a 2-stage raw ring, and each
//    thread widens the codes it copied to bf16 (exact) into the K/V tile
//    before the block's products.  S runs on the codes; each key's scale
//    multiplies its score before the 1/sqrt(D) scale, and each value row's
//    scale multiplies P before P is rounded to bf16 hi + lo.  This is held
//    to the plain version's tolerance, not to B3's bits (the one-shot
//    prefill attends the unquantized rows).
//  A query's bits depend on its own row, its absolute position and the
// keys up to it only: not on the chunk's start, size or padding, the page
// size, the block row's order or the grid.

#include "attention_tile.cuh"

#include <cuda_bf16.h>

namespace {

using attn_tile::kBox;
using attn_tile::kKeys;
using attn_tile::kRows;
using attn_tile::kThreads;

struct Params {
  const __nv_bfloat16* q;
  const void* k;     // [P * page, Hkv, D]
  const void* v;
  const float* ks;   // int8 pools: [P * page, Hkv]; else null
  const float* vs;
  const int* block;  // [pps]
  __nv_bfloat16* out;
  int C, n_valid, start, H, Hkv, D, page;
  float scale;
};

// 16 (4) bytes global -> shared, asynchronous; zeros where !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(hopper::smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(hopper::smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the pool row of the slot's key t
__device__ __forceinline__ size_t pool_row(const Params& p, int t) {
  return static_cast<size_t>(p.block[t / p.page]) * p.page + t % p.page;
}

template <int DP, bool kInt8>
constexpr int smem_bytes() {
  constexpr int tile = (DP / 64) * kBox;
  // Q; K and V: 2 stages (bf16) or one tile each plus a 2-stage raw ring of
  // codes and a 2-stage ring of scales (int8); the 1,024-byte alignment
  return kInt8 ? 3 * tile + 2 * 2 * kKeys * DP + 2 * 2 * kKeys * 4 + 1024 : 5 * tile + 1024;
}

// the query tile: rows at positions q0 .. q0 + 63, live in [lo, hi)
template <int DP>
__device__ __forceinline__ void load_q(const Params& p, uint8_t* sq, int h, int q0, int lo,
                                       int hi) {
  constexpr int kChunks = DP / 8;  // 16-byte chunks of a padded row
  const int jg = threadIdx.x % kChunks;
  const bool col_ok = jg * 8 < p.D;
  for (int r = threadIdx.x / kChunks; r < kRows; r += kThreads / kChunks) {
    const int pos = q0 + r;
    const bool ok = col_ok && pos >= lo && pos < hi;
    const size_t off = ok ? (static_cast<size_t>(pos - p.start) * p.H + h) * p.D + jg * 8 : 0;
    cp_async16(sq + attn_tile::swizzled(r, jg), p.q + off, ok);
  }
}

// bf16 pools: K/V block kb of kv head g into one ring stage
template <int DP>
__device__ __forceinline__ void load_kv(const Params& p, uint8_t* sk, uint8_t* sv, int kb,
                                        int g, int last_key) {
  constexpr int kChunks = DP / 8;
  const auto* kg = static_cast<const __nv_bfloat16*>(p.k);
  const auto* vg = static_cast<const __nv_bfloat16*>(p.v);
  const int jg = threadIdx.x % kChunks;
  const bool col_ok = jg * 8 < p.D;
  for (int r = threadIdx.x / kChunks; r < kKeys; r += kThreads / kChunks) {
    const int t = kb * kKeys + r;
    const bool ok = col_ok && t <= last_key;
    const size_t off = ok ? (pool_row(p, t) * p.Hkv + g) * p.D + jg * 8 : 0;
    const uint32_t dst = attn_tile::swizzled(r, jg);
    cp_async16(sk + dst, kg + off, ok);
    cp_async16(sv + dst, vg + off, ok);
  }
}

// int8 pools: block kb's codes into a raw stage ([K, V][64 keys][DP
// bytes]) and its scales into a scale stage ([K, V][64 keys]); thread t
// copies the chunks idx = t, t + 128, ... (convert_kv widens the same ones)
template <int DP>
__device__ __forceinline__ void load_kv_int8(const Params& p, uint8_t* raw, float* scl, int kb,
                                             int g, int last_key) {
  const auto* kg = static_cast<const int8_t*>(p.k);
  const auto* vg = static_cast<const int8_t*>(p.v);
  const int n_rc = p.D / 16;  // 16-byte chunks of codes a row
  for (int idx = threadIdx.x; idx < kKeys * n_rc; idx += kThreads) {
    const int r = idx / n_rc, rc = idx % n_rc;
    const int t = kb * kKeys + r;
    const bool ok = t <= last_key;
    const size_t off = ok ? (pool_row(p, t) * p.Hkv + g) * p.D + rc * 16 : 0;
    cp_async16(raw + r * DP + rc * 16, kg + off, ok);
    cp_async16(raw + (kKeys + r) * DP + rc * 16, vg + off, ok);
  }
  if (threadIdx.x < kKeys) {
    const int t = kb * kKeys + threadIdx.x;
    const bool ok = t <= last_key;
    const size_t off = ok ? pool_row(p, t) * p.Hkv + g : 0;
    cp_async4(scl + threadIdx.x, p.ks + off, ok);
    cp_async4(scl + kKeys + threadIdx.x, p.vs + off, ok);
  }
}

// 8 codes -> 8 bf16 (exact) as one 16-byte chunk
__device__ __forceinline__ uint4 widen8(const int8_t* c) {
  uint4 w;
  auto* b = reinterpret_cast<__nv_bfloat162*>(&w);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    b[e] = __floats2bfloat162_rn(static_cast<float>(c[2 * e]), static_cast<float>(c[2 * e + 1]));
  }
  return w;
}

// the codes this thread copied (after its own wait) into the bf16 K/V tiles
template <int DP>
__device__ __forceinline__ void convert_kv(const Params& p, const uint8_t* raw, uint8_t* sk,
                                           uint8_t* sv) {
  const int n_rc = p.D / 16;
  for (int idx = threadIdx.x; idx < kKeys * n_rc; idx += kThreads) {
    const int r = idx / n_rc, rc = idx % n_rc;
    const int4 ck = *reinterpret_cast<const int4*>(raw + r * DP + rc * 16);
    const int4 cv = *reinterpret_cast<const int4*>(raw + (kKeys + r) * DP + rc * 16);
    const auto* k8 = reinterpret_cast<const int8_t*>(&ck);
    const auto* v8 = reinterpret_cast<const int8_t*>(&cv);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const uint32_t dst = attn_tile::swizzled(r, 2 * rc + half);
      *reinterpret_cast<uint4*>(sk + dst) = widen8(k8 + 8 * half);
      *reinterpret_cast<uint4*>(sv + dst) = widen8(v8 + 8 * half);
    }
  }
}

// this lane's columns of an output row set to 0 (a padding row)
template <int DP>
__device__ __forceinline__ void zero_row(__nv_bfloat16* orow, int D) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    const int col = 8 * j + 2 * (lane % 4);
    if (col < D) *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(0.f, 0.f);
  }
}

template <int DP, bool kInt8>
__global__ void __launch_bounds__(kThreads) paged_chunk_attention_kernel(const Params p) {
  constexpr int kTile = (DP / 64) * kBox;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sq = smem;                                // [DP / 64][64 rows][128 bytes]
  uint8_t* sk = smem + kTile;                        // bf16: [stage][...]; int8: one tile
  uint8_t* sv = sk + (kInt8 ? 1 : 2) * kTile;
  uint8_t* raw = sv + (kInt8 ? 1 : 2) * kTile;       // int8: [stage][K, V][64][DP]
  float* scl = reinterpret_cast<float*>(raw + 2 * 2 * kKeys * DP);  // int8: [stage][K, V][64]

  const int a = (p.start + p.C - 1) / kRows - static_cast<int>(blockIdx.x);  // longest first
  const int h = blockIdx.y;
  const int g = h / (p.H / p.Hkv);
  const int q0 = a * kRows;
  const int lo = max(q0, p.start);
  const int hi = min(q0 + kRows, p.start + p.n_valid);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = q0 + warp * 16 + lane / 4;

  auto out_row = [&](int i) { return p.out + (static_cast<size_t>(i) * p.H + h) * p.D; };
  if (lo >= hi) {  // padding rows only
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = row0 + 8 * r - p.start;
      if (i >= 0 && i < p.C) zero_row<DP>(out_row(i), p.D);
    }
    return;
  }
  const int last_key = hi - 1;

  load_q<DP>(p, sq, h, q0, lo, hi);
  if constexpr (kInt8) {
    // the padded head-dim columns past D, which no conversion writes
    for (int idx = threadIdx.x; idx < kKeys * (DP / 8); idx += kThreads) {
      const int r = idx / (DP / 8), jg = idx % (DP / 8);
      if (jg * 8 >= p.D) {
        *reinterpret_cast<uint4*>(sk + attn_tile::swizzled(r, jg)) = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(sv + attn_tile::swizzled(r, jg)) = make_uint4(0, 0, 0, 0);
      }
    }
    load_kv_int8<DP>(p, raw, scl, 0, g, last_key);
  } else {
    load_kv<DP>(p, sk, sv, 0, g, last_key);
  }
  cp_async_commit();

  attn_tile::Rows<DP> st;
  st.init();
  const uint32_t qa = hopper::smem_u32(sq);
  for (int kb = 0; kb <= a; ++kb) {
    const int s = kb & 1;
    __syncthreads();  // every warp is past block kb - 1, the last reader of stage s ^ 1
    if (kb < a) {
      if constexpr (kInt8) {
        load_kv_int8<DP>(p, raw + (s ^ 1) * 2 * kKeys * DP, scl + (s ^ 1) * 2 * kKeys, kb + 1, g,
                         last_key);
      } else {
        load_kv<DP>(p, sk + (s ^ 1) * kTile, sv + (s ^ 1) * kTile, kb + 1, g, last_key);
      }
      cp_async_commit();
      cp_async_wait<1>();  // this thread's copies of block kb (and Q) have landed
    } else {
      cp_async_wait<0>();
    }
    if constexpr (kInt8) convert_kv<DP>(p, raw + s * 2 * kKeys * DP, sk, sv);
    hopper::fence_proxy_async();  // the copies and stores, visible to wgmma
    __syncthreads();

    float sc[32];
    if constexpr (kInt8) {
      const float* ks = scl + s * 2 * kKeys;
      attn_tile::scores<DP>(sc, qa, hopper::smem_u32(sk));
      attn_tile::softmax<DP>(sc, st, p.scale, kb == a, kb * kKeys, row0, ks);
      attn_tile::pv<DP>(st, sc, hopper::smem_u32(sv), ks + kKeys);
    } else {
      attn_tile::scores<DP>(sc, qa, hopper::smem_u32(sk + s * kTile));
      attn_tile::softmax<DP>(sc, st, p.scale, kb == a, kb * kKeys, row0, nullptr);
      attn_tile::pv<DP>(st, sc, hopper::smem_u32(sv + s * kTile), nullptr);
    }
  }

  attn_tile::finish<DP>(st);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row0 + 8 * r - p.start;
    if (i < 0 || i >= p.C) continue;
    if (i < p.n_valid) {
      attn_tile::store_row<DP>(st, r, out_row(i), p.D);
    } else {
      zero_row<DP>(out_row(i), p.D);
    }
  }
}

template <int DP, bool kInt8>
int launch(const Params& p, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<DP, kInt8>();
  const cudaError_t err = cudaFuncSetAttribute(
      paged_chunk_attention_kernel<DP, kInt8>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = (p.start + p.C - 1) / kRows - p.start / kRows + 1;
  paged_chunk_attention_kernel<DP, kInt8><<<dim3(n_tiles, p.H), kThreads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <bool kInt8>
int launch_for_dim(const Params& p, cudaStream_t stream) {
  switch (p.D) {
    case 16:
    case 32:
    case 64: return launch<64, kInt8>(p, stream);
    case 112:
    case 128: return launch<128, kInt8>(p, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// One slot's prefill chunk: C query rows at cache positions start ..
// start + C - 1, of which the first n_valid are computed (the others come
// out 0).  block_row: the slot's [pps] page ids.  The page size must
// divide 64, start + n_valid <= pps * page, and every base be 16-byte
// aligned.  kv_int8: k/v pools int8 with float32 scale pools ks/vs (else
// bf16, ks/vs unused)
extern "C" int repro_paged_chunk_attention(const void* q, const void* k_pages,
                                           const void* v_pages, const void* k_scale,
                                           const void* v_scale, const void* block_row, void* out,
                                           int C, int n_valid, int start, int H, int Hkv, int D,
                                           int page, int pps, int kv_int8, float scale,
                                           void* stream) {
  if (C <= 0 || n_valid <= 0 || n_valid > C || start < 0 || Hkv <= 0 || H % Hkv != 0 ||
      page <= 0 || kKeys % page != 0 || pps <= 0 || start + n_valid > pps * page ||
      (kv_int8 && (k_scale == nullptr || v_scale == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = k_pages;
  p.v = v_pages;
  p.ks = static_cast<const float*>(k_scale);
  p.vs = static_cast<const float*>(v_scale);
  p.block = static_cast<const int*>(block_row);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.C = C;
  p.n_valid = n_valid;
  p.start = start;
  p.H = H;
  p.Hkv = Hkv;
  p.D = D;
  p.page = page;
  p.scale = scale;
  auto s = static_cast<cudaStream_t>(stream);
  return kv_int8 ? launch_for_dim<true>(p, s) : launch_for_dim<false>(p, s);
}
