// Paged MLA decode attention (DeepSeek's multi-head latent attention, the
// absorbed-matrix form): one decode token per slot, every head against the
// slot's compressed rows.
//
//   q_c    f32 [B, H, R]          the absorbed query (q_nope . W_uk)
//   q_r    f32 [B, H, Dr]         the roped query
//   ckv    bf16 or int8 [P, page, R]    the layer's compressed-row pool
//   kr     bf16 or int8 [P, page, Dr]   its roped-key pool
//   ckv_s, kr_s  f32 [P, page]    int8 pools only: one scale per row
//   block  int32 [B, pps]         page ids of each slot (0 = null page)
//   lens   int32 [B]              valid keys per slot (new token included)
//   ws     f32                    the splits' partials (scratch)
//   ticket u32 [>= B x column blocks]  zero; the per-slot arrival counters
//   out    f32 [B, H, R]          ctx = softmax(s) @ ckv
//
// with s[h, t] = (q_c[h] . ckv[t] + q_r[h] . kr[t]) * scale, keys t past
// the length masked.  The JAX package has no Pallas kernel for this: it is
// the attention part of the jnp function
//   src/repro/models/blocks.py::_mla_absorbed_attend
// (four float32 einsums over the compressed block row that
// mla_decode_paged gathers first).  This kernel reads the block table
// itself, so no copy of the cache is made.
//
// What bounds it on the H100: every valid latent row (R + Dr elements) is
// read once and used by every head: 2 H (2R + Dr) operations a row on
// 2 (R + Dr) bytes (bf16 pools).  On the float32 CUDA cores that is above
// their balance with the memory (30 a byte at H 16 against 67e12 / 3.35e12
// = 20), so the kernel is moved onto the tensor cores: the float32 operand
// of each product (the query, the softmax weights) enters as three bf16
// terms that hold it exactly, three bf16 products with float32 sums, and
// 3 x 30 = 90 operations a byte is far below the bf16 tensor cores' ridge
// (~295): the bound is the rows' bytes.  At decode lengths only a few
// dozen CTAs have work, so what a design can cut is each CTA's latency:
// chains of dependent loads and products, the wait for the last byte
// before the first product, and the second launch that merged the splits.
//
// Design: one launch; split-KV with the merge fused into it.
//  * One CTA (256 threads, 8 warps) per (split, slot, column block): a
//    split is kSplit = 64 keys at absolute positions [64 s, 64 s + 64) of
//    its slot, so a slot's splits and their arithmetic depend on its own
//    length alone (never on B, pps, the page size or the SM count); the
//    grid spans the block table's capacity and CTAs past the slot's last
//    split return at once.  A column block is a quarter of the context's
//    columns at R 512 (col_split; all of them at R 32): the four CTAs of a
//    split compute the same scores, and each merges its own columns, so
//    the merge, which one CTA's latency bounds, reads a quarter of the
//    partials (on an H100 at 1,024 keys, one block: a 6.4 us merge of a
//    14.3 us launch, four: 2.6 of 10.0, from %globaltimer stamps at the
//    phase boundaries; the bits are the same).
//  * The page ids are read beside the length; the query beside the row
//    ids, straight into mma fragments (below).
//  * Scores on the tensor cores, split over the dims: warp w owns a slice
//    of the latent dims (64 at R 512) and, for the last warps, 16 rope
//    dims, for all 64 keys.  S[16 heads x keys] = q . rows^T by mma.sync
//    m16n8k16 bf16 with float32 accumulation: A the warp's query slice,
//    held in registers as three bf16 terms (split3_bf16x2, mma_bf16.cuh)
//    that sum back to the float32 query; B the staged rows by ldmatrix.
//    Each warp copies its own slice of the split's rows into shared
//    memory, key tile (16 keys, one page at page 16) by key tile, one
//    cp.async commit group each (bf16 pools; int8 codes, exact in bf16,
//    are loaded into registers at once and widened tile by tile with float
//    adds and byte permutes, no conversion instruction), and starts on a
//    key tile once its own copies have landed: no CTA-wide wait before the
//    first product.  The warps' latent and rope sums go to shared memory
//    and are added in warp order, the latent and rope apart, per key s =
//    (lat [x row scale] + rope [x row scale]) x scale: the two einsums
//    added, then scaled, as JAX does.  The products of bf16 terms are
//    exact in float32; only the order of the float32 sums differs.
//  * Softmax of the split per head, two heads a warp: m = max, p = exp(s -
//    m), l = sum p (a fixed shuffle tree); an int8 pool's row scale folded
//    into p (P' = p x scale, the codes then being the rows).
//  * Context on the tensor cores: ctx[16 heads x cols] = P' . rows, P'
//    split into three bf16 terms, the rows through ldmatrix.trans; warp w
//    owns an eighth of the CTA's columns.
//  * A slot of one split writes ctx / l.  Otherwise each CTA writes its
//    float32 partial (acc, m, l) to the workspace and, after a fence, takes
//    a ticket from its (slot, column block)'s counter; the CTA that takes
//    the last one merges the slot's partials of its columns in split-index
//    order (M = max m_s, ctx = sum_s acc_s e^(m_s - M) / sum_s l_s e^(m_s -
//    M), read from L2) and sets the counter back to 0, so a replayed graph
//    finds it zero.  The order is fixed, so the bits do not depend on
//    which CTA arrives last.  A length-0 slot has no split: its first CTAs
//    write 0 (JAX gives the uniform mean there; callers ignore inactive
//    lanes).
//  Every sum runs in an order fixed by key position and head, so a slot's
//  output bits are the same in any batch and under any block-table width.
//  Instances: (R 512, Dr 64), deepseek-v2-lite-16b, and (R 32, Dr 8), its
//  reduced config (rope K padded to 16).  Heads past H are zero rows of
//  the 16 an mma holds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_bf16.cuh"

namespace {

using namespace tc_bf16;

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSplit = 64;              // keys per split; the wrapper's ref.SPLIT
constexpr int kTile = 16;               // keys of a key tile
constexpr int kKeyTiles = kSplit / kTile;
constexpr int kHeads = 16;              // an mma's 16 rows: the heads, zeros past H
constexpr int kPPitch = kSplit + 8;     // floats a head's row of scores / P

// column blocks of the context (CTAs a split); one at the reduced R 32
__host__ __device__ constexpr int col_split(int R) { return R >= 128 ? 4 : 1; }

template <typename KT>
__host__ __device__ constexpr bool is_int8() {
  return std::is_same<KT, int8_t>::value;
}

struct Params {
  const float* qc;
  const float* qr;
  const void* ckv;
  const void* kr;
  const float* ckv_s;  // int8 pools: [P, page] scales; else null
  const float* kr_s;
  const int* block;    // [B, pps]
  const int* lens;
  float* ws;
  unsigned* ticket;    // [B * col_split(R)]
  float* out;
  int H, page, pps, n_split;
  float scale;
};

// the (R, Dr) instance: its warps' slices of the dims and its shared
// memory.  bf16 rows are padded by 8 elements (16 bytes), so the 8 rows an
// ldmatrix matrix reads fall in 8 distinct bank groups
template <int R, int DR>
struct Layout {
  static constexpr int kDrp = DR < 16 ? 16 : DR;  // rope K: whole mma k-steps
  static constexpr int kLatSteps = R / 16;
  static constexpr int kRopeSteps = kDrp / 16;
  // latent k-steps a warp (warps past kLatWarps have none); rope k-step
  // j belongs to warp kRopeWarp0 + j
  static constexpr int kLatPerWarp = kLatSteps >= kWarps ? kLatSteps / kWarps : 1;
  static constexpr int kLatWarps = kLatSteps / kLatPerWarp;
  static constexpr int kRopeWarp0 = kWarps - kRopeSteps;
  static_assert(kLatSteps % kLatPerWarp == 0 && kRopeSteps <= kWarps, "dim slices");
  static constexpr int kRowPitch = R + 8;  // bf16 elements
  static constexpr int kRopePitch = kDrp + 8;
  static constexpr int kRows = kSplit * kRowPitch * 2;
  static constexpr int kRope = kSplit * kRopePitch * 2;
  // the warps' partial scores: latent [kLatWarps][16][kPPitch], rope
  // [kRopeSteps][16][kPPitch]
  static constexpr int kRed = (kLatWarps + kRopeSteps) * kHeads * kPPitch * 4;
  static constexpr int kP = kHeads * kPPitch * 4;
  static constexpr int kBytes = kRows + kRope + kRed + kP;
  static constexpr int kColSplit = col_split(R);
  static constexpr int kCols = R / kColSplit;  // context columns a CTA
  static constexpr int kColPairs = kCols / 16;  // pairs of 8-column mma tiles
  static constexpr int kPairsPerWarp = kColPairs >= kWarps ? kColPairs / kWarps : 1;
  static_assert(kCols % 16 == 0 && kColPairs % kPairsPerWarp == 0, "column split");
  static_assert(kRows % 16 == 0 && kRope % 16 == 0 && kRed % 16 == 0, "16-byte regions");
  // per (slot, split): acc [16][R], then m and l [kColSplit][2][16]
  static constexpr int kPartFloats = kHeads * R + kColSplit * 2 * kHeads;
  // splits whose merge weights fit the reused dynamic shared memory
  static constexpr int kMaxSplits = kBytes / (2 * kHeads * 4);
};

template <int N>
__device__ __forceinline__ void cp_async_wait_upto(int n) {  // n of N groups may stay in flight
  static_assert(N <= 4, "at most four groups");
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    default: cp_async_wait<3>(); break;
  }
}

// int8 codes -> bf16 (exact), BYTES codes into 2 BYTES bytes of shared memory
template <int BYTES>
struct Codes;
template <>
struct Codes<16> {
  using T = uint4;
};
template <>
struct Codes<8> {
  using T = uint2;
};
// codes 2i, 2i + 1 of w as a bf16 pair, with no conversion instruction:
// the float 2^23 + (c + 128) is built from its bits (c + 128 the low byte
// of `biased`, w with each byte's top bit flipped), 2^23 + 128 subtracted
// gives c exactly, and |c| < 2^8 leaves its low 16 bits 0: its high half
// is c in bf16
__device__ __forceinline__ uint32_t widen2(uint32_t biased, int i) {
  const float c0 = __fsub_rn(
      __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7540 | (2 * i))), 8388736.f);
  const float c1 = __fsub_rn(
      __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7540 | (2 * i + 1))), 8388736.f);
  return __byte_perm(__float_as_uint(c0), __float_as_uint(c1), 0x7632);
}
__device__ __forceinline__ void store_widened(__nv_bfloat16* dst, const uint4& c) {
  const uint32_t w[4] = {c.x ^ 0x80808080u, c.y ^ 0x80808080u, c.z ^ 0x80808080u,
                         c.w ^ 0x80808080u};
  uint4* d = reinterpret_cast<uint4*>(dst);
  d[0] = make_uint4(widen2(w[0], 0), widen2(w[0], 1), widen2(w[1], 0), widen2(w[1], 1));
  d[1] = make_uint4(widen2(w[2], 0), widen2(w[2], 1), widen2(w[3], 0), widen2(w[3], 1));
}
__device__ __forceinline__ void store_widened(__nv_bfloat16* dst, const uint2& c) {
  const uint32_t x = c.x ^ 0x80808080u, y = c.y ^ 0x80808080u;
  *reinterpret_cast<uint4*>(dst) = make_uint4(widen2(x, 0), widen2(x, 1), widen2(y, 0), widen2(y, 1));
}

// One warp's slice of a key tile's rows as bf16 in shared memory: dims
// [d0, d0 + D) of rows of W elements, in chunks spread over the warp's
// lanes; rows at or past n_tok are zeros.  bf16: 16-byte cp.async (the
// caller commits).  int8: the codes of each chunk, loaded ahead into
// `raw`, widened and stored.
template <typename KT, int W, int D>
struct SliceCopy {
  static constexpr int kChunkBytes = (D * static_cast<int>(sizeof(KT))) % 16 == 0 ? 16 : 8;
  static constexpr int kChunkElems = kChunkBytes / static_cast<int>(sizeof(KT));
  static constexpr int kPerRow = D / kChunkElems;
  static constexpr int kChunks = kTile * kPerRow;
  static constexpr int kPerLane = (kChunks + 31) / 32;
  using Raw = typename Codes<kChunkBytes>::T;
  static_assert(is_int8<KT>() || kChunkBytes == 16, "bf16 rows copy in 16-byte chunks");

  __device__ static __forceinline__ bool has(int j, int lane) {
    return kChunks % 32 == 0 || lane + 32 * j < kChunks;
  }
  __device__ static __forceinline__ void issue(__nv_bfloat16* dst, int pitch, const KT* pool,
                                               const int* s_row, int kt, int n_tok, int d0,
                                               int lane) {
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      if (!has(j, lane)) break;
      const int i = lane + 32 * j;
      const int key = kt * kTile + i / kPerRow;
      const int e = d0 + (i % kPerRow) * kChunkElems;
      const bool ok = key < n_tok;
      const KT* src = pool + (ok ? static_cast<size_t>(s_row[key]) * W + e : 0);
      cp_async16(dst + key * pitch + e, src, ok ? 16 : 0);
    }
  }
  __device__ static __forceinline__ void load(Raw (&raw)[kPerLane], const KT* pool,
                                              const int* s_row, int kt, int n_tok, int d0,
                                              int lane) {
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int i = lane + 32 * j;
      const int key = kt * kTile + i / kPerRow;
      const int e = d0 + (i % kPerRow) * kChunkElems;
      raw[j] = Raw{};
      if (has(j, lane) && key < n_tok) {
        raw[j] = *reinterpret_cast<const Raw*>(pool + static_cast<size_t>(s_row[key]) * W + e);
      }
    }
  }
  __device__ static __forceinline__ void widen(__nv_bfloat16* dst, int pitch,
                                               const Raw (&raw)[kPerLane], int kt, int d0,
                                               int lane) {
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      if (!has(j, lane)) break;
      const int i = lane + 32 * j;
      const int key = kt * kTile + i / kPerRow;
      const int e = d0 + (i % kPerRow) * kChunkElems;
      store_widened(dst + key * pitch + e, raw[j]);
    }
  }
};

// the query's A fragment of one k-step: dims [d0, d0 + 16) of rows of W
// floats (columns past W zeros), heads as rows (zeros past H); lane (g, q)
// holds heads g, g + 8 at dims 2q + {0, 1} and 8 + 2q + {0, 1}
template <int W>
__device__ __forceinline__ void load_query(float2 (&v)[4], const float* q, int d0, int H, int lg,
                                           int lq) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int h = lg + 8 * (r % 2);
    const int d = d0 + 8 * (r / 2) + 2 * lq;
    v[r] = h < H && d < W ? *reinterpret_cast<const float2*>(q + h * W + d) : make_float2(0.f, 0.f);
  }
}
// ... as three bf16 terms
__device__ __forceinline__ void split_query(uint32_t (&a)[kSplitTerms][4], const float2 (&v)[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    uint32_t t3[kSplitTerms];
    split3_bf16x2(v[r].x, v[r].y, t3);
#pragma unroll
    for (int t = 0; t < kSplitTerms; ++t) a[t][r] = t3[t];
  }
}

template <typename KT, int R, int DR>
__global__ void __launch_bounds__(kThreads, 1) mla_decode_attention_kernel(const Params p) {
  using Lay = Layout<R, DR>;
  constexpr int DRP = Lay::kDrp;
  constexpr int LPW = Lay::kLatPerWarp;
  using LatCopy = SliceCopy<KT, R, 16 * LPW>;
  using RopeCopy = SliceCopy<KT, DR, DR < 16 ? DR : 16>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __nv_bfloat16* s_ckv = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kSplit][kRowPitch]
  __nv_bfloat16* s_kr = reinterpret_cast<__nv_bfloat16*>(smem_raw + Lay::kRows);
  float* s_red = reinterpret_cast<float*>(smem_raw + Lay::kRows + Lay::kRope);
  float* s_p = reinterpret_cast<float*>(smem_raw + Lay::kRows + Lay::kRope + Lay::kRed);
  __shared__ int s_row[kSplit];                 // pool row per key
  __shared__ float s_cs[kSplit], s_ks[kSplit];  // int8 row scales
  __shared__ float s_m[kHeads], s_l[kHeads];
  __shared__ int s_last;

  const int split = blockIdx.x;
  const int b = blockIdx.y;
  const int cb = blockIdx.z;          // column block
  const int c0 = cb * Lay::kCols;     // its first column
  const int H = p.H;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int lg = lane / 4;
  const int lq = lane % 4;
  const int mi = lane / 8;  // ldmatrix: the matrix this lane addresses
  const int mr = lane % 8;  //           and its row
  float* out = p.out + static_cast<size_t>(b) * H * R;
  // the split's page ids, read beside the length (the table holds every
  // key below its capacity)
  const int t0 = split * kSplit;
  const int cap = p.pps * p.page;
  static_assert(kSplit <= kThreads, "a thread per key");
  int page_id = 0;
  if (tid < kSplit && t0 + tid < cap) {
    page_id = p.block[static_cast<size_t>(b) * p.pps + (t0 + tid) / p.page];
  }
  const int L = min(p.lens[b], cap);  // the plain version masks no key past its rows
  if (L <= 0) {  // no key: the slot's output is 0, written by its first CTAs
    if (split == 0) {
      for (int i = tid; i < H * Lay::kCols; i += kThreads) {
        out[(i / Lay::kCols) * R + c0 + i % Lay::kCols] = 0.f;
      }
    }
    return;
  }
  if (t0 >= L) return;  // past the slot's last split: the whole CTA leaves
  const int ns = (L + kSplit - 1) / kSplit;
  const int n_tok = min(kSplit, L - t0);
  const int n_kt = (n_tok + kTile - 1) / kTile;  // key tiles holding a valid key
  if (tid < n_tok) s_row[tid] = page_id * p.page + (t0 + tid) % p.page;

  // ---- this warp's slice of the dims: latent k-steps [lat0, lat0 + LPW)
  // (if lat_warp) and rope k-step rope_ks (if rope_warp); the query's
  // fragments of them, in flight while the rows are issued
  const bool lat_warp = warp < Lay::kLatWarps;
  const int lat0 = warp * LPW;
  const int rope_ks = warp - Lay::kRopeWarp0;
  const bool rope_warp = rope_ks >= 0;
  const float* qc = p.qc + static_cast<size_t>(b) * H * R;
  const float* qr = p.qr + static_cast<size_t>(b) * H * DR;
  float2 qv[LPW + 1][4];
#pragma unroll
  for (int s = 0; s < LPW; ++s) load_query<R>(qv[s], qc, 16 * (lat0 + s), lat_warp ? H : 0, lg, lq);
  load_query<DR>(qv[LPW], qr, 16 * rope_ks, rope_warp ? H : 0, lg, lq);
  __syncthreads();  // the row ids

  // ---- issue this warp's slice of the rows, key tile by key tile
  const KT* ckv = static_cast<const KT*>(p.ckv);
  const KT* kr = static_cast<const KT*>(p.kr);
  const bool rope_rows = rope_warp && 16 * rope_ks < DR;  // a slice with real rope dims
  [[maybe_unused]] typename LatCopy::Raw lat_raw[kKeyTiles][LatCopy::kPerLane];
  [[maybe_unused]] typename RopeCopy::Raw rope_raw[kKeyTiles][RopeCopy::kPerLane];
  if constexpr (is_int8<KT>()) {
#pragma unroll
    for (int kt = 0; kt < kKeyTiles; ++kt) {
      if (kt >= n_kt) break;
      if (lat_warp) LatCopy::load(lat_raw[kt], ckv, s_row, kt, n_tok, 16 * lat0, lane);
      if (rope_rows) RopeCopy::load(rope_raw[kt], kr, s_row, kt, n_tok, 16 * rope_ks, lane);
    }
    if (tid < n_tok) {  // the row scales, for the scores and the softmax
      s_cs[tid] = p.ckv_s[s_row[tid]];
      s_ks[tid] = p.kr_s[s_row[tid]];
    }
  } else {
#pragma unroll
    for (int kt = 0; kt < kKeyTiles; ++kt) {
      if (kt < n_kt) {
        if (lat_warp) LatCopy::issue(s_ckv, Lay::kRowPitch, ckv, s_row, kt, n_tok, 16 * lat0, lane);
        if (rope_rows) {
          RopeCopy::issue(s_kr, Lay::kRopePitch, kr, s_row, kt, n_tok, 16 * rope_ks, lane);
        }
      }
      cp_async_commit();  // one group a key tile, empty past n_kt
    }
  }
  if constexpr (DRP > DR) {  // rope dims past Dr: zeros, written by the pad's own warp
    if (rope_warp && 16 * rope_ks + 16 > DR) {
      for (int i = lane; i < kSplit; i += 32) {
        *reinterpret_cast<uint4*>(s_kr + i * Lay::kRopePitch + DR) = make_uint4(0, 0, 0, 0);
      }
    }
  }

  // ---- the query slice as three bf16 terms, in registers
  uint32_t qa[LPW + 1][kSplitTerms][4];
#pragma unroll
  for (int s = 0; s < LPW + 1; ++s) split_query(qa[s], qv[s]);

  // ---- scores: this warp's slice for every key, key tile by key tile;
  // per 8-key mma tile n, element e of lat / rope: head lg (+ 8 for e >= 2),
  // key 8 n + 2 lq + e % 2
  float lat[2 * kKeyTiles][4], rope[2 * kKeyTiles][4];
#pragma unroll
  for (int n = 0; n < 2 * kKeyTiles; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) lat[n][e] = rope[n][e] = 0.f;
#pragma unroll
  for (int kt = 0; kt < kKeyTiles; ++kt) {
    if (kt >= n_kt) break;
    if constexpr (is_int8<KT>()) {
      if (lat_warp) LatCopy::widen(s_ckv, Lay::kRowPitch, lat_raw[kt], kt, 16 * lat0, lane);
      if (rope_rows) RopeCopy::widen(s_kr, Lay::kRopePitch, rope_raw[kt], kt, 16 * rope_ks, lane);
    } else {
      cp_async_wait_upto<kKeyTiles>(kKeyTiles - 1 - kt);
    }
    __syncwarp();  // the warp's own copies of the tile are visible to its lanes
    // B: keys kt 16 + mr (+ 8 for matrices 2, 3), dims d (+ 8 for matrices
    // 1, 3): b0 / b1 of the tile's two 8-key mma tiles from one ldmatrix_x4
    const int brow = kt * kTile + mr + 8 * (mi >> 1);
    if (lat_warp) {
#pragma unroll
      for (int s = 0; s < LPW; ++s) {
        uint32_t bf[4];
        ldmatrix_x4(bf, s_ckv + brow * Lay::kRowPitch + 16 * (lat0 + s) + 8 * (mi & 1));
#pragma unroll
        for (int t = 0; t < kSplitTerms; ++t) {
          mma_bf16(lat[2 * kt], qa[s][t], bf[0], bf[1]);
          mma_bf16(lat[2 * kt + 1], qa[s][t], bf[2], bf[3]);
        }
      }
    }
    if (rope_warp) {
      uint32_t bf[4];
      ldmatrix_x4(bf, s_kr + brow * Lay::kRopePitch + 16 * rope_ks + 8 * (mi & 1));
#pragma unroll
      for (int t = 0; t < kSplitTerms; ++t) {
        mma_bf16(rope[2 * kt], qa[LPW][t], bf[0], bf[1]);
        mma_bf16(rope[2 * kt + 1], qa[LPW][t], bf[2], bf[3]);
      }
    }
  }
  // the warp's partial sums to shared memory, [slice][head][key]
#pragma unroll
  for (int n = 0; n < 2 * kKeyTiles; ++n) {
    if (n >= 2 * n_kt) break;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int off = (lg + 8 * hf) * kPPitch + 8 * n + 2 * lq;
      if (lat_warp) {
        *reinterpret_cast<float2*>(s_red + warp * kHeads * kPPitch + off) =
            make_float2(lat[n][2 * hf], lat[n][2 * hf + 1]);
      }
      if (rope_warp) {
        *reinterpret_cast<float2*>(s_red + (Lay::kLatWarps + rope_ks) * kHeads * kPPitch + off) =
            make_float2(rope[n][2 * hf], rope[n][2 * hf + 1]);
      }
    }
  }
  __syncthreads();

  // ---- per head (rows w and w + 8; heads past H: zero rows of P): the
  // scores, the slices summed in warp order, the latent and rope apart;
  // then the split's softmax numerators, an int8 pool's row scale folded in
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int h = warp + 8 * hh;
    float* row = s_p + h * kPPitch;
    if (h >= H) {
      row[lane] = 0.f;
      row[lane + 32] = 0.f;
      continue;  // warp-uniform
    }
    float v[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int key = lane + 32 * u;
      v[u] = kNegInf;
      if (key < n_tok) {
        float sl = 0.f, sr = 0.f;
#pragma unroll
        for (int w = 0; w < Lay::kLatWarps; ++w) {
          sl = __fadd_rn(sl, s_red[(w * kHeads + h) * kPPitch + key]);
        }
#pragma unroll
        for (int j = 0; j < Lay::kRopeSteps; ++j) {
          sr = __fadd_rn(sr, s_red[((Lay::kLatWarps + j) * kHeads + h) * kPPitch + key]);
        }
        if constexpr (is_int8<KT>()) {
          sl = __fmul_rn(sl, s_cs[key]);
          sr = __fmul_rn(sr, s_ks[key]);
        }
        v[u] = __fmul_rn(__fadd_rn(sl, sr), p.scale);
      }
    }
    const bool ok0 = lane < n_tok, ok1 = lane + 32 < n_tok;
    float mx = fmaxf(v[0], v[1]);
#pragma unroll
    for (int off = 16; off > 0; off /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float e0 = ok0 ? expf(__fsub_rn(v[0], mx)) : 0.f;
    const float e1 = ok1 ? expf(__fsub_rn(v[1], mx)) : 0.f;
    float sum = __fadd_rn(e0, e1);
#pragma unroll
    for (int off = 16; off > 0; off /= 2) sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, off));
    if constexpr (is_int8<KT>()) {
      row[lane] = ok0 ? __fmul_rn(e0, s_cs[lane]) : 0.f;
      row[lane + 32] = ok1 ? __fmul_rn(e1, s_cs[lane + 32]) : 0.f;
    } else {
      row[lane] = e0;
      row[lane + 32] = e1;
    }
    if (lane == 0) {
      s_m[h] = mx;
      s_l[h] = sum;
    }
  }
  __syncthreads();

  // ---- context: ctx[16 heads x this warp's columns] = P' . rows
  constexpr int NP = Lay::kPairsPerWarp;
  const bool ctx_warp = warp * NP < Lay::kColPairs;
  float acc[2 * NP][4];
#pragma unroll
  for (int n = 0; n < 2 * NP; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const int wc0 = c0 + warp * NP * 16;  // this warp's first column
  if (ctx_warp) {
    for (int ks = 0; ks < n_kt; ++ks) {
      // A: P' rows lg, lg + 8, keys 16 ks + 2 lq (+ 8), as three bf16 terms
      uint32_t af[kSplitTerms][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float2 v = *reinterpret_cast<const float2*>(
            s_p + (lg + 8 * (r % 2)) * kPPitch + 16 * ks + 8 * (r / 2) + 2 * lq);
        uint32_t t3[kSplitTerms];
        split3_bf16x2(v.x, v.y, t3);
#pragma unroll
        for (int t = 0; t < kSplitTerms; ++t) af[t][r] = t3[t];
      }
#pragma unroll
      for (int np = 0; np < NP; ++np) {
        uint32_t xf[4];
        ldmatrix_x4_trans(xf, s_ckv + (16 * ks + mr + 8 * (mi & 1)) * Lay::kRowPitch + wc0 +
                                  16 * np + 8 * (mi >> 1));
#pragma unroll
        for (int t = 0; t < kSplitTerms; ++t) {
          mma_bf16(acc[2 * np], af[t], xf[0], xf[1]);
          mma_bf16(acc[2 * np + 1], af[t], xf[2], xf[3]);
        }
      }
    }
  }

  // ---- one split: ctx / l.  Else the partial, then the ticket
  // element e of acc[n]: head lg (+ 8 for e >= 2), column wc0 + 8 n + 2 lq + e % 2
  if (ns == 1) {
    if (ctx_warp) {
#pragma unroll
      for (int n = 0; n < 2 * NP; ++n) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int h = lg + 8 * hf;
          if (h < H) {
            const float l = fmaxf(s_l[h], 1e-20f);
            *reinterpret_cast<float2*>(out + h * R + wc0 + 8 * n + 2 * lq) =
                make_float2(__fdiv_rn(acc[n][2 * hf], l), __fdiv_rn(acc[n][2 * hf + 1], l));
          }
        }
      }
    }
    return;
  }
  constexpr int kPart = Lay::kPartFloats;
  constexpr int kCS = Lay::kColSplit;
  float* ws_slot = p.ws + static_cast<size_t>(b) * p.n_split * kPart;
  float* part = ws_slot + static_cast<size_t>(split) * kPart;
  if (ctx_warp) {
#pragma unroll
    for (int n = 0; n < 2 * NP; ++n) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int h = lg + 8 * hf;
        if (h < H) {
          *reinterpret_cast<float2*>(part + h * R + wc0 + 8 * n + 2 * lq) =
              make_float2(acc[n][2 * hf], acc[n][2 * hf + 1]);
        }
      }
    }
  }
  float* ml = part + kHeads * R + cb * 2 * kHeads;  // this column block's copy of m, l
  if (tid < H) {
    ml[tid] = s_m[tid];
    ml[kHeads + tid] = s_l[tid];
  }
  __syncthreads();  // every thread's share of the partial is stored
  unsigned* ticket = p.ticket + b * kCS + cb;
  if (tid == 0) {
    __threadfence();  // the CTA's partial is visible device-wide before its ticket
    s_last = atomicAdd(ticket, 1u) == static_cast<unsigned>(ns - 1);
    if (s_last) {
      __threadfence();  // and the other splits' partials before the merge reads them
      *ticket = 0u;     // every split has taken its ticket: ready for the next launch
    }
  }
  __syncthreads();
  if (!s_last) return;

  // ---- the merge of the slot's partials (its columns), in split-index
  // order.  The splits' m and l in one round of loads, then the weights
  float* s_mw = reinterpret_cast<float*>(smem_raw);  // [ns][kHeads] m, then weights
  float* s_lw = s_mw + ns * kHeads;                  // [ns][kHeads] l; rows no longer read
  for (int i = tid; i < ns * kHeads; i += kThreads) {
    const int sp = i / kHeads, h = i % kHeads;
    const float* mls = ws_slot + static_cast<size_t>(sp) * kPart + kHeads * R + cb * 2 * kHeads;
    s_mw[i] = h < H ? __ldcg(mls + h) : 0.f;
    s_lw[i] = h < H ? __ldcg(mls + kHeads + h) : 0.f;
  }
  __syncthreads();
  if (tid < H) {
    float mx = kNegInf;
    for (int sp = 0; sp < ns; ++sp) mx = fmaxf(mx, s_mw[sp * kHeads + tid]);
    float l = 0.f;
    for (int sp = 0; sp < ns; ++sp) {
      const float w = expf(__fsub_rn(s_mw[sp * kHeads + tid], mx));
      s_mw[sp * kHeads + tid] = w;
      l = __fmaf_rn(s_lw[sp * kHeads + tid], w, l);
    }
    s_l[tid] = fmaxf(l, 1e-20f);
  }
  __syncthreads();
  // the partials: kPer float4s of (head, columns) a thread, kSU splits'
  // worth of loads in flight at once, summed in split order
  constexpr int kC4 = Lay::kCols / 4;  // float4s of a head's columns
  constexpr int kItems = kHeads * kC4;
  constexpr int kPer = (kItems + kThreads - 1) / kThreads;
  constexpr int kSU = kPer >= 32 ? 1 : 32 / kPer;
  float4 a[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) a[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s0 = 0; s0 < ns; s0 += kSU) {
    float4 v[kSU][kPer];
#pragma unroll
    for (int u = 0; u < kSU; ++u) {
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int i = tid + kThreads * j;
        const int h = i / kC4;
        v[u][j] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (s0 + u < ns && i < kItems && h < H) {
          v[u][j] = __ldcg(reinterpret_cast<const float4*>(
              ws_slot + static_cast<size_t>(s0 + u) * kPart + h * R + c0 + 4 * (i % kC4)));
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kSU; ++u) {
      if (s0 + u >= ns) break;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int h = min((tid + kThreads * j) / kC4, kHeads - 1);
        const float w = s_mw[(s0 + u) * kHeads + h];
        a[j].x = __fmaf_rn(v[u][j].x, w, a[j].x);
        a[j].y = __fmaf_rn(v[u][j].y, w, a[j].y);
        a[j].z = __fmaf_rn(v[u][j].z, w, a[j].z);
        a[j].w = __fmaf_rn(v[u][j].w, w, a[j].w);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = tid + kThreads * j;
    const int h = i / kC4;
    if (i < kItems && h < H) {
      const float l = s_l[h];
      *reinterpret_cast<float4*>(out + h * R + c0 + 4 * (i % kC4)) = make_float4(
          __fdiv_rn(a[j].x, l), __fdiv_rn(a[j].y, l), __fdiv_rn(a[j].z, l), __fdiv_rn(a[j].w, l));
    }
  }
}

template <typename KT, int R, int DR>
int launch(const Params& p, int B, long long ws_cap, cudaStream_t s) {
  using Lay = Layout<R, DR>;
  if (p.n_split > Lay::kMaxSplits ||
      static_cast<long long>(B) * p.n_split * Lay::kPartFloats > ws_cap) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  void (*kernel)(const Params) = mla_decode_attention_kernel<KT, R, DR>;
  // above 48 KB of dynamic shared memory needs the kernel's opt-in
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Lay::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(p.n_split, B, Lay::kColSplit), kThreads, Lay::kBytes, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename KT>
int launch_for_shape(const Params& p, int B, int R, int Dr, long long ws_cap, cudaStream_t s) {
  if (R == 512 && Dr == 64) return launch<KT, 512, 64>(p, B, ws_cap, s);  // deepseek-v2-lite-16b
  if (R == 32 && Dr == 8) return launch<KT, 32, 8>(p, B, ws_cap, s);      // its reduced config
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// kv_int8: ckv / krope pools int8 with float32 row-scale pools (else bf16,
// the scale pointers unused).  H at most 16; (R, Dr) one of (512, 64),
// (32, 8).  n_split must be ceil(pps * page / 64); ws must hold ws_cap >=
// B n_split 16 (R + 2 C) floats, C = col_split(R) (4 at R 512, else 1);
// ticket must hold ticket_cap >= B C zeros, which the kernel leaves zero.
extern "C" int repro_mla_decode_attention(const void* q_c, const void* q_rope,
                                          const void* ckv_pages, const void* krope_pages,
                                          const void* ckv_scale, const void* krope_scale,
                                          const void* block_table, const void* lengths,
                                          void* ws, long long ws_cap, void* ticket,
                                          int ticket_cap, void* out,
                                          int B, int H, int R, int Dr, int page, int pps,
                                          int n_split, int kv_int8, float scale, void* stream) {
  if (B <= 0 || H <= 0 || H > kHeads || page <= 0 || pps <= 0 ||
      n_split != (pps * page + kSplit - 1) / kSplit || ticket == nullptr ||
      ticket_cap < B * col_split(R) ||
      (kv_int8 && (ckv_scale == nullptr || krope_scale == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{};
  p.qc = static_cast<const float*>(q_c);
  p.qr = static_cast<const float*>(q_rope);
  p.ckv = ckv_pages;
  p.kr = krope_pages;
  p.ckv_s = static_cast<const float*>(ckv_scale);
  p.kr_s = static_cast<const float*>(krope_scale);
  p.block = static_cast<const int*>(block_table);
  p.lens = static_cast<const int*>(lengths);
  p.ws = static_cast<float*>(ws);
  p.ticket = static_cast<unsigned*>(ticket);
  p.out = static_cast<float*>(out);
  p.H = H;
  p.page = page;
  p.pps = pps;
  p.n_split = n_split;
  p.scale = scale;
  auto s = static_cast<cudaStream_t>(stream);
  return kv_int8 ? launch_for_shape<int8_t>(p, B, R, Dr, ws_cap, s)
                 : launch_for_shape<__nv_bfloat16>(p, B, R, Dr, ws_cap, s);
}
