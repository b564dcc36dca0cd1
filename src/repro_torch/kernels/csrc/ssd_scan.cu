// Mamba-2 SSD intra-chunk term (the quadratic "duality" part of the scan),
// in the model's own layout:
//
//   x  [B, S, H, P]  bf16 or f32     a  [B, S, H] f32 (log decay, dt*A)
//   Bm, Cm [B, S, G, N]  same type as x              y  [B, S, H, P] f32
//
// For every (batch, head, chunk of Q positions), with cs the cumulative sum
// of a over the chunk and g = h / (H / G) the head's B/C group:
//
//   L[i, j] = exp(cs_i - cs_j) for j <= i, else 0
//   y[i]    = sum_j (C_i . B_j) L[i, j] x[j]
//
// x, a, Bm and Cm are read through their batch / sequence / head strides
// (the last axis contiguous), so the caller transposes nothing; y is written
// contiguous.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/ssd_scan/ssd_scan.py::ssd_intra_chunk
// and the four transposes of its front end ops.py::ssd_intra_chunk_op; the
// model path it stands in for is the y_diag einsum of
// models/ssm.py::ssd_chunked.
//
// What bounds it on the H100.  The least work is C B^T once per (batch,
// group, chunk) and S_h x_h per head: 2 Q(Q+1)/2 (G N + H P) operations per
// (batch, chunk), against Q H P bf16 inputs and Q H P float32 outputs.  At
// zamba2-7b (H 112, G 1, P = N = 64, Q 128) that is 1.9 GFLOP against 90 MB,
// about 21 operations per byte: below the bf16 tensor cores' ridge (~295),
// so the bound is device memory bytes, ~60% of them the float32 output.
// C B^T computed again for every head would be half of the FLOPs, and the
// float32 CUDA cores would put both products above the byte bound.
//
// Design of the bf16 kernel (ssd_intra_chunk_tc_kernel): one CTA of 8 warps
// per (batch, chunk, block of `hpc` <= 8 heads of one group); two CTAs share
// an SM where P <= 64 (110.6 KB of shared memory and <= 128 registers each),
// so one CTA's loads, exp2 and mma.sync overlap the other's; the wrapper
// picks hpc so that the grid is about one such wave.
//  * C B^T once per CTA, on the tensor cores: mma.sync m16n8k16 bf16 with
//    float32 accumulation (the bf16 products are exact in float32, so only
//    the order of the float32 sums differs from the CUDA cores), for the 16 x
//    16 tile blocks at or below the diagonal only.  Each block is kept in
//    shared memory in the accumulator's own fragment order (8 floats a lane),
//    which is also the A-operand order of the S x product: a lane reads its
//    S fragment back with two 16-byte loads.
//  * cs in double for every head of the CTA (a lane-local sum of 4, then a
//    warp scan): a float32 cumsum over a chunk reaches |cs| ~ 2e3 at the
//    model's decays, where its own rounding (~1e-4 absolute) would move L by
//    ~1e-4 relative.  cs log2(e) is kept as a float pair hi + lo, and L =
//    exp2f((hi_i - hi_j) + (lo_i - lo_j)): float adds only, with the double
//    sum's precision (hi_i - hi_j is exact where L is above float32's
//    range).
//  * Two heads at a time, four warps each; a warp owns a pair of 16-row
//    tiles (r, n-1-r), so every warp visits the same number of key tiles, and
//    key tiles above the diagonal are never visited.  Per key tile it forms S
//    = (C B^T) o L in float32 registers and splits it into three bf16
//    terms of 8 significant bits each, which hold it exactly (x is bf16), so
//    the product keeps the reference's float32 S; it issues three bf16
//    mma.sync per 8 columns of y, with x's fragments loaded by
//    ldmatrix.trans.
//  * x rows of the next pair of heads are copied into shared memory with
//    16-byte cp.async while the current pair computes (two stages); C and B
//    are staged the same way, 64 state dims at a time.  Rows and keys past the
//    chunk (Q not a multiple of 16) are zero-filled and not stored.  Rows of
//    64 or more elements are XOR-swizzled by 16-byte chunk, not padded, so
//    that two CTAs fit.
//  * y leaves the accumulators as float2 stores: each 32-byte sector of a
//    row is written whole by four lanes.
// The wrapper checks the 16-byte alignment of x, Bm and Cm (base and
// strides) that the cp.async copies need.
//
// float32 inputs (on no model path at full width) take a CUDA-core
// kernel, ssd_intra_chunk_f32_kernel: one CTA of 256 threads per (64-row
// block, head, batch), C B^T per head, S through shared memory, products in
// float32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using namespace tc_bf16;

constexpr int kMaxQ = 128;
constexpr int kMaxDevices = 16;

// one cumulative sum of 128 log decays in double, by one warp: a lane-local
// sum of 4, then a warp scan; positions past Q add 0.  out(t, cs_t) stores
// position t.
template <typename Out>
__device__ __forceinline__ void chunk_cumsum(const float* a, long long ass, int Q, Out out) {
  const int lane = threadIdx.x % 32;
  double v[4];
  double run = 0.0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int t = lane * 4 + e;
    run += (t < Q) ? static_cast<double>(a[static_cast<long long>(t) * ass]) : 0.0;
    v[e] = run;
  }
  double incl = run;
#pragma unroll
  for (int off = 1; off < 32; off *= 2) {
    const double n = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += n;
  }
  double excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.0;
#pragma unroll
  for (int e = 0; e < 4; ++e) out(lane * 4 + e, excl + v[e]);
}

// ------------------------------------------------------------ bf16 kernel

constexpr int kTcThreads = 256;
constexpr int kTile = 16;                                    // rows / keys of an mma tile
constexpr int kMaxTiles = kMaxQ / kTile;                     // 8
constexpr int kMaxBlocks = kMaxTiles * (kMaxTiles + 1) / 2;  // 36 blocks at or below the diagonal
constexpr int kBlocksPerWarp = (kMaxBlocks + 7) / 8;         // 5
constexpr int kNChunk = 64;                                  // state dims staged per pass
constexpr int kMaxHeads = 8;                                 // heads per CTA
// bf16 terms of S, each 8 significant bits of it: three hold a float32
// exactly; two leave ~2^-16 |S|, which reaches the 1e-4 gate on the CPU
// rehearsal's outputs at mamba2-130m's widths
constexpr int kTerms = kSplitTerms;
constexpr double kLog2e = 1.4426950408889634;

// A bf16 tile of rows of W elements in shared memory: rows of 64 or more
// are XOR-swizzled by 16-byte chunk (chunk c of row r stored at c ^ (r % 8)),
// narrower rows padded by 8 elements; either way the 8 rows one ldmatrix
// matrix reads, at one logical chunk, fall in 8 distinct bank groups.
template <int W>
constexpr int tile_pitch() {
  return W >= 64 ? W : W + 8;
}
template <int W>
__device__ __forceinline__ int tile_off(int r, int c) {  // element offset of (row, chunk)
  if constexpr (W >= 64) {
    return r * W + ((c ^ (r & 7)) << 3);
  } else {
    return r * (W + 8) + (c << 3);
  }
}

template <int P>
struct TcSmem {
  static constexpr int kXPitch = tile_pitch<P>();                          // bf16 row pitch of x
  static constexpr size_t kG = sizeof(float) * kMaxBlocks * 32 * 8;      // C B^T fragments
  static constexpr size_t kCs = sizeof(float2) * kMaxHeads * kMaxQ;     // cs of every head
  static constexpr size_t kXStage = 2 * 2 * kMaxQ * kXPitch;            // two heads' x, bytes
  static constexpr size_t kStaged = 2 * 2 * kMaxQ * kNChunk;            // C and B, bytes
  // stage 1 of x shares its bytes with the staged C and B (used first)
  static constexpr size_t kStage1 = kXStage > kStaged ? kXStage : kStaged;
  static constexpr size_t kBytes = kG + kCs + kXStage + kStage1;
};

// the (row tile, key tile) of lower-triangle block index bi = rt(rt+1)/2 + kt
__device__ __forceinline__ void block_tiles(int bi, int& rt, int& kt) {
  rt = 0;
  while ((rt + 1) * (rt + 2) / 2 <= bi) ++rt;
  kt = bi - rt * (rt + 1) / 2;
}

// two CTAs an SM where P <= 64 (110.6 KB of shared memory, <= 128 registers)
template <int P>
__global__ void __launch_bounds__(kTcThreads, P <= 64 ? 2 : 1)
ssd_intra_chunk_tc_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ a,
                          const __nv_bfloat16* __restrict__ bm,
                          const __nv_bfloat16* __restrict__ cm, float* __restrict__ y, int S,
                          int H, int G, int N, int Q, int hpc, long long xsb, long long xss,
                          long long xsh, long long asb, long long ass, long long ash,
                          long long bsb, long long bss, long long bsg, long long csb,
                          long long css, long long csg) {
  using L = TcSmem<P>;
  constexpr int kXPitch = L::kXPitch;
  constexpr int kNt = P / 8;  // 8-column tiles of y
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Gs = reinterpret_cast<float*>(smem_raw);                     // [block][lane][8]
  float2* cs = reinterpret_cast<float2*>(smem_raw + L::kG);            // [head][kMaxQ]
  __nv_bfloat16* xs0 = reinterpret_cast<__nv_bfloat16*>(smem_raw + L::kG + L::kCs);
  unsigned char* stage1 = smem_raw + L::kG + L::kCs + L::kXStage;
  __nv_bfloat16* Cst = reinterpret_cast<__nv_bfloat16*>(stage1);      // [kMaxQ][kNChunk]
  __nv_bfloat16* Bst = Cst + kMaxQ * kNChunk;                          // [kMaxQ][kNChunk]

  const int hg = H / G;                 // heads per group
  const int n_hb = (hg + hpc - 1) / hpc;
  const int chunk = blockIdx.x / (G * n_hb);
  const int grp = (blockIdx.x / n_hb) % G;
  const int hb = blockIdx.x % n_hb;
  const int b = blockIdx.y;
  const int h0 = grp * hg + hb * hpc;   // first head of the CTA
  const int nh = min(hpc, hg - hb * hpc);
  const int c0 = chunk * Q;
  const int n_rt = (Q + kTile - 1) / kTile;
  const int qp = n_rt * kTile;          // rows staged: Q rounded up to the tile
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int lg = lane / 4;
  const int lq = lane % 4;

  // stage rows [0, qp) of C and B, dims [n0, n0 + kNChunk), zeros past Q / N
  auto stage_cb = [&](int n0) {
    constexpr int kPer = kNChunk / 8;
    for (int idx = tid; idx < 2 * qp * kPer; idx += kTcThreads) {
      const int mat = idx / (qp * kPer);
      const int r = (idx / kPer) % qp;
      const int k = n0 + 8 * (idx % kPer);
      const bool ok = r < Q && k < N;
      const __nv_bfloat16* src =
          mat == 0 ? cm + b * csb + static_cast<long long>(c0 + (ok ? r : 0)) * css + grp * csg
                   : bm + b * bsb + static_cast<long long>(c0 + (ok ? r : 0)) * bss + grp * bsg;
      __nv_bfloat16* dst = (mat == 0 ? Cst : Bst) + tile_off<kNChunk>(r, (k - n0) / 8);
      cp_async16(dst, src + (ok ? k : 0), ok ? 16 : 0);
    }
  };
  // stage x rows [0, qp) of heads 2 pair, 2 pair + 1 of the CTA into `dst`
  auto stage_x = [&](int pair, __nv_bfloat16* dst) {
    constexpr int kPer = P / 8;
    const int e0 = 2 * pair;
    const int nslot = min(2, nh - e0);
    for (int idx = tid; idx < nslot * qp * kPer; idx += kTcThreads) {
      const int slot = idx / (qp * kPer);
      const int r = (idx / kPer) % qp;
      const int d = 8 * (idx % kPer);
      const bool ok = r < Q;
      const __nv_bfloat16* src = x + b * xsb + static_cast<long long>(c0 + (ok ? r : 0)) * xss +
                                 static_cast<long long>(h0 + e0 + slot) * xsh + d;
      cp_async16(dst + slot * kMaxQ * kXPitch + tile_off<P>(r, d / 8), src, ok ? 16 : 0);
    }
  };

  // prologue: C / B chunk 0, then x of heads 0-1; cs of every head meanwhile
  stage_cb(0);
  cp_async_commit();
  stage_x(0, xs0);
  cp_async_commit();
  // cs log2(e) as a float pair hi + lo: hi_i - hi_j is exact wherever
  // exp(cs_i - cs_j) is not below float32's range, so the exponent costs
  // three float adds and keeps the double sum's precision
  for (int e = warp; e < nh; e += kTcThreads / 32) {
    float2* cse = cs + e * kMaxQ;
    chunk_cumsum(a + b * asb + static_cast<long long>(c0) * ass + (h0 + e) * ash, ass, Q,
                 [cse](int t, double v) {
                   const double w = v * kLog2e;
                   const float hi = static_cast<float>(w);
                   cse[t] = make_float2(hi, static_cast<float>(w - hi));
                 });
  }

  // ---- C B^T, once: warp w owns blocks w, w + 8, ...
  const int n_blocks = n_rt * (n_rt + 1) / 2;
  float gacc[kBlocksPerWarp][2][4];  // [block][keys 0..7, 8..15][fragment]
#pragma unroll
  for (int u = 0; u < kBlocksPerWarp; ++u)
#pragma unroll
    for (int e = 0; e < 8; ++e) gacc[u][e / 4][e % 4] = 0.f;
  const int mi = lane / 8;  // ldmatrix: the matrix this lane addresses
  const int mr = lane % 8;  //           and its row
  for (int n0 = 0; n0 < N; n0 += kNChunk) {
    if (n0 == 0) {
      cp_async_wait<1>();  // C / B chunk 0 (x of heads 0-1 may still be in flight)
    } else {
      __syncthreads();  // the previous chunk's reads are done
      stage_cb(n0);
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncthreads();
    const int ksteps = (min(kNChunk, N - n0) + kTile - 1) / kTile;
#pragma unroll
    for (int u = 0; u < kBlocksPerWarp; ++u) {
      const int bi = warp + 8 * u;
      if (bi >= n_blocks) break;
      int rt, kt;
      block_tiles(bi, rt, kt);
      for (int ks = 0; ks < ksteps; ++ks) {
        uint32_t af[4], bf[4];
        ldmatrix_x4(af, Cst + tile_off<kNChunk>(rt * kTile + mr + 8 * (mi & 1),
                                                2 * ks + (mi >> 1)));
        ldmatrix_x4(bf, Bst + tile_off<kNChunk>(kt * kTile + mr + 8 * (mi >> 1),
                                                2 * ks + (mi & 1)));
        mma_bf16(gacc[u][0], af, bf[0], bf[1]);  // keys 0..7 of the key tile
        mma_bf16(gacc[u][1], af, bf[2], bf[3]);  // keys 8..15
      }
    }
  }
#pragma unroll
  for (int u = 0; u < kBlocksPerWarp; ++u) {
    const int bi = warp + 8 * u;
    if (bi >= n_blocks) break;
    float4* dst = reinterpret_cast<float4*>(Gs + (bi * 32 + lane) * 8);
    dst[0] = make_float4(gacc[u][0][0], gacc[u][0][1], gacc[u][0][2], gacc[u][0][3]);
    dst[1] = make_float4(gacc[u][1][0], gacc[u][1][1], gacc[u][1][2], gacc[u][1][3]);
  }
  __syncthreads();  // C B^T and cs ready; the staged C / B are no longer read

  __nv_bfloat16* xs1 = reinterpret_cast<__nv_bfloat16*>(stage1);
  const int n_pairs = (nh + 1) / 2;
  if (n_pairs > 1) {
    stage_x(1, xs1);
    cp_async_commit();
  }

  // ---- S x, two heads at a time: warps 0-3 the even head, 4-7 the odd one
  const int slot = warp / 4;
  const int wl = warp % 4;
  const int n_tp = (n_rt + 1) / 2;  // pairs of row tiles (r, n_rt - 1 - r)
  for (int pair = 0; pair < n_pairs; ++pair) {
    if (pair + 1 < n_pairs) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int e = 2 * pair + slot;
    if (e < nh) {
      const __nv_bfloat16* xh = (pair % 2 == 0 ? xs0 : xs1) + slot * kMaxQ * kXPitch;
      const float2* cse = cs + e * kMaxQ;
      const int h = h0 + e;
      for (int tp = wl; tp < n_tp; tp += 4) {
        for (int side = 0; side < 2; ++side) {
          const int rt = side == 0 ? tp : n_rt - 1 - tp;
          if (side == 1 && rt == tp) break;
          float acc[kNt][4];
#pragma unroll
          for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
          const int i0 = rt * kTile + lg;  // this lane's rows i0 and i0 + 8
          const float2 ci0 = cse[i0];
          const float2 ci1 = cse[i0 + 8];
          for (int kt = 0; kt <= rt; ++kt) {
            const float4* gf = reinterpret_cast<const float4*>(
                Gs + ((rt * (rt + 1) / 2 + kt) * 32 + lane) * 8);
            const float4 g0 = gf[0];
            const float4 g1 = gf[1];
            const int j0 = kt * kTile + 2 * lq;  // keys j0, j0 + 1, j0 + 8, j0 + 9
            const float4 cj01 = *reinterpret_cast<const float4*>(cse + j0);
            const float4 cj89 = *reinterpret_cast<const float4*>(cse + j0 + 8);
            // fragment element -> (row, key): the accumulator order of C B^T
            float s[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
            const float2 ci[8] = {ci0, ci0, ci1, ci1, ci0, ci0, ci1, ci1};
            const float2 cj[8] = {
                make_float2(cj01.x, cj01.y), make_float2(cj01.z, cj01.w),
                make_float2(cj01.x, cj01.y), make_float2(cj01.z, cj01.w),
                make_float2(cj89.x, cj89.y), make_float2(cj89.z, cj89.w),
                make_float2(cj89.x, cj89.y), make_float2(cj89.z, cj89.w)};
            const int ri[8] = {0, 0, 8, 8, 0, 0, 8, 8};
            const int kj[8] = {0, 1, 0, 1, 8, 9, 8, 9};
#pragma unroll
            for (int k = 0; k < 8; ++k) {
              const bool keep = kt < rt || 2 * lq + kj[k] <= lg + ri[k];
              const float d = (ci[k].x - cj[k].x) + (ci[k].y - cj[k].y);
              s[k] = keep ? s[k] * exp2f(d) : 0.f;
            }
            // S as kTerms bf16 values: each the top 8 significant bits
            // of what the earlier ones leave (the high half of its float32
            // bits; the remainder is exact)
            uint32_t af[kTerms][4];
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              uint32_t t3[kTerms];
              split3_bf16x2(s[2 * r], s[2 * r + 1], t3);
#pragma unroll
              for (int t = 0; t < kTerms; ++t) af[t][r] = t3[t];
            }
            uint32_t xf[P / 16][4];
#pragma unroll
            for (int np = 0; np < P / 16; ++np) {
              ldmatrix_x4_trans(xf[np], xh + tile_off<P>(kt * kTile + mr + 8 * (mi & 1),
                                                         2 * np + (mi >> 1)));
            }
            // term-major, so consecutive mma.sync write independent
            // accumulators
#pragma unroll
            for (int t = 0; t < kTerms; ++t) {
#pragma unroll
              for (int np = 0; np < P / 16; ++np) {
                mma_bf16(acc[2 * np], af[t], xf[np][0], xf[np][1]);
                mma_bf16(acc[2 * np + 1], af[t], xf[np][2], xf[np][3]);
              }
            }
          }
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int t = i0 + 8 * half;
            if (t >= Q) continue;
            float* yrow = y + ((static_cast<size_t>(b) * S + c0 + t) * H + h) * P + 2 * lq;
#pragma unroll
            for (int nt = 0; nt < kNt; ++nt) {
              *reinterpret_cast<float2*>(yrow + nt * 8) =
                  make_float2(acc[nt][2 * half], acc[nt][2 * half + 1]);
            }
          }
        }
      }
    }
    __syncthreads();  // this stage's x is no longer read
    if (pair + 2 < n_pairs) {
      stage_x(pair + 2, pair % 2 == 0 ? xs0 : xs1);
      cp_async_commit();
    }
  }
}

// ---------------------------------------------------------- float32 kernel

constexpr int kBR = 64;  // rows (queries) per CTA
constexpr int kBC = 64;  // keys per block
constexpr int kThreads = 256;

inline size_t f32_smem_bytes(int N, int P) {
  return sizeof(double) * kMaxQ +
         sizeof(float) * (2 * static_cast<size_t>(N) * (kBR + 4) +
                          static_cast<size_t>(kBC) * (P + 4) +
                          static_cast<size_t>(kBC) * (kBR + 4));
}

template <int P>
__global__ void __launch_bounds__(kThreads)
ssd_intra_chunk_f32_kernel(const float* __restrict__ x, const float* __restrict__ a,
                           const float* __restrict__ bm, const float* __restrict__ cm,
                           float* __restrict__ y, int S, int H, int G, int N, int Q,
                           long long xsb, long long xss, long long xsh, long long asb,
                           long long ass, long long ash, long long bsb, long long bss,
                           long long bsg, long long csb, long long css, long long csg) {
  constexpr int kPpt = P / 16;  // output dims per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* cs = reinterpret_cast<double*>(smem_raw);          // [kMaxQ]
  float* Cs = reinterpret_cast<float*>(cs + kMaxQ);           // [N][kBR + 4]
  float* Bs = Cs + N * (kBR + 4);                             // [N][kBC + 4]
  float* Xs = Bs + N * (kBC + 4);                             // [kBC][P + 4]
  float* Ss = Xs + kBC * (P + 4);                             // [kBC][kBR + 4]

  const int n_rb = (Q + kBR - 1) / kBR;
  const int chunk = blockIdx.x / n_rb;
  const int rb = blockIdx.x % n_rb;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (H / G);
  const int c0 = chunk * Q;     // first position of the chunk
  const int r0 = rb * kBR;      // first row of this CTA within the chunk
  const int tid = threadIdx.x;
  const int tx = tid % 16;      // key columns tx*4.. of S; dims tx*kPpt.. of y
  const int ty = tid / 16;      // rows ty*4 .. ty*4+3

  if (tid < 32) {
    chunk_cumsum(a + b * asb + static_cast<long long>(c0) * ass + h * ash, ass, Q,
                 [cs](int t, double v) { cs[t] = v; });
  }
  // C rows of this CTA, transposed; zero past the chunk
  for (int idx = tid; idx < kBR * N; idx += kThreads) {
    const int row = idx / N;
    const int k = idx % N;
    const int t = r0 + row;
    float cv = 0.f;
    if (t < Q) cv = cm[b * csb + static_cast<long long>(c0 + t) * css + g * csg + k];
    Cs[k * (kBR + 4) + row] = cv;
  }

  float o[4][kPpt];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < kPpt; ++e) o[i][e] = 0.f;

  for (int kb = 0; kb <= rb; ++kb) {  // key blocks above the diagonal are skipped
    const int k0 = kb * kBC;
    __syncthreads();  // cs / Cs staged; previous block's Bs / Xs / Ss reads done
    for (int idx = tid; idx < kBC * N; idx += kThreads) {
      const int row = idx / N;
      const int k = idx % N;
      const int t = k0 + row;
      float bv = 0.f;
      if (t < Q) bv = bm[b * bsb + static_cast<long long>(c0 + t) * bss + g * bsg + k];
      Bs[k * (kBC + 4) + row] = bv;
    }
    for (int idx = tid; idx < kBC * P; idx += kThreads) {
      const int row = idx / P;
      const int d = idx % P;
      const int t = k0 + row;
      float xv = 0.f;
      if (t < Q) xv = x[b * xsb + static_cast<long long>(c0 + t) * xss + h * xsh + d];
      Xs[row * (P + 4) + d] = xv;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int k = 0; k < N; ++k) {
      const float4 cv = *reinterpret_cast<const float4*>(&Cs[k * (kBR + 4) + ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[k * (kBC + 4) + tx * 4]);
      const float c4[4] = {cv.x, cv.y, cv.z, cv.w};
      const float b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] += c4[i] * b4[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ti = r0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int tj = k0 + tx * 4 + j;
        float s = 0.f;
        if (tj <= ti && ti < Q) s = sc[i][j] * expf(static_cast<float>(cs[ti] - cs[tj]));
        Ss[(tx * 4 + j) * (kBR + 4) + ty * 4 + i] = s;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBC; ++j) {
      const float4 s4 = *reinterpret_cast<const float4*>(&Ss[j * (kBR + 4) + ty * 4]);
      const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
      float xv[kPpt];
      const float* xrow = &Xs[j * (P + 4) + tx * kPpt];
      if constexpr (kPpt % 4 == 0) {
#pragma unroll
        for (int e = 0; e < kPpt; e += 4) {
          const float4 t = *reinterpret_cast<const float4*>(xrow + e);
          xv[e] = t.x;
          xv[e + 1] = t.y;
          xv[e + 2] = t.z;
          xv[e + 3] = t.w;
        }
      } else {
#pragma unroll
        for (int e = 0; e < kPpt; ++e) xv[e] = xrow[e];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < kPpt; ++e) o[i][e] += sv[i] * xv[e];
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = r0 + ty * 4 + i;
    if (t >= Q) continue;
    float* yrow = y + ((static_cast<size_t>(b) * S + c0 + t) * H + h) * P + tx * kPpt;
#pragma unroll
    for (int e = 0; e < kPpt; ++e) yrow[e] = o[i][e];
  }
}

// ------------------------------------------------------------------ host

// raise the kernel's dynamic shared-memory limit to `bytes`, once per device
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, int (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev] >= static_cast<int>(bytes)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = static_cast<int>(bytes);
  return err;
}

template <int P>
int launch_tc(const void* x, const float* a, const void* bm, const void* cm, float* y, int B,
              int S, int H, int G, int N, int Q, int hpc, const long long* st,
              cudaStream_t stream) {
  static int done[kMaxDevices] = {};
  const size_t bytes = TcSmem<P>::kBytes;
  const cudaError_t err = allow_smem(ssd_intra_chunk_tc_kernel<P>, bytes, done);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_hb = (H / G + hpc - 1) / hpc;
  const dim3 grid((S / Q) * G * n_hb, B);
  ssd_intra_chunk_tc_kernel<P><<<grid, kTcThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x), a, static_cast<const __nv_bfloat16*>(bm),
      static_cast<const __nv_bfloat16*>(cm), y, S, H, G, N, Q, hpc, st[0], st[1], st[2], st[3],
      st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11]);
  return static_cast<int>(cudaGetLastError());
}

template <int P>
int launch_f32(const void* x, const float* a, const void* bm, const void* cm, float* y, int B,
               int S, int H, int G, int N, int Q, const long long* st, cudaStream_t stream) {
  static int done[kMaxDevices] = {};
  const size_t bytes = f32_smem_bytes(N, P);
  const cudaError_t err = allow_smem(ssd_intra_chunk_f32_kernel<P>, bytes, done);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_rb = (Q + kBR - 1) / kBR;
  const dim3 grid((S / Q) * n_rb, H, B);
  ssd_intra_chunk_f32_kernel<P><<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(x), a, static_cast<const float*>(bm),
      static_cast<const float*>(cm), y, S, H, G, N, Q, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9], st[10], st[11]);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strides (in elements): x (batch, seq, head), a (batch, seq, head),
// Bm (batch, seq, group), Cm (batch, seq, group); the last axis of x, Bm and
// Cm is contiguous.  is_bf16: 1 for bf16 x / Bm / Cm (the tensor-core kernel,
// `hpc` heads per CTA; N a multiple of 8, x / Bm / Cm bases and strides
// 16-byte aligned), 0 for float32 (hpc unused).  S must be a multiple of Q,
// Q <= 128, H a multiple of G, N <= 256, P one of 16, 32, 64, 128.
extern "C" int repro_ssd_intra_chunk(const void* x, const void* a, const void* bm, const void* cm,
                                     void* y, int B, int S, int H, int G, int N, int P, int Q,
                                     int hpc, int is_bf16, const long long* strides,
                                     void* stream) {
  if (B <= 0 || S <= 0 || Q <= 0 || Q > kMaxQ || S % Q != 0 || G <= 0 || H % G != 0 ||
      N <= 0 || N > 256 || (is_bf16 && (N % 8 != 0 || hpc <= 0 || hpc > kMaxHeads))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* ap = static_cast<const float*>(a);
  auto* yp = static_cast<float*>(y);
  auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    switch (P) {
      case 16: return launch_tc<16>(x, ap, bm, cm, yp, B, S, H, G, N, Q, hpc, strides, s);
      case 32: return launch_tc<32>(x, ap, bm, cm, yp, B, S, H, G, N, Q, hpc, strides, s);
      case 64: return launch_tc<64>(x, ap, bm, cm, yp, B, S, H, G, N, Q, hpc, strides, s);
      case 128: return launch_tc<128>(x, ap, bm, cm, yp, B, S, H, G, N, Q, hpc, strides, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  switch (P) {
    case 16: return launch_f32<16>(x, ap, bm, cm, yp, B, S, H, G, N, Q, strides, s);
    case 32: return launch_f32<32>(x, ap, bm, cm, yp, B, S, H, G, N, Q, strides, s);
    case 64: return launch_f32<64>(x, ap, bm, cm, yp, B, S, H, G, N, Q, strides, s);
    case 128: return launch_f32<128>(x, ap, bm, cm, yp, B, S, H, G, N, Q, strides, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
