// Paged GQA decode attention: one query token per (slot, head) against the
// slot's pages of one layer's K/V page pool.
//
//   q     bf16 [B, H, D]            this step's queries (rope applied)
//   k, v  bf16 [P, page, Hkv, D]    the layer's page pools
//   block int32 [B, pps]            page ids of each slot (0 = null page)
//   lens  int32 [B]                 valid tokens per slot (new token included)
//   out   bf16 [B, H, D]
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/decode_attention/decode_attention.py::gqa_decode_attention
// and its paged front-end ops.py::paged_decode_attention_op, which first
// gathers every slot's pages into a contiguous [B, Smax, Hkv, D] copy.  This
// kernel reads the block table itself, so no copy of the cache is made.
//
// What bounds it on the H100: each valid K/V row is read once and used for
// 2*D operations per grouped head, far below the card's 295 operations per
// byte, so it is bound by device memory bytes (the slots' valid K/V rows).
//
// Design (simple and exact; split-KV and an int8 pool variant are later):
//  * one CTA (128 threads) per (slot, kv head), walking the slot's valid
//    tokens in tiles of 64 in order; the tile's page ids come from the
//    block table, read in-kernel;
//  * scores: 16-byte loads of each K row, D/8 lanes per token (rounded up
//    to a power of two: 16 lanes, two idle, at D = 112), the grouped
//    heads of the kv head (GQA fold) share every K load; lane shuffles sum
//    the dot products;
//  * f32 online softmax per grouped head (max, exp, running sum, rescale),
//    scores scaled by 1/sqrt(D) and positions >= length at -1e30, as the
//    Pallas kernel does;
//  * each thread owns (head, dim) accumulators and streams the V rows
//    (coalesced across the CTA);
//  * output acc / max(l, 1e-20): a length-0 lane walks no tile and comes
//    out 0, finite (the Pallas kernel gives the uniform mean there; callers
//    ignore inactive lanes either way).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* f) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

template <int D, int MAXR>
__global__ void __launch_bounds__(kThreads)
paged_decode_attention_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k_pages,
                              const __nv_bfloat16* __restrict__ v_pages,
                              const int* __restrict__ block_table,
                              const int* __restrict__ lengths,
                              __nv_bfloat16* __restrict__ out, int H, int Hkv,
                              int page, int pps, float scale) {
  constexpr int kChunks = D / 8;                // 16-byte chunks per row
  // lanes per token: kChunks rounded up to a power of two, so a token's
  // lanes never straddle two tokens and the shuffle sum stays within them;
  // lanes past kChunks (D = 112: lanes 14 and 15 of each 16) load nothing
  constexpr int kLanesPerTok = kChunks <= 2 ? 2 : kChunks <= 4 ? 4 : kChunks <= 8 ? 8 : 16;
  constexpr int kTokPerWarp = 32 / kLanesPerTok;
  constexpr int kAcc = (MAXR * D + kThreads - 1) / kThreads;
  static_assert(kTile % (kWarps * kTokPerWarp) == 0, "tile must split evenly");

  __shared__ float s_p[MAXR][kTile];  // scores, then probabilities
  __shared__ int s_row[kTile];        // pool row (pid * page + offset) per token
  __shared__ float s_m[MAXR], s_l[MAXR], s_corr[MAXR];

  const int g = blockIdx.x;  // kv head
  const int b = blockIdx.y;  // slot
  const int n_rep = H / Hkv;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int chunk = lane % kLanesPerTok;  // this lane's 8 dims of a row
  const int tsub = lane / kLanesPerTok;   // this lane's token within a pass
  const bool has_chunk = chunk < kChunks;
  const int L = lengths[b];

  float qf[MAXR][8];
#pragma unroll
  for (int r = 0; r < MAXR; ++r) {
    if (r < n_rep && has_chunk) {
      load8(q + (static_cast<size_t>(b) * H + g * n_rep + r) * D + chunk * 8, qf[r]);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) qf[r][e] = 0.f;
    }
  }
  if (tid < MAXR) {
    s_m[tid] = kNegInf;
    s_l[tid] = 0.f;
  }
  __syncthreads();
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;

  const size_t row_stride = static_cast<size_t>(Hkv) * D;  // elements per pool row
  for (int t0 = 0; t0 < L; t0 += kTile) {
    const int tile_len = min(kTile, L - t0);
    if (tid < kTile) {
      const int t = t0 + tid;
      s_row[tid] = (t < L) ? block_table[static_cast<size_t>(b) * pps + t / page] * page + t % page
                           : -1;
    }
    __syncthreads();
    // scores of every grouped head for every token of the tile
    for (int tt = warp * kTokPerWarp + tsub; tt < kTile; tt += kWarps * kTokPerWarp) {
      const int row = s_row[tt];
      float dot[MAXR];
#pragma unroll
      for (int r = 0; r < MAXR; ++r) dot[r] = 0.f;
      if (row >= 0 && has_chunk) {
        float kf[8];
        load8(k_pages + static_cast<size_t>(row) * row_stride + static_cast<size_t>(g) * D +
                  chunk * 8,
              kf);
#pragma unroll
        for (int r = 0; r < MAXR; ++r) {
#pragma unroll
          for (int e = 0; e < 8; ++e) dot[r] += qf[r][e] * kf[e];
        }
      }
#pragma unroll
      for (int r = 0; r < MAXR; ++r) {
#pragma unroll
        for (int off = kLanesPerTok / 2; off > 0; off /= 2) {
          dot[r] += __shfl_xor_sync(0xffffffffu, dot[r], off);
        }
      }
      if (chunk == 0) {
#pragma unroll
        for (int r = 0; r < MAXR; ++r) {
          if (r < n_rep) s_p[r][tt] = (row >= 0) ? dot[r] * scale : kNegInf;
        }
      }
    }
    __syncthreads();
    // online softmax, one warp per grouped head
    for (int r = warp; r < n_rep; r += kWarps) {
      float mx = kNegInf;
      for (int j = lane; j < kTile; j += 32) mx = fmaxf(mx, s_p[r][j]);
#pragma unroll
      for (int off = 16; off > 0; off /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = s_m[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < kTile; j += 32) {
        const float p = expf(s_p[r][j] - m_new);
        s_p[r][j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        s_corr[r] = corr;
        s_l[r] = s_l[r] * corr + sum;
        s_m[r] = m_new;
      }
    }
    __syncthreads();
    // acc = acc * corr + p @ v
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int idx = tid + i * kThreads;
      if (idx < n_rep * D) {
        const int r = idx / D;
        const int d = idx % D;
        float a = acc[i] * s_corr[r];
        const __nv_bfloat16* vcol = v_pages + static_cast<size_t>(g) * D + d;
#pragma unroll 8
        for (int j = 0; j < tile_len; ++j) {
          a += s_p[r][j] * __bfloat162float(vcol[static_cast<size_t>(s_row[j]) * row_stride]);
        }
        acc[i] = a;
      }
    }
    __syncthreads();  // the next tile overwrites s_row / s_p
  }
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int idx = tid + i * kThreads;
    if (idx < n_rep * D) {
      const int r = idx / D;
      const int d = idx % D;
      out[(static_cast<size_t>(b) * H + g * n_rep + r) * D + d] =
          __float2bfloat16(acc[i] / fmaxf(s_l[r], 1e-20f));
    }
  }
}

template <int D>
int launch_for_dim(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                   const int* block, const int* lens, __nv_bfloat16* out, int B, int H,
                   int Hkv, int page, int pps, float scale, cudaStream_t s) {
  const dim3 grid(Hkv, B);
  const int n_rep = H / Hkv;
  if (n_rep <= 1) {
    paged_decode_attention_kernel<D, 1><<<grid, kThreads, 0, s>>>(q, k, v, block, lens, out, H,
                                                                  Hkv, page, pps, scale);
  } else if (n_rep <= 2) {
    paged_decode_attention_kernel<D, 2><<<grid, kThreads, 0, s>>>(q, k, v, block, lens, out, H,
                                                                  Hkv, page, pps, scale);
  } else if (n_rep <= 4) {
    paged_decode_attention_kernel<D, 4><<<grid, kThreads, 0, s>>>(q, k, v, block, lens, out, H,
                                                                  Hkv, page, pps, scale);
  } else if (n_rep <= 8) {
    paged_decode_attention_kernel<D, 8><<<grid, kThreads, 0, s>>>(q, k, v, block, lens, out, H,
                                                                  Hkv, page, pps, scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_paged_decode_attention(const void* q, const void* k_pages,
                                            const void* v_pages, const void* block_table,
                                            const void* lengths, void* out, int B, int H,
                                            int Hkv, int D, int page, int pps, float scale,
                                            void* stream) {
  if (B <= 0 || Hkv <= 0 || H % Hkv != 0 || page <= 0 || pps <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k_pages);
  const auto* vp = static_cast<const __nv_bfloat16*>(v_pages);
  const auto* bt = static_cast<const int*>(block_table);
  const auto* ln = static_cast<const int*>(lengths);
  auto* op = static_cast<__nv_bfloat16*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_for_dim<16>(qp, kp, vp, bt, ln, op, B, H, Hkv, page, pps, scale, s);
    case 32: return launch_for_dim<32>(qp, kp, vp, bt, ln, op, B, H, Hkv, page, pps, scale, s);
    case 64: return launch_for_dim<64>(qp, kp, vp, bt, ln, op, B, H, Hkv, page, pps, scale, s);
    case 112: return launch_for_dim<112>(qp, kp, vp, bt, ln, op, B, H, Hkv, page, pps, scale, s);
    case 128: return launch_for_dim<128>(qp, kp, vp, bt, ln, op, B, H, Hkv, page, pps, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
