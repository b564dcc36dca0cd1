// Diagnostic copy of the paged decode attention kernel as it stood before
// the split-KV redesign (one 128-thread CTA per (slot, kv head) walking the
// slot's keys in tiles of 64), its source unchanged but for two template
// switches, so that kernels/diag_b1_passes.py can time its passes apart at
// head dims 112 and 128.  Not part of the kernel library; built by that
// script alone.  With PASSES = 3 and DS = D it compiles to the kernel as it
// was.
//
//   PASSES  bit 0: the K pass loads K rows (without it the scores are 0)
//           bit 1: the V pass runs (without it nothing of V is read)
//   DS      elements between the rows of two kv heads in the pools
//           [P, page, Hkv, DS] (D, or 128 to give D = 112 rows that start
//           256 bytes apart as D = 128 rows do)

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

template <int D, int MAXR, int PASSES, int DS>
__global__ void __launch_bounds__(kThreads)
decode_attention_pr14_kernel(const __nv_bfloat16* __restrict__ q,
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

  const size_t row_stride = static_cast<size_t>(Hkv) * DS;  // elements per pool row
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
      if ((PASSES & 1) && row >= 0 && has_chunk) {
        float kf[8];
        load8(k_pages + static_cast<size_t>(row) * row_stride + static_cast<size_t>(g) * DS +
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
    for (int i = 0; i < ((PASSES & 2) ? kAcc : 0); ++i) {
      const int idx = tid + i * kThreads;
      if (idx < n_rep * D) {
        const int r = idx / D;
        const int d = idx % D;
        float a = acc[i] * s_corr[r];
        const __nv_bfloat16* vcol = v_pages + static_cast<size_t>(g) * DS + d;
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

template <int D, int PASSES>
int launch_passes(int dstride, const dim3& grid, cudaStream_t s, const __nv_bfloat16* q,
                  const __nv_bfloat16* k, const __nv_bfloat16* v, const int* block,
                  const int* lens, __nv_bfloat16* out, int H, int page, int pps, float scale) {
  if (dstride == D) {
    decode_attention_pr14_kernel<D, 1, PASSES, D><<<grid, kThreads, 0, s>>>(
        q, k, v, block, lens, out, H, H, page, pps, scale);
  } else if (dstride == 128) {
    decode_attention_pr14_kernel<D, 1, PASSES, 128><<<grid, kThreads, 0, s>>>(
        q, k, v, block, lens, out, H, H, page, pps, scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_for_dim(int passes, int dstride, const dim3& grid, cudaStream_t s,
                   const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                   const int* block, const int* lens, __nv_bfloat16* out, int H, int page,
                   int pps, float scale) {
  switch (passes) {
    case 1: return launch_passes<D, 1>(dstride, grid, s, q, k, v, block, lens, out, H, page, pps, scale);
    case 2: return launch_passes<D, 2>(dstride, grid, s, q, k, v, block, lens, out, H, page, pps, scale);
    case 3: return launch_passes<D, 3>(dstride, grid, s, q, k, v, block, lens, out, H, page, pps, scale);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// MHA (Hkv = H) only; D 128 or 112; dstride D or 128
extern "C" int diag_decode_attention_pr14(const void* q, const void* k, const void* v,
                                          const void* block, const void* lens, void* out, int B,
                                          int H, int D, int page, int pps, int dstride,
                                          int passes, float scale, void* stream) {
  const dim3 grid(H, B);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  const auto* bt = static_cast<const int*>(block);
  const auto* ln = static_cast<const int*>(lens);
  auto* op = static_cast<__nv_bfloat16*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (D == 128) return launch_for_dim<128>(passes, dstride, grid, s, qp, kp, vp, bt, ln, op, H, page, pps, scale);
  if (D == 112) return launch_for_dim<112>(passes, dstride, grid, s, qp, kp, vp, bt, ln, op, H, page, pps, scale);
  return static_cast<int>(cudaErrorInvalidValue);
}
