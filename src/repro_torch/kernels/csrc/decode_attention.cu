// Paged GQA decode attention: one query token per (slot, head) against the
// slot's pages of one layer's K/V page pool.
//
//   q     bf16 [B, H, D]            this step's queries (rope applied)
//   k, v  bf16 [P, page, Hkv, D]    the layer's page pools
//   block int32 [B, pps]            page ids of each slot (0 = null page)
//   lens  int32 [B]                 valid tokens per slot (new token included)
//   ws    f32  [B, H, n_split, D+2] the splits' partials (scratch)
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
// The tensor cores do not help: the served models are MHA (one query row
// per K/V row).  What matters is having the bytes in flight on every SM.
//
// Design: split-KV with a fixed-order combine, two kernels launched from one
// C entry.
//  * Split kernel, one CTA (128 threads) per (split, kv head, slot).  A
//    split is kSplit = 64 keys; split s holds keys [64 s, 64 s + 64) of
//    its slot, so a slot's splits and their arithmetic depend on its own
//    length alone (never on B, pps, the page size or the SM count).  CTAs
//    past a slot's last split return at once.
//  * The CTA issues every 16-byte chunk of its split's valid K rows, then of
//    its V rows, as cp.async copies into shared memory (two commit groups),
//    so all of the split's bytes (32 KB at D = 128) are in flight at once
//    and V arrives while K is reduced.  32 KB a CTA lets 7 CTAs share an
//    SM, so nearly all of a batch's splits are in flight together.  Rows past the length are not loaded:
//    their scores are set to -1e30 and the V sum stops at the length.  The
//    chunks are numbered row-major over D/8 chunks a row, so D = 112 (14
//    chunks) uses every thread as D = 128 does.  Page ids come from the
//    block table, read in-kernel, one per key.
//  * Scores: D/8 lanes per key (rounded up to a power of two) read the K row
//    from shared memory; the grouped heads of the kv head (GQA) share it;
//    lane shuffles sum the dot products.  Scaled by 1/sqrt(D); keys past the
//    length at -1e30.  Then per grouped head the split's max m, p = exp(s - m)
//    and l = sum p.  p @ V from shared memory with the same lane layout: a
//    thread sums its 8 dims over every 8th key (D >= 72), and the partial
//    sums are merged in a fixed order.  The partial (acc[D], m, l) goes to
//    the workspace in float32.
//  * Combine kernel, one CTA per (head, slot): M = max of the splits' m;
//    out = sum_s acc_s e^(m_s - M) / sum_s l_s e^(m_s - M), both sums taken
//    in split-index order, rounded once to bf16.  A length-0 slot has no
//    split and comes out 0, finite (the Pallas kernel gives the uniform mean
//    there; callers ignore inactive lanes either way).
//  Every sum is taken in an order fixed by the key's position, so a slot's
//  output bits are the same in any batch and under any block-table width.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kSplit = 64;  // keys per split; the wrapper's ref.SPLIT

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

// 16 bytes global -> shared, asynchronous (cached in L2 only)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int D>
constexpr int smem_bytes() {
  return 2 * kSplit * D * 2;  // the split's K and V rows, bf16
}

template <int D, int MAXR>
__global__ void __launch_bounds__(kThreads)
paged_decode_attention_split_kernel(const __nv_bfloat16* __restrict__ q,
                                    const __nv_bfloat16* __restrict__ k_pages,
                                    const __nv_bfloat16* __restrict__ v_pages,
                                    const int* __restrict__ block_table,
                                    const int* __restrict__ lengths,
                                    float* __restrict__ ws, int H, int Hkv, int page,
                                    int pps, int n_split, float scale) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  // lanes per key: kChunks rounded up to a power of two, so a key's lanes
  // never straddle two keys and the shuffle sum stays within them
  constexpr int kLanesPerTok = kChunks <= 2 ? 2 : kChunks <= 4 ? 4 : kChunks <= 8 ? 8 : 16;
  constexpr int kTokPerWarp = 32 / kLanesPerTok;
  static_assert(kSplit % (kWarps * kTokPerWarp) == 0, "split must divide evenly");
  static_assert(kWarps * MAXR * D * 4 <= kSplit * D * 2, "the warps' V sums fit in the K rows");

  extern __shared__ __align__(16) uint8_t smem_raw[];
  __nv_bfloat16* sk = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kSplit][D]
  __nv_bfloat16* sv = sk + kSplit * D;                                // [kSplit][D]
  __shared__ float s_p[MAXR][kSplit];  // scores, then probabilities
  __shared__ int s_row[kSplit];        // pool row (pid * page + offset) per key
  __shared__ float s_m[MAXR], s_l[MAXR];

  const int split = blockIdx.x;
  const int g = blockIdx.y;  // kv head
  const int b = blockIdx.z;  // slot
  const int L = min(lengths[b], pps * page);  // the plain version masks no key past its rows
  const int t0 = split * kSplit;
  if (t0 >= L) return;  // past the slot's last split: the whole CTA leaves
  const int n_tok = min(kSplit, L - t0);
  const int n_rep = H / Hkv;
  const int tid = threadIdx.x;

  for (int i = tid; i < n_tok; i += kThreads) {
    const int t = t0 + i;
    s_row[i] = block_table[static_cast<size_t>(b) * pps + t / page] * page + t % page;
  }
  __syncthreads();
  const size_t row_stride = static_cast<size_t>(Hkv) * D;  // elements per pool row
  const __nv_bfloat16* kg = k_pages + static_cast<size_t>(g) * D;
  const __nv_bfloat16* vg = v_pages + static_cast<size_t>(g) * D;
  for (int i = tid; i < n_tok * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    cp_async16(sk + r * D + c * 8, kg + s_row[r] * row_stride + c * 8);
  }
  cp_async_commit();
  for (int i = tid; i < n_tok * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    cp_async16(sv + r * D + c * 8, vg + s_row[r] * row_stride + c * 8);
  }
  cp_async_commit();

  const int warp = tid / 32;
  const int lane = tid % 32;
  const int chunk = lane % kLanesPerTok;  // this lane's 8 dims of a row
  const int tsub = lane / kLanesPerTok;   // this lane's key within a pass
  const bool has_chunk = chunk < kChunks;
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

  cp_async_wait<1>();  // this thread's K chunks have landed
  __syncthreads();     // and everyone's
  for (int tt = warp * kTokPerWarp + tsub; tt < kSplit; tt += kWarps * kTokPerWarp) {
    float dot[MAXR];
#pragma unroll
    for (int r = 0; r < MAXR; ++r) dot[r] = 0.f;
    if (has_chunk && tt < n_tok) {
      float kf[8];
      load8(sk + tt * D + chunk * 8, kf);
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
        if (r < n_rep) s_p[r][tt] = tt < n_tok ? dot[r] * scale : kNegInf;
      }
    }
  }
  __syncthreads();
  // the split's softmax numerators, one warp per grouped head
  for (int r = warp; r < n_rep; r += kWarps) {
    float mx = kNegInf;
    for (int j = lane; j < kSplit; j += 32) mx = fmaxf(mx, s_p[r][j]);
#pragma unroll
    for (int off = 16; off > 0; off /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int j = lane; j < kSplit; j += 32) {
      const float p = expf(s_p[r][j] - mx);
      s_p[r][j] = p;
      sum += p;
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      s_m[r] = mx;
      s_l[r] = sum;
    }
  }
  cp_async_wait<0>();  // V
  __syncthreads();
  // acc = p @ v: each thread sums the 8 dims of its lane's chunk over the
  // keys of its key group (keys kgi, kgi + 8, ... at D = 128), 16-byte rows
  // from shared memory; the key groups are then summed in a fixed order,
  // lane shuffles within a warp and the four warps through shared memory
  // (the K rows, done with, hold the warps' sums)
  constexpr int kGroups = kWarps * kTokPerWarp;
  float acc[MAXR][8];
#pragma unroll
  for (int r = 0; r < MAXR; ++r) {
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[r][e] = 0.f;
  }
  if (has_chunk) {
    for (int j = warp * kTokPerWarp + tsub; j < n_tok; j += kGroups) {
      float vf[8];
      load8(sv + j * D + chunk * 8, vf);
#pragma unroll
      for (int r = 0; r < MAXR; ++r) {
        if (r < n_rep) {
          const float p = s_p[r][j];
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[r][e] += p * vf[e];
        }
      }
    }
  }
#pragma unroll
  for (int off = kLanesPerTok; off < 32; off *= 2) {
#pragma unroll
    for (int r = 0; r < MAXR; ++r) {
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[r][e] += __shfl_xor_sync(0xffffffffu, acc[r][e], off);
    }
  }
  float* red = reinterpret_cast<float*>(sk);  // [kWarps][MAXR][D]
  if (tsub == 0 && has_chunk) {
#pragma unroll
    for (int r = 0; r < MAXR; ++r) {
      if (r < n_rep) {
#pragma unroll
        for (int e = 0; e < 8; ++e) red[(warp * MAXR + r) * D + chunk * 8 + e] = acc[r][e];
      }
    }
  }
  __syncthreads();
  float* acc_out = ws + (static_cast<size_t>(b) * H + g * n_rep) * n_split * (D + 2);
  for (int idx = tid; idx < n_rep * D; idx += kThreads) {
    const int r = idx / D;
    const int d = idx % D;
    float a = red[r * D + d];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) a += red[(w * MAXR + r) * D + d];
    acc_out[(static_cast<size_t>(r) * n_split + split) * (D + 2) + d] = a;
  }
  if (tid < n_rep) {
    float* ml = acc_out + (static_cast<size_t>(tid) * n_split + split) * (D + 2) + D;
    ml[0] = s_m[tid];
    ml[1] = s_l[tid];
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_attention_combine_kernel(const float* __restrict__ ws,
                                      const int* __restrict__ lengths,
                                      __nv_bfloat16* __restrict__ out, int H, int n_split) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int ns = min((lengths[b] + kSplit - 1) / kSplit, n_split);
  const float* part = ws + (static_cast<size_t>(b) * H + h) * n_split * (D + 2);
  float m = kNegInf;
  for (int s = 0; s < ns; ++s) m = fmaxf(m, part[s * (D + 2) + D]);
  float l = 0.f;
  for (int s = 0; s < ns; ++s) {
    l += part[s * (D + 2) + D + 1] * expf(part[s * (D + 2) + D] - m);
  }
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float a = 0.f;
    for (int s = 0; s < ns; ++s) {
      a += part[s * (D + 2) + d] * expf(part[s * (D + 2) + D] - m);
    }
    out[(static_cast<size_t>(b) * H + h) * D + d] = __float2bfloat16(a / fmaxf(l, 1e-20f));
  }
}

template <int D, int MAXR>
cudaError_t launch_split(const dim3& grid, const __nv_bfloat16* q, const __nv_bfloat16* k,
                         const __nv_bfloat16* v, const int* block, const int* lens, float* ws,
                         int H, int Hkv, int page, int pps, int n_split, float scale,
                         cudaStream_t s) {
  // above 48 KB of dynamic shared memory needs the kernel's opt-in
  const cudaError_t err = cudaFuncSetAttribute(paged_decode_attention_split_kernel<D, MAXR>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               smem_bytes<D>());
  if (err != cudaSuccess) return err;
  paged_decode_attention_split_kernel<D, MAXR><<<grid, kThreads, smem_bytes<D>(), s>>>(
      q, k, v, block, lens, ws, H, Hkv, page, pps, n_split, scale);
  return cudaGetLastError();
}

template <int D>
int launch_for_dim(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                   const int* block, const int* lens, float* ws, __nv_bfloat16* out, int B,
                   int H, int Hkv, int page, int pps, int n_split, float scale,
                   cudaStream_t s) {
  const dim3 grid(n_split, Hkv, B);
  const int n_rep = H / Hkv;
  cudaError_t err;
  if (n_rep <= 1) {
    err = launch_split<D, 1>(grid, q, k, v, block, lens, ws, H, Hkv, page, pps, n_split, scale, s);
  } else if (n_rep <= 2) {
    err = launch_split<D, 2>(grid, q, k, v, block, lens, ws, H, Hkv, page, pps, n_split, scale, s);
  } else if (n_rep <= 4) {
    err = launch_split<D, 4>(grid, q, k, v, block, lens, ws, H, Hkv, page, pps, n_split, scale, s);
  } else if (n_rep <= 8) {
    err = launch_split<D, 8>(grid, q, k, v, block, lens, ws, H, Hkv, page, pps, n_split, scale, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  paged_decode_attention_combine_kernel<D><<<dim3(H, B), kThreads, 0, s>>>(ws, lens, out, H,
                                                                           n_split);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// n_split must be ceil(pps * page / kSplit) and ws hold B * H * n_split *
// (D + 2) floats
extern "C" int repro_paged_decode_attention(const void* q, const void* k_pages,
                                            const void* v_pages, const void* block_table,
                                            const void* lengths, void* ws, void* out, int B,
                                            int H, int Hkv, int D, int page, int pps,
                                            int n_split, float scale, void* stream) {
  if (B <= 0 || Hkv <= 0 || H % Hkv != 0 || page <= 0 || pps <= 0 ||
      n_split != (pps * page + kSplit - 1) / kSplit) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k_pages);
  const auto* vp = static_cast<const __nv_bfloat16*>(v_pages);
  const auto* bt = static_cast<const int*>(block_table);
  const auto* ln = static_cast<const int*>(lengths);
  auto* wp = static_cast<float*>(ws);
  auto* op = static_cast<__nv_bfloat16*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_for_dim<16>(qp, kp, vp, bt, ln, wp, op, B, H, Hkv, page, pps, n_split, scale, s);
    case 32: return launch_for_dim<32>(qp, kp, vp, bt, ln, wp, op, B, H, Hkv, page, pps, n_split, scale, s);
    case 64: return launch_for_dim<64>(qp, kp, vp, bt, ln, wp, op, B, H, Hkv, page, pps, n_split, scale, s);
    case 112: return launch_for_dim<112>(qp, kp, vp, bt, ln, wp, op, B, H, Hkv, page, pps, n_split, scale, s);
    case 128: return launch_for_dim<128>(qp, kp, vp, bt, ln, wp, op, B, H, Hkv, page, pps, n_split, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
