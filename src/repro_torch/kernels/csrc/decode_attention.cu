// Paged GQA attention over one layer's K/V page pool at decode (B1): one
// query token per (slot, head).
//
//   q      bf16 [B, H, D]            this step's queries (rope applied)
//   k, v   bf16 or int8 [P, page, Hkv, D]   the layer's page pools
//   ks, vs f32 [P, page, Hkv]        int8 pools only: one scale per row and head
//   block  int32 [B, pps]            page ids of each slot (0 = null page)
//   lens   int32 [B]                 valid tokens per slot (new token included)
//   ws     f32  [B, H, n_split, D+2] the splits' partials (scratch)
//   out    bf16 [B, H, D]
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/decode_attention/decode_attention.py::gqa_decode_attention
// and its paged front-end ops.py::paged_decode_attention_op, which first
// gathers every slot's pages into a contiguous [B, Smax, Hkv, D] copy; this
// kernel reads the block table itself, so no copy of the cache is made.
// (A prefill chunk's queries run paged_chunk_attention.cu, B3's arithmetic.)
//
// What bounds it on the H100: each valid K/V row is read once per CTA and
// used for 2*D operations per grouped head, far below the card's 295
// operations per byte, so B1 is bound by device memory bytes (the slots'
// valid K/V rows).  int8 pools halve the bytes: codes and one float32
// scale per row and head.
//
// Design: split-KV with a fixed-order combine, two kernels launched from one
// C entry.
//  * Split kernel, one CTA (128 threads) per (split, kv head, slot).  A
//    split is kSplit = 64 keys; split s holds keys [64 s, 64 s + 64) of its
//    slot, so a query's splits and their arithmetic depend on its own
//    length alone (never on B, pps, the page size or the SM count).  CTAs
//    past the last split of their slot return at once.
//  * The CTA issues every 16-byte chunk of its split's valid K rows, then of
//    its V rows, as cp.async copies into shared memory (two commit groups),
//    so all of the split's bytes (32 KB at D = 128 in bf16) are in flight at
//    once and V arrives while K is reduced.  Rows past the length are not
//    loaded: their scores are set to -1e30 and the V sum stops at the
//    length.  Page ids come from the block table, read in-kernel, one per
//    key; an int8 pool's scales come beside the rows.
//  * Scores by D/8 lanes per key (rounded up to a power of two) over 8
//    dims each, the grouped heads of the kv head (GQA) sharing the K row,
//    lane shuffles summing the dot products; an int8 element dequantized
//    in registers as float(q) * scale, one float32 product.  Scaled by
//    1/sqrt(D); keys past the length at -1e30.  Then per grouped head the
//    split's max m, p = exp(s - m) and l = sum p; p @ V with the same lane
//    layout, a thread summing its 8 dims over every 8th key (D >= 72), the
//    partial sums merged in a fixed order.  The partial (acc[D], m, l) goes
//    to the workspace in float32.
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

#include <type_traits>

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

// 8 elements of a K or V row as float32: bf16 as they are, int8 codes times
// the row's scale (JAX's dequantize_rows: one float32 product)
__device__ __forceinline__ void load_row8(const __nv_bfloat16* p, float, float* f) {
  load8(p, f);
}
__device__ __forceinline__ void load_row8(const int8_t* p, float scale, float* f) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const int8_t* c = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] = static_cast<float>(c[i]) * scale;
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

struct Params {
  const __nv_bfloat16* q;
  const void* k;     // KT [P, page, Hkv, D]
  const void* v;
  const float* ks;   // int8 pools: [P, page, Hkv] scales; else null
  const float* vs;
  const int* block;  // [B, pps]
  const int* lens;
  float* ws;
  __nv_bfloat16* out;
  int H, Hkv, page, pps, n_split;
  float scale;
};

// lane layout of the per-query arithmetic: D/8 lanes per key (8 dims each),
// rounded up to a power of two so a key's lanes never straddle two keys and
// the shuffle sum stays within them
template <int D>
struct Lanes {
  static constexpr int kChunks = D / 8;
  static constexpr int kPerTok = kChunks <= 2 ? 2 : kChunks <= 4 ? 4 : kChunks <= 8 ? 8 : 16;
  static constexpr int kTokPerWarp = 32 / kPerTok;
  static constexpr int kGroups = kWarps * kTokPerWarp;  // key groups of the p @ V sums
  static_assert(kSplit % kGroups == 0, "split must divide evenly");
};

template <typename KT>
__host__ __device__ constexpr bool is_int8() {
  return std::is_same<KT, int8_t>::value;
}

// dynamic shared memory: the split's K and V rows, an int8 pool's row
// scales, and the warps' p @ V sums; over bf16 pools those sums go in the
// K rows once the scores are done (the layout before int8 pools)
template <int D, int MAXR, typename KT>
__host__ __device__ constexpr int smem_bytes() {
  return 2 * kSplit * D * static_cast<int>(sizeof(KT)) + (is_int8<KT>() ? 2 * kSplit * 4 : 0) +
         (is_int8<KT>() ? kWarps * MAXR * D * 4 : 0);
}

// issue the split's n_tok K rows, then its V rows, as 16-byte cp.async
// copies (two commit groups); an int8 pool's row scales by plain loads
template <int D, typename KT>
__device__ __forceinline__ void issue_split_loads(const Params& p, int g, const int* s_row,
                                                  int n_tok, KT* sk, KT* sv, float* sks,
                                                  float* svs) {
  constexpr int kCopies = D * static_cast<int>(sizeof(KT)) / 16;  // per row
  const size_t row_stride = static_cast<size_t>(p.Hkv) * D;        // elements per pool row
  const KT* kg = static_cast<const KT*>(p.k) + static_cast<size_t>(g) * D;
  const KT* vg = static_cast<const KT*>(p.v) + static_cast<size_t>(g) * D;
  const int tid = threadIdx.x;
  for (int i = tid; i < n_tok * kCopies; i += kThreads) {
    const int r = i / kCopies, c = i % kCopies;
    cp_async16(reinterpret_cast<uint8_t*>(sk + r * D) + c * 16,
               reinterpret_cast<const uint8_t*>(kg + s_row[r] * row_stride) + c * 16);
  }
  cp_async_commit();
  for (int i = tid; i < n_tok * kCopies; i += kThreads) {
    const int r = i / kCopies, c = i % kCopies;
    cp_async16(reinterpret_cast<uint8_t*>(sv + r * D) + c * 16,
               reinterpret_cast<const uint8_t*>(vg + s_row[r] * row_stride) + c * 16);
  }
  cp_async_commit();
  if constexpr (is_int8<KT>()) {
    for (int i = tid; i < n_tok; i += kThreads) {
      sks[i] = p.ks[static_cast<size_t>(s_row[i]) * p.Hkv + g];
      svs[i] = p.vs[static_cast<size_t>(s_row[i]) * p.Hkv + g];
    }
  }
}

// this lane's 8 dims of each grouped head's query (zeros past the heads)
template <int D, int MAXR>
__device__ __forceinline__ void load_queries(const __nv_bfloat16* qh, int n_rep,
                                             float (&qf)[MAXR][8]) {
  using LN = Lanes<D>;
  const int chunk = (threadIdx.x % 32) % LN::kPerTok;
  const bool has_chunk = chunk < LN::kChunks;
#pragma unroll
  for (int r = 0; r < MAXR; ++r) {
    if (r < n_rep && has_chunk) {
      load8(qh + r * D + chunk * 8, qf[r]);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) qf[r][e] = 0.f;
    }
  }
}

// s_p[r][t] = q_r . k_t * scale for the split's keys t < n_tok, -1e30 past them
template <int D, int MAXR, typename KT>
__device__ __forceinline__ void split_scores(const float (&qf)[MAXR][8], const KT* sk,
                                             const float* sks, float (*s_p)[kSplit], int n_tok,
                                             int n_rep, float scale) {
  using LN = Lanes<D>;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int chunk = lane % LN::kPerTok;  // this lane's 8 dims of a row
  const int tsub = lane / LN::kPerTok;   // this lane's key within a pass
  const bool has_chunk = chunk < LN::kChunks;
  for (int tt = warp * LN::kTokPerWarp + tsub; tt < kSplit; tt += LN::kGroups) {
    float dot[MAXR];
#pragma unroll
    for (int r = 0; r < MAXR; ++r) dot[r] = 0.f;
    if (has_chunk && tt < n_tok) {
      float kf[8];
      load_row8(sk + tt * D + chunk * 8, is_int8<KT>() ? sks[tt] : 0.f, kf);
#pragma unroll
      for (int r = 0; r < MAXR; ++r) {
#pragma unroll
        for (int e = 0; e < 8; ++e) dot[r] += qf[r][e] * kf[e];
      }
    }
#pragma unroll
    for (int r = 0; r < MAXR; ++r) {
#pragma unroll
      for (int off = LN::kPerTok / 2; off > 0; off /= 2) {
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
}

// the split's softmax numerators in place, one warp per grouped head
template <int MAXR>
__device__ __forceinline__ void split_softmax(float (*s_p)[kSplit], float* s_m, float* s_l,
                                              int n_rep) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int r = warp; r < n_rep; r += kWarps) {
    float mx = kNegInf;
    for (int j = lane; j < kSplit; j += 32) mx = fmaxf(mx, s_p[r][j]);
#pragma unroll
    for (int off = 16; off > 0; off /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int j = lane; j < kSplit; j += 32) {
      const float e = expf(s_p[r][j] - mx);
      s_p[r][j] = e;
      sum += e;
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      s_m[r] = mx;
      s_l[r] = sum;
    }
  }
}

// acc = p @ v: each thread sums the 8 dims of its lane's chunk over the keys
// of its key group (keys kgi, kgi + 8, ... at D = 128), 16-byte rows from
// shared memory; the key groups are then summed in a fixed order, lane
// shuffles within a warp here and the four warps by split_store, through
// red [kWarps][MAXR][D]
template <int D, int MAXR, typename KT>
__device__ __forceinline__ void split_pv(const KT* sv, const float* svs,
                                         const float (*s_p)[kSplit], int n_tok, int n_rep,
                                         float* red) {
  using LN = Lanes<D>;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int chunk = lane % LN::kPerTok;
  const int tsub = lane / LN::kPerTok;
  const bool has_chunk = chunk < LN::kChunks;
  float acc[MAXR][8];
#pragma unroll
  for (int r = 0; r < MAXR; ++r) {
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[r][e] = 0.f;
  }
  if (has_chunk) {
    for (int j = warp * LN::kTokPerWarp + tsub; j < n_tok; j += LN::kGroups) {
      float vf[8];
      load_row8(sv + j * D + chunk * 8, is_int8<KT>() ? svs[j] : 0.f, vf);
#pragma unroll
      for (int r = 0; r < MAXR; ++r) {
        if (r < n_rep) {
          const float pr = s_p[r][j];
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[r][e] += pr * vf[e];
        }
      }
    }
  }
#pragma unroll
  for (int off = LN::kPerTok; off < 32; off *= 2) {
#pragma unroll
    for (int r = 0; r < MAXR; ++r) {
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[r][e] += __shfl_xor_sync(0xffffffffu, acc[r][e], off);
    }
  }
  if (tsub == 0 && has_chunk) {
#pragma unroll
    for (int r = 0; r < MAXR; ++r) {
      if (r < n_rep) {
#pragma unroll
        for (int e = 0; e < 8; ++e) red[(warp * MAXR + r) * D + chunk * 8 + e] = acc[r][e];
      }
    }
  }
}

// the warps' sums in warp order, then (acc[D], m, l) of each grouped head to
// the workspace at acc_out [n_rep][n_split][D + 2]
template <int D, int MAXR>
__device__ __forceinline__ void split_store(const float* red, const float* s_m, const float* s_l,
                                            float* acc_out, int n_split, int split, int n_rep) {
  const int tid = threadIdx.x;
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

// the dynamic shared memory of a split CTA, carved
template <int D, typename KT>
struct SplitSmem {
  KT* sk;
  KT* sv;
  float* sks;
  float* svs;
  float* red;
  __device__ __forceinline__ explicit SplitSmem(uint8_t* raw) {
    sk = reinterpret_cast<KT*>(raw);  // [kSplit][D]
    sv = sk + kSplit * D;             // [kSplit][D]
    sks = reinterpret_cast<float*>(sv + kSplit * D);  // int8: [kSplit] each
    svs = sks + kSplit;
    red = is_int8<KT>() ? svs + kSplit : reinterpret_cast<float*>(sk);
  }
};

template <int D, int MAXR, typename KT>
__global__ void __launch_bounds__(kThreads) paged_decode_attention_split_kernel(const Params p) {
  static_assert(is_int8<KT>() ||
                    kWarps * MAXR * D * 4 <= kSplit * D * static_cast<int>(sizeof(KT)),
                "the warps' V sums fit in the K rows");
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const SplitSmem<D, KT> sm(smem_raw);
  __shared__ float s_p[MAXR][kSplit];  // scores, then probabilities
  __shared__ int s_row[kSplit];        // pool row (pid * page + offset) per key
  __shared__ float s_m[MAXR], s_l[MAXR];

  const int split = blockIdx.x;
  const int g = blockIdx.y;  // kv head
  const int b = blockIdx.z;  // slot
  const int L = min(p.lens[b], p.pps * p.page);  // the plain version masks no key past its rows
  const int t0 = split * kSplit;
  if (t0 >= L) return;  // past the slot's last split: the whole CTA leaves
  const int n_tok = min(kSplit, L - t0);
  const int n_rep = p.H / p.Hkv;
  const int tid = threadIdx.x;

  for (int i = tid; i < n_tok; i += kThreads) {
    const int t = t0 + i;
    s_row[i] = p.block[static_cast<size_t>(b) * p.pps + t / p.page] * p.page + t % p.page;
  }
  __syncthreads();
  issue_split_loads<D, KT>(p, g, s_row, n_tok, sm.sk, sm.sv, sm.sks, sm.svs);
  float qf[MAXR][8];
  load_queries<D, MAXR>(p.q + (static_cast<size_t>(b) * p.H + g * n_rep) * D, n_rep, qf);

  cp_async_wait<1>();  // this thread's K chunks have landed
  __syncthreads();     // and everyone's
  split_scores<D, MAXR, KT>(qf, sm.sk, sm.sks, s_p, n_tok, n_rep, p.scale);
  __syncthreads();
  split_softmax<MAXR>(s_p, s_m, s_l, n_rep);
  cp_async_wait<0>();  // V
  __syncthreads();
  split_pv<D, MAXR, KT>(sm.sv, sm.svs, s_p, n_tok, n_rep, sm.red);
  __syncthreads();
  split_store<D, MAXR>(sm.red, s_m, s_l,
                       p.ws + (static_cast<size_t>(b) * p.H + g * n_rep) * p.n_split * (D + 2),
                       p.n_split, split, n_rep);
}

// one (row, head)'s output from its first ns splits' partials at part
// [n_split][D + 2], merged in split-index order
template <int D>
__device__ __forceinline__ void combine_row(const float* part, int ns, __nv_bfloat16* out) {
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
    out[d] = __float2bfloat16(a / fmaxf(l, 1e-20f));
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_attention_combine_kernel(const Params p) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int ns = min((p.lens[b] + kSplit - 1) / kSplit, p.n_split);
  const size_t row = static_cast<size_t>(b) * p.H + h;
  combine_row<D>(p.ws + row * p.n_split * (D + 2), ns, p.out + row * D);
}

template <int D, int MAXR, typename KT>
cudaError_t launch_split(const Params& p, int rows, cudaStream_t s) {
  constexpr int smem = smem_bytes<D, MAXR, KT>();
  void (*kernel)(const Params) = paged_decode_attention_split_kernel<D, MAXR, KT>;
  // above 48 KB of dynamic shared memory needs the kernel's opt-in
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(p.n_split, p.Hkv, rows), kThreads, smem, s>>>(p);
  return cudaGetLastError();
}

template <int D, typename KT>
int launch_for_dim(const Params& p, int rows, cudaStream_t s) {
  const int n_rep = p.H / p.Hkv;
  cudaError_t err;
  if (n_rep <= 1) {
    err = launch_split<D, 1, KT>(p, rows, s);
  } else if (n_rep <= 2) {
    err = launch_split<D, 2, KT>(p, rows, s);
  } else if (n_rep <= 4) {
    err = launch_split<D, 4, KT>(p, rows, s);
  } else if (n_rep <= 8) {
    err = launch_split<D, 8, KT>(p, rows, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  paged_decode_attention_combine_kernel<D><<<dim3(p.H, rows), kThreads, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename KT>
int launch(const Params& p, int D, int rows, cudaStream_t s) {
  switch (D) {
    case 16: return launch_for_dim<16, KT>(p, rows, s);
    case 32: return launch_for_dim<32, KT>(p, rows, s);
    case 64: return launch_for_dim<64, KT>(p, rows, s);
    case 112: return launch_for_dim<112, KT>(p, rows, s);
    case 128: return launch_for_dim<128, KT>(p, rows, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

Params make_params(const void* q, const void* k, const void* v, const void* ks, const void* vs,
                   const void* block, void* ws, void* out, int H, int Hkv, int page, int pps,
                   int n_split, float scale) {
  Params p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = k;
  p.v = v;
  p.ks = static_cast<const float*>(ks);
  p.vs = static_cast<const float*>(vs);
  p.block = static_cast<const int*>(block);
  p.ws = static_cast<float*>(ws);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.H = H;
  p.Hkv = Hkv;
  p.page = page;
  p.pps = pps;
  p.n_split = n_split;
  p.scale = scale;
  return p;
}

}  // namespace

// kv_int8: k/v pools int8 with float32 scale pools ks/vs
// (else bf16, ks/vs unused).  n_split must be ceil(pps * page / kSplit) and
// ws hold B * H * n_split * (D + 2) floats
extern "C" int repro_paged_decode_attention(const void* q, const void* k_pages,
                                            const void* v_pages, const void* k_scale,
                                            const void* v_scale, const void* block_table,
                                            const void* lengths, void* ws, void* out, int B,
                                            int H, int Hkv, int D, int page, int pps,
                                            int n_split, int kv_int8, float scale,
                                            void* stream) {
  if (B <= 0 || Hkv <= 0 || H % Hkv != 0 || page <= 0 || pps <= 0 ||
      n_split != (pps * page + kSplit - 1) / kSplit ||
      (kv_int8 && (k_scale == nullptr || v_scale == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p = make_params(q, k_pages, v_pages, k_scale, v_scale, block_table, ws, out, H, Hkv,
                         page, pps, n_split, scale);
  p.lens = static_cast<const int*>(lengths);
  auto s = static_cast<cudaStream_t>(stream);
  return kv_int8 ? launch<int8_t>(p, D, B, s) : launch<__nv_bfloat16>(p, D, B, s);
}
