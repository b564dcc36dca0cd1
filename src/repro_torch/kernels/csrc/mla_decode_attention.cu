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
//   ws     f32 [B, n_split, H, R+2]     the splits' partials (scratch)
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
// read once and used by every head: 2 * H * (2R + Dr) float32 operations a
// row on 2 (R + Dr) bytes (bf16 pools), 30 operations a byte at H 16 (60
// over int8 pools), above the balance of the f32 CUDA cores and the memory
// (67e12 / 3.35e12 = 20 a byte): the kernel is bound by the float32
// operations, which it keeps (JAX's einsums are float32, and the tensor
// cores' TF32 keeps ~3 decimal digits).  So the design's aim is that each
// row leaves device memory once and every head's work finds it in shared
// memory.
//
// Design: split-KV with a fixed-order combine, two kernels from one C entry.
//  * Split kernel, one CTA (256 threads, 8 warps) per (split, slot).  A
//    split is kSplit = 64 keys at absolute positions [64 s, 64 s + 64) of
//    its slot, so a slot's splits and their arithmetic depend on its own
//    length alone (never on B, pps, the page size or the SM count); the
//    grid spans the block table's capacity and CTAs past the slot's last
//    split return at once.  The split's valid rows of both pools (and an
//    int8 pool's row scales) are copied to shared memory by cp.async, page
//    ids read from the block table in the kernel, one per key: each latent
//    row leaves device memory once and serves all H heads.
//  * Scores: warp w holds heads w and w + 8, lane l the query dims
//    2l + 64i (+1) of both in registers; per key the lanes read the row's
//    pairs from shared memory (an int8 element dequantized as float(code)
//    * scale, one float32 product, JAX's dequantize_rows), the two dot
//    products (latent, rope) summed over the lanes by xor shuffles, then
//    s = (latent + rope) * scale, as JAX adds the two einsums and scales.
//  * Softmax of the split per head (one warp per head pair): m = max,
//    p = exp(s - m), l = sum p.
//  * ctx partial: thread j holds dims 2j, 2j+1 of every head and sums
//    p[h, t] * ckv[t] over the split's keys in order.  (acc, m, l) go to
//    the workspace in float32.
//  * Combine kernel, one CTA per (head, slot): M = max of the splits' m;
//    ctx = sum_s acc_s e^(m_s - M) / sum_s l_s e^(m_s - M), both sums in
//    split-index order.  A length-0 slot has no split and comes out 0
//    (JAX gives the uniform mean there; callers ignore inactive lanes).
//  Every sum runs in an order fixed by key position and head, so a slot's
//  output bits are the same in any batch and under any block-table width.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSplit = 64;              // keys per split; the wrapper's ref.SPLIT
constexpr int kMaxHeads = 2 * kWarps;   // two heads a warp
constexpr int kCombineThreads = 128;

template <typename KT>
__host__ __device__ constexpr bool is_int8() {
  return std::is_same<KT, int8_t>::value;
}

// two neighbouring elements of a row as float32: bf16 as they are, int8
// codes times the row's scale
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p, float) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load2(const int8_t* p, float s) {
  const char2 c = *reinterpret_cast<const char2*>(p);
  return make_float2(__fmul_rn(static_cast<float>(c.x), s), __fmul_rn(static_cast<float>(c.y), s));
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
  }
}
__device__ __forceinline__ void cp_async_commit_and_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// n rows of W elements from the pool rows s_row[0..n) into dst [n][W]
template <typename KT, int W>
__device__ __forceinline__ void issue_rows(KT* dst, const KT* pool, const int* s_row, int n) {
  constexpr int kBytes = W * static_cast<int>(sizeof(KT));
  static_assert(kBytes % 4 == 0, "a row is a whole number of 4-byte words");
  constexpr int kChunk = kBytes % 16 == 0 ? 16 : 4;
  constexpr int kPer = kBytes / kChunk;
  for (int i = threadIdx.x; i < n * kPer; i += kThreads) {
    const int r = i / kPer, c = i % kPer;
    cp_async<kChunk>(reinterpret_cast<uint8_t*>(dst + r * W) + c * kChunk,
                     reinterpret_cast<const uint8_t*>(pool + static_cast<size_t>(s_row[r]) * W) +
                         c * kChunk);
  }
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
  float* out;
  int H, page, pps, n_split;
  float scale;
};

template <typename KT, int R, int DR>
__host__ __device__ constexpr int smem_bytes() {
  return kSplit * (R + DR) * static_cast<int>(sizeof(KT));
}

// the lanes' pairs of a row of W elements: lane l holds dims 2l + 64i, +1
template <int W>
struct Pairs {
  static constexpr int kN = (W + 63) / 64;
};

template <typename KT, int R, int DR>
__global__ void __launch_bounds__(kThreads) mla_decode_split_kernel(const Params p) {
  constexpr int NI = Pairs<R>::kN;
  constexpr int NJ = Pairs<DR>::kN;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  KT* s_ckv = reinterpret_cast<KT*>(smem_raw);  // [kSplit][R]
  KT* s_kr = s_ckv + kSplit * R;                // [kSplit][DR]
  __shared__ __align__(16) float s_p[kSplit][kMaxHeads];  // scores, then p; key-major
  __shared__ float s_cs[kSplit], s_ks[kSplit];            // int8 row scales
  __shared__ int s_row[kSplit];                           // pool row per key
  __shared__ float s_m[kMaxHeads], s_l[kMaxHeads];

  const int split = blockIdx.x;
  const int b = blockIdx.y;
  const int L = min(p.lens[b], p.pps * p.page);  // the plain version masks no key past its rows
  const int t0 = split * kSplit;
  if (t0 >= L) return;  // past the slot's last split: the whole CTA leaves
  const int n_tok = min(kSplit, L - t0);
  const int H = p.H;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  for (int i = tid; i < n_tok; i += kThreads) {
    const int t = t0 + i;
    s_row[i] = p.block[static_cast<size_t>(b) * p.pps + t / p.page] * p.page + t % p.page;
  }
  __syncthreads();
  issue_rows<KT, R>(s_ckv, static_cast<const KT*>(p.ckv), s_row, n_tok);
  issue_rows<KT, DR>(s_kr, static_cast<const KT*>(p.kr), s_row, n_tok);
  if constexpr (is_int8<KT>()) {
    for (int i = tid; i < n_tok; i += kThreads) {
      s_cs[i] = p.ckv_s[s_row[i]];
      s_ks[i] = p.kr_s[s_row[i]];
    }
  }
  // this warp's two heads' query pairs, while the rows are in flight
  float2 qc[2][NI], qr[2][NJ];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int h = warp + hh * kWarps;
    const float* qch = p.qc + (static_cast<size_t>(b) * H + h) * R;
    const float* qrh = p.qr + (static_cast<size_t>(b) * H + h) * DR;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int e = 2 * lane + 64 * i;
      qc[hh][i] = (h < H && e < R) ? *reinterpret_cast<const float2*>(qch + e) : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int e = 2 * lane + 64 * j;
      qr[hh][j] = (h < H && e < DR) ? *reinterpret_cast<const float2*>(qrh + e) : make_float2(0.f, 0.f);
    }
  }
  cp_async_commit_and_wait_all();
  __syncthreads();

  // scores of this warp's heads, key by key
  if (warp < H) {
    for (int t = 0; t < n_tok; ++t) {
      const float cs = is_int8<KT>() ? s_cs[t] : 0.f;
      const float ks = is_int8<KT>() ? s_ks[t] : 0.f;
      float a[2] = {0.f, 0.f}, c[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        const int e = 2 * lane + 64 * i;
        if (e < R) {
          const float2 v = load2(s_ckv + t * R + e, cs);
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            a[hh] = __fmaf_rn(qc[hh][i].x, v.x, a[hh]);
            a[hh] = __fmaf_rn(qc[hh][i].y, v.y, a[hh]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int e = 2 * lane + 64 * j;
        if (e < DR) {
          const float2 v = load2(s_kr + t * DR + e, ks);
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            c[hh] = __fmaf_rn(qr[hh][j].x, v.x, c[hh]);
            c[hh] = __fmaf_rn(qr[hh][j].y, v.y, c[hh]);
          }
        }
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
        for (int off = 16; off > 0; off /= 2) {
          a[hh] = __fadd_rn(a[hh], __shfl_xor_sync(0xffffffffu, a[hh], off));
          c[hh] = __fadd_rn(c[hh], __shfl_xor_sync(0xffffffffu, c[hh], off));
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int h = warp + hh * kWarps;
          if (h < H) s_p[t][h] = __fmul_rn(__fadd_rn(a[hh], c[hh]), p.scale);
        }
      }
    }
  }
  __syncthreads();

  // the split's softmax numerators in place, per head
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int h = warp + hh * kWarps;
    if (h >= H) continue;  // warp-uniform
    float mx = kNegInf;
    for (int t = lane; t < n_tok; t += 32) mx = fmaxf(mx, s_p[t][h]);
#pragma unroll
    for (int off = 16; off > 0; off /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int t = lane; t < n_tok; t += 32) {
      const float e = expf(__fsub_rn(s_p[t][h], mx));
      s_p[t][h] = e;
      sum = __fadd_rn(sum, e);
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2) sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, off));
    if (lane == 0) {
      s_m[h] = mx;
      s_l[h] = sum;
    }
  }
  __syncthreads();

  // ctx partial: thread j holds dims 2j, 2j + 1 of every head
  float* ws = p.ws + (static_cast<size_t>(b) * p.n_split + split) * H * (R + 2);
  for (int j = tid; 2 * j < R; j += kThreads) {
    float2 acc[kMaxHeads];
#pragma unroll
    for (int h = 0; h < kMaxHeads; ++h) acc[h] = make_float2(0.f, 0.f);
    for (int t = 0; t < n_tok; ++t) {
      const float2 v = load2(s_ckv + t * R + 2 * j, is_int8<KT>() ? s_cs[t] : 0.f);
      const float4* pt = reinterpret_cast<const float4*>(s_p[t]);
#pragma unroll
      for (int q4 = 0; q4 < kMaxHeads / 4; ++q4) {
        const float4 pp = pt[q4];
        const float pr[4] = {pp.x, pp.y, pp.z, pp.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          acc[4 * q4 + u].x = __fmaf_rn(pr[u], v.x, acc[4 * q4 + u].x);
          acc[4 * q4 + u].y = __fmaf_rn(pr[u], v.y, acc[4 * q4 + u].y);
        }
      }
    }
#pragma unroll
    for (int h = 0; h < kMaxHeads; ++h) {
      if (h < H) *reinterpret_cast<float2*>(ws + static_cast<size_t>(h) * (R + 2) + 2 * j) = acc[h];
    }
  }
  if (tid < H) {
    ws[static_cast<size_t>(tid) * (R + 2) + R] = s_m[tid];
    ws[static_cast<size_t>(tid) * (R + 2) + R + 1] = s_l[tid];
  }
}

template <int R>
__global__ void __launch_bounds__(kCombineThreads) mla_decode_combine_kernel(const Params p) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int L = min(p.lens[b], p.pps * p.page);
  const int ns = (L + kSplit - 1) / kSplit;
  const size_t stride = static_cast<size_t>(p.H) * (R + 2);  // one split's partials
  const float* part = p.ws + static_cast<size_t>(b) * p.n_split * stride + static_cast<size_t>(h) * (R + 2);
  float m = kNegInf;
  for (int s = 0; s < ns; ++s) m = fmaxf(m, part[s * stride + R]);
  float l = 0.f;
  for (int s = 0; s < ns; ++s) {
    l = __fmaf_rn(part[s * stride + R + 1], expf(__fsub_rn(part[s * stride + R], m)), l);
  }
  float* out = p.out + (static_cast<size_t>(b) * p.H + h) * R;
  for (int r = threadIdx.x; r < R; r += kCombineThreads) {
    float a = 0.f;
    for (int s = 0; s < ns; ++s) {
      a = __fmaf_rn(part[s * stride + r], expf(__fsub_rn(part[s * stride + R], m)), a);
    }
    out[r] = __fdiv_rn(a, fmaxf(l, 1e-20f));
  }
}

template <typename KT, int R, int DR>
int launch(const Params& p, int B, cudaStream_t s) {
  constexpr int smem = smem_bytes<KT, R, DR>();
  void (*kernel)(const Params) = mla_decode_split_kernel<KT, R, DR>;
  // above 48 KB of dynamic shared memory needs the kernel's opt-in
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(p.n_split, B), kThreads, smem, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mla_decode_combine_kernel<R><<<dim3(p.H, B), kCombineThreads, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename KT>
int launch_for_shape(const Params& p, int B, int R, int Dr, cudaStream_t s) {
  if (R == 512 && Dr == 64) return launch<KT, 512, 64>(p, B, s);  // deepseek-v2-lite-16b
  if (R == 32 && Dr == 8) return launch<KT, 32, 8>(p, B, s);      // its reduced config
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// kv_int8: ckv / krope pools int8 with float32 row-scale pools (else bf16,
// the scale pointers unused).  H at most 16; (R, Dr) one of (512, 64),
// (32, 8).  n_split must be ceil(pps * page / 64) and ws hold
// B * n_split * H * (R + 2) floats
extern "C" int repro_mla_decode_attention(const void* q_c, const void* q_rope,
                                          const void* ckv_pages, const void* krope_pages,
                                          const void* ckv_scale, const void* krope_scale,
                                          const void* block_table, const void* lengths,
                                          void* ws, void* out, int B, int H, int R, int Dr,
                                          int page, int pps, int n_split, int kv_int8,
                                          float scale, void* stream) {
  if (B <= 0 || H <= 0 || H > kMaxHeads || page <= 0 || pps <= 0 ||
      n_split != (pps * page + kSplit - 1) / kSplit ||
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
  p.out = static_cast<float*>(out);
  p.H = H;
  p.page = page;
  p.pps = pps;
  p.n_split = n_split;
  p.scale = scale;
  auto s = static_cast<cudaStream_t>(stream);
  return kv_int8 ? launch_for_shape<int8_t>(p, B, R, Dr, s)
                 : launch_for_shape<__nv_bfloat16>(p, B, R, Dr, s);
}
