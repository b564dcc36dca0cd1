// Causal GQA flash attention for prefill, in the model's own layout:
//
//   q    bf16 [B, S, H, D]     k, v  bf16 [B, S, Hkv, D]     out bf16 [B, S, H, D]
//
// read and written through their batch / sequence / head strides (the last
// axis contiguous), so the caller transposes nothing.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/flash_attention.py::flash_attention
// (grid (B*H, q-blocks, kv-blocks), online softmax in VMEM scratch, blocks
// above the diagonal computed and then masked).  The model path it stands
// in for is models/attention.py::chunked_attention(causal=True) as
// models/blocks.py::attn_full calls it.
//
// What bounds it on the H100: a causal prefill does 2*2*B*H*D*S(S+1)/2
// operations on 2*B*S*(2*H+2*Hkv)*D bytes, about S/4 operations per byte
// without GQA, so below S ~ 1200 (the path's buckets are <= 1024) it is
// bound by bytes and above it by the bf16 tensor-core rate.  This simple
// version runs the products on the f32 CUDA cores (no wgmma yet), so it is
// far from either bound; what it does about it is skip the work that is
// never needed: kv blocks above the diagonal are not visited at all, and
// each K/V block is loaded once for 64 queries.
//
// Design:
//  * one CTA (256 threads) per (64-query block, head, batch row); grouped
//    heads read their kv head's rows (GQA fold, no repeat);
//  * for each 64-key block at or below the diagonal: K and V are staged in
//    shared memory as f32 (K transposed), each thread computes a 4x4 block
//    of scores with float4 shared reads, scales by 1/sqrt(D) and, on the
//    diagonal block, sets keys after the query to -1e30;
//  * f32 online softmax in registers: the 16 threads of a half warp share
//    four query rows and reduce row max and row sum with shuffles;
//  * probabilities go through shared memory for the P.V product, each
//    thread accumulating 4 rows x D/16 dims (7 at zamba2-7b's D = 112,
//    read as scalars; 108 KB of shared memory at that D);
//  * out = acc / max(l, 1e-20), cast to bf16.  Rows past S (a bucket that is
//    not a multiple of 64) are computed on zeros and not stored; keys past S
//    lie after every valid query, so the causal mask already hides them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;

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

template <int D>
constexpr int smem_floats() {
  return D * (kBQ + 4) + D * (kBK + 4) + kBK * (D + 4) + kBK * (kBQ + 4);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_causal_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v,
                              __nv_bfloat16* __restrict__ out, int S, int H, int Hkv,
                              long long qsb, long long qss, long long qsh,
                              long long ksb, long long kss, long long ksh,
                              long long vsb, long long vss, long long vsh,
                              long long osb, long long oss, long long osh, float scale) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  constexpr int kDpt = D / 16;    // output dims per thread
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                 // [D][kBQ + 4]  queries, transposed
  float* Ks = Qs + D * (kBQ + 4);   // [D][kBK + 4]  keys, transposed
  float* Vs = Ks + D * (kBK + 4);   // [kBK][D + 4]  values
  float* Ps = Vs + kBK * (D + 4);   // [kBK][kBQ + 4] probabilities, transposed

  const int qb = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // key columns tx*4.. in scores; dims tx*kDpt.. in output
  const int ty = tid / 16;  // query rows ty*4 .. ty*4+3
  const int q0 = qb * kBQ;

  for (int ci = tid; ci < kBQ * kChunks; ci += kThreads) {
    const int row = ci / kChunks;
    const int c = ci % kChunks;
    float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    const int s = q0 + row;
    if (s < S) load8(q + b * qsb + s * qss + h * qsh + c * 8, f);
#pragma unroll
    for (int e = 0; e < 8; ++e) Qs[(c * 8 + e) * (kBQ + 4) + row] = f[e];
  }

  float m[4], l[4], o[4][kDpt];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < kDpt; ++e) o[i][e] = 0.f;
  }

  for (int kb = 0; kb <= qb; ++kb) {  // blocks above the diagonal are skipped
    const int k0 = kb * kBK;
    __syncthreads();  // Q staged; previous block's Ks / Vs / Ps reads done
    for (int ci = tid; ci < kBK * kChunks; ci += kThreads) {
      const int row = ci / kChunks;
      const int c = ci % kChunks;
      float kf[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      float vf[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      const int s = k0 + row;
      if (s < S) {
        load8(k + b * ksb + s * kss + g * ksh + c * 8, kf);
        load8(v + b * vsb + s * vss + g * vsh + c * 8, vf);
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        Ks[(c * 8 + e) * (kBK + 4) + row] = kf[e];
        Vs[row * (D + 4) + c * 8 + e] = vf[e];
      }
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&Qs[d * (kBQ + 4) + ty * 4]);
      const float4 c = *reinterpret_cast<const float4*>(&Ks[d * (kBK + 4) + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] += av[i] * cv[j];
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float s = sc[i][j] * scale;
        if (kb == qb && k0 + tx * 4 + j > qpos) s = kNegInf;
        sc[i][j] = s;
        mx = fmaxf(mx, s);
      }
#pragma unroll
      for (int off = 8; off > 0; off /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m_new);
        sc[i][j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < kDpt; ++e) o[i][e] *= corr;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) Ps[(tx * 4 + j) * (kBQ + 4) + ty * 4 + i] = sc[i][j];
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      const float4 p4 = *reinterpret_cast<const float4*>(&Ps[j * (kBQ + 4) + ty * 4]);
      const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
      float vv[kDpt];
      const float* vrow = &Vs[j * (D + 4) + tx * kDpt];
      if constexpr (kDpt % 4 == 0) {
#pragma unroll
        for (int e = 0; e < kDpt; e += 4) {
          const float4 t = *reinterpret_cast<const float4*>(vrow + e);
          vv[e] = t.x;
          vv[e + 1] = t.y;
          vv[e + 2] = t.z;
          vv[e + 3] = t.w;
        }
      } else {
#pragma unroll
        for (int e = 0; e < kDpt; ++e) vv[e] = vrow[e];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < kDpt; ++e) o[i][e] += pv[i] * vv[e];
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty * 4 + i;
    if (s >= S) continue;
    const float denom = fmaxf(l[i], 1e-20f);
    __nv_bfloat16* orow = out + b * osb + s * oss + h * osh + tx * kDpt;
#pragma unroll
    for (int e = 0; e < kDpt; ++e) orow[e] = __float2bfloat16(o[i][e] / denom);
  }
}

template <int D>
int launch_for_dim(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                   __nv_bfloat16* out, int B, int S, int H, int Hkv, const long long* st,
                   float scale, cudaStream_t stream) {
  constexpr int bytes = smem_floats<D>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(flash_attention_causal_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_attention_causal_kernel<D><<<grid, kThreads, bytes, stream>>>(
      q, k, v, out, S, H, Hkv, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11], scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strides (in elements): q (batch, seq, head), k (...), v (...), out (...);
// the head-dim stride is 1 and every stride is a multiple of 8
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* out,
                                     int B, int S, int H, int Hkv, int D,
                                     const long long* strides, float scale, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || H % Hkv != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  auto* op = static_cast<__nv_bfloat16*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_for_dim<16>(qp, kp, vp, op, B, S, H, Hkv, strides, scale, s);
    case 32: return launch_for_dim<32>(qp, kp, vp, op, B, S, H, Hkv, strides, scale, s);
    case 64: return launch_for_dim<64>(qp, kp, vp, op, B, S, H, Hkv, strides, scale, s);
    case 112: return launch_for_dim<112>(qp, kp, vp, op, B, S, H, Hkv, strides, scale, s);
    case 128: return launch_for_dim<128>(qp, kp, vp, op, B, S, H, Hkv, strides, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
