// Diagnostic copy of the float32 causal attention pair as it stood before
// its tensor-core redesigns: the forward, delta, dK/dV and dQ kernels of
// csrc/flash_attention_f32.cu, every product in float32 on the CUDA cores;
// the forward a CTA per (64-query tile, head, batch row) over the key tiles
// up to it, P through shared memory; dK/dV a CTA per (64-key tile, kv head,
// batch row) walking the group's heads and the query tiles after it.  Its
// source is unchanged but for the names of its four kernels and its three
// C entries (same arguments as the library's repro_attention_f32_fwd /
// repro_attention_f32_dkdv / repro_attention_f32_dq), so that
// chip_smoke.py's kernels phase and kernels/diag_attention_f32.py can time
// it beside the library's kernels in one call.  Not part of the kernel
// library; built by kernels/diag_attention_f32.py.
//
//   q   f32 [B, S, H, D]     k, v  f32 [B, S, Hkv, D]     (read through their
//                                                          b / s / h strides)
//   o   f32 [B, S, H, D]     lse   f32 [B, H, S]          (contiguous)
//   do  f32 [B, S, H, D]     delta f32 [B, H, S]          (contiguous)
//   dq  f32 [B, S, H, D]     dk, dv f32 [B, S, Hkv, D]    (contiguous)
//
// D is 64 or 128; H % Hkv == 0; query i attends keys 0..i.  Tiles live in
// shared memory with rows padded to D + 1 floats; a thread owns rows ty,
// ty+16, ty+32, ty+48 (ty = tid/16) and columns tx + 16 j (tx = tid%16) of
// each 64 x 64 score tile and 64 x D accumulator.  No atomics.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;     // queries of a tile
constexpr int kKeys = 64;     // keys of a tile
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

struct Strides {  // elements
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh;
};

template <int D>
__host__ __device__ constexpr int tile_floats() {
  return kRows * (D + 1);
}

// rows row0 .. row0+63 of a [.., S, .., D] tensor (base already at the
// batch row and head; row stride rs) into shared memory rows of D + 1
// floats; rows past S are zeros.  float4 loads: the wrapper checks 16-byte
// alignment of the base and of every stride
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src,
                                          long long rs, int row0, int S) {
  constexpr int kVec = D / 4;
#pragma unroll
  for (int it = 0; it < kRows * kVec / kThreads; ++it) {
    const int idx = threadIdx.x + it * kThreads;
    const int r = idx / kVec, c = (idx % kVec) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < S) {
      x = __ldg(reinterpret_cast<const float4*>(src + (row0 + r) * rs + c));
    }
    float* d = dst + r * (D + 1) + c;
    d[0] = x.x;
    d[1] = x.y;
    d[2] = x.z;
    d[3] = x.w;
  }
}

// 64 floats of a [B, H, S] row statistic (lse, delta), 0 past S
__device__ __forceinline__ void load_row_stat(float* dst, const float* __restrict__ src, int row0,
                                              int S) {
  if (threadIdx.x < kRows) {
    const int i = row0 + threadIdx.x;
    dst[threadIdx.x] = i < S ? src[i] : 0.f;
  }
}

// dot product of two shared-memory rows of D floats, in order of d
template <int D>
__device__ __forceinline__ float dot_rows(const float* a, const float* b) {
  float s = 0.f;
#pragma unroll 16
  for (int d = 0; d < D; ++d) s = fmaf(a[d], b[d], s);
  return s;
}

__device__ __forceinline__ float max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// acc[a][j] += sum_n P[rows a][n] * T[n][tx + 16 j]: P in shared memory,
// 64 x (64 + 1), T a tile of 64 x (D + 1)
template <int D>
__device__ __forceinline__ void accumulate_pt(float (&acc)[4][D / 16], const float* sP,
                                              const float* sT, int ty, int tx) {
#pragma unroll 4
  for (int n = 0; n < 64; ++n) {
    float p[4], t[D / 16];
#pragma unroll
    for (int a = 0; a < 4; ++a) p[a] = sP[(ty + 16 * a) * (kKeys + 1) + n];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) t[j] = sT[n * (D + 1) + tx + 16 * j];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[a][j] = fmaf(p[a], t[j], acc[a][j]);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
cuda_core_f32_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ lse, int S, int H, int Hkv, Strides st,
                         float scale) {
  constexpr int NJ = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + tile_floats<D>();
  float* sV = sK + tile_floats<D>();
  float* sP = sV + tile_floats<D>();  // 64 x 65
  const int qt = gridDim.x - 1 - blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv), q0 = qt * kRows;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_tile<D>(sQ, q + b * st.qb + h * st.qh, st.qs, q0, S);
  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = kNegInf;
    l[a] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[a][j] = 0.f;
  }
  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * kKeys;
    __syncthreads();  // the previous tile's readers are done
    load_tile<D>(sK, k + b * st.kb + hk * st.kh, st.ks, k0, S);
    load_tile<D>(sV, v + b * st.vb + hk * st.vh, st.vs, k0, S);
    __syncthreads();
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = ty + 16 * a;
      float s[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int n = tx + 16 * c;
        s[c] = dot_rows<D>(sQ + r * (D + 1), sK + n * (D + 1)) * scale;
        if (k0 + n > q0 + r) s[c] = kNegInf;
      }
      const float mt = max16(fmaxf(fmaxf(s[0], s[1]), fmaxf(s[2], s[3])));
      const float m_new = fmaxf(m[a], mt);
      float ps = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(s[c] - m_new);
        sP[r * (kKeys + 1) + tx + 16 * c] = p;
        ps += p;
      }
      const float corr = expf(m[a] - m_new);
      l[a] = l[a] * corr + sum16(ps);
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[a][j] *= corr;
      m[a] = m_new;
    }
    __syncthreads();
    accumulate_pt<D>(acc, sP, sV, ty, tx);
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = q0 + ty + 16 * a;
    if (i >= S) continue;
    const float den = fmaxf(l[a], 1e-20f);
    float* orow = o + ((static_cast<long long>(b) * S + i) * H + h) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) orow[tx + 16 * j] = acc[a][j] / den;
    if (tx == 0) lse[(static_cast<long long>(b) * H + h) * S + i] = m[a] + logf(l[a]);
  }
}

// delta[b, h, i] = sum_d dO[b, i, h, d] * O[b, i, h, d]: a warp a row
template <int D>
__global__ void __launch_bounds__(kThreads)
cuda_core_f32_delta_kernel(const float* __restrict__ o, const float* __restrict__ dout,
                           float* __restrict__ delta, int B, int S, int H) {
  const long long row = static_cast<long long>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  if (row >= static_cast<long long>(B) * S * H) return;
  const int lane = threadIdx.x & 31;
  const float* orow = o + row * D;
  const float* drow = dout + row * D;
  float s = 0.f;
#pragma unroll
  for (int d = lane; d < D; d += 32) s = fmaf(drow[d], orow[d], s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) {
    const int h = static_cast<int>(row % H);
    const long long bi = row / H;  // b * S + i
    const int i = static_cast<int>(bi % S), b = static_cast<int>(bi / S);
    delta[(static_cast<long long>(b) * H + h) * S + i] = s;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
cuda_core_f32_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ lse,
                          const float* __restrict__ dout, const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv, int S, int H, int Hkv,
                          Strides st, float scale) {
  constexpr int NJ = D / 16;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + tile_floats<D>();
  float* sQ = sV + tile_floats<D>();
  float* sO = sQ + tile_floats<D>();   // dO
  float* sP = sO + tile_floats<D>();   // P^T, then dS^T: 64 keys x 65
  float* sL = sP + kKeys * (kRows + 1);
  float* sD = sL + kRows;
  const int kt = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int group = H / Hkv, k0 = kt * kKeys, n_qt = (S + kRows - 1) / kRows;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_tile<D>(sK, k + b * st.kb + hk * st.kh, st.ks, k0, S);
  load_tile<D>(sV, v + b * st.vb + hk * st.vh, st.vs, k0, S);
  float dk_acc[4][NJ], dv_acc[4][NJ];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dk_acc[a][j] = dv_acc[a][j] = 0.f;

  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const long long stat = (static_cast<long long>(b) * H + h) * S;
    const float* dob = dout + (static_cast<long long>(b) * S * H + h) * D;
    for (int qt = kt; qt < n_qt; ++qt) {
      const int q0 = qt * kRows;
      __syncthreads();  // the previous tile's readers are done
      load_tile<D>(sQ, q + b * st.qb + h * st.qh, st.qs, q0, S);
      load_tile<D>(sO, dob, static_cast<long long>(H) * D, q0, S);
      load_row_stat(sL, lse + stat, q0, S);
      load_row_stat(sD, delta + stat, q0, S);
      __syncthreads();
      float p[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int jr = ty + 16 * a;  // key row of the tile
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int ir = tx + 16 * c;  // query row of the tile
          const float s = dot_rows<D>(sQ + ir * (D + 1), sK + jr * (D + 1)) * scale;
          const bool keep = k0 + jr <= q0 + ir && q0 + ir < S;
          p[a][c] = keep ? expf(s - sL[ir]) : 0.f;
          sP[jr * (kRows + 1) + ir] = p[a][c];
        }
      }
      __syncthreads();
      accumulate_pt<D>(dv_acc, sP, sO, ty, tx);  // dV += P^T dO
      float ds[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int jr = ty + 16 * a;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int ir = tx + 16 * c;
          const float dp = dot_rows<D>(sO + ir * (D + 1), sV + jr * (D + 1));
          ds[a][c] = p[a][c] * (dp - sD[ir]);
        }
      }
      __syncthreads();  // every thread is done reading P^T
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) sP[(ty + 16 * a) * (kRows + 1) + tx + 16 * c] = ds[a][c];
      __syncthreads();
      accumulate_pt<D>(dk_acc, sP, sQ, ty, tx);  // dK += dS^T Q
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int j = k0 + ty + 16 * a;
    if (j >= S) continue;
    const long long row = (static_cast<long long>(b) * S + j) * Hkv + hk;
#pragma unroll
    for (int c = 0; c < NJ; ++c) {
      dk[row * D + tx + 16 * c] = dk_acc[a][c] * scale;
      dv[row * D + tx + 16 * c] = dv_acc[a][c];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
cuda_core_f32_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ lse,
                        const float* __restrict__ dout, const float* __restrict__ delta,
                        float* __restrict__ dq, int S, int H, int Hkv, Strides st,
                        float scale) {
  constexpr int NJ = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sO = sQ + tile_floats<D>();   // dO
  float* sK = sO + tile_floats<D>();
  float* sV = sK + tile_floats<D>();
  float* sP = sV + tile_floats<D>();   // dS: 64 queries x 65
  float* sL = sP + kRows * (kKeys + 1);
  float* sD = sL + kRows;
  const int qt = gridDim.x - 1 - blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv), q0 = qt * kRows;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const long long stat = (static_cast<long long>(b) * H + h) * S;

  load_tile<D>(sQ, q + b * st.qb + h * st.qh, st.qs, q0, S);
  load_tile<D>(sO, dout + (static_cast<long long>(b) * S * H + h) * D,
               static_cast<long long>(H) * D, q0, S);
  load_row_stat(sL, lse + stat, q0, S);
  load_row_stat(sD, delta + stat, q0, S);
  float dq_acc[4][NJ];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dq_acc[a][j] = 0.f;

  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * kKeys;
    __syncthreads();  // the previous tile's readers are done
    load_tile<D>(sK, k + b * st.kb + hk * st.kh, st.ks, k0, S);
    load_tile<D>(sV, v + b * st.vb + hk * st.vh, st.vs, k0, S);
    __syncthreads();
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int ir = ty + 16 * a;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int jr = tx + 16 * c;
        const float s = dot_rows<D>(sQ + ir * (D + 1), sK + jr * (D + 1)) * scale;
        const bool keep = k0 + jr <= q0 + ir && q0 + ir < S;
        const float p = keep ? expf(s - sL[ir]) : 0.f;
        const float dp = dot_rows<D>(sO + ir * (D + 1), sV + jr * (D + 1));
        sP[ir * (kKeys + 1) + jr] = p * (dp - sD[ir]);
      }
    }
    __syncthreads();
    accumulate_pt<D>(dq_acc, sP, sK, ty, tx);  // dQ += dS K
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = q0 + ty + 16 * a;
    if (i >= S) continue;
    float* row = dq + ((static_cast<long long>(b) * S + i) * H + h) * D;
#pragma unroll
    for (int c = 0; c < NJ; ++c) row[tx + 16 * c] = dq_acc[a][c] * scale;
  }
}

template <int D>
constexpr int fwd_smem() {
  return (3 * tile_floats<D>() + kRows * (kKeys + 1)) * 4;
}

template <int D>
constexpr int bwd_smem() {
  return (4 * tile_floats<D>() + kRows * (kKeys + 1) + 2 * kRows) * 4;
}

Strides strides_of(const long long* s) {
  return Strides{s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8]};
}

bool shape_ok(int B, int S, int H, int Hkv, int D) {
  return B > 0 && S > 0 && Hkv > 0 && H % Hkv == 0 && (D == 64 || D == 128);
}

template <int D>
int launch_fwd(const float* q, const float* k, const float* v, float* o, float* lse, int B,
               int S, int H, int Hkv, Strides st, float scale, cudaStream_t s) {
  auto kernel = cuda_core_f32_fwd_kernel<D>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, fwd_smem<D>());
  const dim3 grid((S + kRows - 1) / kRows, H, B);
  kernel<<<grid, kThreads, fwd_smem<D>(), s>>>(q, k, v, o, lse, S, H, Hkv, st, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkdv(const float* q, const float* k, const float* v, const float* o,
                const float* lse, const float* dout, float* delta, float* dk, float* dv, int B,
                int S, int H, int Hkv, Strides st, float scale, cudaStream_t s) {
  const long long rows = static_cast<long long>(B) * S * H;
  const int warps = kThreads / 32;
  cuda_core_f32_delta_kernel<D><<<static_cast<unsigned>((rows + warps - 1) / warps), kThreads,
                                  0, s>>>(o, dout, delta, B, S, H);
  const int status = static_cast<int>(cudaGetLastError());
  if (status != 0) return status;
  auto kernel = cuda_core_f32_dkdv_kernel<D>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bwd_smem<D>());
  const dim3 grid((S + kKeys - 1) / kKeys, Hkv, B);
  kernel<<<grid, kThreads, bwd_smem<D>(), s>>>(q, k, v, lse, dout, delta, dk, dv, S, H, Hkv,
                                                st, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq(const float* q, const float* k, const float* v, const float* lse,
              const float* dout, const float* delta, float* dq, int B, int S, int H, int Hkv,
              Strides st, float scale, cudaStream_t s) {
  auto kernel = cuda_core_f32_dq_kernel<D>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bwd_smem<D>());
  const dim3 grid((S + kRows - 1) / kRows, H, B);
  kernel<<<grid, kThreads, bwd_smem<D>(), s>>>(q, k, v, lse, dout, delta, dq, S, H, Hkv, st,
                                                scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strides: q, k, v (batch, sequence, head), in elements
extern "C" int diag_attention_f32_fwd_cuda_cores(const void* q, const void* k, const void* v,
                                                 void* o, void* lse, int B, int S, int H,
                                                 int Hkv, int D, const long long* strides,
                                                 float scale, void* stream) {
  if (!shape_ok(B, S, H, Hkv, D)) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const Strides st = strides_of(strides);
  auto qp = static_cast<const float*>(q), kp = static_cast<const float*>(k),
       vp = static_cast<const float*>(v);
  auto op = static_cast<float*>(o), lp = static_cast<float*>(lse);
  return D == 64 ? launch_fwd<64>(qp, kp, vp, op, lp, B, S, H, Hkv, st, scale, s)
                 : launch_fwd<128>(qp, kp, vp, op, lp, B, S, H, Hkv, st, scale, s);
}

// delta (written here, read by diag_attention_f32_dq_cuda_cores), then dK and dV
extern "C" int diag_attention_f32_dkdv_cuda_cores(const void* q, const void* k, const void* v,
                                        const void* o, const void* lse, const void* dout,
                                        void* delta, void* dk, void* dv, int B, int S, int H,
                                        int Hkv, int D, const long long* strides, float scale,
                                        void* stream) {
  if (!shape_ok(B, S, H, Hkv, D)) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const Strides st = strides_of(strides);
  auto qp = static_cast<const float*>(q), kp = static_cast<const float*>(k),
       vp = static_cast<const float*>(v), op = static_cast<const float*>(o),
       lp = static_cast<const float*>(lse), gp = static_cast<const float*>(dout);
  auto dp = static_cast<float*>(delta), dkp = static_cast<float*>(dk),
       dvp = static_cast<float*>(dv);
  return D == 64
             ? launch_dkdv<64>(qp, kp, vp, op, lp, gp, dp, dkp, dvp, B, S, H, Hkv, st, scale, s)
             : launch_dkdv<128>(qp, kp, vp, op, lp, gp, dp, dkp, dvp, B, S, H, Hkv, st, scale,
                                s);
}

extern "C" int diag_attention_f32_dq_cuda_cores(const void* q, const void* k, const void* v,
                                      const void* lse, const void* dout, const void* delta,
                                      void* dq, int B, int S, int H, int Hkv, int D,
                                      const long long* strides, float scale, void* stream) {
  if (!shape_ok(B, S, H, Hkv, D)) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const Strides st = strides_of(strides);
  auto qp = static_cast<const float*>(q), kp = static_cast<const float*>(k),
       vp = static_cast<const float*>(v), lp = static_cast<const float*>(lse),
       gp = static_cast<const float*>(dout), dp = static_cast<const float*>(delta);
  auto dqp = static_cast<float*>(dq);
  return D == 64 ? launch_dq<64>(qp, kp, vp, lp, gp, dp, dqp, B, S, H, Hkv, st, scale, s)
                 : launch_dq<128>(qp, kp, vp, lp, gp, dp, dqp, B, S, H, Hkv, st, scale, s);
}
