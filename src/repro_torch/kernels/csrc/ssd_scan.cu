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
// What bounds it on the H100: per (batch, head, chunk) it does Q(Q+1)/2
// (N + P) multiply-adds on Q P inputs of x, Q of a (B and C are shared by
// the group's heads) and Q P float32 outputs, about Q/3 operations per byte
// at N = P = 64 and bf16 x (43 at Q = 128, above the card's float32 ridge
// of 20).  The products stay in float32 (the reference keeps S = (C B^T) o L
// in float32, which a bf16 or TF32 tensor-core product would round), so the
// limit is the float32 rate of the CUDA cores, above the byte bound.  What
// the design does about it: blocks above the diagonal are never visited,
// and each B and x row block is staged once for the 64 rows that use it.
//
// Design (one CTA of 256 threads per 64-row block of a chunk, head, batch):
//  * warp 0 computes the chunk's cumulative sum of a in double precision
//    (a lane-local sum of 4, then a warp scan): a float32 cumsum over a
//    chunk reaches |cs| ~ 2e3 at the model's decays, where its own rounding
//    (~1e-4 absolute) would move L by ~1e-4 relative; differences of double
//    sums give L to float32 precision;
//  * C of the CTA's 64 rows is staged in shared memory as f32, transposed;
//  * for each 64-key block at or below the diagonal, B and x rows are
//    staged; each thread computes a 4x4 block of C B^T with float4 shared
//    reads, multiplies by L (0 above the diagonal and past the chunk);
//  * S goes through shared memory (transposed) for the S x product, each
//    thread accumulating 4 rows x P/16 dims in registers;
//  * rows and keys past the chunk (Q < 64) are staged as zeros and not
//    stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBR = 64;   // rows (queries) per CTA
constexpr int kBC = 64;   // keys per block
constexpr int kThreads = 256;
constexpr int kMaxQ = 128;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

inline size_t smem_bytes(int N, int P) {
  return sizeof(double) * kMaxQ +
         sizeof(float) * (2 * static_cast<size_t>(N) * (kBR + 4) +
                          static_cast<size_t>(kBC) * (P + 4) +
                          static_cast<size_t>(kBC) * (kBR + 4));
}

template <typename T, int P>
__global__ void __launch_bounds__(kThreads)
ssd_intra_chunk_kernel(const T* __restrict__ x, const float* __restrict__ a,
                       const T* __restrict__ bm, const T* __restrict__ cm,
                       float* __restrict__ y, int S, int H, int G, int N, int Q,
                       long long xsb, long long xss, long long xsh,
                       long long asb, long long ass, long long ash,
                       long long bsb, long long bss, long long bsg,
                       long long csb, long long css, long long csg) {
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

  // cumulative sum of a over the chunk, in double
  if (tid < 32) {
    const int lane = tid;
    double v[4];
    double run = 0.0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = lane * 4 + e;
      const double at =
          (t < Q) ? static_cast<double>(a[b * asb + static_cast<long long>(c0 + t) * ass + h * ash])
                  : 0.0;
      run += at;
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
    for (int e = 0; e < 4; ++e) {
      const int t = lane * 4 + e;
      if (t < kMaxQ) cs[t] = excl + v[e];
    }
  }
  // C rows of this CTA, transposed; zero past the chunk
  for (int idx = tid; idx < kBR * N; idx += kThreads) {
    const int row = idx / N;
    const int k = idx % N;
    const int t = r0 + row;
    float cv = 0.f;
    if (t < Q) cv = to_f(cm[b * csb + static_cast<long long>(c0 + t) * css + g * csg + k]);
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
      if (t < Q) bv = to_f(bm[b * bsb + static_cast<long long>(c0 + t) * bss + g * bsg + k]);
      Bs[k * (kBC + 4) + row] = bv;
    }
    for (int idx = tid; idx < kBC * P; idx += kThreads) {
      const int row = idx / P;
      const int d = idx % P;
      const int t = k0 + row;
      float xv = 0.f;
      if (t < Q) xv = to_f(x[b * xsb + static_cast<long long>(c0 + t) * xss + h * xsh + d]);
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

template <typename T, int P>
int launch_typed(const void* x, const float* a, const void* bm, const void* cm, float* y, int B,
                 int S, int H, int G, int N, int Q, const long long* st, cudaStream_t stream) {
  const size_t bytes = smem_bytes(N, P);
  cudaError_t err = cudaFuncSetAttribute(ssd_intra_chunk_kernel<T, P>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_rb = (Q + kBR - 1) / kBR;
  const dim3 grid((S / Q) * n_rb, H, B);
  ssd_intra_chunk_kernel<T, P><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), a, static_cast<const T*>(bm), static_cast<const T*>(cm), y, S,
      H, G, N, Q, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10],
      st[11]);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_for_type(const void* x, const float* a, const void* bm, const void* cm, float* y,
                    int B, int S, int H, int G, int N, int P, int Q, const long long* st,
                    cudaStream_t s) {
  switch (P) {
    case 16: return launch_typed<T, 16>(x, a, bm, cm, y, B, S, H, G, N, Q, st, s);
    case 32: return launch_typed<T, 32>(x, a, bm, cm, y, B, S, H, G, N, Q, st, s);
    case 64: return launch_typed<T, 64>(x, a, bm, cm, y, B, S, H, G, N, Q, st, s);
    case 128: return launch_typed<T, 128>(x, a, bm, cm, y, B, S, H, G, N, Q, st, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// strides (in elements): x (batch, seq, head), a (batch, seq, head),
// Bm (batch, seq, group), Cm (batch, seq, group); the last axis of x, Bm and
// Cm is contiguous.  is_bf16: 1 for bf16 x / Bm / Cm, 0 for float32.
// S must be a multiple of Q, Q <= 128, H a multiple of G, N <= 256.
extern "C" int repro_ssd_intra_chunk(const void* x, const void* a, const void* bm, const void* cm,
                                     void* y, int B, int S, int H, int G, int N, int P, int Q,
                                     int is_bf16, const long long* strides, void* stream) {
  if (B <= 0 || S <= 0 || Q <= 0 || Q > kMaxQ || S % Q != 0 || G <= 0 || H % G != 0 ||
      N <= 0 || N > 256) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* ap = static_cast<const float*>(a);
  auto* yp = static_cast<float*>(y);
  auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch_for_type<__nv_bfloat16>(x, ap, bm, cm, yp, B, S, H, G, N, P, Q, strides, s);
  }
  return launch_for_type<float>(x, ap, bm, cm, yp, B, S, H, G, N, P, Q, strides, s);
}
