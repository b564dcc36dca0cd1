// Diagnostic copy of the W4A16 kernels as they stood before the tensor-core
// redesign (float32 x, products on the CUDA cores): w4a16_gemv_kernel, one
// warp per 4 output columns streaming their packed rows, and
// w4a16_gemm_kernel, 64x64 output tiles of 4x4 outputs a thread over
// 32-wide K slices staged in shared memory as float32.  The source is
// unchanged but for the names of its two C entry points, so that
// kernels/diag_b4_cuda_cores.py can time it beside the library's kernels
// in one run.  Not part of the kernel library; built by that script alone.
//
//   out f32 [M, N] = x f32 [M, K] . dequant(wp uint8 [N, K/2], scale f32 [N, NG])^T
// with column k dequantized as (nibble - 8) * scale[n, k / G].

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kCols = 4;  // output columns per warp

__device__ __forceinline__ float lo_val(uint32_t byte, float s) {
  return static_cast<float>(static_cast<int>(byte & 0xFu) - 8) * s;
}

__device__ __forceinline__ float hi_val(uint32_t byte, float s) {
  return static_cast<float>(static_cast<int>((byte >> 4) & 0xFu) - 8) * s;
}

template <int MT, bool VEC>
__global__ void __launch_bounds__(kWarps * 32)
w4a16_gemv_kernel(const float* __restrict__ x, const uint8_t* __restrict__ wp,
                  const float* __restrict__ scale, float* __restrict__ out, int M,
                  int N, int K, int G, int NG) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n0 = (blockIdx.x * kWarps + warp) * kCols;
  if (n0 >= N) return;  // whole warp leaves together
  const int KB = K / 2;
  const uint8_t* rows[kCols];
  const float* srow[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const int n = min(n0 + c, N - 1);  // columns past N repeat the last one
    rows[c] = wp + static_cast<size_t>(n) * KB;
    srow[c] = scale + static_cast<size_t>(n) * NG;
  }
  float acc[MT][kCols];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[m][c] = 0.f;

  if (VEC) {
#pragma unroll 2
    for (int k0 = lane * 8; k0 < K; k0 += 256) {
      const int g = k0 / G;
      float w[kCols][8];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const uint32_t word = __ldg(reinterpret_cast<const uint32_t*>(rows[c] + k0 / 2));
        const float s = __ldg(srow[c] + g);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t byte = (word >> (8 * j)) & 0xFFu;
          w[c][2 * j] = lo_val(byte, s);
          w[c][2 * j + 1] = hi_val(byte, s);
        }
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (m < M) {
          const float4* xr = reinterpret_cast<const float4*>(x + static_cast<size_t>(m) * K + k0);
          const float4 a = __ldg(xr);
          const float4 b = __ldg(xr + 1);
          const float xv[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
          for (int c = 0; c < kCols; ++c)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[m][c] = fmaf(xv[j], w[c][j], acc[m][c]);
        }
      }
    }
  } else {
    for (int jb = lane; jb < KB; jb += 32) {
      const int k = 2 * jb;  // G is even, so k and k + 1 share a group
      const int g = k / G;
      float wl[kCols], wh[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const uint32_t byte = __ldg(rows[c] + jb);
        const float s = __ldg(srow[c] + g);
        wl[c] = lo_val(byte, s);
        wh[c] = hi_val(byte, s);
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (m < M) {
          const float x0 = __ldg(x + static_cast<size_t>(m) * K + k);
          const float x1 = __ldg(x + static_cast<size_t>(m) * K + k + 1);
#pragma unroll
          for (int c = 0; c < kCols; ++c) acc[m][c] = fmaf(x1, wh[c], fmaf(x0, wl[c], acc[m][c]));
        }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < kCols; ++c)
#pragma unroll
      for (int off = 16; off > 0; off /= 2) acc[m][c] += __shfl_xor_sync(0xffffffffu, acc[m][c], off);
  if (lane == 0) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        if (m < M && n0 + c < N) out[static_cast<size_t>(m) * N + n0 + c] = acc[m][c];
      }
    }
  }
}

constexpr int kTM = 64;
constexpr int kTN = 64;
constexpr int kTK = 32;

__global__ void __launch_bounds__(256)
w4a16_gemm_kernel(const float* __restrict__ x, const uint8_t* __restrict__ wp,
                  const float* __restrict__ scale, float* __restrict__ out, int M, int N,
                  int K, int G, int NG) {
  __shared__ float Xs[kTK][kTM + 4];
  __shared__ float Ws[kTK][kTN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // output columns tx*4 .. tx*4+3
  const int ty = tid / 16;  // output rows    ty*4 .. ty*4+3
  const int m0 = blockIdx.y * kTM;
  const int n0 = blockIdx.x * kTN;
  const int KB = K / 2;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kTK) {
    for (int e = tid; e < kTM * kTK; e += 256) {
      const int r = e / kTK, kk = e % kTK;
      const int gm = m0 + r, gk = k0 + kk;
      Xs[kk][r] = (gm < M && gk < K) ? __ldg(x + static_cast<size_t>(gm) * K + gk) : 0.f;
    }
    for (int e = tid; e < kTN * (kTK / 2); e += 256) {
      const int c = e / (kTK / 2), jb = e % (kTK / 2);
      const int gn = n0 + c, gk = k0 + 2 * jb;  // K is even: gk < K covers gk + 1
      float lo = 0.f, hi = 0.f;
      if (gn < N && gk < K) {
        const uint32_t byte = __ldg(wp + static_cast<size_t>(gn) * KB + gk / 2);
        const float s = __ldg(scale + static_cast<size_t>(gn) * NG + gk / G);
        lo = lo_val(byte, s);
        hi = hi_val(byte, s);
      }
      Ws[2 * jb][c] = lo;
      Ws[2 * jb + 1][c] = hi;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTK; ++kk) {
      float a[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Xs[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Ws[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty * 4 + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gn < N) out[static_cast<size_t>(gm) * N + gn] = acc[i][j];
    }
  }
}

template <int MT>
void launch_gemv(const float* x, const uint8_t* wp, const float* s, float* out, int M, int N,
                 int K, int G, int NG, bool vec, cudaStream_t stream) {
  const int cols_per_block = kWarps * kCols;
  const dim3 grid((N + cols_per_block - 1) / cols_per_block);
  if (vec) {
    w4a16_gemv_kernel<MT, true><<<grid, kWarps * 32, 0, stream>>>(x, wp, s, out, M, N, K, G, NG);
  } else {
    w4a16_gemv_kernel<MT, false><<<grid, kWarps * 32, 0, stream>>>(x, wp, s, out, M, N, K, G, NG);
  }
}

}  // namespace

// vec: 1 when K % 8 == 0, G % 8 == 0, x is 16-byte and wp 4-byte aligned
extern "C" int diag_w4a16_gemv_cuda_cores(const void* x, const void* wp, const void* scale, void* out,
                                int M, int N, int K, int G, int NG, int vec, void* stream) {
  if (M <= 0 || M > 8 || N <= 0 || K <= 0 || K % 2 || G <= 0 || G % 2 || NG <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* xp = static_cast<const float*>(x);
  const auto* w = static_cast<const uint8_t*>(wp);
  const auto* s = static_cast<const float*>(scale);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const bool v = vec != 0;
  if (M == 1) {
    launch_gemv<1>(xp, w, s, o, M, N, K, G, NG, v, st);
  } else if (M == 2) {
    launch_gemv<2>(xp, w, s, o, M, N, K, G, NG, v, st);
  } else if (M <= 4) {
    launch_gemv<4>(xp, w, s, o, M, N, K, G, NG, v, st);
  } else {
    launch_gemv<8>(xp, w, s, o, M, N, K, G, NG, v, st);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int diag_w4a16_gemm_cuda_cores(const void* x, const void* wp, const void* scale, void* out,
                                int M, int N, int K, int G, int NG, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 2 || G <= 0 || G % 2 || NG <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((N + kTN - 1) / kTN, (M + kTM - 1) / kTM);
  w4a16_gemm_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const uint8_t*>(wp),
      static_cast<const float*>(scale), static_cast<float*>(out), M, N, K, G, NG);
  return static_cast<int>(cudaGetLastError());
}
