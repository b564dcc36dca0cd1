// W8A8 integer product for the port's linear layers:
//   out int32 [M, N] = x_q int8 [M, K] . w_q int8 [N, K]^T
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/int8_pagegemv/int8_pagegemv.py::paged_int8_gemm
// (int8 x int8 -> int32 on the MXU over 256x2048 weight-page tiles).  Both
// operands here are K-contiguous: W8A8 weights are stored [out, in]
// (quant/convert.py), and activations are [tokens, in], so the contraction
// needs no transpose.
//
// What bounds it on the H100: at decode (M = live slots <= 8) every weight
// byte is read once and used M times, so the product is bound by device
// memory bytes (N*K at 3.35 TB/s).  At prefill (M = slots x bucket, in the
// thousands) it is bound by integer operations (2*M*N*K).
//
// Design (the simple, exact version; wgmma and TMA are later work):
//  * int8_gemv_kernel (M <= 8): one warp per output column n; lanes stream
//    the weight row in 16-byte chunks (coalesced, read once) and __dp4a it
//    against the matching chunk of each activation row, which stays in L1 /
//    L2.  A warp shuffle sums the lanes.  Many independent warps keep the
//    memory system busy.
//  * int8_gemm_kernel (M > 8): 64x64 output tiles, 256 threads each owning
//    4x4 outputs; 64-byte K slices of both operands are staged in shared
//    memory as 32-bit words, read back as int4 vectors, and multiplied with
//    __dp4a (2 shared loads per 16 dp4a).
//  * Ragged N and M are masked; K is any length: the 16-byte vector path
//    needs K % 16 == 0 and aligned rows, else a byte-wise masked path packs
//    the words itself.
// Integer sums are exact in any order, so both paths are bit-exact against
// the plain version.  |sum| <= 127*127*K stays below 2^31 for K < 133,000.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGemvWarps = 8;

__device__ __forceinline__ int pack4(const int8_t* p, int k, int K) {
  // bytes p[k..k+3], zero past K, packed little-endian for __dp4a
  int v = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int byte = (k + b < K) ? static_cast<int>(static_cast<uint8_t>(p[k + b])) : 0;
    v |= byte << (8 * b);
  }
  return v;
}

template <int MT, bool VEC>
__global__ void __launch_bounds__(kGemvWarps * 32)
int8_gemv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                 int32_t* __restrict__ out, int M, int N, int K) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n = blockIdx.x * kGemvWarps + warp;
  if (n >= N) return;  // whole warp leaves together
  const int8_t* wr = w + static_cast<size_t>(n) * K;
  int acc[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) acc[m] = 0;
  if (VEC) {
    const int chunks = K / 16;
    const int4* w4 = reinterpret_cast<const int4*>(wr);
#pragma unroll 4
    for (int c = lane; c < chunks; c += 32) {
      const int4 wv = __ldg(w4 + c);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (m < M) {
          const int4 xv = __ldg(reinterpret_cast<const int4*>(
              x + static_cast<size_t>(m) * K) + c);
          int a = acc[m];
          a = __dp4a(wv.x, xv.x, a);
          a = __dp4a(wv.y, xv.y, a);
          a = __dp4a(wv.z, xv.z, a);
          a = __dp4a(wv.w, xv.w, a);
          acc[m] = a;
        }
      }
    }
  } else {
    for (int k = lane * 4; k < K; k += 128) {
      const int wv = pack4(wr, k, K);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (m < M) {
          acc[m] = __dp4a(wv, pack4(x + static_cast<size_t>(m) * K, k, K), acc[m]);
        }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int off = 16; off > 0; off /= 2) {
      acc[m] += __shfl_xor_sync(0xffffffffu, acc[m], off);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (m < M) out[static_cast<size_t>(m) * N + n] = acc[m];
    }
  }
}

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBKW = 16;  // 16 words = 64 bytes of K per stage

__device__ __forceinline__ int4 load_chunk(const int8_t* base, int row, int rows,
                                           int k, int K, bool vec) {
  // the 16-byte chunk [k, k+16) of row `row`, zero outside the matrix
  int4 v = make_int4(0, 0, 0, 0);
  if (row >= rows || k >= K) return v;
  const int8_t* p = base + static_cast<size_t>(row) * K;
  if (vec) return *reinterpret_cast<const int4*>(p + k);
  v.x = pack4(p, k, K);
  v.y = pack4(p, k + 4, K);
  v.z = pack4(p, k + 8, K);
  v.w = pack4(p, k + 12, K);
  return v;
}

template <bool VEC>
__global__ void __launch_bounds__(256)
int8_gemm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                 int32_t* __restrict__ out, int M, int N, int K) {
  // +4 words of padding keeps each row 16-byte aligned for the int4 reads
  __shared__ __align__(16) int As[kBKW][kBM + 4];
  __shared__ __align__(16) int Bs[kBKW][kBN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // output columns tx*4 .. tx*4+3
  const int ty = tid / 16;  // output rows    ty*4 .. ty*4+3
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int lrow = tid / 4;  // staging: one 16-byte chunk of A and of B
  const int lch = tid % 4;
  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += 4 * kBKW) {
    const int4 av = load_chunk(x, m0 + lrow, M, k0 + lch * 16, K, VEC);
    const int4 bv = load_chunk(w, n0 + lrow, N, k0 + lch * 16, K, VEC);
    As[lch * 4 + 0][lrow] = av.x;
    As[lch * 4 + 1][lrow] = av.y;
    As[lch * 4 + 2][lrow] = av.z;
    As[lch * 4 + 3][lrow] = av.w;
    Bs[lch * 4 + 0][lrow] = bv.x;
    Bs[lch * 4 + 1][lrow] = bv.y;
    Bs[lch * 4 + 2][lrow] = bv.z;
    Bs[lch * 4 + 3][lrow] = bv.w;
    __syncthreads();
#pragma unroll
    for (int kw = 0; kw < kBKW; ++kw) {
      const int4 a4 = *reinterpret_cast<const int4*>(&As[kw][ty * 4]);
      const int4 b4 = *reinterpret_cast<const int4*>(&Bs[kw][tx * 4]);
      const int a[4] = {a4.x, a4.y, a4.z, a4.w};
      const int b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
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
void launch_gemv(const int8_t* x, const int8_t* w, int32_t* out, int M, int N,
                 int K, bool vec, cudaStream_t stream) {
  const dim3 grid((N + kGemvWarps - 1) / kGemvWarps);
  const dim3 block(kGemvWarps * 32);
  if (vec) {
    int8_gemv_kernel<MT, true><<<grid, block, 0, stream>>>(x, w, out, M, N, K);
  } else {
    int8_gemv_kernel<MT, false><<<grid, block, 0, stream>>>(x, w, out, M, N, K);
  }
}

}  // namespace

// vec: 1 when K % 16 == 0 and both base pointers are 16-byte aligned
extern "C" int repro_int8_gemv(const void* x, const void* w, void* out, int M,
                               int N, int K, int vec, void* stream) {
  const auto* xp = static_cast<const int8_t*>(x);
  const auto* wp = static_cast<const int8_t*>(w);
  auto* op = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || M > 8 || N <= 0 || K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (M == 1) {
    launch_gemv<1>(xp, wp, op, M, N, K, vec != 0, s);
  } else if (M == 2) {
    launch_gemv<2>(xp, wp, op, M, N, K, vec != 0, s);
  } else if (M <= 4) {
    launch_gemv<4>(xp, wp, op, M, N, K, vec != 0, s);
  } else {
    launch_gemv<8>(xp, wp, op, M, N, K, vec != 0, s);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_int8_gemm(const void* x, const void* w, void* out, int M,
                               int N, int K, int vec, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  const auto* xp = static_cast<const int8_t*>(x);
  const auto* wp = static_cast<const int8_t*>(w);
  auto* op = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (vec) {
    int8_gemm_kernel<true><<<grid, 256, 0, s>>>(xp, wp, op, M, N, K);
  } else {
    int8_gemm_kernel<false><<<grid, 256, 0, s>>>(xp, wp, op, M, N, K);
  }
  return static_cast<int>(cudaGetLastError());
}
