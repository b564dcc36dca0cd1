// W8A8 integer product for the port's linear layers:
//   out int32 [M, N] = x_q int8 [M, K] . w_q int8 [N, K]^T
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/int8_pagegemv/int8_pagegemv.py::paged_int8_gemm
// (int8 x int8 -> int32 on the MXU over 256x2048 weight-page tiles).  Both
// operands here are K-contiguous: W8A8 weights are stored [out, in]
// (quant/convert.py), and activations are [tokens, in], so the contraction
// needs no transpose; K-major is also the only layout int8 wgmma takes.
//
// What bounds it on the H100: at decode (M = live slots <= 8) every weight
// byte is read once and used M times, so the product is bound by device
// memory bytes (N*K at 3.35 TB/s).  At prefill (M = slots x bucket, in the
// thousands) it is bound by integer operations (2*M*N*K at 1,979 TOP/s),
// a rate only the tensor cores' wgmma reaches (mma.sync and __dp4a do not).
//
// Design, four variants (the wrapper picks one from the shape and the
// operands' alignment alone, int8_pagegemv/ops.py::gemm_variant):
//  * int8_gemv_mma_kernel (M <= 8, K % 16 == 0, 16-byte aligned bases:
//    every model's decode shape): a CTA of 16 warps owns 16 output columns
//    (weight rows); its warps take the 64-byte K slabs in turn (slab s to
//    warp s % 16), so at each step the CTA reads 1 KB of each of its 16
//    rows.  Each lane loads 16 bytes of two weight rows and 16
//    bytes of one activation row straight into registers (4 slabs in flight
//    per warp, the weights past L1) and feeds them to the tensor cores as
//    mma.sync m16n8k32 s32.s8.s8 with the weights as A ("swap AB": the
//    16-row tile is the product's M) and the activation rows, zero-padded
//    to 8, as B.  The k order inside a slab is permuted alike in A and B so
//    that each lane's operands are 16 contiguous bytes: two mmas a slab.
//    Each activation chunk is loaded once per slab and serves 16 output
//    columns.  The 16 warps' int32 fragments are summed through shared
//    memory in warp order.  Many CTAs of 16 columns (688 at N 11008) keep
//    every SM streaming to the end, with no tail of a long-lived CTA; 16
//    warps a CTA (rather than 8) keep more bytes in flight where N is
//    small (256 CTAs at N 4096).
//  * int8_gemv_dp4a_kernel (M <= 8, K not a multiple of 16 or a misaligned
//    base: on no model's path): one warp per output column; lanes pack
//    4-byte words of the weight row and of each activation row (zero past
//    K) and __dp4a them; a warp shuffle sums the lanes.
//  * int8_gemm_tc_kernel (M > 8, K % 16 == 0, 16-byte aligned bases: every
//    model shape): a CTA computes a 128x256 output tile.  One producer
//    warp (one thread of it) issues TMA loads of 128-byte K slices of x
//    (128 rows) and w (256 rows) into a 4-stage ring in shared memory
//    (128-byte swizzle, mbarrier completion, 192 KB); two consumer
//    warpgroups each run wgmma m64n256k32 s32.s8.s8 on their 64 rows,
//    keeping one group of four in flight while the next stage arrives,
//    and release a stage to the producer as soon as its products are
//    done.  The 256-wide tile reads each x slice from shared memory once
//    for 256 outputs, half the x traffic of a 128-wide tile per product.
//    TMA writes zeros outside the tensors, which covers ragged M, N and K;
//    the epilogue stores the int32 accumulators as they are, masked at the
//    M and N edges.  CTAs walk M fastest, so the CTAs in flight share a
//    few weight tiles and the weights are read from device memory about
//    once.
//  * int8_gemm_kernel (M > 8, K not a multiple of 16 or a misaligned
//    base: on no model's path): 64x64 output tiles, 256 threads each
//    owning 4x4 outputs; 64-byte K slices of both operands are packed
//    byte by byte (zero past K) into 32-bit words in shared memory, read
//    back as int4 vectors, and multiplied with __dp4a.
//  * Ragged N and M are masked everywhere; K is any length in the __dp4a
//    variants.
// Integer sums are exact in any order, so every variant is bit-exact
// against the plain version.  |sum| <= 127*127*K stays below 2^31 for
// K < 133,000.

#include "hopper.cuh"

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

template <int MT>
__global__ void __launch_bounds__(kGemvWarps * 32)
int8_gemv_dp4a_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                      int32_t* __restrict__ out, int M, int N, int K) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n = blockIdx.x * kGemvWarps + warp;
  if (n >= N) return;  // whole warp leaves together
  const int8_t* wr = w + static_cast<size_t>(n) * K;
  int acc[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) acc[m] = 0;
  for (int k = lane * 4; k < K; k += 128) {
    const int wv = pack4(wr, k, K);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (m < M) {
        acc[m] = __dp4a(wv, pack4(x + static_cast<size_t>(m) * K, k, K), acc[m]);
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

constexpr int kMmaWarps = 16;  // warps per CTA, taking the K slabs in turn
constexpr int kMmaRows = 16;   // output columns (weight rows) per CTA: the mma's M
constexpr int kMmaUnroll = 4;  // 64-byte slabs in flight per warp

// 16 bytes of a weight row, kept out of L1 (each byte is used once)
__device__ __forceinline__ int4 ldg_stream(const int4* p) {
  int4 v;
  asm("ld.global.nc.L1::no_allocate.v4.s32 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

// c[16 x 8] += a[16 x 32] . b[32 x 8], int8 in, int32 out (mma.sync
// fragments: a0/a2 row g, a1/a3 row g + 8, k 4q..4q+3 and 16+4q..16+4q+3;
// b0/b1 column g, the same k; c0/c1 row g, c2/c3 row g + 8, columns 2q and
// 2q + 1; g = lane / 4, q = lane % 4)
__device__ __forceinline__ void mma_s8(int (&c)[4], int a0, int a1, int a2, int a3, int b0,
                                       int b1) {
  asm(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kMmaWarps * 32)
int8_gemv_mma_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                     int32_t* __restrict__ out, int M, int N, int K) {
  __shared__ int red[kMmaWarps][32][4];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // weight rows g and g + 8 of the tile; activation row g
  const int q = lane % 4;  // 16-byte chunk q of each 64-byte slab
  const int n0 = blockIdx.x * kMmaRows;
  const int chunks = K / 16;
  const int slabs = (chunks + 3) / 4;
  const bool row0 = n0 + g < N, row1 = n0 + g + 8 < N, xrow = g < M;
  const int4* w0 = reinterpret_cast<const int4*>(w + static_cast<size_t>(row0 ? n0 + g : 0) * K);
  const int4* w1 = reinterpret_cast<const int4*>(w + static_cast<size_t>(row1 ? n0 + g + 8 : 0) * K);
  const int4* xr = reinterpret_cast<const int4*>(x + static_cast<size_t>(xrow ? g : 0) * K);
  const int4 zero = make_int4(0, 0, 0, 0);
  int acc[4] = {0, 0, 0, 0};
  for (int s0 = warp; s0 < slabs; s0 += kMmaWarps * kMmaUnroll) {
    int4 wa[kMmaUnroll], wb[kMmaUnroll], xv[kMmaUnroll];
#pragma unroll
    for (int u = 0; u < kMmaUnroll; ++u) {
      const int c = 4 * (s0 + u * kMmaWarps) + q;
      const bool in = c < chunks;
      wa[u] = (in && row0) ? ldg_stream(w0 + c) : zero;
      wb[u] = (in && row1) ? ldg_stream(w1 + c) : zero;
      xv[u] = (in && xrow) ? __ldg(xr + c) : zero;
    }
#pragma unroll
    for (int u = 0; u < kMmaUnroll; ++u) {
      // physical bytes 0..7 of each lane's chunk as the mma's k 4q.. and
      // 16+4q.., bytes 8..15 as the next mma's: the same in A and in B
      mma_s8(acc, wa[u].x, wb[u].x, wa[u].y, wb[u].y, xv[u].x, xv[u].y);
      mma_s8(acc, wa[u].z, wb[u].z, wa[u].w, wb[u].w, xv[u].z, xv[u].w);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) red[warp][lane][i] = acc[i];
  __syncthreads();
  if (warp == 0) {
    int sum[4] = {0, 0, 0, 0};
#pragma unroll
    for (int v = 0; v < kMmaWarps; ++v) {
#pragma unroll
      for (int i = 0; i < 4; ++i) sum[i] += red[v][lane][i];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = 2 * q + (i & 1);
      const int n = n0 + g + 8 * (i >> 1);
      if (m < M && n < N) out[static_cast<size_t>(m) * N + n] = sum[i];
    }
  }
}

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBKW = 16;  // 16 words = 64 bytes of K per stage

__device__ __forceinline__ int4 load_chunk(const int8_t* base, int row, int rows,
                                           int k, int K) {
  // the 16-byte chunk [k, k+16) of row `row`, zero outside the matrix
  int4 v = make_int4(0, 0, 0, 0);
  if (row >= rows || k >= K) return v;
  const int8_t* p = base + static_cast<size_t>(row) * K;
  v.x = pack4(p, k, K);
  v.y = pack4(p, k + 4, K);
  v.z = pack4(p, k + 8, K);
  v.w = pack4(p, k + 12, K);
  return v;
}

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
    const int4 av = load_chunk(x, m0 + lrow, M, k0 + lch * 16, K);
    const int4 bv = load_chunk(w, n0 + lrow, N, k0 + lch * 16, K);
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

constexpr int kTcBM = 128;    // rows of x per CTA: two consumer warpgroups of 64
constexpr int kTcBN = 256;    // rows of w (output columns) per CTA
constexpr int kTcBK = 128;    // bytes of K per stage: one 128-byte swizzle row
constexpr int kTcStages = 4;
constexpr int kTcTileA = kTcBM * kTcBK;  // 16 KB
constexpr int kTcTileB = kTcBN * kTcBK;  // 32 KB
constexpr int kTcThreads = 2 * 128 + 32;  // warpgroups 0, 1 consume; warp 8 produces
constexpr int kTcSmem = kTcStages * (kTcTileA + kTcTileB) + 2 * kTcStages * 8 + 1024;

__global__ void __launch_bounds__(kTcThreads, 1)
int8_gemm_tc_kernel(const __grid_constant__ CUtensorMap tmx,
                    const __grid_constant__ CUtensorMap tmw, int32_t* __restrict__ out, int M,
                    int N, int K) {
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1,024 bytes: tiles start on that grid
  uint8_t* smem = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sa = smem;                            // [stage][128 rows][128 bytes]
  uint8_t* sb = smem + kTcStages * kTcTileA;     // [stage][256 rows][128 bytes]
  uint64_t* full = reinterpret_cast<uint64_t*>(sb + kTcStages * kTcTileB);
  uint64_t* empty = full + kTcStages;
  const int m0 = blockIdx.x * kTcBM;
  const int n0 = blockIdx.y * kTcBN;
  const int nk = (K + kTcBK - 1) / kTcBK;
  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kTcStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {  // producer
    if (threadIdx.x == 2 * 128) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % kTcStages;
        hopper::mbar_wait(&empty[s], ((kt / kTcStages) & 1) ^ 1);
        hopper::mbar_expect_tx(&full[s], kTcTileA + kTcTileB);
        hopper::tma_load_2d(sa + s * kTcTileA, &tmx, &full[s], kt * kTcBK, m0);
        hopper::tma_load_2d(sb + s * kTcTileB, &tmw, &full[s], kt * kTcBK, n0);
      }
    }
    return;
  }

  int32_t acc[kTcBN / 2];
#pragma unroll
  for (int i = 0; i < kTcBN / 2; ++i) acc[i] = 0;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % kTcStages;
    hopper::mbar_wait(&full[s], (kt / kTcStages) & 1);
    const uint32_t a0 = hopper::smem_u32(sa + s * kTcTileA + wg * 64 * kTcBK);
    const uint32_t b0 = hopper::smem_u32(sb + s * kTcTileB);
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTcBK / 32; ++kk) {
      hopper::wgmma_m64n256k32_s8_ss(acc, hopper::desc_sw128(a0 + kk * 32, 16, 1024),
                                     hopper::desc_sw128(b0 + kk * 32, 16, 1024), 1);
    }
    hopper::wgmma_commit();
    hopper::fence_regs(acc);
    if (kt > 0) {  // the previous stage's products are done: hand it back
      hopper::wgmma_wait<1>();
      hopper::fence_regs(acc);
      if (lane == 0) hopper::mbar_arrive(&empty[(kt - 1) % kTcStages]);
    }
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);

  const int warp = (threadIdx.x % 128) / 32;
  const int r0 = m0 + wg * 64 + warp * 16 + lane / 4;
  const bool pairs = (N % 2) == 0;
#pragma unroll
  for (int j = 0; j < kTcBN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * (lane % 4);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = r0 + 8 * half;
      if (row >= M || col >= N) continue;
      int32_t* p = out + static_cast<size_t>(row) * N + col;
      const int v0 = acc[4 * j + 2 * half];
      const int v1 = acc[4 * j + 2 * half + 1];
      if (pairs) {
        *reinterpret_cast<int2*>(p) = make_int2(v0, v1);
      } else {
        p[0] = v0;
        if (col + 1 < N) p[1] = v1;
      }
    }
  }
}

template <int MT>
void launch_gemv_dp4a(const int8_t* x, const int8_t* w, int32_t* out, int M, int N, int K,
                      cudaStream_t stream) {
  const dim3 grid((N + kGemvWarps - 1) / kGemvWarps);
  int8_gemv_dp4a_kernel<MT><<<grid, kGemvWarps * 32, 0, stream>>>(x, w, out, M, N, K);
}

}  // namespace

// the tensor-core GeMV: M <= 8, K % 16 == 0 and 16-byte aligned x and w
extern "C" int repro_int8_gemv(const void* x, const void* w, void* out, int M, int N, int K,
                               void* stream) {
  if (M <= 0 || M > 8 || N <= 0 || K <= 0 || K % 16 != 0 ||
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((N + kMmaRows - 1) / kMmaRows);
  int8_gemv_mma_kernel<<<grid, kMmaWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w), static_cast<int32_t*>(out),
      M, N, K);
  return static_cast<int>(cudaGetLastError());
}

// the __dp4a GeMV: M <= 8, any K, any alignment
extern "C" int repro_int8_gemv_dp4a(const void* x, const void* w, void* out, int M, int N,
                                    int K, void* stream) {
  const auto* xp = static_cast<const int8_t*>(x);
  const auto* wp = static_cast<const int8_t*>(w);
  auto* op = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || M > 8 || N <= 0 || K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (M == 1) {
    launch_gemv_dp4a<1>(xp, wp, op, M, N, K, s);
  } else if (M == 2) {
    launch_gemv_dp4a<2>(xp, wp, op, M, N, K, s);
  } else if (M <= 4) {
    launch_gemv_dp4a<4>(xp, wp, op, M, N, K, s);
  } else {
    launch_gemv_dp4a<8>(xp, wp, op, M, N, K, s);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_int8_gemm(const void* x, const void* w, void* out, int M,
                               int N, int K, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  int8_gemm_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<int32_t*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

// the tensor-core variant: K % 16 == 0 and 16-byte aligned x and w (the TMA
// tensor maps' row stride and base); returns hopper::kTensorMapError + the
// CUresult if a tensor map cannot be encoded
extern "C" int repro_int8_gemm_tc(const void* x, const void* w, void* out, int M, int N, int K,
                                  void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 != 0 ||
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap tmx, tmw;
  const cuuint64_t kstride[1] = {static_cast<cuuint64_t>(K)};
  const cuuint64_t dx[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(M)};
  const cuuint64_t dw[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(N)};
  const cuuint32_t bx[2] = {kTcBK, kTcBM};
  const cuuint32_t bw[2] = {kTcBK, kTcBN};
  int st = hopper::encode_tensor_map(&tmx, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, x, dx, kstride, bx);
  if (st != 0) return st;
  st = hopper::encode_tensor_map(&tmw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, w, dw, kstride, bw);
  if (st != 0) return st;
  const cudaError_t err = cudaFuncSetAttribute(
      int8_gemm_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kTcSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((M + kTcBM - 1) / kTcBM, (N + kTcBN - 1) / kTcBN);
  int8_gemm_tc_kernel<<<grid, kTcThreads, kTcSmem, static_cast<cudaStream_t>(stream)>>>(
      tmx, tmw, static_cast<int32_t*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}
