// Grouped GEMM over experts, the MoE family's routed-expert product:
//
//   out bf16 [R, N],  out[r, :] = x[r, :] . W[e(r)]
//
// x bf16 [R, K] holds rows sorted by expert, group_sizes int32 [E] how many
// rows each expert owns (expert e's rows follow expert e-1's), W bf16
// [E, K, N] the stacked expert weights in the JAX layout (up / gate
// [E, d_model, moe_d_ff], down [E, moe_d_ff, d_model]).  Each output
// accumulates in float32 and is rounded to bf16 once, what
// jax.lax.ragged_dot returns for bf16 operands; rows past the groups' sum
// are written 0.
//
// Replaces jax.lax.ragged_dot in src/repro/models/moe.py::_expert_gemm
// (three calls a layer: up, gate, down).  The JAX package has no Pallas
// kernel for it; XLA lowers the call itself.
//
// What bounds it on the H100.  At decode (4 slots x top-4 = 16 rows over
// at most 16 of 64 experts) every non-empty expert's K x N weights are read
// once for a row or two: bytes, non-empty experts x K x N x 2 B at
// 3.35 TB/s.  At prefill (up to 8,192 rows, ~136 an expert) each weight
// byte serves ~136 rows: operations, 2 R K N at the bf16 tensor cores' 989
// TFLOP/s.
//
// Design (a first, simple kernel: mma.sync, no wgmma or TMA yet):
//  * Group offsets are read on the device.  The grid is sized from static
//    bounds only: N / 64 column tiles by ceil(R / 64) + min(E, R) + 1 row
//    tiles, the most 64-row tiles any split of R rows into E groups (plus
//    the zero rows past their sum) can need.  Every CTA walks group_sizes
//    (E <= a few hundred int32, from L1) to find its expert and row tile;
//    a CTA past the last tile exits.  The launch reads nothing on the
//    host, so a CUDA graph can hold it.  An empty expert owns no tile and
//    launches no work that writes.
//  * A CTA of 4 warps computes one 64 x 64 output tile of one expert over
//    all of K: mma.sync m16n8k16 bf16 -> f32, each warp 32 x 32 (2 x 4
//    tiles).  32-element K slices of x (the expert's rows, zero-filled
//    past its last row) and of W (row-major, N contiguous) stream through
//    a 4-stage cp.async ring; x's fragments come from ldmatrix, W's from
//    ldmatrix.trans.  Rows of the ring are padded by 8 elements, so the
//    8 rows one ldmatrix matrix reads fall in 8 distinct bank groups.
//  * A row's bits do not depend on its group.  Every output is one
//    accumulator summed over K in the same order (32-element slices in
//    ascending order, two m16n8k16 steps each), whatever the row count,
//    the row's place in its tile or the other experts' loads: one
//    instruction sequence, no GeMV / GEMM switch, no split of K.  The
//    tensor cores compute each output element from its own row of A, so
//    zero-filled rows beside it change nothing.
//  * K and N must be multiples of 8 (16-byte copies), the bases 16-byte
//    aligned; the wrapper checks both.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;           // rows of an output tile
constexpr int kBN = 64;           // columns of an output tile
constexpr int kBK = 32;           // K slice a stage holds
constexpr int kStages = 4;
constexpr int kThreads = 128;     // 4 warps, 2 x 2 over the tile
constexpr int kAPitch = kBK + 8;  // bf16 row pitch of the x ring (80 bytes)
constexpr int kBPitch = kBN + 8;  // bf16 row pitch of the W ring (144 bytes)

using bf16 = __nv_bfloat16;

// 16 bytes global -> shared, asynchronous; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8 x 8 bf16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8; r[m] holds matrix m's (row l / 4, columns 2 (l % 4) + {0, 1}), or
// with .trans its (rows 2 (l % 4) + {0, 1}, column l / 4)
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s)
               : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s)
               : "memory");
}

// c[16 x 8] += a[16 x 16] . b[16 x 8], bf16 in, f32 out (g = lane / 4,
// q = lane % 4: a0 row g, a1 row g + 8, k 2q + {0, 1}; a2 / a3 the same
// rows, k 8 + 2q + {0, 1}; b0 k 2q + {0, 1}, b1 k 8 + 2q + {0, 1}, column
// g; c0 / c1 row g, c2 / c3 row g + 8, columns 2q + {0, 1})
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kThreads)
    grouped_gemm_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                        const int* __restrict__ group_sizes, bf16* __restrict__ out, int R,
                        int K, int N, int E) {
  // this CTA's row tile: walk the groups in order (sizes clamped to
  // [0, rows left], as the plain version clamps them)
  const int tile = blockIdx.y;
  int expert = -1, t = 0, start = 0, row0 = 0, row_end = R;
  for (int e = 0; e < E; ++e) {
    const int g = min(max(group_sizes[e], 0), R - start);
    const int nt = (g + kBM - 1) / kBM;
    if (tile < t + nt) {
      expert = e;
      row0 = start + (tile - t) * kBM;
      row_end = start + g;
      break;
    }
    t += nt;
    start += g;
  }
  const int n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x;
  if (expert < 0) {
    // rows past the groups' sum: zero tiles after the last group's
    if (tile >= t + (R - start + kBM - 1) / kBM) return;
    row0 = start + (tile - t) * kBM;
    for (int c = tid; c < kBM * kBN / 8; c += kThreads) {
      const int r = row0 + c / (kBN / 8), n = n0 + (c % (kBN / 8)) * 8;
      if (r < R && n < N) {
        *reinterpret_cast<uint4*>(out + static_cast<long long>(r) * N + n) =
            make_uint4(0u, 0u, 0u, 0u);
      }
    }
    return;
  }

  // the rings hold bf16 bit patterns (only cp.async and ldmatrix touch them)
  __shared__ __align__(16) uint16_t As[kStages][kBM * kAPitch];
  __shared__ __align__(16) uint16_t Bs[kStages][kBK * kBPitch];
  const bf16* we = w + static_cast<long long>(expert) * K * N;
  const int n_kt = (K + kBK - 1) / kBK;

  auto load = [&](int stage, int kt) {
    const int k0 = kt * kBK;
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // x: 64 rows x 4 chunks of 8
      const int c = tid + i * kThreads;
      const int r = c / 4, kc = (c % 4) * 8;
      const bool ok = row0 + r < row_end && k0 + kc < K;
      const bf16* src = ok ? x + static_cast<long long>(row0 + r) * K + k0 + kc : x;
      cp_async16(&As[stage][r * kAPitch + kc], src, ok ? 16 : 0);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // W: 32 K rows x 8 chunks of 8
      const int c = tid + i * kThreads;
      const int r = c / 8, nc = (c % 8) * 8;
      const bool ok = k0 + r < K && n0 + nc < N;
      const bf16* src = ok ? we + static_cast<long long>(k0 + r) * N + n0 + nc : we;
      cp_async16(&Bs[stage][r * kBPitch + nc], src, ok ? 16 : 0);
    }
  };

  const int lane = tid % 32, warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;  // the warp's 32 x 32 quarter
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_kt) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < n_kt; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // slice kt landed; every warp is done with kt - 1
    const int next = kt + kStages - 1;
    if (next < n_kt) load(next % kStages, next);
    cp_async_commit();
    const uint16_t* a = As[kt % kStages];
    const uint16_t* b = Bs[kt % kStages];
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[2][4], bfr[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        // matrices: rows 0-7 / 8-15 at k 0-7, then the same at k 8-15
        const int r = wm * 32 + mi * 16 + lane % 16;
        ldmatrix_x4(af[mi], a + r * kAPitch + kk + (lane / 16) * 8);
      }
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        // matrices: (k 0-7, n block 2 nj), (k 8-15, 2 nj), (k 0-7, 2 nj + 1),
        // (k 8-15, 2 nj + 1)
        const int m = lane / 8;
        const int kr = kk + (m & 1) * 8 + lane % 8;
        const int nc = wn * 32 + (nj * 2 + (m >> 1)) * 8;
        ldmatrix_x4_trans(bfr[nj], b + kr * kBPitch + nc);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_bf16(acc[mi][j], af[mi], bfr[j / 2][(j % 2) * 2], bfr[j / 2][(j % 2) * 2 + 1]);
    }
  }
  cp_async_wait<0>();

  // epilogue: round once to bf16, store the expert's rows only
  const int g = lane / 4, q = lane % 4;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = row0 + wm * 32 + mi * 16 + g;
      const int n = n0 + wn * 32 + j * 8 + 2 * q;
      if (n >= N) continue;
      if (r < row_end) {
        *reinterpret_cast<__nv_bfloat162*>(out + static_cast<long long>(r) * N + n) =
            __floats2bfloat162_rn(acc[mi][j][0], acc[mi][j][1]);
      }
      if (r + 8 < row_end) {
        *reinterpret_cast<__nv_bfloat162*>(out + static_cast<long long>(r + 8) * N + n) =
            __floats2bfloat162_rn(acc[mi][j][2], acc[mi][j][3]);
      }
    }
  }
}

// the row tiles any split of R rows into E groups can need, plus the zero
// tiles past the groups' sum
int row_tiles(int R, int E) { return (R + kBM - 1) / kBM + (E < R ? E : R) + 1; }

}  // namespace

extern "C" int repro_grouped_gemm(const void* x, const void* w, const void* group_sizes,
                                  void* out, int R, int K, int N, int E, void* stream) {
  if (R < 0 || K <= 0 || N <= 0 || E <= 0 || K % 8 != 0 || N % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (R == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((N + kBN - 1) / kBN, row_tiles(R, E));
  grouped_gemm_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const int*>(group_sizes), static_cast<bf16*>(out), R, K, N, E);
  return static_cast<int>(cudaGetLastError());
}
