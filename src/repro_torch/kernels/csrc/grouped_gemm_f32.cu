// Float32 grouped GEMM over experts and its gradient, the moe family's
// routed-expert product under training:
//
//   forward  out [R, N] = x [R, K] . W[e(r)]       grouped_f32_fwd_kernel
//   dX       dx  [R, K] = dy [R, N] . W[e(r)]^T    grouped_f32_dx_kernel
//   dW       dw  [E, K, N], dw[e] = x_e^T . dy_e   grouped_f32_dw_kernel
//
// x (dy) holds rows sorted by expert, group_sizes int32 [E] how many rows
// each expert owns (expert e's rows follow expert e-1's; each size clamped
// to [0, rows left], as the plain version clamps it), W float32 [E, K, N]
// the stacked expert weights in the JAX layout (up / gate [E, d_model,
// moe_d_ff], down [E, moe_d_ff, d_model]).  Rows of out and dx past the
// groups' sum are written 0, and so is dw of an expert without rows.
//
// Replaces jax.lax.ragged_dot under jax.value_and_grad in
// src/repro/models/moe.py::_expert_gemm (three products a layer, each with
// its dX and dW in the backward).  The JAX package has no Pallas kernel for
// it; XLA lowers the call and its transpose itself.  csrc/grouped_gemm.cu
// is the bf16 forward the serving path runs; training is float32 and needs
// the gradient, which is why this file exists.
//
// What bounds it on the H100 (qwen2-moe-a2.7b training: R = 8 x 256 tokens
// x top-4 = 8,192 pair rows over 60 of 64 experts; K x N 2048 x 1408 up /
// gate, 1408 x 2048 down; 11.5 MB of float32 weights an expert): operations.
// Each of the three is 2 R K N = 47.2 GFLOP, 0.70 ms on the float32 CUDA
// cores at 67 TFLOP/s, against 0.24-0.25 ms for its bytes (the non-empty
// experts' weights, x and the output once; dW writes every expert's
// [K, N], 738 MB).  Plain TF32 on the tensor cores keeps ~3 digits and is
// not used (the training gates hold float32's accuracy).
//
// Design (a first kernel: right and simple; ROADMAP lists the work left):
//  * FFMA on the CUDA cores.  A CTA of 256 threads computes a 64 x 64
//    output tile, each thread a 4 x 4 register micro-tile, over reduction
//    steps of kBK = 32 brought by cp.async (16 bytes a copy, zero-filled
//    past the operand's edge) into two shared-memory stages, the next step
//    in flight while this one computes.
//  * Operand layouts.  An operand tile is stored as it lies in device
//    memory: contiguous along the reduction (x and dy rows in the forward
//    and dX, W's rows in dX: [64][kBK + 4], padded so that rows four apart
//    fall on other banks; a thread's four outputs are 16 apart) or along
//    the output (W in the forward, x and dy in dW: [kBK][64]; a thread's
//    four outputs adjacent).  Either way a thread reads a 4 x 4 block of
//    each operand per four reduction steps as four float4 loads and runs
//    64 FFMAs on them.
//  * Tiles of the forward and dX: 64 rows of one expert from its first row
//    (its last tile may be short) by 64 columns; the zero tiles past the
//    groups' sum write 0.  The grid is columns x a static bound on the row
//    tiles, ceil(R / 64) + min(E, R) + 1, the most any split of R rows
//    into E groups can need; each CTA finds its tile by scanning the group
//    sizes on the device, 32 at a time with warp scans and a ballot (as
//    grouped_gemm.cu finds its tiles), and a CTA past the schedule exits.
//    The launch reads nothing on the host.
//  * dW: one CTA per (N tile, K tile, expert); it finds its expert's rows
//    by the same scan and walks all of them, kBK at a time, ascending.  No
//    split over rows, so no second pass and no atomics; an expert without
//    rows stores its zero accumulators.
//  * One fixed order a sum: every output is one float32 accumulator, one
//    fmaf a product, over K ascending (forward), N ascending (dX) or the
//    group's rows ascending (dW), whatever R, the row's group or its place
//    in it.  A second run, a recomputed (remat) forward and a resumed
//    training run give the same bits.
//  * K and N must be multiples of 4 and the bases 16-byte aligned (16-byte
//    copies); the wrapper checks both.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;                  // output rows of a tile
constexpr int kBN = 64;                  // output columns of a tile
constexpr int kBK = 32;                  // reduction steps of a stage
constexpr int kThreads = 256;            // 16 x 16 threads, 4 x 4 outputs each
constexpr int kLdK = kBK + 4;            // row stride of a reduction-contiguous tile
constexpr int kLdO = 64;                 // row stride of an output-contiguous tile
constexpr int kStage = kBM * kLdK;       // floats of a stage (the larger layout)
constexpr unsigned kAll = 0xffffffffu;

static_assert(kBM == 64 && kBN == 64 && kThreads == 256, "4 x 4 outputs a thread");
static_assert(kBK * kLdO <= kStage, "an output-contiguous tile fits a stage");

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------- schedule

// the warp's view of experts e0 .. e0 + 31 given the rows and row tiles
// before them (grouped_gemm.cu's scan at 64-row tiles): lane i holds expert
// e0 + i's rows [begin, end), its first row tile and its tile count; every
// lane holds the totals after the chunk.  Expert e's rows end at min(P, R),
// P the sum of max(size, 0) up to e.
struct Chunk {
  int begin, end, tile, tiles, next_start, next_tile;
};

__device__ __forceinline__ Chunk scan_chunk(const int* gs, int E, int R, int e0, int start,
                                            int t) {
  const int lane = threadIdx.x % 32;
  const int e = e0 + lane;
  const int a = e < E ? min(max(gs[e], 0), R) : 0;
  int p = a;  // inclusive sum of the chunk's sizes, saturating at R
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(kAll, p, d);
    if (lane >= d) p = min(p + v, R);
  }
  int q = __shfl_up_sync(kAll, p, 1);
  if (lane == 0) q = 0;
  Chunk c;
  c.begin = min(start + q, R);
  c.end = min(start + p, R);
  c.tiles = (c.end - c.begin + kBM - 1) / kBM;
  int s = c.tiles;  // inclusive sum of the tile counts
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(kAll, s, d);
    if (lane >= d) s += v;
  }
  c.tile = t + s - c.tiles;
  c.next_start = __shfl_sync(kAll, c.end, 31);
  c.next_tile = t + __shfl_sync(kAll, s, 31);
  return c;
}

struct RowTile {
  int expert;  // -1: rows past the groups' sum
  int row0;    // the tile's first row (>= R: no tile)
  int end;     // the expert's end row (R past the sum)
};

// row tile y of the schedule: each expert's tiles from its first row, then
// the zero tiles of the rows past the groups' sum (every lane of warp 0
// calls it)
__device__ RowTile find_row_tile(const int* gs, int E, int R, int y) {
  int start = 0, t = 0;
  for (int e0 = 0; e0 < E; e0 += 32) {
    const Chunk c = scan_chunk(gs, E, R, e0, start, t);
    const unsigned hit = __ballot_sync(kAll, y >= c.tile && y < c.tile + c.tiles);
    if (hit != 0u) {
      const int src = __ffs(hit) - 1;
      const int tile = __shfl_sync(kAll, c.tile, src);
      const int begin = __shfl_sync(kAll, c.begin, src);
      return {e0 + src, begin + (y - tile) * kBM, __shfl_sync(kAll, c.end, src)};
    }
    start = c.next_start;
    t = c.next_tile;
  }
  return {-1, start + (y - t) * kBM, R};
}

// expert e's rows [begin, end) (every lane of warp 0 calls it)
__device__ int2 expert_rows(const int* gs, int E, int R, int e) {
  int start = 0;
  for (int e0 = 0; e0 < E; e0 += 32) {
    const Chunk c = scan_chunk(gs, E, R, e0, start, 0);
    if (e < e0 + 32) {
      return make_int2(__shfl_sync(kAll, c.begin, e - e0), __shfl_sync(kAll, c.end, e - e0));
    }
    start = c.next_start;
  }
  return make_int2(R, R);
}

// ------------------------------------------------------------ the product

// An operand's tile in device memory: element (o, k), o an output index (a
// row of the tile for A, a column for B) and k a reduction index, lies at
// base[o * ld + k] when the operand is reduction-contiguous (kK) and at
// base[k * ld + o] otherwise; o is valid below o_end.
struct Operand {
  const float* base;
  long long ld;
  int o0, o_end;
};

// the stage at reduction index k0: 512 copies of 16 bytes, two a thread;
// copies past the operand's edge (o >= o_end, k >= k_end) zero-fill
template <bool kK>
__device__ __forceinline__ void load_stage(float* tile, const Operand& op, int k0, int k_end) {
#pragma unroll
  for (int c = threadIdx.x; c < 512; c += kThreads) {
    const int o = kK ? c / (kBK / 4) : (c % (kBN / 4)) * 4;
    const int k = kK ? (c % (kBK / 4)) * 4 : c / (kBN / 4);
    const int go = op.o0 + o, gk = k0 + k;
    const bool ok = go < op.o_end && gk < k_end;
    const long long at = kK ? static_cast<long long>(go) * op.ld + gk
                            : static_cast<long long>(gk) * op.ld + go;
    cp_async16(tile + (kK ? o * kLdK + k : k * kLdO + o), ok ? op.base + at : op.base, ok);
  }
}

// the thread's i-th output index of a 64-wide tile side: 16 apart in a
// reduction-contiguous tile (rows four apart would share banks), adjacent
// in an output-contiguous one
template <bool kK>
__device__ __forceinline__ int out_index(int lane_o, int i) {
  return kK ? lane_o + 16 * i : 4 * lane_o + i;
}

// v[i][kk]: the thread's output i at reduction step q + kk of the stage
template <bool kK>
__device__ __forceinline__ void fetch(float (&v)[4][4], const float* tile, int lane_o, int q) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 t = kK ? *reinterpret_cast<const float4*>(tile + (lane_o + 16 * i) * kLdK + q)
                        : *reinterpret_cast<const float4*>(tile + (q + i) * kLdO + 4 * lane_o);
    if (kK) {
      v[i][0] = t.x, v[i][1] = t.y, v[i][2] = t.z, v[i][3] = t.w;
    } else {
      v[0][i] = t.x, v[1][i] = t.y, v[2][i] = t.z, v[3][i] = t.w;
    }
  }
}

// acc[i][j] = sum over k in [k_begin, k_end), ascending, of A(row i, k)
// B(k, col j), one fmaf a product
template <bool kAK, bool kBK_>
__device__ __forceinline__ void tile_product(float (&acc)[4][4], const Operand& a,
                                             const Operand& b, int k_begin, int k_end,
                                             float* sa, float* sb) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  const int steps = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;
  if (steps == 0) return;
  load_stage<kAK>(sa, a, k_begin, k_end);
  load_stage<kBK_>(sb, b, k_begin, k_end);
  cp_async_commit();
  for (int s = 0; s < steps; ++s) {
    const int cur = s & 1;
    if (s + 1 < steps) {
      load_stage<kAK>(sa + (cur ^ 1) * kStage, a, k_begin + (s + 1) * kBK, k_end);
      load_stage<kBK_>(sb + (cur ^ 1) * kStage, b, k_begin + (s + 1) * kBK, k_end);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // every thread's copies of this stage have landed
    const float* ta = sa + cur * kStage;
    const float* tb = sb + cur * kStage;
#pragma unroll
    for (int q = 0; q < kBK; q += 4) {
      float va[4][4], vb[4][4];
      fetch<kAK>(va, ta, ty, q);
      fetch<kBK_>(vb, tb, tx, q);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(va[i][kk], vb[j][kk], acc[i][j]);
    }
    __syncthreads();  // the stage is refilled by the step after next
  }
}

// the thread's outputs at rows row0 + out_index<kAK>(ty, i) below row_end
// and columns col0 + out_index<kBK_>(tx, j) below n_cols of a row-major
// [*, n_cols] output
template <bool kAK, bool kBK_>
__device__ __forceinline__ void store_tile(float* __restrict__ out, int n_cols,
                                           const float (&acc)[4][4], int row0, int row_end,
                                           int col0) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + out_index<kAK>(ty, i);
    if (r >= row_end) continue;
    float* row = out + static_cast<long long>(r) * n_cols;
    if (!kBK_) {  // four adjacent columns; n_cols % 4 == 0: all or none
      const int c = col0 + 4 * tx;
      if (c < n_cols) {
        *reinterpret_cast<float4*>(row + c) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = col0 + tx + 16 * j;
        if (c < n_cols) row[c] = acc[i][j];
      }
    }
  }
}

// a 64 x 64 tile of zeros from row0 (rows below R, columns below n_cols)
__device__ __forceinline__ void store_zeros(float* __restrict__ out, int n_cols, int row0,
                                            int R, int col0) {
  for (int c = threadIdx.x; c < kBM * kBN / 4; c += kThreads) {
    const int r = row0 + c / (kBN / 4), n = col0 + (c % (kBN / 4)) * 4;
    if (r < R && n < n_cols) {
      *reinterpret_cast<float4*>(out + static_cast<long long>(r) * n_cols + n) =
          make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// the CTA's row tile (blockIdx.y), found by warp 0
__device__ __forceinline__ RowTile cta_row_tile(const int* gs, int E, int R) {
  __shared__ RowTile found;
  if (threadIdx.x < 32) {
    const RowTile t = find_row_tile(gs, E, R, blockIdx.y);
    if (threadIdx.x == 0) found = t;
  }
  __syncthreads();
  return found;
}

__global__ void __launch_bounds__(kThreads, 2)
    grouped_f32_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                           const int* __restrict__ gs, float* __restrict__ out, int R, int K,
                           int N, int E) {
  __shared__ __align__(16) float sa[2 * kStage];
  __shared__ __align__(16) float sb[2 * kStage];
  const RowTile t = cta_row_tile(gs, E, R);
  if (t.row0 >= R) return;  // past the schedule's tiles
  const int n0 = blockIdx.x * kBN;
  if (t.expert < 0) {
    store_zeros(out, N, t.row0, R, n0);
    return;
  }
  const Operand a{x, K, t.row0, t.end};                                      // x[r][k]
  const Operand b{w + static_cast<long long>(t.expert) * K * N, N, n0, N};  // W_e[k][n]
  float acc[4][4];
  tile_product<true, false>(acc, a, b, 0, K, sa, sb);
  store_tile<true, false>(out, N, acc, t.row0, t.end, n0);
}

__global__ void __launch_bounds__(kThreads, 2)
    grouped_f32_dx_kernel(const float* __restrict__ dy, const float* __restrict__ w,
                          const int* __restrict__ gs, float* __restrict__ dx, int R, int K,
                          int N, int E) {
  __shared__ __align__(16) float sa[2 * kStage];
  __shared__ __align__(16) float sb[2 * kStage];
  const RowTile t = cta_row_tile(gs, E, R);
  if (t.row0 >= R) return;
  const int k0 = blockIdx.x * kBN;  // the tile's dx columns
  if (t.expert < 0) {
    store_zeros(dx, K, t.row0, R, k0);
    return;
  }
  const Operand a{dy, N, t.row0, t.end};                                     // dy[r][n]
  const Operand b{w + static_cast<long long>(t.expert) * K * N, N, k0, K};  // W_e[k][n]
  float acc[4][4];
  tile_product<true, true>(acc, a, b, 0, N, sa, sb);
  store_tile<true, true>(dx, K, acc, t.row0, t.end, k0);
}

__global__ void __launch_bounds__(kThreads, 2)
    grouped_f32_dw_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                          const int* __restrict__ gs, float* __restrict__ dw, int R, int K,
                          int N, int E) {
  __shared__ __align__(16) float sa[2 * kStage];
  __shared__ __align__(16) float sb[2 * kStage];
  __shared__ int2 rows;
  const int e = blockIdx.z;
  if (threadIdx.x < 32) {
    const int2 r = expert_rows(gs, E, R, e);
    if (threadIdx.x == 0) rows = r;
  }
  __syncthreads();
  const int k0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const Operand a{x, K, k0, K};   // x[r][k]: output k, reduction r
  const Operand b{dy, N, n0, N};  // dy[r][n]
  float acc[4][4];
  tile_product<false, false>(acc, a, b, rows.x, rows.y, sa, sb);
  store_tile<false, false>(dw + static_cast<long long>(e) * K * N, N, acc, k0, K, n0);
}

// the row tiles any split of R rows into E groups can need, plus the zero
// tiles past the groups' sum
long long row_tiles(int R, int E) {
  return (R + kBM - 1) / kBM + (E < R ? E : R) + 1;
}

bool bad_args(const void* a, const void* b, const void* c, int R, int K, int N, int E) {
  const uintptr_t bases = reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
                          reinterpret_cast<uintptr_t>(c);
  return R < 0 || K <= 0 || N <= 0 || E <= 0 || E > 65535 || K % 4 != 0 || N % 4 != 0 ||
         (bases & 15) != 0 || row_tiles(R, E) > 65535 || (K + kBM - 1) / kBM > 65535;
}

}  // namespace

extern "C" int repro_grouped_f32_fwd(const void* x, const void* w, const void* group_sizes,
                                     void* out, int R, int K, int N, int E, void* stream) {
  if (bad_args(x, w, out, R, K, N, E)) return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((N + kBN - 1) / kBN, static_cast<unsigned>(row_tiles(R, E)));
  grouped_f32_fwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const int*>(group_sizes), static_cast<float*>(out), R, K, N, E);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_grouped_f32_dx(const void* dy, const void* w, const void* group_sizes,
                                    void* dx, int R, int K, int N, int E, void* stream) {
  if (bad_args(dy, w, dx, R, K, N, E)) return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((K + kBN - 1) / kBN, static_cast<unsigned>(row_tiles(R, E)));
  grouped_f32_dx_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dy), static_cast<const float*>(w),
      static_cast<const int*>(group_sizes), static_cast<float*>(dx), R, K, N, E);
  return static_cast<int>(cudaGetLastError());
}

// launched for R == 0 too: every expert's dw is written (zeros)
extern "C" int repro_grouped_f32_dw(const void* x, const void* dy, const void* group_sizes,
                                    void* dw, int R, int K, int N, int E, void* stream) {
  if (bad_args(x, dy, dw, R, K, N, E)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + kBN - 1) / kBN, (K + kBM - 1) / kBM, E);
  grouped_f32_dw_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dy),
      static_cast<const int*>(group_sizes), static_cast<float*>(dw), R, K, N, E);
  return static_cast<int>(cudaGetLastError());
}
