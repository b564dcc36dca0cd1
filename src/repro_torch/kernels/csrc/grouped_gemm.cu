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
// What bounds it on the H100 (qwen2-moe-a2.7b, E 64, K x N 2048 x 1408 or
// 1408 x 2048, 5.8 MB of weights an expert):
//  * decode (4 slots x top-4 = 16 rows over at most 16 experts): bytes, the
//    non-empty experts' weights read once for a row or two each;
//  * prefill with a real routing (8,192 rows, ~136 an expert over 60
//    experts): still bytes, 60 experts' weights (369 MB) at 3.35 TB/s take
//    longer than the 47 GFLOP at the bf16 tensor cores' 989 TFLOP/s;
//  * a skew (8,192 rows on one expert): operations, one expert's weights
//    serve every row.
// So the design reads each expert's weights from device memory about once,
// keeps many of their bytes in flight on every SM, and runs the products on
// the only unit that reaches the tensor cores' rate, wgmma.
//
// Design:
//  * Tensor cores: wgmma m64n128k16 bf16 -> f32, A (x) and B (W) both from
//    shared memory in the 128-byte swizzled layout.  x's tile is K-major; W
//    is [K, N] with N contiguous, so B is MN-major, transposed by the
//    instruction (tnspB, as B3's P V).
//  * Tiles: a tile is up to 192 rows of one expert from its first row (its
//    last tile may be short) by 128 columns.  Three consumer warpgroups of
//    64 rows share the tile's W; a warpgroup without rows of the expert
//    issues no wgmma and loads no x.  192-row tiles put a whole expert of a
//    real routing (~136 rows) in one tile, so its weights are read once per
//    column tile, not twice.  Rows past the groups' sum make zero tiles,
//    written by the consumers without the rings.  Tiles are numbered
//    columns fastest, so an expert's tiles run side by side and its
//    weights come from device memory about once, then from L2.
//  * Asynchronous copies: two producer warps, one thread each, issue TMA
//    loads for 64-element K slices.  W: an 8-stage ring, a stage the slice
//    of the tile's 128 columns as two 64-column boxes (a 3-D map over
//    [E, K, N], so a slice never reaches into the next expert and K past
//    the end is zero-filled).  x: a ring of 11 boxes, one box (64 rows
//    from the warpgroup's first row; a 2-D map over [R, K], rows past R
//    zero-filled, rows of the next expert computed and never stored) for
//    each warpgroup with rows and each slice, so a decode tile with one
//    such warpgroup keeps 11 slices of x in flight and a prefill tile 3.
//    Consumers release a stage or box once its products are done, keeping
//    one group of four wgmma in flight; the consumer warpgroups meet after
//    each slice's waits (consumers_sync), which keeps a warpgroup from
//    waiting on a box two phases on.
//  * Scheduling: a persistent grid, min(SMs, a static bound on the tiles):
//    N / 128 columns by ceil(R / 192) + min(E, R) + 1 row tiles, the most
//    any split of R rows into E groups can need.  CTA i takes tiles i,
//    i + grid, ...; the group sizes are copied to shared memory once, and
//    every warp finds a tile's expert and rows by scanning them 32 at a
//    time (two warp scans and a ballot), so the launch reads nothing on
//    the host and a CUDA graph holds it.  The producers fill the next
//    tile's stages while the consumers store the last one's outputs.
//  * One per-row arithmetic for every row count: every output is one
//    float32 accumulator over K in ascending k16 steps, through the same
//    wgmma shape, whatever R, the row's group, its place in the tile or the
//    other experts' loads: no GeMV path for decode, no split of K.  The
//    tensor cores compute each output from its own row of A, so the rows
//    beside it change nothing.
//  * What is left on the table (PERF.md): a decode tile is bound by the
//    per-slice handshakes of its one live warpgroup, not by its bytes.
//  * K and N must be multiples of 8 (TMA's 16-byte strides), the bases
//    16-byte aligned; the wrapper checks both.

#include "hopper.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 64;                  // rows of a consumer warpgroup
constexpr int kConsumers = 3;            // consumer warpgroups of a CTA
constexpr int kRowTile = kConsumers * kBM;
constexpr int kBN = 128;                 // columns of a tile (wgmma n128)
constexpr int kBK = 64;                  // K slice: 128 bytes of an x row
constexpr int kBox = 64 * 128;           // one TMA box: 64 rows x 128 bytes
constexpr int kXBoxes = 11;              // x ring: >= 2 kConsumers (see consumers_sync)
constexpr int kWStages = 8;              // W ring: a slice's two 64-column boxes a stage
constexpr int kWStage = (kBN / 64) * kBox;
constexpr int kSmemExperts = 1024;       // group sizes kept in shared memory
constexpr int kThreads = kConsumers * 128 + 64;  // + a W and an x producer warp
constexpr int kSmem = kXBoxes * kBox + kWStages * kWStage + 2 * (kXBoxes + kWStages) * 8 +
                      kSmemExperts * 4 + 1024;
constexpr unsigned kAll = 0xffffffffu;

// the warp's view of experts e0 .. e0 + 31 given the rows and row tiles
// before them: lane i holds expert e0 + i's rows [begin, end) and its first
// row tile, its tile count; every lane holds the totals after the chunk.
// Sizes are clamped to [0, rows left], as the plain version clamps them:
// expert e's rows end at min(P, R), P the sum of max(size, 0) up to e.
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
  c.tiles = (c.end - c.begin + kRowTile - 1) / kRowTile;
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

// row tiles of the schedule: each expert's, then the zero tiles of the rows
// past the groups' sum (every lane of the warp calls it)
__device__ int count_row_tiles(const int* gs, int E, int R) {
  int start = 0, t = 0;
  for (int e0 = 0; e0 < E; e0 += 32) {
    const Chunk c = scan_chunk(gs, E, R, e0, start, t);
    start = c.next_start;
    t = c.next_tile;
  }
  return t + (R - start + kRowTile - 1) / kRowTile;
}

struct RowTile {
  int expert;  // -1: rows past the groups' sum
  int row0;    // the tile's first row
  int end;     // the expert's end row (R past the sum)
};

// row tile y of the schedule (every lane of the warp calls it)
__device__ RowTile find_row_tile(const int* gs, int E, int R, int y) {
  int start = 0, t = 0;
  for (int e0 = 0; e0 < E; e0 += 32) {
    const Chunk c = scan_chunk(gs, E, R, e0, start, t);
    const unsigned hit = __ballot_sync(kAll, y >= c.tile && y < c.tile + c.tiles);
    if (hit != 0u) {
      const int src = __ffs(hit) - 1;
      const int tile = __shfl_sync(kAll, c.tile, src);
      const int begin = __shfl_sync(kAll, c.begin, src);
      return {e0 + src, begin + (y - tile) * kRowTile, __shfl_sync(kAll, c.end, src)};
    }
    start = c.next_start;
    t = c.next_tile;
  }
  return {-1, start + (y - t) * kRowTile, R};
}

// The consumer warpgroups take each K slice together.  A warpgroup reads
// only its own x boxes, so without this it could run a box's uses ahead of
// another warpgroup's and wait on a parity two phases on; after it, every
// box of an earlier slice has landed, so a box's previous use is complete
// when a warpgroup waits on the next.  A box is released during the slice
// after its own, so the x ring holds at least two slices' boxes (kXBoxes
// >= 2 kConsumers), or a warpgroup would wait here for a box whose room
// only a partner's later release makes.
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers * 128) : "memory");
}

// a consumer warpgroup's 64 rows x 128 columns of zeros, 16 bytes a store
__device__ __forceinline__ void store_zeros(bf16* __restrict__ out, int row0, int n0, int R,
                                            int N) {
  for (int c = threadIdx.x % 128; c < kBM * kBN / 8; c += 128) {
    const int r = row0 + c / (kBN / 8), n = n0 + (c % (kBN / 8)) * 8;
    if (r < R && n < N) {
      *reinterpret_cast<uint4*>(out + static_cast<long long>(r) * N + n) =
          make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    grouped_gemm_kernel(const __grid_constant__ CUtensorMap tmx,
                        const __grid_constant__ CUtensorMap tmw,
                        const int* __restrict__ group_sizes, bf16* __restrict__ out, int R,
                        int K, int N, int E) {
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1,024 bytes: boxes start on that grid
  uint8_t* xring = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* wring = xring + kXBoxes * kBox;
  uint64_t* xfull = reinterpret_cast<uint64_t*>(wring + kWStages * kWStage);
  uint64_t* xempty = xfull + kXBoxes;
  uint64_t* wfull = xempty + kXBoxes;
  uint64_t* wempty = wfull + kWStages;
  int* sgs = reinterpret_cast<int*>(wempty + kWStages);
  // warpgroups 0 .. kConsumers - 1 consume; warpgroup kConsumers holds the
  // two producer warps.  Read from lane 0, so the compiler sees that it is
  // the same in a warp and keeps the wgmma unserialized
  const int wg = __shfl_sync(kAll, threadIdx.x / 128, 0);
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int b = 0; b < kXBoxes; ++b) {
      hopper::mbar_init(&xfull[b], 1);
      hopper::mbar_init(&xempty[b], 4);  // the warps of the warpgroup that reads it
    }
    for (int s = 0; s < kWStages; ++s) {
      hopper::mbar_init(&wfull[s], 1);
      hopper::mbar_init(&wempty[s], kConsumers * 4);  // one arrival per consumer warp
    }
    hopper::fence_barrier_init();
  }
  // the group sizes, read once by the whole CTA (walked from device memory
  // where there are more experts than shared memory keeps)
  const int* gs = group_sizes;
  if (E <= kSmemExperts) {
    for (int e = threadIdx.x; e < E; e += kThreads) sgs[e] = group_sizes[e];
    gs = sgs;
  }
  __syncthreads();

  const int col_tiles = (N + kBN - 1) / kBN;
  const int nk = (K + kBK - 1) / kBK;
  const int tiles = count_row_tiles(gs, E, R) * col_tiles;
  uint32_t it = 0;  // K slices this CTA has put through the W ring
  uint32_t xb = 0;  // x boxes it has put through the x ring
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const RowTile rt = find_row_tile(gs, E, R, tile / col_tiles);
    const int n0 = (tile % col_tiles) * kBN;
    if (rt.expert < 0) {
      if (wg < kConsumers) store_zeros(out, rt.row0 + wg * kBM, n0, R, N);
      continue;
    }
    // warpgroups with rows of the expert (the same in every lane)
    const int live = min(kConsumers, (rt.end - rt.row0 + kBM - 1) / kBM);

    if (wg == kConsumers) {  // producers: W (warp 0), x (warp 1), one lane each
      if (lane == 0 && warp == 0) {
        const int wboxes = N - n0 > 64 ? 2 : 1;
        for (int kt = 0; kt < nk; ++kt) {
          const uint32_t j = it + kt;
          const int s = j % kWStages;
          hopper::mbar_wait(&wempty[s], ((j / kWStages) & 1) ^ 1);
          hopper::mbar_expect_tx(&wfull[s], wboxes * kBox);
          for (int c = 0; c < wboxes; ++c) {
            hopper::tma_load_3d(wring + s * kWStage + c * kBox, &tmw, &wfull[s], n0 + c * 64,
                                kt * kBK, rt.expert);
          }
        }
      } else if (lane == 0 && warp == 1) {
        for (int kt = 0; kt < nk; ++kt) {
          for (int w = 0; w < live; ++w) {
            const uint32_t g = xb + kt * live + w;
            const int b = g % kXBoxes;
            hopper::mbar_wait(&xempty[b], ((g / kXBoxes) & 1) ^ 1);
            hopper::mbar_expect_tx(&xfull[b], kBox);
            hopper::tma_load_2d(xring + b * kBox, &tmx, &xfull[b], kt * kBK, rt.row0 + w * kBM);
          }
        }
      }
      __syncwarp();
    } else if (wg >= live) {  // no rows: keep the W ring's count and the step only
      for (int kt = 0; kt < nk; ++kt) {
        const uint32_t j = it + kt;
        hopper::mbar_wait(&wfull[j % kWStages], (j / kWStages) & 1);
        consumers_sync();
        if (lane == 0) hopper::mbar_arrive(&wempty[j % kWStages]);
      }
    } else {
      float acc[kBN / 2];
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;
      for (int kt = 0; kt < nk; ++kt) {
        const uint32_t j = it + kt;
        const uint32_t g = xb + kt * live + wg;  // this warpgroup's x box
        hopper::mbar_wait(&wfull[j % kWStages], (j / kWStages) & 1);
        hopper::mbar_wait(&xfull[g % kXBoxes], (g / kXBoxes) & 1);
        consumers_sync();
        const uint32_t xa = hopper::smem_u32(xring + (g % kXBoxes) * kBox);
        const uint32_t wa = hopper::smem_u32(wring + (j % kWStages) * kWStage);
        hopper::fence_regs(acc);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          // x: 16 columns (32 bytes) of each 128-byte row; W: 16 K rows of
          // 128 bytes, the two 64-column boxes kBox apart
          hopper::wgmma_m64n128k16_bf16_ss_tnspb(
              acc, hopper::desc_sw128(xa + kk * 32, 16, 1024),
              hopper::desc_sw128(wa + kk * 16 * 128, kBox, 1024), 1);
        }
        hopper::wgmma_commit();
        hopper::fence_regs(acc);
        if (kt > 0) {  // the previous slice's products are done: hand it back
          hopper::wgmma_wait<1>();
          hopper::fence_regs(acc);
          if (lane == 0) {
            hopper::mbar_arrive(&wempty[(j - 1) % kWStages]);
            hopper::mbar_arrive(&xempty[(g - live) % kXBoxes]);
          }
        }
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      if (lane == 0) {
        hopper::mbar_arrive(&wempty[(it + nk - 1) % kWStages]);
        hopper::mbar_arrive(&xempty[(xb + (nk - 1) * live + wg) % kXBoxes]);
      }

      // round once to bf16, store the expert's rows only
      const int r = rt.row0 + wg * kBM + warp * 16 + lane / 4;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * (lane % 4);
        if (col >= N) continue;  // N % 8 == 0: both columns or neither
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = r + 8 * h;
          if (row < rt.end) {
            *reinterpret_cast<__nv_bfloat162*>(out + static_cast<long long>(row) * N + col) =
                __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
          }
        }
      }
    }
    it += nk;
    xb += nk * live;
  }
}

// the row tiles any split of R rows into E groups can need, plus the zero
// tiles past the groups' sum
long long row_tiles(int R, int E) {
  return (R + kRowTile - 1) / kRowTile + (E < R ? E : R) + 1;
}

constexpr int kMaxDevices = 64;

// per device, once: the SM count and the shared-memory opt-in (kept off
// the launch path, so a graph capture sees only the launch)
int device_sms(int* sms) {
  static int cached[kMaxDevices] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < kMaxDevices && cached[dev] > 0) {
    *sms = cached[dev];
    return 0;
  }
  err = cudaFuncSetAttribute(grouped_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < kMaxDevices) cached[dev] = *sms;
  return 0;
}

}  // namespace

// returns hopper::kTensorMapError + the CUresult if a tensor map cannot be
// encoded
extern "C" int repro_grouped_gemm(const void* x, const void* w, const void* group_sizes,
                                  void* out, int R, int K, int N, int E, void* stream) {
  if (R < 0 || K <= 0 || N <= 0 || E <= 0 || K % 8 != 0 || N % 8 != 0 ||
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (R == 0) return static_cast<int>(cudaSuccess);
  int sms = 0;
  int st = device_sms(&sms);
  if (st != 0) return st;
  CUtensorMap tmx, tmw;
  const cuuint64_t dx[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(R)};
  const cuuint64_t sx[1] = {static_cast<cuuint64_t>(K) * 2};
  const cuuint32_t bx[2] = {kBK, kBM};
  const cuuint64_t dw[3] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(K),
                            static_cast<cuuint64_t>(E)};
  const cuuint64_t sw[2] = {static_cast<cuuint64_t>(N) * 2,
                            static_cast<cuuint64_t>(K) * N * 2};
  const cuuint32_t bw[3] = {64, kBK, 1};
  st = hopper::encode_tensor_map(&tmx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, dx, sx, bx);
  if (st != 0) return st;
  st = hopper::encode_tensor_map(&tmw, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, w, dw, sw, bw);
  if (st != 0) return st;
  const long long tiles = (N + kBN - 1) / kBN * row_tiles(R, E);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  grouped_gemm_kernel<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      tmx, tmw, static_cast<const int*>(group_sizes), static_cast<bf16*>(out), R, K, N, E);
  return static_cast<int>(cudaGetLastError());
}
