// W4A16 product for the port's W4A16 linears (zamba2-7b's shared attention
// block and the lm_head under --quant w4a16):
//   out f32 [M, N] = x [M, K] . dequant(wp uint8 [N, K/2], scale f32 [N, NG])^T
// x bf16 or float32; byte j of row n packs columns 2j (low nibble) and 2j+1
// (high nibble), each stored plus 8, and column k dequantizes as
// (nibble - 8) * scale[n, k / G], G = min(128, K), NG = ceil(K / G).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/w4a16_gemv/w4a16_gemv.py::w4a16_gemm
// (nibbles unpacked and dequantized in VMEM per 256x2048 tile, then an f32
// product on the MXU).  Both operands here are K-contiguous: W4A16 weights
// are stored [out, in/2] (quant/convert.py), activations [tokens, in].
//
// What bounds it on the H100.  At decode (M = live slots <= 8) each packed
// byte is read once and used 2 M times: device memory bytes (N K / 2 plus
// the scales at 3.35 TB/s).  At prefill (M = 2048 tokens a group) the
// 2 M N K operations on the bf16 tensor cores (989 TFLOP/s; 0.21 ms at
// zamba2-7b's 3584 x 14336).  The CUDA cores reach neither: unpacking,
// converting and scaling a nibble, then M FMAs on it, is ~16 float32
// lane-ops a packed byte at M 4, more than the card's ~33 T lane-ops/s can
// issue at 3.35 TB/s, and a zamba2-7b prefill group's 10.9 TFLOP of W4A16
// products would take 163 ms at the float32 peak.  So every kernel here
// runs its products on the bf16 tensor cores (mma.sync m16n8k16 or wgmma
// m64n128k16) with float32 accumulation:
//  * nibbles -> bf16 in registers, exactly, ~1.6 ops a nibble
//    (dequant8): byte j of a packed word and byte j of the word >> 4 go to
//    the low bytes of the two bf16 halves (prmt), are masked to 4 bits and
//    ORed with 0x4300 (lop3: bf16 128 + n exactly), and one bf16x2
//    subtraction of 136 leaves n - 8.  A product of a bf16 value and a
//    4-bit integer is exact in float32.
//  * the scale never rounds into the weight: each group's partial (the
//    products of its <= 128 columns, summed by the mma in float32) is
//    folded into a float32 total as fmaf(partial, scale[n, g], total), in
//    group order.
//  * x in its own dtype: bf16 x is one bf16 term; float32 x is split into
//    three bf16 terms (each the top 8 significant bits of what the earlier
//    ones leave, which hold a float32 exactly: split3), and a group's
//    partial sums the products of all three (3x the mma).
//
// Design.
//  * w4a16_gemv_mma_kernel (M <= 8): a weight-streaming GeMV with the
//    weights as the mma's A ("swap AB": 16 weight rows are the product's M)
//    and the x rows, zero past M, as its B.  A CTA of 16 warps owns 16
//    weight rows; its warps take the groups of 128 columns in turn (group
//    i to warp i % 16: split K inside the CTA, so a short N such as 3584,
//    224 CTAs, still keeps every SM streaming).  Per group, lane (g, q)
//    loads the 16 packed bytes of columns [32q, 32q + 32) of rows g and
//    g + 8 (ld.global.nc, not kept in L1) and the 32 x values of token g at
//    the same columns (from L1 / L2: x is small and read by every CTA), and
//    issues 8 mma: word t of its bytes is the A operand of steps 2t and
//    2t + 1, and the mma's k slots 2q, 2q + 1, 8 + 2q, 9 + 2q hold 4
//    consecutive columns of the lane's own 32, in A and in B alike.  So both
//    operands are contiguous 16-byte loads and x needs no permutation; x's
//    registers serve both weight rows.  One group in flight a warp keeps
//    the registers near 60, so two CTAs of 16 warps share an SM.  The 16 warps' totals
//    are summed through shared memory in warp order.
//  * w4a16_gemm_wgmma_kernel (M > 8, bf16 x, 16-byte loads: every model
//    shape): 128x128 output tiles, K tiles of 64 columns (half a group),
//    warp-specialized as B2's int8_gemm_tc_kernel.  A producer warpgroup
//    copies each K tile into a ring of five slots with cp.async (x's rows,
//    128-byte swizzled; the packed weights; a group's scales with its first
//    tile) and, two tiles later, dequantizes the weights into a bf16 tile of
//    the same slot (once per CTA) and signals it full on an mbarrier.  Two
//    consumer warpgroups multiply 64 rows each by wgmma m64n128k16 from
//    shared memory, hand the slot back when its wgmma are done, and fold a
//    group's products into their totals after the group's last tile.
//    wgmma rather than mma.sync: on the card the mma.sync tile below is
//    slower at every prefill shape.  What holds this one below its bound
//    is, by the count, the L2 -> SM traffic of a 128x128 tile (x's rows are
//    read again by every column tile: ~100 operations a byte).
//  * w4a16_gemm_mma_kernel (M > 8, float32 x, or a K or base off the
//    16-byte grid: on no model's path): the same K tiles and ring, copied
//    and dequantized by every thread (float32 x split into three bf16 term
//    tiles), 8 warps of 64x32 on mma.sync, one __syncthreads a tile.
//    Its tiles are rows of 64 bf16 with 16-byte chunks XOR-swizzled by row
//    (swz), the layout wgmma's 128-byte swizzle reads, so ldmatrix reads them
//    without bank conflicts.
//  * Ragged M, N and K are masked everywhere (zeros past K in x and in the
//    weights).  A 16-byte vector path needs K % 32 == 0 and aligned bases
//    (every model shape); otherwise the GeMV and the mma.sync GEMM load byte
//    by byte.
//
// Batch invariance: a row's bits do not depend on M within 1..8 (each mma
// column is its own dot product, and the work split depends on N and K
// only).  The GeMV and the tiled variants give different bits for the same
// row: their mma sum other columns together and the GeMV splits K across
// warps; all are held to the plain version's float32 tolerance.

#include "hopper.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>


namespace {

constexpr int kMaxDevices = 16;

// four packed bytes -> four bf16x2 words, word j = (lo(byte j) - 8,
// hi(byte j) - 8): columns 2j and 2j + 1 of the word's 8, exactly
__device__ __forceinline__ void dequant8(uint32_t w, uint32_t (&out)[4]) {
  const uint32_t sh = w >> 4;
  const __nv_bfloat162 k136 = __floats2bfloat162_rn(136.f, 136.f);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    // byte j of w to bytes 0 and 1, byte j of w >> 4 to bytes 2 and 3
    const uint32_t t = __byte_perm(w, sh, j * 0x0011 + (4 + j) * 0x1100);
    const uint32_t v = (t & 0x000F000Fu) | 0x43004300u;  // bf16 128 + n, twice
    const __nv_bfloat162 d = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v), k136);
    out[j] = *reinterpret_cast<const uint32_t*>(&d);
  }
}

// two floats (columns c, c + 1) -> three bf16x2 words whose sum is exact:
// each term is the high half of what the earlier terms leave
__device__ __forceinline__ void split3(float f0, float f1, uint32_t (&t)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const uint32_t b0 = __float_as_uint(f0);
    const uint32_t b1 = __float_as_uint(f1);
    t[i] = __byte_perm(b0, b1, 0x7632);
    f0 -= __uint_as_float(b0 & 0xFFFF0000u);
    f1 -= __uint_as_float(b1 & 0xFFFF0000u);
  }
}

// c[16 x 8] += a[16 x 16] . b[16 x 8], bf16 in, f32 out (mma.sync fragments,
// g = lane / 4, q = lane % 4: a0 row g, a1 row g + 8, k 2q + {0, 1}; a2 / a3
// the same rows, k 8 + 2q + {0, 1}; b0 k 2q + {0, 1}, b1 k 8 + 2q + {0, 1},
// column g; c0 / c1 row g, c2 / c3 row g + 8, columns 2q + {0, 1})
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// 16 bytes of a weight row, kept out of L1 (each byte is used once)
__device__ __forceinline__ uint4 ldg_stream(const void* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

// the 16 packed bytes of columns [k0, k0 + 32) of a weight row; zero bytes
// past K or where !ok (VEC: the chunk is whole and 16-byte aligned)
template <bool VEC>
__device__ __forceinline__ uint4 load_w16(const uint8_t* row, int k0, int K, bool ok) {
  if constexpr (VEC) return ok ? ldg_stream(row + k0 / 2) : make_uint4(0, 0, 0, 0);
  uint32_t v[4] = {0, 0, 0, 0};
  if (ok) {
#pragma unroll
    for (int b = 0; b < 16; ++b) {
      if (k0 + 2 * b < K) v[b / 4] |= static_cast<uint32_t>(__ldg(row + k0 / 2 + b)) << (8 * (b % 4));
    }
  }
  return make_uint4(v[0], v[1], v[2], v[3]);
}

// the 16 bytes of x at column kc of one row (4 float32 or 8 bf16 values),
// loaded element by element, zero past K or where !ok
template <bool F32X>
__device__ __forceinline__ uint4 load_chunk_x(const void* row, int kc, int K, bool ok) {
  uint32_t v[4];
  if constexpr (F32X) {
    const float* r = static_cast<const float*>(row);
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = (ok && kc + e < K) ? __float_as_uint(__ldg(r + kc + e)) : 0u;
  } else {
    const unsigned short* r = static_cast<const unsigned short*>(row);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t lo = (ok && kc + 2 * e < K) ? __ldg(r + kc + 2 * e) : 0u;
      const uint32_t hi = (ok && kc + 2 * e + 1 < K) ? __ldg(r + kc + 2 * e + 1) : 0u;
      v[e] = lo | (hi << 16);
    }
  }
  return make_uint4(v[0], v[1], v[2], v[3]);
}

// the x values of columns [k0, k0 + 32) of one row (a GeMV lane's share of
// a group), zero past K or where !ok: bf16 as bf16x2 words, float32 as
// float bits (VEC: 16-byte loads, the chunk whole and aligned)
template <bool F32X, bool VEC>
__device__ __forceinline__ void load_x32(const void* row, int k0, int K, bool ok,
                                         uint32_t (&xw)[F32X ? 32 : 16]) {
  constexpr int kCols = F32X ? 4 : 8;  // columns of a 16-byte chunk
#pragma unroll
  for (int i = 0; i < 32 / kCols; ++i) {
    uint4 v;
    if constexpr (VEC) {
      const uint4* p = reinterpret_cast<const uint4*>(
          static_cast<const char*>(row) + static_cast<size_t>(k0 + kCols * i) * (F32X ? 4 : 2));
      v = ok ? __ldg(p) : make_uint4(0, 0, 0, 0);
    } else {
      v = load_chunk_x<F32X>(row, k0 + kCols * i, K, ok);
    }
    xw[4 * i] = v.x;
    xw[4 * i + 1] = v.y;
    xw[4 * i + 2] = v.z;
    xw[4 * i + 3] = v.w;
  }
}

__device__ __forceinline__ void st_shared16(void* p, uint4 v) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(s), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}

__device__ __forceinline__ uint4 ld_shared16(const void* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(s)
               : "memory");
  return v;
}

// 16 bytes global -> shared, asynchronous; zeros where !ok
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}
// 4 bytes global -> shared, asynchronous; zeros where !ok
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ------------------------------------------------------------------ GeMV

constexpr int kGvWarps = 16;  // warps per CTA, taking the groups in turn
constexpr int kGvRows = 16;   // weight rows (output columns) per CTA: the mma's M

// one mma step of the GeMV: B is x at the lane's columns c .. c + 3
template <bool F32X, int NW>
__device__ __forceinline__ void gemv_step(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                          uint32_t a3, const uint32_t (&xw)[NW], int col) {
  if constexpr (F32X) {
    uint32_t lo[3], hi[3];
    split3(__uint_as_float(xw[col]), __uint_as_float(xw[col + 1]), lo);
    split3(__uint_as_float(xw[col + 2]), __uint_as_float(xw[col + 3]), hi);
#pragma unroll
    for (int t = 0; t < 3; ++t) mma_bf16(c, a0, a1, a2, a3, lo[t], hi[t]);
  } else {
    mma_bf16(c, a0, a1, a2, a3, xw[col / 2], xw[col / 2 + 1]);
  }
}

template <bool F32X, bool VEC>
__global__ void __launch_bounds__(kGvWarps * 32)
w4a16_gemv_mma_kernel(const void* __restrict__ x, const uint8_t* __restrict__ wp,
                      const float* __restrict__ scale, float* __restrict__ out, int M, int N,
                      int K, int G, int NG) {
  constexpr int kXW = F32X ? 32 : 16;  // 32-bit words of x a lane holds per group
  __shared__ float red[kGvWarps][32][4];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // weight rows g and g + 8 of the tile; token g
  const int q = lane % 4;  // columns [32q, 32q + 32) of each group
  const int n0 = blockIdx.x * kGvRows;
  const bool row0 = n0 + g < N, row1 = n0 + g + 8 < N, xrow = g < M;
  const size_t KB = K / 2;
  const uint8_t* w0 = wp + static_cast<size_t>(row0 ? n0 + g : 0) * KB;
  const uint8_t* w1 = wp + static_cast<size_t>(row1 ? n0 + g + 8 : 0) * KB;
  const float* s0 = scale + static_cast<size_t>(row0 ? n0 + g : 0) * NG;
  const float* s1 = scale + static_cast<size_t>(row1 ? n0 + g + 8 : 0) * NG;
  const void* xr = static_cast<const char*>(x) +
                   static_cast<size_t>(xrow ? g : 0) * K * (F32X ? 4 : 2);
  float total[4] = {0.f, 0.f, 0.f, 0.f};
  for (int gi = warp; gi < NG; gi += kGvWarps) {
    const int k0 = gi * G + 32 * q;  // G = min(128, K): the lane's chunk ends by the group's end
    const bool in = k0 < K;
    const uint4 wa = load_w16<VEC>(w0, k0, K, in && row0);
    const uint4 wb = load_w16<VEC>(w1, k0, K, in && row1);
    uint32_t xw[kXW];
    load_x32<F32X, VEC>(xr, k0, K, in && xrow, xw);
    const float sa = row0 ? __ldg(s0 + gi) : 0.f;
    const float sb = row1 ? __ldg(s1 + gi) : 0.f;
    float c[4] = {0.f, 0.f, 0.f, 0.f};
    const uint32_t ww0[4] = {wa.x, wa.y, wa.z, wa.w};
    const uint32_t ww1[4] = {wb.x, wb.y, wb.z, wb.w};
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      uint32_t r0[4], r1[4];  // rows g and g + 8, columns 8t .. 8t + 7
      dequant8(ww0[t], r0);
      dequant8(ww1[t], r1);
      gemv_step<F32X>(c, r0[0], r1[0], r0[1], r1[1], xw, 8 * t);
      gemv_step<F32X>(c, r0[2], r1[2], r0[3], r1[3], xw, 8 * t + 4);
    }
    total[0] = fmaf(c[0], sa, total[0]);
    total[1] = fmaf(c[1], sa, total[1]);
    total[2] = fmaf(c[2], sb, total[2]);
    total[3] = fmaf(c[3], sb, total[3]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) red[warp][lane][i] = total[i];
  __syncthreads();
  if (warp == 0) {
    float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int v = 0; v < kGvWarps; ++v) {
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

// ------------------------------------------------------- mma.sync GEMM

constexpr int kBM = 128;  // output rows (tokens) a CTA
constexpr int kBN = 128;  // output columns (weight rows) a CTA
constexpr int kBK = 64;   // columns of K a stage: half a group
constexpr int kGmThreads = 256;
constexpr int kTileElems = kBM * kBK;  // one bf16 tile of x (or of W: kBN == kBM)

// element offset of (row r, 16-byte chunk c) in a [rows][kBK] bf16 tile:
// chunk c of row r is stored at chunk c ^ (r % 8), so the 8 rows one
// ldmatrix matrix reads at one chunk fall in 8 distinct bank groups
__device__ __forceinline__ int swz(int r, int c) { return r * kBK + ((c ^ (r & 7)) << 3); }

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s)
               : "memory");
}

// shared memory of the GEMM: a ring of two raw K tiles (x as it comes,
// [128][64] bf16 swizzled or float32 row-major, and the packed weights,
// [128][32] bytes), then two bf16 weight tiles (dequantized) and, for
// float32 x, two sets of three bf16 term tiles
template <bool F32X>
struct GemmSmem {
  static constexpr int kStages = 2;
  static constexpr int kX = kBM * kBK * (F32X ? 4 : 2);
  static constexpr int kW = kBN * kBK / 2;
  static constexpr int kSlot = kX + kW;
  static constexpr int kWbf = kStages * kSlot;           // offset of the bf16 W tiles
  static constexpr int kXbf = kWbf + 2 * kTileElems * 2;  // offset of the x term tiles
  static constexpr int kBytes = kXbf + (F32X ? 2 * 3 * kTileElems * 2 : 0);
};

template <bool F32X, bool VEC>
__global__ void __launch_bounds__(kGmThreads, 1)
w4a16_gemm_mma_kernel(const void* __restrict__ x, const uint8_t* __restrict__ wp,
                      const float* __restrict__ scale, float* __restrict__ out, int M, int N,
                      int K, int G, int NG) {
  using L = GemmSmem<F32X>;
  constexpr int S = L::kStages;
  constexpr int kTerms = F32X ? 3 : 1;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, q = lane % 4;
  const int wm = warp / 4;  // rows [64 wm, 64 wm + 64) of the tile
  const int wn = warp % 4;  // columns [32 wn, 32 wn + 32)
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const size_t KB = K / 2;
  const int T = (K + kBK - 1) / kBK;
  const int wr = tid / 2, wh = tid % 2;  // weight row and 32-column half this thread copies

  // the copies of K tile t into ring slot t % S (16-byte cp.async, zeros
  // outside the matrices; byte-wise loads and plain stores without VEC);
  // always one commit group, empty past the last tile
  auto issue = [&](int t) {
    if (t < T) {
      unsigned char* slot = smem_raw + (t % S) * L::kSlot;
      const int k0 = t * kBK;
#pragma unroll
      for (int i = 0; i < (F32X ? 8 : 4); ++i) {
        // bf16: 8-column chunk xc of row r, stored swizzled; float32: 4-column
        // chunk of row r, stored row-major
        const int r = F32X ? tid / 16 + 16 * i : tid / 8 + 32 * i;
        const int c = F32X ? tid % 16 : tid % 8;
        const int kc = k0 + (F32X ? 4 : 8) * c;
        const bool ok = m0 + r < M && kc < K;
        const char* xrow = static_cast<const char*>(x) +
                           static_cast<size_t>(ok ? m0 + r : 0) * K * (F32X ? 4 : 2);
        unsigned char* dst = slot + (F32X ? (r * kBK + 4 * c) * 4 : swz(r, c) * 2);
        if constexpr (VEC) {
          cp_async16(dst, xrow + (ok ? kc : 0) * (F32X ? 4 : 2), ok);
        } else {
          st_shared16(dst, load_chunk_x<F32X>(xrow, kc, K, ok));
        }
      }
      const int kw = k0 + 32 * wh;
      const bool ok = n0 + wr < N && kw < K;
      const uint8_t* wrow = wp + static_cast<size_t>(ok ? n0 + wr : 0) * KB;
      unsigned char* dst = slot + L::kX + wr * 32 + wh * 16;
      if constexpr (VEC) {
        cp_async16(dst, wrow + (ok ? kw / 2 : 0), ok);
      } else {
        st_shared16(dst, load_w16<false>(wrow, kw, K, ok));
      }
    }
    cp_async_commit();
  };
  // K tile t's packed weights (and float32 x) from its ring slot to bf16
  // tiles: the weight bytes a thread converts are those it copied itself;
  // float32 x is read after a barrier (other threads copied it)
  auto convert = [&](int t) {
    const unsigned char* slot = smem_raw + (t % S) * L::kSlot;
    __nv_bfloat16* wbf = reinterpret_cast<__nv_bfloat16*>(smem_raw + L::kWbf) + (t & 1) * kTileElems;
    const uint4 nib = ld_shared16(slot + L::kX + wr * 32 + wh * 16);
    const uint32_t wv[4] = {nib.x, nib.y, nib.z, nib.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t d[4];
      dequant8(wv[j], d);
      st_shared16(wbf + swz(wr, 4 * wh + j), make_uint4(d[0], d[1], d[2], d[3]));
    }
    if constexpr (F32X) {
      __nv_bfloat16* xbf =
          reinterpret_cast<__nv_bfloat16*>(smem_raw + L::kXbf) + (t & 1) * 3 * kTileElems;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // 8 columns of row r (chunk xc of the bf16 tiles) as three terms
        const int r = tid / 8 + 32 * i, xc = tid % 8;
        const float* src = reinterpret_cast<const float*>(slot) + r * kBK + 8 * xc;
        const uint4 a = ld_shared16(src), b = ld_shared16(src + 4);
        const float f[8] = {__uint_as_float(a.x), __uint_as_float(a.y), __uint_as_float(a.z),
                            __uint_as_float(a.w), __uint_as_float(b.x), __uint_as_float(b.y),
                            __uint_as_float(b.z), __uint_as_float(b.w)};
        uint32_t tm[4][3];
#pragma unroll
        for (int p = 0; p < 4; ++p) split3(f[2 * p], f[2 * p + 1], tm[p]);
#pragma unroll
        for (int tt = 0; tt < 3; ++tt) {
          st_shared16(xbf + tt * kTileElems + swz(r, xc),
                      make_uint4(tm[0][tt], tm[1][tt], tm[2][tt], tm[3][tt]));
        }
      }
    }
  };

  float part[4][4][4], total[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[mt][nt][e] = total[mt][nt][e] = 0.f;

  const int mi = lane / 8, li = lane % 8;  // ldmatrix: matrix and row this lane addresses
#pragma unroll
  for (int t = 0; t < S - 1; ++t) issue(t);
  cp_async_wait<S - 2>();
  if constexpr (F32X) __syncthreads();  // x chunks copied by other threads
  convert(0);
  for (int t = 0; t < T; ++t) {
    // tile t's bf16 tiles are written; every warp is done with tile t - 1,
    // so its ring slot and bf16 buffers may be written again
    __syncthreads();
    issue(t + S - 1);
    // a group's last tile folds its partials with the group's scales
    const bool fold = t + 1 == T || ((t + 1) * kBK) % G == 0;
    float sc[4][2];
    if (fold) {
      const int grp = t * kBK / G;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + 32 * wn + 8 * nt + 2 * q + e;
          sc[nt][e] = n < N ? __ldg(scale + static_cast<size_t>(n) * NG + grp) : 0.f;
        }
    }
    const __nv_bfloat16* xt =
        F32X ? reinterpret_cast<const __nv_bfloat16*>(smem_raw + L::kXbf) + (t & 1) * 3 * kTileElems
             : reinterpret_cast<const __nv_bfloat16*>(smem_raw + (t % S) * L::kSlot);
    const __nv_bfloat16* wt = reinterpret_cast<const __nv_bfloat16*>(smem_raw + L::kWbf) + (t & 1) * kTileElems;
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      uint32_t bf[2][4];  // n8 tiles 2p, 2p + 1: (b0, b1) each
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        ldmatrix_x4(bf[p], wt + swz(32 * wn + 16 * p + 8 * (mi >> 1) + li, 2 * ks + (mi & 1)));
      }
#pragma unroll
      for (int tt = 0; tt < kTerms; ++tt) {
        uint32_t af[4][4];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          ldmatrix_x4(af[mt], xt + tt * kTileElems +
                                  swz(64 * wm + 16 * mt + 8 * (mi & 1) + li, 2 * ks + (mi >> 1)));
        }
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            mma_bf16(part[mt][nt], af[mt][0], af[mt][1], af[mt][2], af[mt][3],
                     bf[nt / 2][2 * (nt % 2)], bf[nt / 2][2 * (nt % 2) + 1]);
      }
    }
    if (fold) {
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            total[mt][nt][e] = fmaf(part[mt][nt][e], sc[nt][e & 1], total[mt][nt][e]);
            part[mt][nt][e] = 0.f;
          }
    }
    if (t + 1 < T) {
      cp_async_wait<S - 2>();  // this thread's copies of tile t + 1 have landed
      if constexpr (F32X) __syncthreads();
      convert(t + 1);
    }
  }
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + 64 * wm + 16 * mt + g + 8 * h;
        const int n = n0 + 32 * wn + 8 * nt + 2 * q;
        if (m >= M) continue;
        float* o = out + static_cast<size_t>(m) * N + n;
        if (n + 1 < N && N % 2 == 0) {
          *reinterpret_cast<float2*>(o) = make_float2(total[mt][nt][2 * h], total[mt][nt][2 * h + 1]);
        } else {
          if (n < N) o[0] = total[mt][nt][2 * h];
          if (n + 1 < N) o[1] = total[mt][nt][2 * h + 1];
        }
      }
}

// ------------------------------------------------------------ wgmma GEMM

// bf16 x with 16-byte loads (every model shape).  Warp-specialized, as B2's
// int8_gemm_tc_kernel: warpgroup 2 produces, warpgroups 0 and 1 consume.
// The producer copies K tile t (x's 128 rows, the packed weights of the
// tile's 128 output columns and, on a group's first tile, the group's
// scales) into ring slot t % kWsStages with cp.async, and two tiles later,
// when those bytes have landed, dequantizes the weights to a bf16 tile in
// the same slot and signals it full.  Each consumer warpgroup multiplies
// its 64 rows by wgmma m64n128k16, both operands read from shared memory in
// the 128-byte swizzled layout swz() writes, hands the slot back once the
// wgmma that read it are done, and after a group's last tile waits for its
// products and folds them into the totals with the group's scales (the
// group's first wgmma starts from zero).  Nothing reads an accumulator
// while a wgmma is in flight, so the wgmma of a group stay pipelined.
constexpr int kWsStages = 5;
constexpr int kWsLag = 2;  // tiles between a tile's copies and its dequantization
constexpr int kWsThreads = 3 * 128;
constexpr int kWsX = kTileElems * 2;         // x tile, bf16
constexpr int kWsW = kBN * kBK * 2;          // weight tile, bf16
constexpr int kWsNib = kBN * kBK / 2;        // packed weights
constexpr int kWsSlot = kWsX + kWsW + kWsNib;
constexpr int kWsScales = kWsStages * kWsSlot;           // scales of 4 groups
constexpr int kWsBars = kWsScales + 4 * kBN * 4;         // full[], empty[]
constexpr int kWsBytes = kWsBars + 2 * kWsStages * 8 + 1024;  // + room to align to 1,024

__global__ void __launch_bounds__(kWsThreads, 1)
w4a16_gemm_wgmma_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ wp,
                        const float* __restrict__ scale, float* __restrict__ out, int M, int N,
                        int K, int G, int NG) {
  constexpr int S = kWsStages;
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1,024 bytes: tiles start on that grid
  uint8_t* smem = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  float* sbuf = reinterpret_cast<float*>(smem + kWsScales);  // [group % 4][kBN]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kWsBars);
  uint64_t* empty = full + S;
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int T = (K + kBK - 1) / kBK;
  if (tid == 0) {
    for (int i = 0; i < S; ++i) {
      hopper::mbar_init(&full[i], 128);  // every producer thread
      hopper::mbar_init(&empty[i], 8);   // one arrival per consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {  // producer
    const int p = tid - 256;
    const size_t KB = K / 2;
    for (int t = 0; t < T + kWsLag; ++t) {
      if (t < T) {  // copy tile t
        const int s = t % S;
        uint8_t* slot = smem + s * kWsSlot;
        hopper::mbar_wait(&empty[s], ((t / S) & 1) ^ 1);
        const int k0 = t * kBK;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int r = p / 8 + 16 * i, c = p % 8;
          const int kc = k0 + 8 * c;
          const bool ok = m0 + r < M && kc < K;
          cp_async16(slot + swz(r, c) * 2,
                     x + static_cast<size_t>(ok ? m0 + r : 0) * K + (ok ? kc : 0), ok);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int kw = k0 + 32 * h;
          const bool ok = n0 + p < N && kw < K;
          cp_async16(slot + kWsX + kWsW + p * 32 + h * 16,
                     wp + static_cast<size_t>(ok ? n0 + p : 0) * KB + (ok ? kw / 2 : 0), ok);
        }
        if (k0 % G == 0) {
          const int grp = k0 / G, n = n0 + p;
          cp_async4(sbuf + (grp % 4) * kBN + p,
                    scale + static_cast<size_t>(n < N ? n : 0) * NG + grp, n < N);
        }
      }
      cp_async_commit();
      if (t >= kWsLag) {  // tile u's bytes have landed: dequantize, then full
        const int u = t - kWsLag, s = u % S;
        uint8_t* slot = smem + s * kWsSlot;
        cp_async_wait<kWsLag>();
        __nv_bfloat16* wbf = reinterpret_cast<__nv_bfloat16*>(slot + kWsX);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint4 nib = ld_shared16(slot + kWsX + kWsW + p * 32 + h * 16);
          const uint32_t wv[4] = {nib.x, nib.y, nib.z, nib.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            uint32_t d[4];
            dequant8(wv[j], d);
            st_shared16(wbf + swz(p, 4 * h + j), make_uint4(d[0], d[1], d[2], d[3]));
          }
        }
        hopper::fence_proxy_async();  // this thread's copies and stores, for wgmma
        hopper::mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // consumers
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, q = lane % 4;
  float acc[64], total[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = total[i] = 0.f;
  for (int t = 0; t < T; ++t) {
    const int s = t % S;
    hopper::mbar_wait(&full[s], (t / S) & 1);
    const uint32_t xa = hopper::smem_u32(smem + s * kWsSlot) + wg * 64 * 128;
    const uint32_t wa = hopper::smem_u32(smem + s * kWsSlot + kWsX);
    const bool first = (t * kBK) % G == 0;
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      hopper::wgmma_m64n128k16_bf16_ss(acc, hopper::desc_sw128(xa + kk * 32, 16, 1024),
                                       hopper::desc_sw128(wa + kk * 32, 16, 1024),
                                       kk == 0 && first ? 0 : 1);
    }
    hopper::wgmma_commit();
    hopper::fence_regs(acc);
    if (t > 0) {  // tile t - 1's products are done: hand its slot back
      hopper::wgmma_wait<1>();
      hopper::fence_regs(acc);
      if (lane == 0) hopper::mbar_arrive(&empty[(t - 1) % S]);
    }
    if (t + 1 == T || ((t + 1) * kBK) % G == 0) {  // the group ends: fold it
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      const float* sc = sbuf + ((t * kBK / G) % 4) * kBN;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float2 s2 = *reinterpret_cast<const float2*>(sc + 8 * j + 2 * q);
        total[4 * j] = fmaf(acc[4 * j], s2.x, total[4 * j]);
        total[4 * j + 1] = fmaf(acc[4 * j + 1], s2.y, total[4 * j + 1]);
        total[4 * j + 2] = fmaf(acc[4 * j + 2], s2.x, total[4 * j + 2]);
        total[4 * j + 3] = fmaf(acc[4 * j + 3], s2.y, total[4 * j + 3]);
      }
    }
  }

  const int r0 = m0 + wg * 64 + (warp % 4) * 16 + g;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int n = n0 + 8 * j + 2 * q;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = r0 + 8 * h;
      if (m >= M) continue;
      float* o = out + static_cast<size_t>(m) * N + n;
      if (n + 1 < N && N % 2 == 0) {
        *reinterpret_cast<float2*>(o) = make_float2(total[4 * j + 2 * h], total[4 * j + 2 * h + 1]);
      } else {
        if (n < N) o[0] = total[4 * j + 2 * h];
        if (n + 1 < N) o[1] = total[4 * j + 2 * h + 1];
      }
    }
  }
}

// ------------------------------------------------------------------ host

// raise a kernel's dynamic shared-memory limit to `bytes`, once per device
template <typename Kern>
cudaError_t allow_smem(Kern kernel, int bytes, int (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev] >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = bytes;
  return err;
}

template <bool F32X, bool VEC>
int launch_gemv(const void* x, const uint8_t* wp, const float* s, float* out, int M, int N, int K,
                int G, int NG, cudaStream_t stream) {
  const dim3 grid((N + kGvRows - 1) / kGvRows);
  w4a16_gemv_mma_kernel<F32X, VEC><<<grid, kGvWarps * 32, 0, stream>>>(x, wp, s, out, M, N, K, G,
                                                                       NG);
  return static_cast<int>(cudaGetLastError());
}

template <bool F32X, bool VEC>
int launch_gemm(const void* x, const uint8_t* wp, const float* s, float* out, int M, int N, int K,
                int G, int NG, cudaStream_t stream) {
  static int done[kMaxDevices] = {};
  constexpr int bytes = GemmSmem<F32X>::kBytes;
  const cudaError_t err = allow_smem(w4a16_gemm_mma_kernel<F32X, VEC>, bytes, done);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  w4a16_gemm_mma_kernel<F32X, VEC><<<grid, kGmThreads, bytes, stream>>>(x, wp, s, out, M, N, K, G,
                                                                        NG);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int M, int N, int K, int G, int NG) {
  return M <= 0 || N <= 0 || K <= 0 || K % 2 || G != (K < 128 ? K : 128) ||
         NG != (K + G - 1) / G;
}

}  // namespace

// x_f32: 1 for float32 x, 0 for bf16; vec: 1 when K % 32 == 0 and the x
// and wp bases are 16-byte aligned (the 16-byte vector loads); G must be
// min(128, K) and NG = ceil(K / G)
extern "C" int repro_w4a16_gemv(const void* x, const void* wp, const void* scale, void* out,
                                int M, int N, int K, int G, int NG, int x_f32, int vec,
                                void* stream) {
  if (M > 8 || bad_shape(M, N, K, G, NG)) return static_cast<int>(cudaErrorInvalidValue);
  const auto* w = static_cast<const uint8_t*>(wp);
  const auto* s = static_cast<const float*>(scale);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (x_f32) {
    return vec ? launch_gemv<true, true>(x, w, s, o, M, N, K, G, NG, st)
               : launch_gemv<true, false>(x, w, s, o, M, N, K, G, NG, st);
  }
  return vec ? launch_gemv<false, true>(x, w, s, o, M, N, K, G, NG, st)
             : launch_gemv<false, false>(x, w, s, o, M, N, K, G, NG, st);
}

extern "C" int repro_w4a16_gemm(const void* x, const void* wp, const void* scale, void* out,
                                int M, int N, int K, int G, int NG, int x_f32, int vec,
                                void* stream) {
  if (bad_shape(M, N, K, G, NG) || (M + kBM - 1) / kBM > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* w = static_cast<const uint8_t*>(wp);
  const auto* s = static_cast<const float*>(scale);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (x_f32) {
    return vec ? launch_gemm<true, true>(x, w, s, o, M, N, K, G, NG, st)
               : launch_gemm<true, false>(x, w, s, o, M, N, K, G, NG, st);
  }
  if (vec) {
    static int done[kMaxDevices] = {};
    const cudaError_t err = allow_smem(w4a16_gemm_wgmma_kernel, kWsBytes, done);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
    w4a16_gemm_wgmma_kernel<<<grid, kWsThreads, kWsBytes, st>>>(
        static_cast<const __nv_bfloat16*>(x), w, s, o, M, N, K, G, NG);
    return static_cast<int>(cudaGetLastError());
  }
  return launch_gemm<false, false>(x, w, s, o, M, N, K, G, NG, st);
}
