// Causal GQA self-attention in float32 and its gradient, for training:
//
//   q   f32 [B, S, H, D]     k, v  f32 [B, S, Hkv, D]     (read through their
//                                                          b / s / h strides)
//   o   f32 [B, S, H, D]     lse   f32 [B, H, S]          (contiguous)
//   do  f32 [B, S, H, D]     delta f32 [B, H, S]          (contiguous)
//   dq  f32 [B, S, H, D]     dk, dv f32 [B, S, Hkv, D]    (contiguous)
//
// D is 64 (smollm-360m) or 128 (llama2-7b, qwen2-vl-72b); H % Hkv == 0;
// query i attends keys 0..i.
//
// Replaces no Pallas kernel.  The JAX package trains through
// jax.value_and_grad of the jnp chunked_attention
// (src/repro/models/attention.py:31); its Pallas flash attention has no
// backward.  The port's bf16 kernel (flash_attention.cu, B3) rounds its
// operands to bf16 for the tensor cores and has no backward either, so a
// float32 model on the card (training, whose oracle is the JAX package's
// float32) needs this pair.
//
// What bounds it on the H100.  The forward does 4*D operations a (query,
// key) pair that the causal mask keeps, S(S+1)/2 pairs a head, on 4*B*S*(H
// + Hkv)*D + 4*B*H*S bytes: at S = 256, D = 64, ~S/4 operations a byte of
// float32.  The gradient needs S = Q K^T again (P is not kept), dP = dO
// V^T, dV = P^T dO, dK = dS^T Q and dQ = dS K: 10*D operations a pair,
// 2.5x the forward.  All three kernels run on the tensor cores in 3xTF32
// (below): three TF32 products for each float32 one, so a bound is 3x the
// operations at 495 TFLOP/s, 0.41x the float32 CUDA-core bound (67
// TFLOP/s), or the bytes at 3.35 TB/s where they take longer (the forward
// at smollm-360m's training shape: 0.0063 ms).
//
// The arithmetic: 3xTF32, mma.sync.m16n8k8 with float32
// accumulators.  Each operand x is split as big = TF32(x), rounded to
// nearest (11 significant bits; cvt.rna.tf32's bits, made on the integer
// pipe: cvt made the backward 1.2-1.3x slower), and small = x - big
// (exact in float32), of which the tensor cores read the top 11 bits; a
// product is a_small b_big + a_big b_small + a_big b_big, accumulated in
// float32.  big + small as read holds x within 2^-21 |x|, and the dropped
// a_small b_small is below 2^-22 |a b|, so a product is within ~2^-20 of a
// b before the float32 sum: each term of a sum within a factor of 16 of
// float32's own rounding (2^-24), well inside the 1e-5 gate against
// float64.  One-term TF32 is within 2^-11 |x| an operand (~1e-3 a
// product): it misses the gate (tests/test_torch_train_attention_tc.py
// and tests/test_torch_train_attention_fwd_tc.py show both).  Why not the repo's
// bf16 three-term split (mma_bf16.cuh, B6 and the MLA kernel): it holds x
// exactly in three 8-bit terms, but keeping float32 accuracy takes the six
// term products down to ~2^-24 (t0 t0, t0 t1, t1 t0, t0 t2, t1 t1, t2 t0),
// 6 mma.sync m16n8k16 for each 16-deep float32 product where 3xTF32 takes
// 6 m16n8k8: the same tensor-core work, with three splits of each operand
// instead of two.  3xTF32 is also the arithmetic of SDPA's float32 backward
// (CUTLASS's OpMultiplyAddFastF32), the yardstick.
//
// Every kernel has 4 warps a CTA, each owning 16 rows of the CTA's 64;
// tiles in shared memory with rows padded to D + 4 floats, so the fragment
// loads below fall in 32 distinct banks.
//
// Design of the forward: a CTA per (64-query tile, head, batch row), the
// longest first.  Q once by cp.async, then the keys 0 .. the tile's end in
// steps of kFwdStep (32) keys, each step's K and V by cp.async into a
// second buffer while the step before it computes.  S = Q K^T as C
// fragments (a warp's 16 queries by 32 keys; big . big and the cross
// terms in two accumulators, added at the end of the head dim); scaled,
// -1e30 for a key after the query (and so past S); the online softmax in
// registers, in float32 with expf: a thread holds rows g and g + 8, whose
// max and sum it takes over its quad's 4 lanes by shuffles, and rescales O
// by exp(m_old - m_new); then O += P V with P straight from the S fragment
// as the A operand and V's B fragment loaded from rows 2q, 2q + 1, two k
// steps at a time into zeroed registers added with a rounded float32 add
// (below).  A step whose first key is after a warp's last query is skipped
// by that warp (it adds exactly nothing).  Writes O = acc / max(l, 1e-20)
// and lse = m + log(l); rows past S write nothing.  Steps of 32 keys at
// D 128 take 255 registers and two CTAs an SM (shared memory, 101 KB):
// 0.87 device ms at llama2-7b's shape on an H100, where steps of 16 held
// to 168 registers for three CTAs an SM took 0.93-1.02
// (kernels/diag_attention_f32_parts.py builds the other choices: steps of
// 16 or 64, Q or K/V split once in shared memory rather than by each warp
// at every fragment load (both slower), one accumulator for O, the score
// loop unrolled by 2, two or four CTAs an SM at D 64).
//
// Design of the backward:
//  * delta = rowsum(dO * O), [B, H, S]: one warp a row, launched by the
//    dK/dV entry before the dK/dV kernel;
//  * dK/dV: a CTA per (64-key tile, rank, kv head, batch row), where the
//    group's heads are dealt to `ctas` CTAs (the largest divisor of the
//    group up to 8; rank r takes heads r, r + ctas, ...), which form one
//    thread-block cluster.  K and V once, then for each of the rank's heads
//    and each step of kQ queries (32 at D 64, 16 at D 128) from the key
//    tile on: S^T = K Q^T and dP^T = V dO^T as C fragments (a warp's 16
//    keys by kQ queries; big . big and the cross terms in two accumulators,
//    added at the end of the head dim); P^T = exp(S^T scale - lse) (0 above the diagonal
//    and for rows past S) and dS^T = P^T (dP^T - delta) in registers; then
//    dV += P^T dO and dK += dS^T Q with P^T and dS^T as the A operands
//    straight from the registers: a C fragment holds columns 2q, 2q+1 of
//    its 8, so the A fragment takes them as k slots q and q+4 and the B
//    fragment is loaded by hand from rows 2q and 2q+1 of the Q / dO tile.
//    The next step's Q, dO, lse and delta come by cp.async into a second
//    buffer while a step computes.  At the end each rank's partial dK, dV
//    goes to its shared memory, and after a cluster barrier each rank sums
//    a slice of the tile over ranks 0, 1, ... in order through distributed
//    shared memory (dK scaled once), writes it, and waits at a second
//    barrier before its memory is released.  One CTA (ctas 1) writes
//    straight from its registers;
//  * dQ: a CTA per (64-query tile, head, batch row), the longest first: Q
//    and dO once, lse and delta into registers once, then steps of kK keys
//    (32 at D 64, 16 at D 128) up to the tile's end, each loaded by
//    cp.async into a second buffer while the step before it computes: S = Q
//    K^T and dP = dO V^T as C fragments, dS in registers, dQ += dS K with
//    dS as the A operand as above; dQ scaled once at the end.
//  The walks' sums (O, dK, dV, dQ) take two k steps' products at a time in
//  zeroed registers and add them with a rounded float32 add: the mma's own
//  accumulator truncates, and over a walk of thousands of mma.sync it
//  drifted to 2.9e-5 of dK's max at llama2-7b's shape on an H100
//  (kernels/diag_attention_f32_parts.py times and checks each such choice
//  undone).
//  CTAs and the longest walk, at smollm-360m's training shape (B 8, S 256, H
//  15 over 5, D 64): dK/dV 4 key tiles x 3 ranks x 5 x 8 = 480 CTAs, 8 steps
//  of 32 queries (4 tiles) at the most (one CTA a key tile walking the
//  group had 160 CTAs and 12 steps of 64); dQ and the forward 480 CTAs, 8
//  steps of 32 keys.  At llama2-7b's (B 1, S 2048, H 32 over 32, D 128):
//  dK/dV 32 x 1 x 32 = 1,024 CTAs, 128 steps of 16 queries at the most; dQ
//  1,024 CTAs, 128 steps of 16 keys; the forward 1,024 CTAs, 64 steps of
//  32 keys.  The backward two CTAs an SM (at most 255 registers a thread;
//  ~70 KB of shared memory at D 64, ~101 KB at D 128); the forward three at
//  D 64 (168 registers, 52 KB), two at D 128.
//  No atomics: each output element is one fixed sum (for dK/dV: per rank,
//  its heads in order, then the query steps, then the mma's own order
//  within a step; then the ranks in order), so two runs on the same inputs
//  give the same bits whichever CTA runs first, and so does a recomputed
//  forward (activation checkpointing).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kRows = 64;     // queries of a tile
constexpr int kKeys = 64;     // keys of a tile
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

struct Strides {  // elements
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh;
};

// delta[b, h, i] = sum_d dO[b, i, h, d] * O[b, i, h, d]: a warp a row
template <int D>
__global__ void __launch_bounds__(kThreads)
attention_f32_dkdv_delta_kernel(const float* __restrict__ o, const float* __restrict__ dout,
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

// ---------------------------------------------------------------------------
// the backward on the tensor cores: 3xTF32 mma.sync m16n8k8
// ---------------------------------------------------------------------------

constexpr int kBwdThreads = 128;  // 4 warps, 16 rows each
constexpr int kMaxCtas = 8;       // the portable cluster size

// row stride of a backward tile in shared memory (floats)
template <int D>
__host__ __device__ constexpr int bwd_ld() {
  return D + 4;
}
// queries a dK/dV step, keys a dQ step: 32 at D 64 (64 spilled at 255
// registers: dK/dV 10% slower on an H100); at D 128, 16 keeps a CTA at
// ~101 KB of shared memory, two an SM (32: one CTA an SM, dK/dV 1.4x
// slower at llama2-7b's shape)
template <int D>
__host__ __device__ constexpr int bwd_step() {
  return D == 64 ? 32 : 16;
}

// x = big + small: big is cvt.rna.tf32(x) (round to nearest, ties away,
// on the integer pipe: cvt runs at a fraction of its rate), small the exact
// remainder, whose low 13 bits the tensor cores ignore (they read a TF32
// operand's top 19 bits): the pair holds x within 2^-21 |x|
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// c[16 x 8] += a[16 x 8] . b[8 x 8], TF32 in, float32 out (g = lane / 4,
// q = lane % 4: a0 row g, a1 row g + 8, k q; a2 / a3 the same rows, k q + 4;
// b0 k q, b1 k q + 4, column g; c0 / c1 row g, c2 / c3 row g + 8, columns
// 2q + {0, 1})
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// operands of one 3xTF32 mma, split
struct SplitA {
  uint32_t big[4], small[4];
};
struct SplitB {
  uint32_t big[2], small[2];
};

__device__ __forceinline__ void split_a(float a0, float a1, float a2, float a3, SplitA& s) {
  split_tf32(a0, s.big[0], s.small[0]);
  split_tf32(a1, s.big[1], s.small[1]);
  split_tf32(a2, s.big[2], s.small[2]);
  split_tf32(a3, s.big[3], s.small[3]);
}

__device__ __forceinline__ void split_b(float b0, float b1, SplitB& s) {
  split_tf32(b0, s.big[0], s.small[0]);
  split_tf32(b1, s.big[1], s.small[1]);
}

// c += a b in 3xTF32: the two cross terms first, then big . big
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const SplitA& a, const SplitB& b) {
  mma_tf32(c, a.small, b.big[0], b.big[1]);
  mma_tf32(c, a.big, b.small[0], b.small[1]);
  mma_tf32(c, a.big, b.big[0], b.big[1]);
}

// the same with big . big in hi and the cross terms in lo, for a sum over
// the head dim whose two parts are added once at its end: each keeps the
// truncation of the mma's accumulator (below) relative to its own size
// (1.3e-6 of dK's max at llama2-7b's shape on an H100, against 3.5e-6
// with one accumulator)
__device__ __forceinline__ void mma_3xtf32_hl(float (&hi)[4], float (&lo)[4], const SplitA& a,
                                              const SplitB& b) {
  mma_tf32(lo, a.small, b.big[0], b.big[1]);
  mma_tf32(lo, a.big, b.small[0], b.small[1]);
  mma_tf32(hi, a.big, b.big[0], b.big[1]);
}

// c += a0 b0 + a1 b1 (two k steps) for a sum over a whole walk: the six
// products into zeroed registers, then one rounded float32 add each.  The
// mma's accumulator does not round to nearest (it truncates), so a sum of
// thousands of mma.sync in one accumulator drifts toward zero (2.9e-5 of
// dK's max at S 2048); the CUDA cores' adds keep the walk's sum to
// float32's own rounding
__device__ __forceinline__ void mma_3xtf32_add2(float (&c)[4], const SplitA& a0,
                                                const SplitB& b0, const SplitA& a1,
                                                const SplitB& b1) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_3xtf32(t, a0, b0);
  mma_3xtf32(t, a1, b1);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += t[e];
}

// A fragment of rows r0 + g, r0 + g + 8 and columns c0 + q, c0 + q + 4 of a
// row-major tile
template <int LD>
__device__ __forceinline__ void load_a(const float* t, int r0, int c0, int g, int q, SplitA& s) {
  const float* p = t + (r0 + g) * LD + c0 + q;
  split_a(p[0], p[8 * LD], p[4], p[8 * LD + 4], s);
}

// B fragment of a product against a tile's transpose (k along the tile's
// columns): b0 = t[n0 + g][c0 + q], b1 = t[n0 + g][c0 + q + 4]
template <int LD>
__device__ __forceinline__ void load_b_t(const float* t, int n0, int c0, int g, int q,
                                         SplitB& s) {
  const float* p = t + (n0 + g) * LD + c0 + q;
  split_b(p[0], p[4], s);
}

// B fragment of a product against a tile (k along the tile's rows), whose A
// is a C fragment: k slot q is row r0 + 2q, slot q + 4 row r0 + 2q + 1
template <int LD>
__device__ __forceinline__ void load_b_rows(const float* t, int r0, int c0, int g, int q,
                                            SplitB& s) {
  const float* p = t + (r0 + 2 * q) * LD + c0 + g;
  split_b(p[0], p[LD], s);
}

// a C fragment (columns 2q, 2q + 1 of rows g, g + 8) as an A fragment with
// k slots q, q + 4 at those columns
__device__ __forceinline__ void c_as_a(const float (&c)[4], SplitA& s) {
  split_a(c[0], c[2], c[1], c[3], s);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// rows row0 .. row0 + ROWS - 1 of a [.., S, .., D] tensor (base at the batch
// row and head; row stride rs) into shared memory rows of bwd_ld<D>()
// floats by cp.async, 16 bytes a copy (the wrapper checks the 16-byte grid
// of the base and every stride); rows past S are zeros
template <int D, int ROWS>
__device__ __forceinline__ void load_rows_async(float* dst, const float* __restrict__ src,
                                                long long rs, int row0, int S) {
  constexpr int kVec = D / 4, LD = bwd_ld<D>();
#pragma unroll
  for (int it = 0; it < ROWS * kVec / kBwdThreads; ++it) {
    const int idx = threadIdx.x + it * kBwdThreads;
    const int r = idx / kVec, c = (idx % kVec) * 4;
    const bool in = row0 + r < S;
    tc_bf16::cp_async16(dst + r * LD + c, in ? src + (row0 + r) * rs + c : src, in ? 16 : 0);
  }
}

// ROWS floats of a [B, H, S] row statistic (lse, delta) by cp.async, 0 past S
template <int ROWS>
__device__ __forceinline__ void load_stat_async(float* dst, const float* __restrict__ src,
                                                int row0, int S) {
  if (threadIdx.x < ROWS) {
    const int i = row0 + threadIdx.x;
    cp_async4(dst + threadIdx.x, i < S ? src + i : src, i < S ? 4 : 0);
  }
}

// ---------------------------------------------------------------------------
// the forward on the tensor cores: the same 3xTF32 fragments
// ---------------------------------------------------------------------------

// keys a forward step, at either D (the plain version's FWD_STEP,
// kernels/flash_attention/ref.py)
constexpr int kFwdStep = 32;
// the most forward CTAs an SM: the launch bounds hold a thread's registers
// to what that many leave (168 at 3)
constexpr int kFwdMaxCtas = 3;

template <int D>
__host__ __device__ constexpr int fwd_smem() {
  // Q: 64 rows; K, V: two buffers of kFwdStep rows
  return (kRows + 4 * kFwdStep) * bwd_ld<D>() * 4;
}

// forward CTAs an SM: as many as its 228 KB of shared memory holds (1 KB
// of it reserved a CTA), at most kFwdMaxCtas
template <int D>
__host__ __device__ constexpr int fwd_ctas() {
  return 228 * 1024 / (fwd_smem<D>() + 1024) < kFwdMaxCtas ? 228 * 1024 / (fwd_smem<D>() + 1024)
                                                             : kFwdMaxCtas;
}
static_assert(fwd_smem<128>() <= 227 * 1024 && fwd_ctas<128>() >= 2,
              "the forward leaves two CTAs an SM at D 128");
static_assert(fwd_smem<64>() <= 227 * 1024 && fwd_ctas<64>() >= 2,
              "the forward leaves two CTAs an SM at D 64");

// O = softmax(Q K^T scale, causal) V and lse = m + log(l): a CTA per
// (64-query tile, head, batch row), the longest first; each warp 16 of the
// tile's rows, a thread its rows g and g + 8
template <int D>
__global__ void __launch_bounds__(kBwdThreads, fwd_ctas<D>())
attention_f32_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ lse, int S, int H, int Hkv, Strides st,
                         float scale) {
  constexpr int LD = bwd_ld<D>(), KS = kFwdStep, NT = KS / 8, NU = D / 8;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kRows * LD;                         // [2][KS][LD]
  float* sV = sK + 2 * KS * LD;                        // [2][KS][LD]
  const int qt = gridDim.x - 1 - blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv), q0 = qt * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, qd = lane & 3;
  const int i0 = warp * 16;  // the warp's queries in the tile
  const int n_steps = (min(q0 + kRows, S) + KS - 1) / KS;  // keys 0 .. the tile's last

  auto load_step = [&](int n) {
    const int buf = n & 1;
    load_rows_async<D, KS>(sK + buf * KS * LD, k + b * st.kb + hk * st.kh, st.ks, n * KS, S);
    load_rows_async<D, KS>(sV + buf * KS * LD, v + b * st.vb + hk * st.vh, st.vs, n * KS, S);
  };
  load_rows_async<D, kRows>(sQ, q + b * st.qb + h * st.qh, st.qs, q0, S);
  load_step(0);
  tc_bf16::cp_async_commit();

  // the running max, sum and O of the thread's two rows
  const int row_i[2] = {q0 + i0 + g, q0 + i0 + g + 8};
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o_acc[NU][4];
#pragma unroll
  for (int u = 0; u < NU; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) o_acc[u][e] = 0.f;

  for (int n = 0; n < n_steps; ++n) {
    if (n + 1 < n_steps) {
      load_step(n + 1);  // into the buffer step n - 1 read
      tc_bf16::cp_async_commit();
      tc_bf16::cp_async_wait<1>();
    } else {
      tc_bf16::cp_async_wait<0>();
    }
    __syncthreads();
    const int buf = n & 1, kb0 = n * KS;
    float* tK = sK + buf * KS * LD;
    float* tV = sV + buf * KS * LD;
    // a step whose first key is after the warp's last query adds nothing
    if (kb0 <= q0 + i0 + 15) {
      // S = Q K^T: the warp's 16 queries by KS keys
      float s[NT][4], s_lo[NT][4];
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[t][e] = s_lo[t][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D; kk += 8) {
        SplitA aq;
        load_a<LD>(sQ, i0, kk, g, qd, aq);
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          SplitB bk;
          load_b_t<LD>(tK, 8 * t, kk, g, qd, bk);
          mma_3xtf32_hl(s[t], s_lo[t], aq, bk);
        }
      }
      // the online softmax: S scaled, -1e30 for a key after the query (and
      // so past S), each row's max and sum over its quad's 4 lanes
      float mt[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = kb0 + 8 * t + 2 * qd + (e & 1);
          float x = (s[t][e] + s_lo[t][e]) * scale;
          if (j > row_i[e >> 1]) x = kNegInf;
          s[t][e] = x;
          mt[e >> 1] = fmaxf(mt[e >> 1], x);
        }
      float corr[2], ps[2] = {0.f, 0.f};
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float x = fmaxf(mt[half], __shfl_xor_sync(0xffffffffu, mt[half], 1));
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
        const float m_new = fmaxf(m[half], x);
        corr[half] = expf(m[half] - m_new);
        m[half] = m_new;
      }
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[t][e] = expf(s[t][e] - m[e >> 1]);
          ps[e >> 1] += s[t][e];
        }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float x = ps[half] + __shfl_xor_sync(0xffffffffu, ps[half], 1);
        x += __shfl_xor_sync(0xffffffffu, x, 2);
        l[half] = l[half] * corr[half] + x;
      }
#pragma unroll
      for (int u = 0; u < NU; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) o_acc[u][e] *= corr[e >> 1];
      // O += P V, two k steps of 8 keys at a time
#pragma unroll
      for (int t = 0; t < NT; t += 2) {
        SplitA a0, a1;
        c_as_a(s[t], a0);
        c_as_a(s[t + 1], a1);
#pragma unroll
        for (int u = 0; u < NU; ++u) {
          SplitB b0, b1;
          load_b_rows<LD>(tV, 8 * t, 8 * u, g, qd, b0);
          load_b_rows<LD>(tV, 8 * t + 8, 8 * u, g, qd, b1);
          mma_3xtf32_add2(o_acc[u], a0, b0, a1, b1);
        }
      }
    }
    __syncthreads();  // every warp is done with this step's buffers
  }
  const long long stat = (static_cast<long long>(b) * H + h) * S;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = row_i[half];
    if (i >= S) continue;
    const float den = fmaxf(l[half], 1e-20f);
    float* row = o + ((static_cast<long long>(b) * S + i) * H + h) * D;
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      *reinterpret_cast<float2*>(row + 8 * u + 2 * qd) =
          make_float2(o_acc[u][2 * half] / den, o_acc[u][2 * half + 1] / den);
    }
    if (qd == 0) lse[stat + i] = m[half] + logf(l[half]);
  }
}

template <int D>
__host__ __device__ constexpr int dkdv_smem() {
  // K, V: 64 rows; Q, dO: two buffers of bwd_step rows; lse, delta: two each
  return (2 * kKeys * bwd_ld<D>() + 4 * bwd_step<D>() * bwd_ld<D>() + 4 * bwd_step<D>()) * 4;
}

template <int D>
__host__ __device__ constexpr int dq_smem() {
  // Q, dO: 64 rows; K, V: two buffers of bwd_step rows
  return (2 * kRows * bwd_ld<D>() + 4 * bwd_step<D>() * bwd_ld<D>()) * 4;
}

template <int D>
__global__ void __launch_bounds__(kBwdThreads, 2)
attention_f32_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ lse,
                          const float* __restrict__ dout, const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv, int S, int H, int Hkv,
                          Strides st, float scale, int ctas) {
  constexpr int LD = bwd_ld<D>(), QS = bwd_step<D>(), NT = QS / 8, NU = D / 8;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + kKeys * LD;
  float* sQ = sV + kKeys * LD;     // [2][QS][LD]
  float* sO = sQ + 2 * QS * LD;    // dO, [2][QS][LD]
  float* sL = sO + 2 * QS * LD;    // lse, [2][QS]
  float* sDl = sL + 2 * QS;        // delta, [2][QS]
  const int rank = static_cast<int>(blockIdx.x) % ctas, kt = blockIdx.x / ctas;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int group = H / Hkv, k0 = kt * kKeys;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, qd = lane & 3;
  const int j0 = warp * 16;  // the warp's keys in the tile
  const int n_qs = (S - k0 + QS - 1) / QS;                 // query steps a head
  const int n_steps = (group - rank + ctas - 1) / ctas * n_qs;  // heads rank, rank + ctas, ..

  auto load_step = [&](int n) {
    const int h = hk * group + rank + n / n_qs * ctas, q0 = k0 + n % n_qs * QS, buf = n & 1;
    load_rows_async<D, QS>(sQ + buf * QS * LD, q + b * st.qb + h * st.qh, st.qs, q0, S);
    load_rows_async<D, QS>(sO + buf * QS * LD, dout + (static_cast<long long>(b) * S * H + h) * D,
                           static_cast<long long>(H) * D, q0, S);
    const long long stat = (static_cast<long long>(b) * H + h) * S;
    load_stat_async<QS>(sL + buf * QS, lse + stat, q0, S);
    load_stat_async<QS>(sDl + buf * QS, delta + stat, q0, S);
  };
  load_rows_async<D, kKeys>(sK, k + b * st.kb + hk * st.kh, st.ks, k0, S);
  load_rows_async<D, kKeys>(sV, v + b * st.vb + hk * st.vh, st.vs, k0, S);
  load_step(0);
  tc_bf16::cp_async_commit();

  float dk_acc[NU][4], dv_acc[NU][4];
#pragma unroll
  for (int u = 0; u < NU; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[u][e] = dv_acc[u][e] = 0.f;

  for (int n = 0; n < n_steps; ++n) {
    if (n + 1 < n_steps) {
      load_step(n + 1);  // into the buffer step n - 1 read
      tc_bf16::cp_async_commit();
      tc_bf16::cp_async_wait<1>();
    } else {
      tc_bf16::cp_async_wait<0>();
    }
    __syncthreads();
    const int buf = n & 1, q0 = k0 + n % n_qs * QS;
    const float* tQ = sQ + buf * QS * LD;
    const float* tO = sO + buf * QS * LD;
    const float* tL = sL + buf * QS;
    const float* tD = sDl + buf * QS;

    // S^T = K Q^T and dP^T = V dO^T: the warp's 16 keys by QS queries
    float p[NT][4], ds[NT][4], p_lo[NT][4], ds_lo[NT][4];
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[t][e] = ds[t][e] = p_lo[t][e] = ds_lo[t][e] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < D; kk += 8) {
      SplitA ak, av;
      load_a<LD>(sK, j0, kk, g, qd, ak);
      load_a<LD>(sV, j0, kk, g, qd, av);
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        SplitB bq, bo;
        load_b_t<LD>(tQ, 8 * t, kk, g, qd, bq);
        load_b_t<LD>(tO, 8 * t, kk, g, qd, bo);
        mma_3xtf32_hl(p[t], p_lo[t], ak, bq);
        mma_3xtf32_hl(ds[t], ds_lo[t], av, bo);
      }
    }
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[t][e] += p_lo[t][e];
        ds[t][e] += ds_lo[t][e];
      }
    // P^T = exp(S^T scale - lse), dS^T = P^T (dP^T - delta), in registers
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int il = 8 * t + 2 * qd + (e & 1), i = q0 + il;
        const int j = k0 + j0 + g + (e >> 1) * 8;
        const float pv = j <= i && i < S ? expf(p[t][e] * scale - tL[il]) : 0.f;
        p[t][e] = pv;
        ds[t][e] = pv * (ds[t][e] - tD[il]);
      }
    // dV += P^T dO, dK += dS^T Q, two k steps of 8 queries at a time
#pragma unroll
    for (int t = 0; t < NT; t += 2) {
      SplitA ap0, as0, ap1, as1;
      c_as_a(p[t], ap0);
      c_as_a(ds[t], as0);
      c_as_a(p[t + 1], ap1);
      c_as_a(ds[t + 1], as1);
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        SplitB bo0, bq0, bo1, bq1;
        load_b_rows<LD>(tO, 8 * t, 8 * u, g, qd, bo0);
        load_b_rows<LD>(tQ, 8 * t, 8 * u, g, qd, bq0);
        load_b_rows<LD>(tO, 8 * t + 8, 8 * u, g, qd, bo1);
        load_b_rows<LD>(tQ, 8 * t + 8, 8 * u, g, qd, bq1);
        mma_3xtf32_add2(dv_acc[u], ap0, bo0, ap1, bo1);
        mma_3xtf32_add2(dk_acc[u], as0, bq0, as1, bq1);
      }
    }
    __syncthreads();  // every warp is done with this step's buffer
  }

  if (ctas == 1) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int j = k0 + j0 + g + 8 * half;
      if (j >= S) continue;
      const long long row = ((static_cast<long long>(b) * S + j) * Hkv + hk) * D;
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        const int c = 8 * u + 2 * qd;
        *reinterpret_cast<float2*>(dk + row + c) =
            make_float2(dk_acc[u][2 * half] * scale, dk_acc[u][2 * half + 1] * scale);
        *reinterpret_cast<float2*>(dv + row + c) =
            make_float2(dv_acc[u][2 * half], dv_acc[u][2 * half + 1]);
      }
    }
    return;
  }
  // the group's sum over the cluster's ranks, in rank order: partials
  // [2][64][D] (dK, dV) in each rank's shared memory, where the tiles were
  cg::cluster_group cluster = cg::this_cluster();
  float* part = smem;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = j0 + g + 8 * half;
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      const int c = r * D + 8 * u + 2 * qd;
      *reinterpret_cast<float2*>(part + c) =
          make_float2(dk_acc[u][2 * half], dk_acc[u][2 * half + 1]);
      *reinterpret_cast<float2*>(part + kKeys * D + c) =
          make_float2(dv_acc[u][2 * half], dv_acc[u][2 * half + 1]);
    }
  }
  cluster.sync();
  constexpr int kTile4 = kKeys * D / 4;  // float4s of one tensor's tile
  for (int idx = rank * kBwdThreads + threadIdx.x; idx < 2 * kTile4;
       idx += kBwdThreads * ctas) {
    const int which = idx / kTile4, rem = idx % kTile4;
    const int j = k0 + rem / (D / 4), c = rem % (D / 4) * 4;
    if (j >= S) continue;
    float4 acc = *reinterpret_cast<const float4*>(cluster.map_shared_rank(part, 0) + 4 * idx);
    for (int r = 1; r < ctas; ++r) {
      const float4 x = *reinterpret_cast<const float4*>(cluster.map_shared_rank(part, r) + 4 * idx);
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    const long long off = ((static_cast<long long>(b) * S + j) * Hkv + hk) * D + c;
    if (which == 0) {
      *reinterpret_cast<float4*>(dk + off) =
          make_float4(acc.x * scale, acc.y * scale, acc.z * scale, acc.w * scale);
    } else {
      *reinterpret_cast<float4*>(dv + off) = acc;
    }
  }
  cluster.sync();  // no rank leaves while another reads its partials
}

template <int D>
__global__ void __launch_bounds__(kBwdThreads, 2)
attention_f32_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ lse,
                        const float* __restrict__ dout, const float* __restrict__ delta,
                        float* __restrict__ dq, int S, int H, int Hkv, Strides st,
                        float scale) {
  constexpr int LD = bwd_ld<D>(), KS = bwd_step<D>(), NT = KS / 8, NU = D / 8;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sO = sQ + kRows * LD;    // dO
  float* sK = sO + kRows * LD;    // [2][KS][LD]
  float* sV = sK + 2 * KS * LD;   // [2][KS][LD]
  const int qt = gridDim.x - 1 - blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv), q0 = qt * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, qd = lane & 3;
  const int i0 = warp * 16;  // the warp's queries in the tile
  const int n_steps = (min(q0 + kRows, S) + KS - 1) / KS;  // keys 0 .. the tile's last

  auto load_step = [&](int n) {
    const int buf = n & 1;
    load_rows_async<D, KS>(sK + buf * KS * LD, k + b * st.kb + hk * st.kh, st.ks, n * KS, S);
    load_rows_async<D, KS>(sV + buf * KS * LD, v + b * st.vb + hk * st.vh, st.vs, n * KS, S);
  };
  load_rows_async<D, kRows>(sQ, q + b * st.qb + h * st.qh, st.qs, q0, S);
  load_rows_async<D, kRows>(sO, dout + (static_cast<long long>(b) * S * H + h) * D,
                            static_cast<long long>(H) * D, q0, S);
  load_step(0);
  tc_bf16::cp_async_commit();
  // the row statistics of the thread's two rows, once
  const long long stat = (static_cast<long long>(b) * H + h) * S;
  float row_lse[2], row_delta[2];
  int row_i[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = q0 + i0 + g + 8 * half;
    row_i[half] = i;
    row_lse[half] = i < S ? lse[stat + i] : 0.f;
    row_delta[half] = i < S ? delta[stat + i] : 0.f;
  }

  float dq_acc[NU][4];
#pragma unroll
  for (int u = 0; u < NU; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[u][e] = 0.f;

  for (int n = 0; n < n_steps; ++n) {
    if (n + 1 < n_steps) {
      load_step(n + 1);
      tc_bf16::cp_async_commit();
      tc_bf16::cp_async_wait<1>();
    } else {
      tc_bf16::cp_async_wait<0>();
    }
    __syncthreads();
    const int buf = n & 1, kb0 = n * KS;
    const float* tK = sK + buf * KS * LD;
    const float* tV = sV + buf * KS * LD;

    // S = Q K^T and dP = dO V^T: the warp's 16 queries by KS keys
    float p[NT][4], ds[NT][4], p_lo[NT][4], ds_lo[NT][4];
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[t][e] = ds[t][e] = p_lo[t][e] = ds_lo[t][e] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < D; kk += 8) {
      SplitA aq, ao;
      load_a<LD>(sQ, i0, kk, g, qd, aq);
      load_a<LD>(sO, i0, kk, g, qd, ao);
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        SplitB bk, bv;
        load_b_t<LD>(tK, 8 * t, kk, g, qd, bk);
        load_b_t<LD>(tV, 8 * t, kk, g, qd, bv);
        mma_3xtf32_hl(p[t], p_lo[t], aq, bk);
        mma_3xtf32_hl(ds[t], ds_lo[t], ao, bv);
      }
    }
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[t][e] += p_lo[t][e];
        ds[t][e] += ds_lo[t][e];
      }
    // P = exp(S scale - lse), dS = P (dP - delta), in registers
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e >> 1, i = row_i[half];
        const int j = kb0 + 8 * t + 2 * qd + (e & 1);
        const float pv = j <= i && i < S ? expf(p[t][e] * scale - row_lse[half]) : 0.f;
        ds[t][e] = pv * (ds[t][e] - row_delta[half]);
      }
    // dQ += dS K, two k steps of 8 keys at a time
#pragma unroll
    for (int t = 0; t < NT; t += 2) {
      SplitA as0, as1;
      c_as_a(ds[t], as0);
      c_as_a(ds[t + 1], as1);
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        SplitB bk0, bk1;
        load_b_rows<LD>(tK, 8 * t, 8 * u, g, qd, bk0);
        load_b_rows<LD>(tK, 8 * t + 8, 8 * u, g, qd, bk1);
        mma_3xtf32_add2(dq_acc[u], as0, bk0, as1, bk1);
      }
    }
    __syncthreads();  // every warp is done with this step's buffer
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = row_i[half];
    if (i >= S) continue;
    float* row = dq + ((static_cast<long long>(b) * S + i) * H + h) * D;
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      *reinterpret_cast<float2*>(row + 8 * u + 2 * qd) =
          make_float2(dq_acc[u][2 * half] * scale, dq_acc[u][2 * half + 1] * scale);
    }
  }
}

Strides strides_of(const long long* s) {
  return Strides{s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8]};
}

bool shape_ok(int B, int S, int H, int Hkv, int D) {
  return B > 0 && S > 0 && Hkv > 0 && H % Hkv == 0 && (D == 64 || D == 128);
}

// CTAs that share a key tile's dK/dV (one cluster): the largest divisor of
// the group up to the portable cluster size
int group_ctas(int group) {
  for (int c = kMaxCtas; c > 1; --c) {
    if (group % c == 0) return c;
  }
  return 1;
}

template <int D>
int launch_fwd(const float* q, const float* k, const float* v, float* o, float* lse, int B,
               int S, int H, int Hkv, Strides st, float scale, cudaStream_t s) {
  auto kernel = attention_f32_fwd_kernel<D>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, fwd_smem<D>());
  const dim3 grid((S + kRows - 1) / kRows, H, B);
  kernel<<<grid, kBwdThreads, fwd_smem<D>(), s>>>(q, k, v, o, lse, S, H, Hkv, st, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkdv(const float* q, const float* k, const float* v, const float* o,
                const float* lse, const float* dout, float* delta, float* dk, float* dv, int B,
                int S, int H, int Hkv, Strides st, float scale, cudaStream_t s) {
  const long long rows = static_cast<long long>(B) * S * H;
  const int warps = kThreads / 32;
  attention_f32_dkdv_delta_kernel<D><<<static_cast<unsigned>((rows + warps - 1) / warps),
                                       kThreads, 0, s>>>(o, dout, delta, B, S, H);
  int status = static_cast<int>(cudaGetLastError());
  if (status != 0) return status;
  auto kernel = attention_f32_dkdv_kernel<D>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dkdv_smem<D>());
  const int ctas = group_ctas(H / Hkv);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((S + kKeys - 1) / kKeys * ctas), Hkv, B);
  cfg.blockDim = dim3(kBwdThreads);
  cfg.dynamicSmemBytes = dkdv_smem<D>();
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = ctas > 1 ? 1 : 0;
  status = static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, q, k, v, lse, dout,
                                               static_cast<const float*>(delta), dk, dv, S, H,
                                               Hkv, st, scale, ctas));
  if (status != 0) return status;
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq(const float* q, const float* k, const float* v, const float* lse,
              const float* dout, const float* delta, float* dq, int B, int S, int H, int Hkv,
              Strides st, float scale, cudaStream_t s) {
  auto kernel = attention_f32_dq_kernel<D>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_smem<D>());
  const dim3 grid((S + kRows - 1) / kRows, H, B);
  kernel<<<grid, kBwdThreads, dq_smem<D>(), s>>>(q, k, v, lse, dout, delta, dq, S, H, Hkv, st,
                                                  scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strides: q, k, v (batch, sequence, head), in elements
extern "C" int repro_attention_f32_fwd(const void* q, const void* k, const void* v, void* o,
                                       void* lse, int B, int S, int H, int Hkv, int D,
                                       const long long* strides, float scale, void* stream) {
  if (!shape_ok(B, S, H, Hkv, D)) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const Strides st = strides_of(strides);
  auto qp = static_cast<const float*>(q), kp = static_cast<const float*>(k),
       vp = static_cast<const float*>(v);
  auto op = static_cast<float*>(o), lp = static_cast<float*>(lse);
  return D == 64 ? launch_fwd<64>(qp, kp, vp, op, lp, B, S, H, Hkv, st, scale, s)
                 : launch_fwd<128>(qp, kp, vp, op, lp, B, S, H, Hkv, st, scale, s);
}

// delta (written here, read by repro_attention_f32_dq), then dK and dV
extern "C" int repro_attention_f32_dkdv(const void* q, const void* k, const void* v,
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

extern "C" int repro_attention_f32_dq(const void* q, const void* k, const void* v,
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
