// The per-block arithmetic of the attention kernels, shared by B3
// (flash_attention.cu, one-shot prefill, causal or bidirectional) and the
// paged chunk kernel (paged_chunk_attention.cu, causal), so that a causal
// query computed by either kernel gets the same bits: one warpgroup (128
// threads) holds a 64-row query tile and walks 64-key K/V blocks that lie
// at absolute multiples of 64 from key 0.  Per block:
//
//   S  = Q K^T by wgmma m64n64k16 (bf16 in, f32 accumulate), the head dim
//        in k-steps of 16 in order; Q and K K-major in shared memory
//   S' = S * 1/sqrt(D) (int8 pools: (S * key scale) * 1/sqrt(D)); causal:
//        keys after the row set to -1e30 on the diagonal block;
//        bidirectional: keys from the key count on (TMA's zero rows past
//        the end, which would score 0) set to -1e30 on the last block
//   m' = max(m, rowmax S'); corr = exp(m - m'); P = exp(S' - m')
//   l  = fma(l, corr, rowsum P); O = O * corr + P V
//
// P enters the P V wgmma from registers as bf16 hi + bf16 lo (lo the
// rounding residual; int8 pools: P times the value row's scale first), V
// from shared memory as the MN-major B operand.  The end: O / max(l,
// 1e-20), rounded to bf16.  Every rounding is written out (__fmul_rn,
// __fmaf_rn), so the compiler contracts nothing differently in the two
// kernels.
//
// Tiles in shared memory are in TMA's 128-byte swizzled layout
// (hopper.cuh): [DP / 64 column blocks][64 rows][128 bytes], the 16-byte
// chunk j of row r stored at chunk j ^ (r % 8), each tile 1,024-byte
// aligned.  The head dim is padded with zero columns to DP = 64 (D <= 64)
// or 128 (D 112, 128); B3 also has DP = 192 (D 192, MLA's prefill).
//
// Register layout (the wgmma accumulator, hopper.cuh): thread t, warp w =
// t / 32, lane l, holds rows 16w + l/4 and 16w + l/4 + 8 of the tile, and
// of each row the columns 8j + 2(l%4) + {0, 1}.

#pragma once

#include <cuda_bf16.h>

#include "hopper.cuh"

namespace attn_tile {

constexpr float kNegInf = -1e30f;
constexpr int kRows = 64;        // query rows per tile: one warpgroup
constexpr int kKeys = 64;        // keys per K/V block
constexpr int kBox = 64 * 128;   // one column block of a tile: 64 rows x 128 bytes
constexpr int kThreads = 128;

// byte offset of the 16-byte chunk jg (8 head dims) of row r in a tile
__device__ __forceinline__ uint32_t swizzled(int r, int jg) {
  return (jg / 8) * kBox + r * 128 + (((jg % 8) ^ (r % 8)) << 4);
}

// the running softmax state of this thread's two rows
template <int DP>
struct Rows {
  float o[DP / 2];
  float m[2];
  float l[2];  // this thread's share of each row's sum

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
    m[0] = m[1] = kNegInf;
    l[0] = l[1] = 0.f;
  }
};

// S = Q K^T over one block; qa / ka: shared addresses of the Q and K tiles
template <int DP>
__device__ __forceinline__ void scores(float (&sc)[32], uint32_t qa, uint32_t ka) {
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.f;
  hopper::fence_regs(sc);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint32_t off = (kk / 4) * kBox + (kk % 4) * 32;
    hopper::wgmma_m64n64k16_bf16_ss(sc, hopper::desc_sw128(qa + off, 16, 1024),
                                    hopper::desc_sw128(ka + off, 16, 1024), 1);
  }
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(sc);
}

// the block's key (0..63) of accumulator entry i of this lane
__device__ __forceinline__ int key_of(int i, int lane) {
  return 8 * (i / 4) + 2 * (lane % 4) + (i & 1);
}

// scale and mask the block's scores, update the rows' max, sum and output
// scaling, and leave P in sc.  diag: the block holds the tile's last keys
// (kCausal: keys after a row are masked; else keys from n_keys on);
// key0: the block's first key; row0: the absolute position of this
// thread's first row.  kscale: null, or the block's 64 key scales (int8
// pools).  n_keys: the key count (bidirectional only)
template <int DP, bool kCausal = true>
__device__ __forceinline__ void softmax(float (&sc)[32], Rows<DP>& st, float scale, bool diag,
                                       int key0, int row0, const float* kscale,
                                       int n_keys = 0) {
  const int lane = threadIdx.x % 32;
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int key = key_of(i, lane);
    float v = sc[i];
    if (kscale != nullptr) v = __fmul_rn(v, kscale[key]);
    v = __fmul_rn(v, scale);
    if constexpr (kCausal) {
      if (diag && key0 + key > row0 + 8 * ((i >> 1) & 1)) v = kNegInf;
    } else {
      if (diag && key0 + key >= n_keys) v = kNegInf;
    }
    sc[i] = v;
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], v);
  }
  float corr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(st.m[r], mx[r]);
    corr[r] = expf(__fsub_rn(st.m[r], m_new));
    st.m[r] = m_new;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const float p = expf(__fsub_rn(sc[i], st.m[(i >> 1) & 1]));
    sc[i] = p;
    sum[(i >> 1) & 1] = __fadd_rn(sum[(i >> 1) & 1], p);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) st.l[r] = __fmaf_rn(st.l[r], corr[r], sum[r]);
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) st.o[i] = __fmul_rn(st.o[i], corr[(i >> 1) & 1]);
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// O[:, 0:DP] += A . V for one 16-key slice; dv: the descriptor of the
// slice's first 64-column block.  DP 192 (MLA's qk head) is an n128
// product over column blocks 0-1 and an n64 product over block 2: the
// accumulator entries of columns 128-191 follow those of 0-127, so o[64..95]
// is the n64 product's accumulator (each column's sum is the same
// instruction sequence as in an n192 product)
template <int DP>
__device__ __forceinline__ void pv_product(float (&o)[DP / 2], const uint32_t (&a)[4],
                                           uint64_t dv) {
  if constexpr (DP == 64) {
    hopper::wgmma_m64n64k16_bf16_rs_tnspb(o, a, dv);
  } else if constexpr (DP == 128) {
    hopper::wgmma_m64n128k16_bf16_rs_tnspb(o, a, dv);
  } else {
    static_assert(DP == 192, "padded head dims: 64, 128, 192");
    hopper::wgmma_m64n128k16_bf16_rs_tnspb(*reinterpret_cast<float(*)[64]>(&o[0]), a, dv);
    // the descriptor's start address is in 16-byte units: block 2 is 2 kBox on
    hopper::wgmma_m64n64k16_bf16_rs_tnspb(*reinterpret_cast<float(*)[32]>(&o[64]), a,
                                          dv + static_cast<uint64_t>((2 * kBox) >> 4));
  }
}

// O += P V; va: shared address of the V tile [64 keys][DP].  P as bf16 hi
// + lo in the A-operand layout: for keys 16kc..16kc+15, register r holds
// P[8kc + 2r], P[8kc + 2r + 1].  vscale: null, or the block's 64 value
// scales (int8 pools), folded into P before it is rounded
template <int DP>
__device__ __forceinline__ void pv(Rows<DP>& st, const float (&sc)[32], uint32_t va,
                                   const float* vscale) {
  const int lane = threadIdx.x % 32;
  uint32_t phi[4][4], plo[4][4];
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = 8 * kc + 2 * r;
      float p0 = sc[i];
      float p1 = sc[i + 1];
      if (vscale != nullptr) {
        p0 = __fmul_rn(p0, vscale[key_of(i, lane)]);
        p1 = __fmul_rn(p1, vscale[key_of(i + 1, lane)]);
      }
      const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
      const float2 hf = __bfloat1622float2(hi);
      phi[kc][r] = bf16x2_bits(hi);
      plo[kc][r] = bf16x2_bits(__floats2bfloat162_rn(__fsub_rn(p0, hf.x), __fsub_rn(p1, hf.y)));
    }
  }
  hopper::fence_regs(st.o);
  hopper::wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    const uint64_t dv = hopper::desc_sw128(va + kc * 16 * 128, kBox, 1024);
    pv_product<DP>(st.o, phi[kc], dv);
    pv_product<DP>(st.o, plo[kc], dv);
  }
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(st.o);
}

// after the last block: each row's sum over its four lanes
template <int DP>
__device__ __forceinline__ void finish(Rows<DP>& st) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    st.l[r] = __fadd_rn(st.l[r], __shfl_xor_sync(0xffffffffu, st.l[r], 1));
    st.l[r] = __fadd_rn(st.l[r], __shfl_xor_sync(0xffffffffu, st.l[r], 2));
  }
}

// row r (0: the thread's first row, 1: its second) of the output, its
// first D columns, to orow
template <int DP>
__device__ __forceinline__ void store_row(const Rows<DP>& st, int r, __nv_bfloat16* orow,
                                          int D) {
  const int lane = threadIdx.x % 32;
  const float denom = fmaxf(st.l[r], 1e-20f);
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    const int col = 8 * j + 2 * (lane % 4);
    if (col < D) {
      *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(
          __fdiv_rn(st.o[4 * j + 2 * r], denom), __fdiv_rn(st.o[4 * j + 2 * r + 1], denom));
    }
  }
}

}  // namespace attn_tile
