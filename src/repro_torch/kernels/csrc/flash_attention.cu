// Causal GQA flash attention for prefill, in the model's own layout:
//
//   q    bf16 [B, S, H, D]     k, v  bf16 [B, S, Hkv, D]     out bf16 [B, S, H, D]
//
// read and written through their batch / sequence / head strides (the last
// axis contiguous), so the caller transposes nothing; D in {16, 32, 64, 112,
// 128}.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/flash_attention.py::flash_attention
// (grid (B*H, q-blocks, kv-blocks), online softmax in VMEM scratch, blocks
// above the diagonal computed and then masked).  The model path it stands
// in for is models/attention.py::chunked_attention(causal=True) as
// models/blocks.py::attn_full calls it.
//
// What bounds it on the H100: a causal prefill does 2*2*B*H*D*S(S+1)/2
// operations on 2*B*S*(2*H+2*Hkv)*D bytes, about S/4 operations per byte
// without GQA, so below S ~ 1200 (the path's buckets are <= 1024) it is
// bound by bytes and above it by the bf16 tensor-core rate.  Either way the
// products have to leave the f32 CUDA cores (67 TFLOP/s) for the tensor
// cores (989 TFLOP/s bf16, reached only through wgmma), and the K/V loads
// have to overlap the products.
//
// Design:
//  * one CTA of one warpgroup (128 threads) per (64-query block, head,
//    batch row), the longest query blocks launched first; grouped heads read
//    their kv head's rows (GQA fold, no repeat);
//  * TMA loads every tile as boxes of 64 rows x 64 head dims (128 bytes,
//    128-byte swizzle) through 4-d tensor maps over [B, S, H, D], so the
//    strides stay the caller's.  The head dim is padded in shared memory to
//    64 (D <= 64) or 128 (D 112, 128) by TMA's zero fill past D: the zero
//    columns add nothing to Q K^T, and the output columns past D are not
//    stored;
//  * the Q tile is loaded once; K/V blocks of 64 keys stream through a
//    2-stage ring, block kb+1 loading while block kb computes.  Blocks
//    above the diagonal are never loaded; block boundaries lie at absolute
//    multiples of 64 from key 0, so each query's reduction order is fixed
//    by absolute key position;
//  * S = Q K^T by wgmma m64n64k16 (bf16 in, f32 accumulate; Q and K
//    K-major in shared memory), scaled by 1/sqrt(D) and, on the diagonal
//    block, keys after the query set to -1e30; f32 online softmax in the
//    accumulator registers, row max and sum across the four lanes of a row;
//  * O += P V by wgmma with P from registers (the accumulator layout of S
//    is the A-operand layout) and V from shared memory as the MN-major B
//    operand (transposed by the descriptor).  The plain version multiplies
//    f32 P by f32 V; a single bf16 P would add a relative error of ~2^-9 a
//    term, enough to put outputs near 0 past the check's 2 bf16 steps +
//    1e-5.  So P enters the tensor cores as bf16 hi + bf16 lo (lo = the
//    rounding residual), two products into one f32 accumulator, leaving a
//    residual of ~2^-17 of P;
//  * out = O / max(l, 1e-20), cast to bf16.  Rows past S (a bucket that is
//    not a multiple of 64) are computed on TMA's zeros and not stored; keys
//    past S lie after every valid query, so the causal mask hides them.

#include "hopper.cuh"

#include <cuda_bf16.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kRows = 64;           // query rows per CTA: one warpgroup
constexpr int kKeys = 64;           // keys per K/V block
constexpr int kBox = 64 * 128;      // one TMA box: 64 rows x 64 bf16 = 8 KB
constexpr int kThreads = 128;

template <int DP>
constexpr int smem_bytes() {
  return 5 * (DP / 64) * kBox + 3 * 8 + 1024;  // Q, 2 x K, 2 x V, barriers
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int DP>
__device__ __forceinline__ void pv_product(float (&o)[DP / 2], const uint32_t (&a)[4],
                                           uint64_t dv) {
  if constexpr (DP == 64) {
    hopper::wgmma_m64n64k16_bf16_rs_tnspb(o, a, dv);
  } else {
    hopper::wgmma_m64n128k16_bf16_rs_tnspb(o, a, dv);
  }
}

// one thread: K/V block kb of kv head g, batch row b into one ring stage
template <int NB>
__device__ __forceinline__ void load_kv(const CUtensorMap* tk, const CUtensorMap* tv,
                                        uint8_t* sk, uint8_t* sv, uint64_t* bar, int kb, int g,
                                        int b) {
  hopper::mbar_expect_tx(bar, 2 * NB * kBox);
#pragma unroll
  for (int c = 0; c < NB; ++c) {
    hopper::tma_load_4d(sk + c * kBox, tk, bar, c * 64, g, kb * kKeys, b);
    hopper::tma_load_4d(sv + c * kBox, tv, bar, c * 64, g, kb * kKeys, b);
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ out,
                       int S, int H, int Hkv, int D, long long osb, long long oss,
                       long long osh, float scale) {
  constexpr int NB = DP / 64;       // 64-column blocks of the padded head dim
  constexpr int kTile = NB * kBox;  // one 64-row tile of Q, K or V
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1,024 bytes: tiles start on that grid
  uint8_t* smem = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sq = smem;              // [NB][64 rows][128 bytes]
  uint8_t* sk = smem + kTile;      // [stage][NB][64 keys][128 bytes]
  uint8_t* sv = smem + 3 * kTile;  // [stage][NB][64 keys][128 bytes]
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + 5 * kTile);  // Q, K/V stage 0, 1

  const int nqb = (S + kRows - 1) / kRows;
  const int qb = nqb - 1 - static_cast<int>(blockIdx.x);  // longest rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (H / Hkv);
  const int q0 = qb * kRows;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) hopper::mbar_init(&bars[i], 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    hopper::mbar_expect_tx(&bars[0], kTile);
#pragma unroll
    for (int c = 0; c < NB; ++c) hopper::tma_load_4d(sq + c * kBox, &tq, &bars[0], c * 64, h, q0, b);
    load_kv<NB>(&tk, &tv, sk, sv, &bars[1], 0, g, b);
  }

  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m_r[2] = {kNegInf, kNegInf};  // rows row0 and row0 + 8
  float l_r[2] = {0.f, 0.f};          // this thread's share of each row's sum
  const int row0 = q0 + warp * 16 + lane / 4;
  const uint32_t qa = hopper::smem_u32(sq);
  hopper::mbar_wait(&bars[0], 0);

  for (int kb = 0; kb <= qb; ++kb) {
    const int st = kb & 1;
    if (kb < qb) {
      // every warp is past block kb - 1, the last reader of stage st ^ 1
      asm volatile("bar.sync 1, 128;\n" ::: "memory");
      if (tid == 0) load_kv<NB>(&tk, &tv, sk + (st ^ 1) * kTile, sv + (st ^ 1) * kTile,
                                &bars[1 + (st ^ 1)], kb + 1, g, b);
    }
    hopper::mbar_wait(&bars[1 + st], (kb >> 1) & 1);

    // S = Q K^T
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    const uint32_t ka = hopper::smem_u32(sk + st * kTile);
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

    // online softmax, f32
    const bool diag = kb == qb;
    const int key0 = kb * kKeys + 2 * (lane % 4);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float v = sc[4 * j + e] * scale;
        if (diag && key0 + 8 * j + (e & 1) > row0 + 8 * (e >> 1)) v = kNegInf;
        sc[4 * j + e] = v;
        mx[e >> 1] = fmaxf(mx[e >> 1], v);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_r[r], mx[r]);
      corr[r] = expf(m_r[r] - m_new);
      m_r[r] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float p = expf(sc[i] - m_r[(i >> 1) & 1]);
      sc[i] = p;
      sum[(i >> 1) & 1] += p;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * corr[r] + sum[r];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] *= corr[(i >> 1) & 1];

    // P as bf16 hi + lo in the A-operand layout: for keys 16kc..16kc+15,
    // register r holds sc[8kc + 2r], sc[8kc + 2r + 1]
    uint32_t phi[4][4], plo[4][4];
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float p0 = sc[8 * kc + 2 * r];
        const float p1 = sc[8 * kc + 2 * r + 1];
        const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
        const float2 hf = __bfloat1622float2(hi);
        phi[kc][r] = bf16x2_bits(hi);
        plo[kc][r] = bf16x2_bits(__floats2bfloat162_rn(p0 - hf.x, p1 - hf.y));
      }
    }

    // O += P V: V [64 keys][DP] is the MN-major B operand; 16 keys a step
    const uint32_t va = hopper::smem_u32(sv + st * kTile);
    hopper::fence_regs(o);
    hopper::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      const uint64_t dv = hopper::desc_sw128(va + kc * 16 * 128, kBox, 1024);
      pv_product<DP>(o, phi[kc], dv);
      pv_product<DP>(o, plo[kc], dv);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(o);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s = row0 + 8 * r;
    if (s >= S) continue;
    const float denom = fmaxf(l_r[r], 1e-20f);
    __nv_bfloat16* orow = out + b * osb + s * oss + h * osh;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
      if (col < D) {
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(o[4 * j + 2 * r] / denom, o[4 * j + 2 * r + 1] / denom);
      }
    }
  }
}

// a 4-d tensor map over [B, S, heads, D] (innermost first), boxes of 64 head
// dims x 1 head x 64 rows x 1 batch row
int encode_bshd(CUtensorMap* map, const void* base, int B, int S, int heads, int D,
                const long long* st) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st[2]) * 2,
                                 static_cast<cuuint64_t>(st[1]) * 2,
                                 static_cast<cuuint64_t>(st[0]) * 2};
  const cuuint32_t box[4] = {64, 1, kRows, 1};
  return hopper::encode_tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base, dims,
                                   strides, box);
}

template <int DP>
int launch_for_dim(const void* q, const void* k, const void* v, __nv_bfloat16* out, int B,
                   int S, int H, int Hkv, int D, const long long* st, float scale,
                   cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int status = encode_bshd(&tq, q, B, S, H, D, st);
  if (status == 0) status = encode_bshd(&tk, k, B, S, Hkv, D, st + 3);
  if (status == 0) status = encode_bshd(&tv, v, B, S, Hkv, D, st + 6);
  if (status != 0) return status;
  constexpr int bytes = smem_bytes<DP>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kRows - 1) / kRows, H, B);
  flash_attention_kernel<DP><<<grid, kThreads, bytes, stream>>>(
      tq, tk, tv, out, S, H, Hkv, D, st[9], st[10], st[11], scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strides (in elements): q (batch, seq, head), k (...), v (...), out (...);
// the head-dim stride is 1, every stride a multiple of 8 and every base
// 16-byte aligned (TMA's rules); returns hopper::kTensorMapError + the
// CUresult if a tensor map cannot be encoded
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* out,
                                     int B, int S, int H, int Hkv, int D,
                                     const long long* strides, float scale, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || H % Hkv != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* op = static_cast<__nv_bfloat16*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
    case 32:
    case 64: return launch_for_dim<64>(q, k, v, op, B, S, H, Hkv, D, strides, scale, s);
    case 112:
    case 128: return launch_for_dim<128>(q, k, v, op, B, S, H, Hkv, D, strides, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
