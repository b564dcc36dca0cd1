// GQA flash attention for prefill, causal or bidirectional, in the model's
// own layout:
//
//   q    bf16 [B, S, H, D]     k, v  bf16 [B, Skv, Hkv, D]     out bf16 [B, S, H, D]
//
// read and written through their batch / sequence / head strides (the last
// axis contiguous), so the caller transposes nothing; D a multiple of 8 up
// to 64 (MLA's reduced qk head of 24 among them), 112, 128 or 192 (MLA's qk
// head: 128 no-rope + 64 rope dims, v padded to it by the caller).  Causal: Skv == S, query i attends keys 0..i.  Bidirectional (the
// whisper encoder's self-attention, Skv == S, and its decoder's
// cross-attention over the encoder's rows, any Skv): every query attends
// every key.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/flash_attention.py::flash_attention
// (grid (B*H, q-blocks, kv-blocks), online softmax in VMEM scratch, blocks
// above the diagonal computed and then masked; causal=False leaves the mask
// out).  The model path it stands in for is
// models/attention.py::chunked_attention(causal) as models/blocks.py::attn_full
// calls it.
//
// What bounds it on the H100: a causal prefill does 2*2*B*H*D*S(S+1)/2
// operations on 2*B*S*(2*H+2*Hkv)*D bytes, about S/4 operations per byte
// without GQA, so below S ~ 1200 (the path's buckets are <= 1024) it is
// bound by bytes and above it by the bf16 tensor-core rate.  Either way the
// products have to leave the f32 CUDA cores (67 TFLOP/s) for the tensor
// cores (989 TFLOP/s bf16, reached only through wgmma), and the K/V loads
// have to overlap the products.  A bidirectional pass does 4*B*H*D*S*Skv
// operations: whisper's encoder (S = Skv = 1500) is bound by operations,
// its cross-attention (a prompt of S <= 448 over Skv = 1500) by bytes.
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
//    stored.  D 192 is three boxes (5 x 24 KB of tiles, 121 KB of shared
//    memory); its P V product is an n128 wgmma and an n64 one
//    (attention_tile.cuh), and a thread's accumulator grows to 96 floats;
//  * the Q tile is loaded once; K/V blocks of 64 keys stream through a
//    2-stage ring, block kb+1 loading while block kb computes.  Causal:
//    blocks above the diagonal are never loaded; bidirectional: every
//    block of the Skv keys is.  Block boundaries lie at absolute multiples
//    of 64 from key 0, so each query's reduction order is fixed by absolute
//    key position;
//  * S = Q K^T by wgmma m64n64k16 (bf16 in, f32 accumulate; Q and K
//    K-major in shared memory), scaled by 1/sqrt(D) and, causal, on the
//    diagonal block keys after the query set to -1e30; bidirectional, on
//    the last block keys from Skv on (TMA's zero fill, which would score 0
//    and enter the softmax) set to -1e30; f32 online softmax in the
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
//    past S lie after every valid query, so the causal mask hides them
//    (bidirectional: the last block's mask).
//  The mode is a template parameter (kCausal), so the causal instantiation
//  is the code it was before the bidirectional one existed.  The per-block
//  arithmetic (S, the mask, the online softmax, P hi + lo, P V and the final
//  division) lives in attention_tile.cuh and is shared with the paged chunk
//  kernel (paged_chunk_attention.cu): a causal query's output depends only
//  on its own row, its absolute position and the keys up to it, so a
//  prefill chunk's query gets this kernel's one-shot bits.

#include "attention_tile.cuh"

#include <cuda_bf16.h>

namespace {

using attn_tile::kBox;
using attn_tile::kKeys;
using attn_tile::kRows;
using attn_tile::kThreads;

template <int DP>
constexpr int smem_bytes() {
  return 5 * (DP / 64) * kBox + 3 * 8 + 1024;  // Q, 2 x K, 2 x V, barriers
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

template <int DP, bool kCausal>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ out,
                       int S, int Skv, int H, int Hkv, int D, long long osb, long long oss,
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
  // the last K/V block: the diagonal one (causal) or the one holding key
  // Skv - 1 (bidirectional)
  const int last = kCausal ? qb : (Skv + kKeys - 1) / kKeys - 1;
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

  attn_tile::Rows<DP> st;
  st.init();
  const int row0 = q0 + warp * 16 + lane / 4;
  const uint32_t qa = hopper::smem_u32(sq);
  hopper::mbar_wait(&bars[0], 0);

  for (int kb = 0; kb <= last; ++kb) {
    const int s = kb & 1;
    if (kb < last) {
      // every warp is past block kb - 1, the last reader of stage s ^ 1
      asm volatile("bar.sync 1, 128;\n" ::: "memory");
      if (tid == 0) load_kv<NB>(&tk, &tv, sk + (s ^ 1) * kTile, sv + (s ^ 1) * kTile,
                                &bars[1 + (s ^ 1)], kb + 1, g, b);
    }
    hopper::mbar_wait(&bars[1 + s], (kb >> 1) & 1);
    float sc[32];
    attn_tile::scores<DP>(sc, qa, hopper::smem_u32(sk + s * kTile));
    attn_tile::softmax<DP, kCausal>(sc, st, scale, kb == last, kb * kKeys, row0, nullptr, Skv);
    attn_tile::pv<DP>(st, sc, hopper::smem_u32(sv + s * kTile), nullptr);
  }

  attn_tile::finish<DP>(st);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s = row0 + 8 * r;
    if (s < S) attn_tile::store_row<DP>(st, r, out + b * osb + s * oss + h * osh, D);
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

template <int DP, bool kCausal>
int launch_for_dim(const void* q, const void* k, const void* v, __nv_bfloat16* out, int B,
                   int S, int Skv, int H, int Hkv, int D, const long long* st, float scale,
                   cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int status = encode_bshd(&tq, q, B, S, H, D, st);
  if (status == 0) status = encode_bshd(&tk, k, B, Skv, Hkv, D, st + 3);
  if (status == 0) status = encode_bshd(&tv, v, B, Skv, Hkv, D, st + 6);
  if (status != 0) return status;
  constexpr int bytes = smem_bytes<DP>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<DP, kCausal>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kRows - 1) / kRows, H, B);
  flash_attention_kernel<DP, kCausal><<<grid, kThreads, bytes, stream>>>(
      tq, tk, tv, out, S, Skv, H, Hkv, D, st[9], st[10], st[11], scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int launch_for_mode(const void* q, const void* k, const void* v, __nv_bfloat16* out, int B,
                    int S, int Skv, int H, int Hkv, int D, const long long* st, float scale,
                    int causal, cudaStream_t stream) {
  return causal ? launch_for_dim<DP, true>(q, k, v, out, B, S, Skv, H, Hkv, D, st, scale, stream)
                : launch_for_dim<DP, false>(q, k, v, out, B, S, Skv, H, Hkv, D, st, scale,
                                            stream);
}

}  // namespace

// S queries and Skv keys (causal: Skv == S); strides (in elements): q
// (batch, seq, head), k (...), v (...), out (...); the head-dim stride is 1,
// every stride a multiple of 8 and every base 16-byte aligned (TMA's rules);
// returns hopper::kTensorMapError + the CUresult if a tensor map cannot be
// encoded
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* out,
                                     int B, int S, int Skv, int H, int Hkv, int D,
                                     const long long* strides, float scale, int causal,
                                     void* stream) {
  if (B <= 0 || S <= 0 || Skv <= 0 || Hkv <= 0 || H % Hkv != 0 || (causal && Skv != S)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* op = static_cast<__nv_bfloat16*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (D > 0 && D <= 64 && D % 8 == 0) {
    return launch_for_mode<64>(q, k, v, op, B, S, Skv, H, Hkv, D, strides, scale, causal, s);
  }
  switch (D) {
    case 112:
    case 128:
      return launch_for_mode<128>(q, k, v, op, B, S, Skv, H, Hkv, D, strides, scale, causal, s);
    case 192:
      return launch_for_mode<192>(q, k, v, op, B, S, Skv, H, Hkv, D, strides, scale, causal, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
