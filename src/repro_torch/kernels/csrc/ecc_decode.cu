// On-die ECC decode of flash pages (paper section VI, Fig. 8b):
//   out uint8 [B, P] = decode(pages uint8 [B, P], sidecar)
// with the sidecar of each page: threshold copies uint8 [T], addresses
// int32 [K], their 5-bit Hamming parity uint8 [K], value copies uint8 [K, 2].
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/ecc_decode/ecc_decode.py::ecc_decode_pages
// together with its front end ecc_decode_op (kernels/ecc_decode/ops.py),
// whose bit twiddling (threshold vote, Hamming correction, value vote) runs
// here inside the kernel.  Per page:
//   1. thr = per-bit majority of the T threshold copies;
//   2. each entry's address is Hamming-corrected (valid = syndrome <= 19)
//      and its value voted: majority of {in-page value, copy0, copy1};
//   3. every value with |v| > thr is clamped to 0;
//   4. each entry writes voted (valid) or the clamped in-page value
//      (invalid) at its address, in entry order, so where entries collide
//      the last one wins.
// That is core/ecc.py::decode_pages of the port bit for bit (the plain
// version, which fixes the same collision rule); JAX leaves the order at
// colliding addresses to the implementation.
//
// What bounds it on the H100: each page is read once and written once
// (2 x 16 KB) beside ~0.7 KB of sidecar, and the work per byte is a few
// integer operations, so it is bound by device memory bytes.
//
// Design: one CTA of 256 threads per page.  The page is staged in 16 KB of
// shared memory with 16-byte vector loads while warp 0 loads the sidecar;
// warp 0 then votes and corrects every entry (8 rounds of 32 lanes hold
// K <= 256 entries in registers) and reads each addressed value before the
// clamp; all threads clamp the page in place, 16 bytes at a time; warp 0
// applies the restores round by round, and inside a round
// __match_any_sync leaves each address to its highest lane, the last entry;
// one coalesced vector store writes the page out.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRounds = 8;  // entries per lane of warp 0: K <= 256

// codeword position (1-based, of the 19) of each of the 14 address bits
__constant__ int kDataPos[14] = {3, 5, 6, 7, 9, 10, 11, 12, 13, 14, 15, 17, 18, 19};

__device__ __forceinline__ uint32_t clamp_byte(uint32_t byte, int thr) {
  const int v = static_cast<int>(static_cast<int8_t>(static_cast<uint8_t>(byte)));
  const int mag = v < 0 ? -v : v;
  return mag > thr ? 0u : byte;
}

__device__ __forceinline__ int clamp_word(int word, int thr) {
  const uint32_t w = static_cast<uint32_t>(word);
  uint32_t out = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) out |= clamp_byte((w >> (8 * b)) & 0xFFu, thr) << (8 * b);
  return static_cast<int>(out);
}

__global__ void __launch_bounds__(kThreads)
ecc_decode_kernel(const uint8_t* __restrict__ pages, const uint8_t* __restrict__ thr_copies,
                  const int32_t* __restrict__ addr, const uint8_t* __restrict__ parity,
                  const uint8_t* __restrict__ copies, uint8_t* __restrict__ out, int P,
                  int K, int T) {
  extern __shared__ int4 page4[];  // P bytes
  uint8_t* page = reinterpret_cast<uint8_t*>(page4);
  const size_t b = blockIdx.x;
  const int nvec = P / 16;
  const int lane = threadIdx.x % 32;
  const bool warp0 = threadIdx.x < 32;

  // 1. stage the page; warp 0 loads its entries' sidecar words meanwhile
  const int4* src4 = reinterpret_cast<const int4*>(pages + b * P);
  for (int v = threadIdx.x; v < nvec; v += kThreads) page4[v] = __ldg(src4 + v);
  int e_addr[kRounds];
  uint32_t e_par[kRounds], e_c0[kRounds], e_c1[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int i = lane + 32 * r;
    e_addr[r] = -1 - lane;  // a key no real address matches
    e_par[r] = e_c0[r] = e_c1[r] = 0;
    if (warp0 && i < K) {
      const size_t e = b * K + i;
      e_addr[r] = __ldg(addr + e);
      e_par[r] = __ldg(parity + e);
      e_c0[r] = __ldg(copies + 2 * e);
      e_c1[r] = __ldg(copies + 2 * e + 1);
    }
  }
  int thr = 0;  // per-bit majority of the T threshold copies
  for (int bit = 0; bit < 8; ++bit) {
    int count = 0;
    for (int j = 0; j < T; ++j) count += (__ldg(thr_copies + b * T + j) >> bit) & 1;
    if (count > T / 2) thr |= 1 << bit;
  }
  __syncthreads();

  // 2. warp 0: correct each address, vote each value from the page as read
  uint32_t e_val[kRounds];
  if (warp0) {
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      e_val[r] = 0;
      if (lane + 32 * r < K) {
        const int a = e_addr[r];
        int syn = static_cast<int>(e_par[r] & 31u);
#pragma unroll
        for (int k = 0; k < 14; ++k) {
          if ((a >> k) & 1) syn ^= kDataPos[k];
        }
        int fixed = a;
#pragma unroll
        for (int k = 0; k < 14; ++k) {
          if (syn == kDataPos[k]) fixed ^= 1 << k;
        }
        fixed = min(max(fixed, 0), P - 1);
        const uint32_t orig = page[fixed];
        const uint32_t voted = (orig & e_c0[r]) | (orig & e_c1[r]) | (e_c0[r] & e_c1[r]);
        e_addr[r] = fixed;
        e_val[r] = syn <= 19 ? voted : clamp_byte(orig, thr);
      }
    }
  }
  __syncthreads();

  // 3. clamp every value above the threshold, 16 bytes per step
  for (int v = threadIdx.x; v < nvec; v += kThreads) {
    int4 w = page4[v];
    w.x = clamp_word(w.x, thr);
    w.y = clamp_word(w.y, thr);
    w.z = clamp_word(w.z, thr);
    w.w = clamp_word(w.w, thr);
    page4[v] = w;
  }
  __syncthreads();

  // 4. restores in entry order: rounds in sequence, and inside a round the
  //    highest lane (the later entry) of each address writes
  if (warp0) {
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const unsigned peers = __match_any_sync(0xffffffffu, e_addr[r]);
      if (lane + 32 * r < K && lane == 31 - __clz(peers)) {
        page[e_addr[r]] = static_cast<uint8_t>(e_val[r]);
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // 5. one coalesced store
  int4* dst4 = reinterpret_cast<int4*>(out + b * P);
  for (int v = threadIdx.x; v < nvec; v += kThreads) dst4[v] = page4[v];
}

}  // namespace

// P % 16 == 0, P <= 48 KB, both page pointers 16-byte aligned, K <= 256
extern "C" int repro_ecc_decode(const void* pages, const void* thr_copies, const void* addr,
                                const void* parity, const void* copies, void* out, int B,
                                int P, int K, int T, void* stream) {
  if (B <= 0 || P <= 0 || P % 16 || P > 48 * 1024 || K <= 0 || K > 32 * kRounds || T <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ecc_decode_kernel<<<B, kThreads, P, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(pages), static_cast<const uint8_t*>(thr_copies),
      static_cast<const int32_t*>(addr), static_cast<const uint8_t*>(parity),
      static_cast<const uint8_t*>(copies), static_cast<uint8_t*>(out), P, K, T);
  return static_cast<int>(cudaGetLastError());
}
