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
// (2 x 16 KB) beside ~1.2 KB of sidecar, and the work per byte is a few
// integer operations, so it is bound by device memory bytes.  Staging the
// page in shared memory and leaving the entries to one warp would keep the
// other warps waiting with no load in flight; so the page stays in
// registers, and every warp works on the entries.
//
// Design: one CTA of 256 threads per page, the page in registers.
//  * Every thread first issues its 16-byte loads of the page (64 bytes a
//    thread for 16 KB), and keeps them in registers until the one store.
//  * Meanwhile thread t < K takes entry t: its sidecar words, its corrected
//    address, and its voted value from the in-page byte at that address as
//    read (a one-byte load that the page's own loads bring into L1 / L2).
//    Warp 0 votes the threshold once, by ballots over the T copies.
//  * Step 4 in parallel: entry t restores its address only if no later
//    entry names the same one (K^2 / 2 compares of addresses in shared
//    memory, four at a time).  An invalid last entry writes the clamped
//    in-page value, which the clamp already gives, so only valid last
//    entries patch.  Each links itself into a list of the thread whose
//    registers hold its byte (atomicExch on that thread's list head).
//  * Each thread clamps its 64 bytes with thr, four bytes per few integer
//    operations, patches the bytes its list names, and stores: the page
//    reaches device memory in one pass.
// Shared memory is ~3.3 KB a CTA, so 6 CTAs (6 pages, 96 KB of loads) fit
// on an SM at once; their loads overlap the entries' work of the others.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// codeword position (1-based, of the 19) of each of the 14 address bits
__constant__ int kDataPos[14] = {3, 5, 6, 7, 9, 10, 11, 12, 13, 14, 15, 17, 18, 19};

// the four int8 values of a word with |v| > thr set to 0, all four at once:
// |v| per byte is (v ^ s) + (s & 1) with s = 0xFF in negative bytes (0..128,
// no carry between bytes), and |v| + 127 - thr reaches bit 7 exactly when
// |v| > thr (at most 255: no carry either); no |v| exceeds thr >= 128
__device__ __forceinline__ int clamp_word(int word, int thr) {
  if (thr >= 128) return word;
  const uint32_t x = static_cast<uint32_t>(word);
  const uint32_t neg = (x >> 7) & 0x01010101u;
  const uint32_t mag = (x ^ (neg * 0xFFu)) + neg;
  const uint32_t over = (mag + (127u - static_cast<uint32_t>(thr)) * 0x01010101u) & 0x80808080u;
  return static_cast<int>(x & ~((over >> 7) * 0xFFu));
}

// byte `byte` (0..15) of a 16-byte vector set to `val`
__device__ __forceinline__ void put_byte(int4& w, int byte, uint32_t val) {
  const int sh = 8 * (byte & 3);
  const int word = byte >> 2;
  const int keep = static_cast<int>(~(0xFFu << sh));
  const int add = static_cast<int>(val << sh);
  w.x = word == 0 ? (w.x & keep) | add : w.x;
  w.y = word == 1 ? (w.y & keep) | add : w.y;
  w.z = word == 2 ? (w.z & keep) | add : w.z;
  w.w = word == 3 ? (w.w & keep) | add : w.w;
}

// VPT: 16-byte vectors of the page per thread (vector i in thread i % 256)
template <int VPT>
__global__ void __launch_bounds__(kThreads, VPT <= 4 ? 6 : 2)
ecc_decode_kernel(const uint8_t* __restrict__ pages, const uint8_t* __restrict__ thr_copies,
                  const int32_t* __restrict__ addr, const uint8_t* __restrict__ parity,
                  const uint8_t* __restrict__ copies, uint8_t* __restrict__ out, int P,
                  int K, int T) {
  __shared__ __align__(16) int addr_s[kThreads];  // entry t's corrected address; -1 past K
  __shared__ int head_s[kThreads];                // thread t's list of restores
  __shared__ int next_s[kThreads];
  __shared__ uint8_t val_s[kThreads];
  __shared__ int thr_s;
  const size_t b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nvec = P / 16;

  // 1. the page into registers
  const int4* src4 = reinterpret_cast<const int4*>(pages + b * P);
  int4 v[VPT];
#pragma unroll
  for (int r = 0; r < VPT; ++r) {
    const int i = tid + kThreads * r;
    v[r] = i < nvec ? __ldg(src4 + i) : make_int4(0, 0, 0, 0);
  }

  // 2. entry tid: corrected address, validity, voted value
  int fixed = -1;
  bool valid = false;
  uint32_t voted = 0;
  if (tid < K) {
    const size_t e = b * K + tid;
    const int a = __ldg(addr + e);
    int syn = static_cast<int>(__ldg(parity + e) & 31u);
    const uint32_t c0 = __ldg(copies + 2 * e);
    const uint32_t c1 = __ldg(copies + 2 * e + 1);
#pragma unroll
    for (int k = 0; k < 14; ++k) {
      if ((a >> k) & 1) syn ^= kDataPos[k];
    }
    fixed = a;
#pragma unroll
    for (int k = 0; k < 14; ++k) {
      if (syn == kDataPos[k]) fixed ^= 1 << k;
    }
    fixed = min(max(fixed, 0), P - 1);
    valid = syn <= 19;
    const uint32_t orig = __ldg(pages + b * P + fixed);  // the page as read
    voted = (orig & c0) | (orig & c1) | (c0 & c1);
  }
  addr_s[tid] = fixed;
  head_s[tid] = -1;
  if (tid < 32) {  // per-bit majority of the T threshold copies, by ballots
    int thr = 0;
    for (int bit = 0; bit < 8; ++bit) {
      int count = 0;
      for (int j0 = 0; j0 < T; j0 += 32) {
        const uint32_t c = j0 + tid < T ? __ldg(thr_copies + b * T + j0 + tid) : 0u;
        count += __popc(__ballot_sync(0xffffffffu, (c >> bit) & 1u));
      }
      if (count > T / 2) thr |= 1 << bit;
    }
    if (tid == 0) thr_s = thr;
  }
  __syncthreads();

  // 3. the last entry at each address restores it (valid ones only: an
  //    invalid one writes the clamped value the clamp already leaves)
  if (tid < K) {
    bool later = false;
    for (int j = (tid + 1) & ~3; j < K; j += 4) {
      const int4 w = *reinterpret_cast<const int4*>(addr_s + j);
      later |= (w.x == fixed && j > tid) | (w.y == fixed && j + 1 > tid) |
               (w.z == fixed && j + 2 > tid) | (w.w == fixed && j + 3 > tid);
    }
    if (!later && valid) {
      val_s[tid] = static_cast<uint8_t>(voted);
      next_s[tid] = atomicExch(&head_s[(fixed >> 4) % kThreads], tid);
    }
  }
  __syncthreads();

  // 4. clamp, patch this thread's restores, one store
  const int thr = thr_s;
#pragma unroll
  for (int r = 0; r < VPT; ++r) {
    v[r].x = clamp_word(v[r].x, thr);
    v[r].y = clamp_word(v[r].y, thr);
    v[r].z = clamp_word(v[r].z, thr);
    v[r].w = clamp_word(v[r].w, thr);
  }
  for (int e = head_s[tid]; e >= 0; e = next_s[e]) {
    const int a = addr_s[e];
    const int slot = (a >> 4) / kThreads;
#pragma unroll
    for (int r = 0; r < VPT; ++r) {
      if (r == slot) put_byte(v[r], a & 15, val_s[e]);
    }
  }
  int4* dst4 = reinterpret_cast<int4*>(out + b * P);
#pragma unroll
  for (int r = 0; r < VPT; ++r) {
    const int i = tid + kThreads * r;
    if (i < nvec) dst4[i] = v[r];
  }
}

}  // namespace

// P % 16 == 0, P <= 48 KB, both page pointers 16-byte aligned, K <= 256
extern "C" int repro_ecc_decode(const void* pages, const void* thr_copies, const void* addr,
                                const void* parity, const void* copies, void* out, int B,
                                int P, int K, int T, void* stream) {
  if (B <= 0 || P <= 0 || P % 16 || P > 48 * 1024 || K <= 0 || K > kThreads || T <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* pg = static_cast<const uint8_t*>(pages);
  const auto* th = static_cast<const uint8_t*>(thr_copies);
  const auto* ad = static_cast<const int32_t*>(addr);
  const auto* pa = static_cast<const uint8_t*>(parity);
  const auto* cp = static_cast<const uint8_t*>(copies);
  auto* o = static_cast<uint8_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (P <= 4 * 16 * kThreads) {
    ecc_decode_kernel<4><<<B, kThreads, 0, s>>>(pg, th, ad, pa, cp, o, P, K, T);
  } else {
    ecc_decode_kernel<12><<<B, kThreads, 0, s>>>(pg, th, ad, pa, cp, o, P, K, T);
  }
  return static_cast<int>(cudaGetLastError());
}
