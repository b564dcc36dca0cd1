// Device functions of the mma.sync bf16 kernels (B6, csrc/ssd_scan.cu, and
// the paged MLA decode attention, csrc/mla_decode_attention.cu): 16-byte
// cp.async, ldmatrix (plain and .trans), the m16n8k16 bf16 mma with float32
// accumulation, and the split of float32 values into three bf16 terms that
// hold them exactly.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tc_bf16 {

// bf16 terms a float32 value is split into (split3_bf16x2)
constexpr int kSplitTerms = 3;

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

// c[16 x 8] += a[16 x 16] . b[16 x 8], bf16 in, f32 out (mma.sync fragments,
// g = lane / 4, q = lane % 4: a0 row g, a1 row g + 8, k 2q + {0, 1}; a2 / a3
// the same rows, k 8 + 2q + {0, 1}; b0 k 2q + {0, 1}, b1 k 8 + 2q + {0, 1},
// column g; c0 / c1 row g, c2 / c3 row g + 8, columns 2q + {0, 1})
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x0, x1 as kSplitTerms bf16 pairs (x0 in the low half): term i is the top 8
// significant bits of what terms 0..i-1 leave (the high half of its float32
// bits; the remainder is exact), so the three sum back to x exactly
// wherever |x| >= 2^-110 (below it, a term among the subnormals keeps the
// bits of their top half only: within 2^-133 of x)
__device__ __forceinline__ void split3_bf16x2(float x0, float x1,
                                              uint32_t (&t)[kSplitTerms]) {
#pragma unroll
  for (int i = 0; i < kSplitTerms; ++i) {
    const uint32_t b0 = __float_as_uint(x0);
    const uint32_t b1 = __float_as_uint(x1);
    t[i] = __byte_perm(b0, b1, 0x7632);  // k 2q: low half
    x0 -= __uint_as_float(b0 & 0xFFFF0000u);
    x1 -= __uint_as_float(b1 & 0xFFFF0000u);
  }
}

}  // namespace tc_bf16
