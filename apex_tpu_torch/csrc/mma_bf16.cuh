// Helpers shared by the kernels (decode_attention.cu, decode_sampling.cu,
// flash_attention.cu, fused_ce.cu): mma.sync.m16n8k16 with bf16 or fp16
// inputs (the element type T, bf16 unless named) and fp32 accumulators,
// the ldmatrix loads that fill its operands from shared memory (b16:
// the same for both types), the quad reductions over a fragment row, and
// 16-, 8- and 4-byte cp.async copies.
//
// Fragment layout (PTX ISA, mma.m16n8k16): lane = 4 * g + t holds, of
// the 16 x 8 accumulator, rows g and g + 8 at columns 2t and 2t + 1
// (d[0], d[1] row g; d[2], d[3] row g + 8); of the 16 x 16 A operand,
// a[0] = (g, 2t..2t+1), a[1] = (g + 8, 2t..), a[2] = (g, 2t + 8..),
// a[3] = (g + 8, 2t + 8..); of the 16 x 8 B operand, b0 = (k 2t..2t+1,
// n g), b1 = (k 2t + 8.., n g).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <type_traits>

namespace apex_mma {

using bf16 = __nv_bfloat16;
using f16 = __half;

// d += a . b (16 x 16 by 16 x 8), T (bf16 or fp16) in, fp32 accumulate.
template <typename T = bf16>
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  static_assert(std::is_same<T, bf16>::value || std::is_same<T, f16>::value,
                "mma16816 takes bf16 or fp16");
  if constexpr (std::is_same<T, f16>::value) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// Two fp32 values rounded to T (nearest even), lo in the low half.
template <typename T = bf16>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<T, f16>::value) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Four 8 x 8 matrices of a 2-byte type; lane l gives the address of row
// (l & 7) of matrix l >> 3 (16-byte aligned).
template <typename T>
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const T* p) {
  static_assert(sizeof(T) == 2, "ldmatrix .b16 reads 2-byte values");
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// Two 8 x 8 matrices; lanes 0-15 give the row addresses as for x4.
template <typename T>
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const T* p) {
  static_assert(sizeof(T) == 2, "ldmatrix .b16 reads 2-byte values");
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// The same, each matrix transposed on the way in.
template <typename T>
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const T* p) {
  static_assert(sizeof(T) == 2, "ldmatrix .b16 reads 2-byte values");
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// A fragment of the 16 x 16 block at (m0, k0) of row-major X (row stride
// ld elements, a multiple of 8).
template <typename T>
__device__ __forceinline__ void ld_a(uint32_t (&a)[4], const T* X, int ld, int m0,
                                     int k0, int lane) {
  ldmatrix_x4(a, X + (m0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8);
}

// B fragments of two neighbouring n-tiles, columns n0..n0+15, depth
// k0..k0+15, from Y stored n-major (Y[n * ld + k], "col" operand):
// b[0], b[1] for columns n0..n0+7, b[2], b[3] for n0+8..n0+15.
template <typename T>
__device__ __forceinline__ void ld_b_nk(uint32_t (&b)[4], const T* Y, int ld, int n0,
                                        int k0, int lane) {
  ldmatrix_x4(b, Y + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 +
                     ((lane >> 3) & 1) * 8);
}

// b[0], b[1] of ld_b_nk alone: one n-tile, columns n0..n0+7.
template <typename T>
__device__ __forceinline__ void ld_b_nk1(uint32_t (&b)[2], const T* Y, int ld, int n0,
                                         int k0, int lane) {
  ldmatrix_x2(b, Y + (n0 + (lane & 7)) * ld + k0 + ((lane >> 3) & 1) * 8);
}

// The same from Y stored k-major (Y[k * ld + n], row-major K x N).
template <typename T>
__device__ __forceinline__ void ld_b_kn(uint32_t (&b)[4], const T* Y, int ld, int n0,
                                        int k0, int lane) {
  ldmatrix_x4_trans(b, Y + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 +
                           (lane >> 4) * 8);
}

// Max / sum over the quad (4 lanes) that holds one fragment row.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// 16-byte asynchronous copy global -> shared (both 16-byte aligned);
// the first src_bytes come from src, the rest are zeros (src_bytes 0:
// nothing is read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
// The same for 8 bytes (8-byte aligned), through L1.
__device__ __forceinline__ void cp_async8(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
// The same for 4 bytes (4-byte aligned), through L1.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace apex_mma
