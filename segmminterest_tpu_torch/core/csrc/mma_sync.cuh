// Warp-level tensor-core building blocks for sm_80+ (used on sm_90a):
// cp.async staging, ldmatrix and mma.sync m16n8k16 in bf16 with fp32
// accumulators, as inline PTX, so that a kernel sees every fragment's
// coordinates.
//
// Fragment layout of mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32
// (PTX ISA, "Matrix Fragments for mma.m16n8k16"), with g = lane / 4 and
// t = lane % 4:
//   A (16 x 16, row major), four 32-bit registers of two bf16 each:
//     a[0] = (row g,     cols 2t, 2t+1)     a[1] = (row g + 8, cols 2t, 2t+1)
//     a[2] = (row g,     cols 2t+8, 2t+9)   a[3] = (row g + 8, cols 2t+8, 2t+9)
//   B (16 x 8, K x N), two registers: b[0] = (rows 2t, 2t+1, col g),
//     b[1] = (rows 2t+8, 2t+9, col g)
//   C, D (16 x 8, fp32): c[0], c[1] = (row g, cols 2t, 2t+1),
//     c[2], c[3] = (row g + 8, cols 2t, 2t+1)
// The lower column of a bf16 pair sits in the lower 16 bits. The C fragments
// of two neighbouring n8 tiles are, once rounded to bf16, the A fragment of
// one k16 step: a[0..1] from the first tile's c, a[2..3] from the second's.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace segmm {

// 16-byte asynchronous copy global -> shared (sm_80+); fills zeros when
// `valid` is false, reading nothing from `src`.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
}
// 4-byte asynchronous copy global -> shared, zeros when `valid` is false.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Four 8x8 bf16 matrices from shared memory: lane l gives the address of
// row l % 8 of matrix l / 8 (16 contiguous bytes, 16-byte aligned); r[m] is
// this lane's part of matrix m, (row g, cols 2t, 2t+1).
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(row)));
}

// The same, each matrix transposed: r[m] holds (rows 2t, 2t+1, col g) of
// the stored matrix m.
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(row)));
}

// d += a . b on the bf16 tensor cores, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 (nearest even) in one register, `lo` in the
// lower half.
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// x = hi + lo to about 2^-17 relative: hi = bf16(x), lo = bf16(x - hi).
__device__ __forceinline__ void split_bf16(float x, float& hi, float& lo) {
  hi = __bfloat162float(__float2bfloat16_rn(x));
  lo = x - hi;
}

}  // namespace segmm
