// Warp-level tensor-core building blocks for Hopper (sm_90a): ldmatrix,
// 16-byte cp.async with commit groups, the 3xTF32 operand split and the
// mma.sync products (m16n8k8 TF32, m16n8k16 bf16, f32 accumulation).
//
// Fragment layouts of mma.sync.m16n8k{8,16} (row.col), for lane = 4 g + t:
//   C (16 x 8, f32):  c0, c1 at (row g, cols 2t, 2t+1); c2, c3 at row g + 8.
//   bf16 A (16 x 16): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
//                     a3 (g+8, 2t+8..), two bf16 a register, the lower
//                     column in the low half.
//   bf16 B (16 x 8):  b0 (rows 2t, 2t+1; col g), b1 (rows 2t+8, 2t+9; col g).
//   TF32 A (16 x 8):  a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4).
//   TF32 B (8 x 8):   b0 (row t, col g), b1 (row t+4, col g).
// Included by sa_mlp_max.cu, sa_mlp_max_bwd.cu and flash_attention.cu. The
// MLP forward and backward must compute the same products bit for bit
// (sa_mlp_max.cu's note), which one copy of these blocks keeps so.

#pragma once

#include <cuda_bf16.h>

namespace pcot {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// four 8 x 8 b16 matrices; lanes 8j..8j+7 give the row addresses of matrix j,
// and each lane receives (row lane / 4, columns 2 (lane % 4), +1) of each
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// the same, transposed: each lane receives (rows 2 (lane % 4), +1; column lane / 4)
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// cvt.rna.tf32.f32 (to 10 mantissa bits, ties away from zero) for finite x,
// as two integer operations at the ALU's full rate: add half a TF32 ulp to
// the magnitude and clear the 13 low bits. The conversion instruction runs
// at a quarter of that rate and, two per operand, held the MLP kernels'
// products to about a third of the tensor cores' TF32 rate.
__device__ __forceinline__ unsigned tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo, both TF32 values (the low 13 bits zero)
__device__ __forceinline__ void split_tf32(unsigned x, unsigned& hi, unsigned& lo) {
  hi = tf32_rna(__uint_as_float(x));
  lo = tf32_rna(__uint_as_float(x) - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 as a bf16 pair, the first in the low half (round to nearest even)
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

}  // namespace pcot
