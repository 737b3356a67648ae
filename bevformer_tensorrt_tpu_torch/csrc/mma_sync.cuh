// Warp-level tensor-core building blocks shared by the two flash-attention
// kernels (flash_attn.cu, flash_attn_int8.cu): cp.async tile copies,
// ldmatrix, the mma.sync shapes they use and the split of a float into two
// TF32 terms.  Inline PTX only.
//
// Fragment layouts (PTX ISA, "Matrix Fragments for mma.m16n8k*"), with
// g = lane / 4 and t = lane % 4:
//   accumulator (16 x 8, every shape):  c0 (g, 2t)  c1 (g, 2t+1)  c2 (g+8, 2t)  c3 (g+8, 2t+1)
//   m16n8k8 tf32   A: a0 (g, t) a1 (g+8, t) a2 (g, t+4) a3 (g+8, t+4); B: b0 (k t, n g) b1 (k t+4, n g)
//   m16n8k16 bf16  A: a0 (g, 2t..2t+1) a1 (g+8, 2t..) a2 (g, 2t+8..) a3 (g+8, 2t+8..);
//                  B: b0 (k 2t..2t+1, n g) b1 (k 2t+8..2t+9, n g)
//   m16n8k32 s8    A: a0 (g, 4t..4t+3) a1 (g+8, 4t..) a2 (g, 4t+16..) a3 (g+8, 4t+16..);
//                  B: b0 (k 4t..4t+3, n g) b1 (k 4t+16..4t+19, n g)
// Each register holds its elements lowest column (or k) first.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace mma {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; with `valid` false the 16 bytes are zero-filled
// and nothing is read (src must still be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// two 8x8 b16 matrices, transposed: lanes 0-15 give the rows' addresses
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1) : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                                  uint32_t& r3, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(smem_u32(p)));
}

// x = big + small, both TF32: big is x cut to TF32's 10 explicit mantissa
// bits (exact: no rounding), small the 13 bits after them rounded to TF32,
// to nearest, ties away from zero (cvt.rna), so that the tensor core, which
// drops the low 13 bits of an operand, sees it whole.  big + small is x to
// about 2^-22 of |x|; one rounding instead of two per value (measured on
// the H100: the kernel spends less time converting, and the float32 bar of
// 1e-5 is held at ~2.4e-6).
__device__ __forceinline__ void tf32_split(float x, uint32_t& big, uint32_t& small) {
  big = __float_as_uint(x) & 0xffffe000u;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small) : "f"(x - __uint_as_float(big)));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace mma
