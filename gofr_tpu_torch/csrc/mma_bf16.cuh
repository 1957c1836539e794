// Helpers shared by the flash-attention kernels: the strides a kernel is
// given and the bf16 tensor-core product (mma.sync m16n8k16) with its
// operand packing. Internal to each translation unit.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

struct Strides {
  int64_t qb, qs, qh, kb, ks, kh, vb, vs, vh;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// c += a (16x16, row) * b (16x8, col), bf16 inputs, f32 accumulators.
// Fragment layout (g = lane / 4, t = lane % 4):
//   A regs 0..3: (row g, cols 2t..2t+1), (g+8, 2t..), (g, 2t+8..), (g+8, 2t+8..)
//   B regs 0..1: (k 2t..2t+1, col g), (k 2t+8..2t+9, col g)
//   C 0..3:      (row g, cols 2t, 2t+1), (row g+8, cols 2t, 2t+1)
// A C tile of n-tiles 2i and 2i+1 is, packed to bf16, the A operand of
// k-step i of the next product (the FlashAttention-2 register hand-off).
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace
