// int8 pieces shared by the port's W8A8 kernels: the s8 tensor-core MMA
// (mma.sync m16n8k32, int32 accumulate), its fragment loads, and the JAX
// package's symmetric quantization (scale = max|row| / 127 floored at 1e-8;
// q = round(v / scale) half to even, clipped to +-127).
//
// Fragment layouts of mma.sync.m16n8k32 s8 (PTX ISA), g = lane / 4, t = lane % 4:
//   A (16x32, row-major): reg0 = A[g][4t..4t+3]      reg1 = A[g+8][4t..4t+3]
//                          reg2 = A[g][16+4t..+3]     reg3 = A[g+8][16+4t..+3]
//   B (32x8, k x n):       reg0 = B[4t..4t+3][g]      reg1 = B[16+4t..+3][g]
//   C (16x8, s32):         as the bf16 MMA's C (common.cuh)
// The four bytes of a register are four consecutive k, lowest byte first.
#pragma once

#include <stdint.h>

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// round(v / s) half to even, clipped to +-127
__device__ __forceinline__ signed char quant(float v, float s) {
  const int q = __float2int_rn(__fdiv_rn(v, s));
  return (signed char)max(-127, min(127, q));
}

__device__ __forceinline__ float row_scale(float amax) {
  return fmaxf(__fdiv_rn(amax, 127.f), 1e-8f);
}

// Four int8 values (the low bytes of a..d) as one register, a lowest.
__device__ __forceinline__ uint32_t pack_s8(int a, int b, int c, int d) {
  return (uint32_t)(a & 0xff) | ((uint32_t)(b & 0xff) << 8) |
         ((uint32_t)(c & 0xff) << 16) | ((uint32_t)(d & 0xff) << 24);
}

// A fragment (16 x 32 int8, row-major) at `base` with row stride ld bytes.
__device__ __forceinline__ void load_a8(uint32_t* a, const signed char* base,
                                        int ld, int lane) {
  const signed char* p0 = base + (lane >> 2) * ld + 4 * (lane & 3);
  const signed char* p1 = p0 + 8 * ld;
  a[0] = *reinterpret_cast<const uint32_t*>(p0);
  a[1] = *reinterpret_cast<const uint32_t*>(p1);
  a[2] = *reinterpret_cast<const uint32_t*>(p0 + 16);
  a[3] = *reinterpret_cast<const uint32_t*>(p1 + 16);
}

// B fragment (k 32 x n 8) from a matrix stored n-major, w[n * ld + k], in
// shared memory.
__device__ __forceinline__ void load_b8_s(uint32_t* b, const signed char* w,
                                          int ld, int lane) {
  const signed char* p = w + (lane >> 2) * ld + 4 * (lane & 3);
  b[0] = *reinterpret_cast<const uint32_t*>(p);
  b[1] = *reinterpret_cast<const uint32_t*>(p + 16);
}

// Four 8x8 b16 matrices from shared memory (ldmatrix .x4): lane l gives the
// address of row l % 8 of matrix l / 8, and receives in r[i] the bytes
// 4t..4t+3 of row g of matrix i (g = lane / 4, t = lane % 4): for int8 data
// with rows of 16 bytes that is an A or B fragment register as laid out above.
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}
