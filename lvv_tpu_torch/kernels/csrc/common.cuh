// Shared pieces of the port's hand-written Hopper kernels: bf16 tensor-core
// MMA (mma.sync m16n8k16, fp32 accumulate) with explicit fragment layouts,
// and the online-softmax loop that the attention kernels share.
//
// Fragment layouts of mma.sync.m16n8k16 (PTX ISA, "Matrix Fragments for
// mma.m16n8k16"), with g = lane / 4 and t = lane % 4:
//   A (16x16, row-major): reg0 = A[g][2t..2t+1]    reg1 = A[g+8][2t..2t+1]
//                          reg2 = A[g][2t+8..+9]    reg3 = A[g+8][2t+8..+9]
//   B (16x8, k x n):       reg0 = B[2t..2t+1][g]    reg1 = B[2t+8..+9][g]
//   C (16x8, fp32):        c0,c1 = C[g][2t..2t+1]  c2,c3 = C[g+8][2t..2t+1]
// Because the C layout is known, softmax statistics and epilogues work on
// the accumulators in registers (no shared-memory round trip).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

#define LVV_NEG_BIG (-1e30f)   // masked score, as the JAX kernels use
#define LVV_LOG2E 1.4426950408889634f

__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ float bf(bf16 v) { return __bfloat162float(v); }

// a norm parameter, bf16 or fp32, as a float
__device__ __forceinline__ float param_f(bf16 v) { return bf(v); }
__device__ __forceinline__ float param_f(float v) { return v; }

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// A fragment of the 16x16 block at `base` of a row-major tile (ld elements).
__device__ __forceinline__ void load_a(uint32_t* a, const bf16* base, int ld,
                                       int lane) {
  const bf16* p0 = base + (lane >> 2) * ld + 2 * (lane & 3);
  const bf16* p1 = p0 + 8 * ld;
  a[0] = *reinterpret_cast<const uint32_t*>(p0);
  a[1] = *reinterpret_cast<const uint32_t*>(p1);
  a[2] = *reinterpret_cast<const uint32_t*>(p0 + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p1 + 8);
}

// B fragment (k 16 x n 8) from a tile stored n-major: base[n * ld + k]
// (rows of K in attention: the score product contracts over their last dim).
__device__ __forceinline__ void load_b_nk(uint32_t* b, const bf16* base,
                                          int ld, int lane) {
  const bf16* p = base + (lane >> 2) * ld + 2 * (lane & 3);
  b[0] = *reinterpret_cast<const uint32_t*>(p);
  b[1] = *reinterpret_cast<const uint32_t*>(p + 8);
}

// B fragment (k 16 x n 8) from a tile stored k-major: base[k * ld + n]
// (rows of V, rows of a weight matrix [in, out]).
__device__ __forceinline__ void load_b_kn(uint32_t* b, const bf16* base,
                                          int ld, int lane) {
  const bf16* p = base + 2 * (lane & 3) * ld + (lane >> 2);
  b[0] = pack_bf16(p[0], p[ld]);
  b[1] = pack_bf16(p[8 * ld], p[9 * ld]);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

constexpr int kBQ = 64;        // q rows per block (16 per warp)
constexpr int kBK = 64;        // kv rows per tile
constexpr int kAttnThreads = 128;

// Copy rows [0, kBK) of a kv tile into shared memory (row ld = D + 8),
// 16 bytes per thread and step; rows at or past `n_valid` are zero-filled.
template <int D>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          long long row_stride, int n_valid) {
  constexpr int LD = D + 8;
  for (int i = threadIdx.x; i < kBK * D / 8; i += kAttnThreads) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < n_valid)
      v = *reinterpret_cast<const uint4*>(src + r * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = v;
  }
}

// bf16 scores of this warp's 16 q rows (q_s, row ld D + 8) against the kv
// tile in k_s: s[j] is the C fragment of kv columns 8j .. 8j + 7.
template <int D>
__device__ __forceinline__ void qk_bf16(float (&s)[kBK / 8][4],
                                        const bf16* q_s, const bf16* k_s) {
  constexpr int LD = D + 8;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    load_a(a, q_s + warp * 16 * LD + kk * 16, LD, lane);
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      uint32_t b[2];
      load_b_nk(b, k_s + j * 8 * LD + kk * 16, LD, lane);
      mma16816(s[j], a, b);
    }
  }
}

// o += P @ V for this warp's 16 rows: P (in the C fragment layout of the
// kv tile's scores) rounded to bf16 straight from the accumulators, V the
// tile in v_s (row ld D + 8).
template <int D>
__device__ __forceinline__ void pv_bf16(float (&o)[D / 8][4],
                                        const float (&s)[kBK / 8][4],
                                        const bf16* v_s) {
  constexpr int LD = D + 8;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kc = 0; kc < kBK / 16; ++kc) {
    uint32_t a[4];
    a[0] = pack_f32(s[2 * kc][0], s[2 * kc][1]);
    a[1] = pack_f32(s[2 * kc][2], s[2 * kc][3]);
    a[2] = pack_f32(s[2 * kc + 1][0], s[2 * kc + 1][1]);
    a[3] = pack_f32(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      uint32_t b[2];
      load_b_kn(b, v_s + kc * 16 * LD + j * 8, LD, lane);
      mma16816(o[j], a, b);
    }
  }
}

// Online-softmax attention of a 64-row q tile over kv positions [0, kv_end),
// one warp per 16 q rows.
//   load_kv(k0):  fills the kv tile k0 .. k0 + kBK in shared memory (v_s
//                 holds V, row ld D + 8, zero past the end)
//   scores(k0, s): the log2-domain logits of this warp's rows against that
//                 tile, in the C fragment layout (LVV_NEG_BIG where masked)
// On return o holds the unnormalised output rows g and g + 8 of this warp
// and l0 / l1 their softmax denominators.
template <int D, class LoadKV, class Scores>
__device__ __forceinline__ void flash_loop(const bf16* v_s, int kv_end,
                                           LoadKV load_kv, Scores scores,
                                           float (&o)[D / 8][4], float& l0,
                                           float& l1) {
  float m0 = LVV_NEG_BIG, m1 = LVV_NEG_BIG;
  l0 = 0.f;
  l1 = 0.f;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // every warp is done with the previous kv tile
    load_kv(k0);
    __syncthreads();
    float s[kBK / 8][4];
    scores(k0, s);
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    const float alpha0 = exp2f(m0 - mx0), alpha1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      s[j][0] = exp2f(s[j][0] - m0);
      s[j][1] = exp2f(s[j][1] - m0);
      s[j][2] = exp2f(s[j][2] - m1);
      s[j][3] = exp2f(s[j][3] - m1);
      ps0 += s[j][0] + s[j][1];
      ps1 += s[j][2] + s[j][3];
    }
    l0 = l0 * alpha0 + quad_sum(ps0);
    l1 = l1 * alpha1 + quad_sum(ps1);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[j][0] *= alpha0;
      o[j][1] *= alpha0;
      o[j][2] *= alpha1;
      o[j][3] *= alpha1;
    }
    pv_bf16<D>(o, s, v_s);
  }
  l0 = fmaxf(l0, 1e-30f);  // guard, as the JAX kernel's finalize does
  l1 = fmaxf(l1, 1e-30f);
}

// The log2-domain scores of this warp's rows against the kv tile at k0:
// bf16 q·k (q_s / k_s, row ld D + 8), then
//   score(acc, row, col): the logit of tile row `row` (0..63) and kv
//                         position `col`, given acc = q·k
template <int D, class Score>
__device__ __forceinline__ void qk_scores(float (&s)[kBK / 8][4],
                                          const bf16* q_s, const bf16* k_s,
                                          int k0, Score score) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = lane & 3;
  const int r0 = warp * 16 + (lane >> 2), r1 = r0 + 8;
  qk_bf16<D>(s, q_s, k_s);
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j) {
    const int col = k0 + j * 8 + 2 * t;
    s[j][0] = score(s[j][0], r0, col);
    s[j][1] = score(s[j][1], r0, col + 1);
    s[j][2] = score(s[j][2], r1, col);
    s[j][3] = score(s[j][3], r1, col + 1);
  }
}

// flash_loop with the bf16 q·k scores of qk_scores.
template <int D, class LoadKV, class Score>
__device__ __forceinline__ void flash_tile(const bf16* q_s, const bf16* k_s,
                                           const bf16* v_s, int kv_end,
                                           LoadKV load_kv, Score score,
                                           float (&o)[D / 8][4], float& l0,
                                           float& l1) {
  auto scores = [&](int k0, float (&s)[kBK / 8][4]) {
    qk_scores<D>(s, q_s, k_s, k0, score);
  };
  flash_loop<D>(v_s, kv_end, load_kv, scores, o, l0, l1);
}

// Raise a kernel's dynamic shared-memory limit above the 48 KB default.
template <class K>
static cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}
