// The int8 p@v online softmax shared by the rel-pos attention kernels
// (relpos_attention.cu's K-d8 arm and flash_attention_relpos.cu's int8 arm
// of K-h): p quantized per row and per GROUP of kv columns against the
// group's own maximum, sp = max(exp2(gmax - m_new), 1e-30),
// p8 = round(p·127/sp), o = o·alpha + (z·(sp/127))·sv with z the int32 sum
// of p8 @ v8 over the group; l sums the unquantized p. A 64-column tile
// cannot see its group's maximum, so each group is walked twice: once for
// the row maxima of its scores, once to quantize and accumulate. p8 goes
// from the score accumulators into the s8 A fragment in registers: the kv
// order inside a 32-deep step is permuted the same way in the B fragments,
// which are read two bytes at a time from the transposed v8 tile.
#pragma once

#include "common.cuh"
#include "int8.cuh"

constexpr int kLDV8 = kBK + 16;  // row of the transposed int8 v tile, bytes

__device__ __forceinline__ uint32_t ld_u16(const signed char* p) {
  return *reinterpret_cast<const uint16_t*>(p);
}

// The PV8 online softmax over kv [0, s) in groups of `group` columns (a
// multiple of kBK). load_k(k0) fills k_s, load_v8(k0) the int8 v tile v8_s
// ([d][kLDV8], kv along a row), scores(k0, s) as flash_loop's; sv: the d
// per-channel scales of v. Returns what flash_loop returns.
template <int D, class LoadK, class LoadV8, class Scores>
__device__ __forceinline__ void pv8_loop(const signed char* v8_s, int s,
                                         int group, LoadK load_k,
                                         LoadV8 load_v8, Scores scores,
                                         const float* __restrict__ sv,
                                         float (&o)[D / 8][4], float& l0,
                                         float& l1) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float m0 = LVV_NEG_BIG, m1 = LVV_NEG_BIG;
  l0 = 0.f;
  l1 = 0.f;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  for (int g0 = 0; g0 < s; g0 += group) {
    const int g1 = min(g0 + group, s);
    // pass 1: the group's row maxima
    float gm0 = LVV_NEG_BIG, gm1 = LVV_NEG_BIG;
    for (int k0 = g0; k0 < g1; k0 += kBK) {
      __syncthreads();
      load_k(k0);
      __syncthreads();
      float sc[kBK / 8][4];
      scores(k0, sc);
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        gm0 = fmaxf(gm0, fmaxf(sc[j][0], sc[j][1]));
        gm1 = fmaxf(gm1, fmaxf(sc[j][2], sc[j][3]));
      }
    }
    gm0 = quad_max(gm0);
    gm1 = quad_max(gm1);
    const float mn0 = fmaxf(m0, gm0), mn1 = fmaxf(m1, gm1);
    const float alpha0 = exp2f(m0 - mn0), alpha1 = exp2f(m1 - mn1);
    const float sp0 = fmaxf(exp2f(gm0 - mn0), 1e-30f);
    const float sp1 = fmaxf(exp2f(gm1 - mn1), 1e-30f);
    const float mul0 = __fdiv_rn(127.f, sp0), mul1 = __fdiv_rn(127.f, sp1);
    m0 = mn0;
    m1 = mn1;

    // pass 2: p (fp32, summed into l), p8, z += p8 @ v8 (int32)
    int z[D / 8][4];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) z[j][0] = z[j][1] = z[j][2] = z[j][3] = 0;
    float ps0 = 0.f, ps1 = 0.f;
    for (int k0 = g0; k0 < g1; k0 += kBK) {
      __syncthreads();
      load_k(k0);
      load_v8(k0);
      __syncthreads();
      float sc[kBK / 8][4];
      scores(k0, sc);
      int p8[kBK / 8][4];
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = exp2f(sc[j][i] - (i < 2 ? m0 : m1));
          if (i < 2) ps0 += p; else ps1 += p;
          p8[j][i] = min(127, __float2int_rn(__fmul_rn(p, i < 2 ? mul0 : mul1)));
        }
      }
      // 32 kv a step; k-slot 4t + i holds kv column 2t + (i & 1) + 8 (i >> 1)
      // of each 16-column half (the order of the score fragments)
#pragma unroll
      for (int kc = 0; kc < kBK / 32; ++kc) {
        const int j = 4 * kc;
        uint32_t a[4];
        a[0] = pack_s8(p8[j][0], p8[j][1], p8[j + 1][0], p8[j + 1][1]);
        a[1] = pack_s8(p8[j][2], p8[j][3], p8[j + 1][2], p8[j + 1][3]);
        a[2] = pack_s8(p8[j + 2][0], p8[j + 2][1], p8[j + 3][0], p8[j + 3][1]);
        a[3] = pack_s8(p8[j + 2][2], p8[j + 2][3], p8[j + 3][2], p8[j + 3][3]);
#pragma unroll
        for (int jn = 0; jn < D / 8; ++jn) {
          const signed char* vr = v8_s + (jn * 8 + g) * kLDV8 + kc * 32 + 2 * t;
          uint32_t b[2];
          b[0] = ld_u16(vr) | (ld_u16(vr + 8) << 16);
          b[1] = ld_u16(vr + 16) | (ld_u16(vr + 24) << 16);
          mma_s8(z[jn], a, b);
        }
      }
    }
    l0 = l0 * alpha0 + quad_sum(ps0);
    l1 = l1 * alpha1 + quad_sum(ps1);
    const float spc0 = __fmul_rn(sp0, 1.f / 127.f);
    const float spc1 = __fmul_rn(sp1, 1.f / 127.f);
#pragma unroll
    for (int jn = 0; jn < D / 8; ++jn) {
      const int c = jn * 8 + 2 * t;
      const float sva = sv[c], svb = sv[c + 1];
      o[jn][0] = __fadd_rn(__fmul_rn(o[jn][0], alpha0),
                           __fmul_rn(__fmul_rn(__int2float_rn(z[jn][0]), spc0), sva));
      o[jn][1] = __fadd_rn(__fmul_rn(o[jn][1], alpha0),
                           __fmul_rn(__fmul_rn(__int2float_rn(z[jn][1]), spc0), svb));
      o[jn][2] = __fadd_rn(__fmul_rn(o[jn][2], alpha1),
                           __fmul_rn(__fmul_rn(__int2float_rn(z[jn][2]), spc1), sva));
      o[jn][3] = __fadd_rn(__fmul_rn(o[jn][3], alpha1),
                           __fmul_rn(__fmul_rn(__int2float_rn(z[jn][3]), spc1), svb));
    }
  }
  l0 = fmaxf(l0, 1e-30f);
  l1 = fmaxf(l1, 1e-30f);
}
