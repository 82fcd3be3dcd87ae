// The int8 p·v attention core for sm_90a that the three int8 launches
// share: relpos_attention.cu's K-d8 (from packed qkv) and
// flash_attention_relpos.cu's int8 arms of K-h (streaming, from head-split
// views; fused, depth-128 augmented operands). It replaces the `quant8`
// bodies of lvv_tpu/ops/attention.py (K-h :336-348, K-h fused :592-598,
// K-d8 :717-723), which compute one function:
//   an online softmax over kv in GROUPS of `group` columns from column 0;
//   per row and group, with gmax the group's row maximum and m the running
//   one, sp = max(exp2(gmax - m), 1e-30), p = exp2(s - m) (summed
//   unquantized into l), p8 = min(127, rint(p · 127/sp)), z = p8 @ v8 in
//   int32 over the group, and o = o·alpha + (z·fl(sp·fl(1/127)))·sv, with v8
//   / sv the per-channel int8 v of the wrappers' quantize_v.
//
// What bounds it on the H100: q·k (2·S²·d bf16 operations a (view, head))
// and p·v (2·S²·d int8 operations), far above the card's ~295 operations
// per byte. The design computes q·k twice (below): 2·S²·d more bf16
// operations, the design's work and not the bound's. Past the products,
// every score takes some 15 fp32 / integer instructions (bias twice, exp,
// quantize, pack) and one exp on the SFU: at SAM's shapes those, and the
// wait for each step's products, are what the kernel's time is made of.
//
// Design. A block owns 64 q rows a consumer warpgroup (two, or one where a
// thread needs more than 168 registers: head dim 128, tables read from
// global memory), on wgmma, and one producer warp that keeps a ring of
// stages in flight by TMA, with full / empty mbarriers.
//   - A group's row maximum must be exact before any p of it is quantized,
//     and its fp32 scores do not fit on chip (128 rows x 1024 x 4 B), so
//     each group is walked twice: pass 1 streams its K tiles and keeps only
//     the row maxima of S = q·kᵀ + bias (no exp, no V); pass 2 streams K
//     and the int8 V tile, recomputes S, and turns it into p, l and p8.
//     The producer streams the tiles in that order (a pass-1 stage carries
//     no V).
//   - Tiles are 128 keys. K is bf16 [128, DQ] in 128-byte-swizzled panels
//     (attn_sm90.cuh); V8 is int8 [DV channels][128 kv], one 128-byte
//     swizzle row per channel, K-major as 8-bit wgmma needs (it has no
//     transpose bit): the wrapper's transposed copy v8t [B, H, d, s_pad]
//     already lies that way, so one TMA box fetches it. A tile's scores
//     are made in steps of NS keys (128, 64 or 32: the plan's `step`).
//   - p8 never leaves registers: wgmma m64nDVk32 s8 takes A from registers
//     in mma.sync m16n8k32's A layout per warp (row g: k 4t..4t+3 and
//     16+4t..16+4t+3), while the f32 accumulator of S holds columns 2t,
//     2t+1, 8+2t, 9+2t of each 16. So the k-slot 4t + i of each 16 holds
//     kv column 2t + (i & 1) + 8 (i >> 1): v8t's kv axis is permuted the
//     same way inside each 16 columns (ops/attention.py `pv8_kv_perm`); the
//     int32 sum over a permuted kv axis is the same integer. rint is a
//     magic-number add (exact, ties to even, below 2^22) and the bytes are
//     packed with prmt, all on the fp32 / integer pipes.
//   - The running maximum is subtracted inside the bias (one add a score
//     less), and p is ex2.approx.ftz: exp2f's own SFU instruction without
//     its fix-up below 2^-126 (see `quantize`). sp and the rescale keep
//     exp2f; 127/sp is __fdiv_rn, as the plain version's division.
//   - A group that is not a whole number of tiles (any multiple of 64 is
//     taken) is masked inside the tile that straddles it: that tile is
//     streamed once for each group it touches.
//   - v8t and sv come from pv8_quantize_v (below) inside the same launch,
//     bit-equal to the PyTorch quantization it replaces.
#pragma once

#include "gemm_sm90.cuh"
#include "int8.cuh"

namespace sm90 {

// wgmma m64nNk32 s8 · s8 -> s32 with A from registers (4 per thread, mma.sync
// m16n8k32's A layout per warp) and B by descriptor (K-major): d += A · B,
// or d = A · B where `acc` is 0.
template <int N>
struct WgS8R;

template <> struct WgS8R<64> {
  static __device__ __forceinline__ void mma(int* d, const uint32_t* a,
                                             uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
          "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

template <> struct WgS8R<128> {
  static __device__ __forceinline__ void mma(int* d, const uint32_t* a,
                                             uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
          "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
          "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
          "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
          "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

// wgmma m64n32k16 (A and B from shared memory, both K-major): the 32-key
// score steps.
template <> struct Wgmma<32> {
  static __device__ __forceinline__ void ss(float* d, uint64_t a,
                                            uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(acc));
  }
};

// DQ: depth of the score product (d, or 128 for the fused form's augmented
// operands); DV: head dim of v; NS: keys a step (a tile's scores are made
// NS columns at a time); WGS: consumer warpgroups of 64 q rows. ptxas
// budgets registers for whole warpgroups, so two consumer warpgroups and
// the producer warp leave a thread 168: enough for the 128-key steps of
// SAM's grids (s 64, o 32, z 32, p8 16 registers), not for the wider
// rules' bookkeeping, which step 64 keys, nor for head dim 128 or the
// tables read from global memory, which take one consumer warpgroup (up
// to 255 registers: o and z alone are 128 at head dim 128).
template <int DQ, int DV, int NS_, int WGS>
struct Pv8Cfg {
  static constexpr int BQ = 64 * WGS;             // q rows a block
  static constexpr int BN = 128;                  // keys a tile
  static constexpr int NS = NS_;
  static constexpr int CONS = 128 * WGS;          // consumer threads
  static constexpr int QP = DQ / 64;
  static constexpr int Q_PB = BQ * 128, KV_PB = BN * 128;
  static constexpr int Q_BYTES = QP * Q_PB, K_BYTES = QP * KV_PB;
  static constexpr int STAGE = K_BYTES + DV * BN; // K panels, then V8
  static constexpr int THREADS = CONS + 32;       // and the producer warp
};

// Shared memory: q, the ring of `stages` stages, `tab` bytes of tables,
// the barriers (full and empty per stage, q's).
struct Pv8Smem {
  int tab, bar, total;
};

__host__ __device__ inline Pv8Smem pv8_smem(int q_bytes, int stage,
                                            int stages, int tab) {
  Pv8Smem m;
  m.tab = q_bytes + stages * stage;
  m.bar = (m.tab + tab + 7) & ~7;
  m.total = m.bar + (2 * stages + 1) * 8;
  return m;
}

template <class C>
inline int pv8_smem_bytes(int stages, int tab) {
  return pv8_smem(C::Q_BYTES, C::STAGE, stages, tab).total + kSmemAlign;
}

// The position in a ring of `n` stages: stage and the parity of its round.
struct Ring {
  int st = 0, ph = 0;
  __device__ __forceinline__ void next(int n) {
    if (++st == n) {
      st = 0;
      ph ^= 1;
    }
  }
};

// The block's barriers at `bar`: full[stages], empty[stages] (one arrival
// per consumer warp), q.
__device__ __forceinline__ void pv8_init_bars(uint64_t* bar, int stages,
                                              int consumer_warps) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      bar_init(&bar[i], 1);
      bar_init(&bar[stages + i], consumer_warps);
    }
    bar_init(&bar[2 * stages], 1);
    bar_fence_init();
  }
  __syncthreads();
}

// The tiles in the order the consumers take them: for each group [g0, g1)
// its tiles from g0 rounded down to BN, twice (pass 0: K; pass 1: K and V8).
template <int BN>
struct Pv8Fills {
  int kv_end, group, g0 = 0, k0 = 0, pass = 0;
  __device__ Pv8Fills(int kv_end_, int group_)
      : kv_end(kv_end_), group(group_) {}
  __device__ __forceinline__ bool done() const { return g0 >= kv_end; }
  __device__ __forceinline__ int g1() const { return min(g0 + group, kv_end); }
  __device__ __forceinline__ void next() {
    k0 += BN;
    if (k0 >= g1()) {
      if (pass) g0 += group;
      pass ^= 1;
      k0 = g0 / BN * BN;
    }
  }
};

// Producer (one thread of the producer warp): every tile into the ring in
// the consumers' order. load_k(dst, bar, row) issues the K panels of the
// tile at kv `row`; the V8 tile comes from vmap at (row, 0, h, b).
template <class C, class LoadK>
__device__ __forceinline__ void pv8_produce(int kv_end, int group, int stages,
                                            unsigned char* ring,
                                            uint64_t* bar,
                                            const CUtensorMap* vmap, int h,
                                            int b, LoadK load_k) {
  uint64_t* full = bar;
  uint64_t* empty = bar + stages;
  Ring r;
  int i = 0;
  for (Pv8Fills<C::BN> f(kv_end, group); !f.done(); f.next(), ++i) {
    if (i >= stages) bar_wait(&empty[r.st], r.ph ^ 1);
    bar_expect_tx(&full[r.st], f.pass ? C::STAGE : C::K_BYTES);
    unsigned char* dst = ring + r.st * C::STAGE;
    load_k(dst, &full[r.st], f.k0);
    if (f.pass) tma_load(dst + C::K_BYTES, vmap, &full[r.st], f.k0, 0, h, b);
    r.next(stages);
  }
}

// Columns of the NS-column step at c0 outside the group [g0, g1) are
// masked (a tile that straddles a group edge, or kv_end).
template <int NS>
__device__ __forceinline__ void pv8_mask(float (&sc)[NS / 2], int c0, int g0,
                                         int g1) {
  if (c0 >= g0 && c0 + NS <= g1) return;
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < NS / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = c0 + 8 * j + 2 * t + e;
      if (col < g0 || col >= g1) sc[4 * j + e] = sc[4 * j + 2 + e] = LVV_NEG_BIG;
    }
}

// The low bytes of four words as one word, a lowest.
__device__ __forceinline__ uint32_t pack_low_bytes(uint32_t a, uint32_t b,
                                                   uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

// p8 = min(127, rint(x)) of x >= 0 in the low byte of the result: the add
// of 1.5·2^23 rounds x to an integer (ties to even) into the low mantissa
// bits.
__device__ __forceinline__ uint32_t p8_bits(float x) {
  return __float_as_uint(__fadd_rn(fminf(x, 127.f), 12582912.f));
}

// The consumers' two passes over every group (this warpgroup's 64 q rows at
// q_addr; the ring's first stage at ring_addr), a tile at a time and each
// tile NS keys at a time: q·k by wgmma, then the step's softmax work, then
// (pass 2) its p·v; the two warpgroups' steps interleave on the SM.
// scores(c0, sc, m0, m1) turns the q·kᵀ of the NS columns from c0 into
// log2-domain logits less m0 / m1 (rows g / g + 8) in place (the
// accumulator layout: pass 2 subtracts the running maximum there, inside
// the bias, and pass 1 nothing); sv: this (view, head)'s DV channel scales.
// On return o holds rows g and g + 8 of each warp, unnormalised, and
// l0 / l1 their guarded denominators.
template <class C, int DQ, int DV, class Scores>
__device__ __forceinline__ void pv8_consume(
    int kv_end, int group, int stages, uint32_t q_addr, uint32_t ring_addr,
    uint64_t* bar, Scores scores, const float* __restrict__ sv,
    float (&o)[DV / 2], float& l0, float& l1) {
  constexpr int BN = C::BN, NS = C::NS, HS = BN / NS;
  uint64_t* full = bar;
  uint64_t* empty = bar + stages;
  const int lane = threadIdx.x & 31, t = lane & 3;
  Ring r;
  float m0 = LVV_NEG_BIG, m1 = LVV_NEG_BIG;
  l0 = l1 = 0.f;
#pragma unroll
  for (int k = 0; k < DV / 2; ++k) o[k] = 0.f;
  float gm0 = LVV_NEG_BIG, gm1 = LVV_NEG_BIG;   // the group's row maxima
  float alpha0 = 1.f, alpha1 = 1.f, sp0 = 1.f, sp1 = 1.f;
  float mul0 = 127.f, mul1 = 127.f, ps0 = 0.f, ps1 = 0.f;
  int z[DV / 2];   // set by each group's first p·v

  // the q·kᵀ of step hs of the tile at kt (q's address taken anew: the q
  // descriptors are not held across the loop)
  auto qk = [&](float (&sc)[NS / 2], uint32_t kt, int hs) {
    uint32_t qa;
    asm volatile("mov.b32 %0, %1;" : "=r"(qa) : "r"(q_addr));
    qk_sm90<DQ, NS>(sc, qa, C::Q_PB, kt + hs * NS * 128, C::KV_PB);
  };
  // p = 2^(logit - m) of one step, summed into ps, and p8 as the s8 A
  // operand: k-slots 4t..4t+3 of each 16 hold columns 2t, 2t + 1 of its
  // first and second 8-column block. ex2.approx.ftz is exp2f's own SFU
  // instruction: only p below 2^-126 differ (0, not subnormal), and such a
  // p quantizes to 0 against any sp >= 1e-30 and is lost in l.
  auto quantize = [&](const float (&sc)[NS / 2], uint32_t (&a)[NS / 8]) {
#pragma unroll
    for (int kc = 0; kc < NS / 32; ++kc) {
      uint32_t u[4][4];   // [8-column block][accumulator slot]
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* e = sc + 4 * (4 * kc + jj);
        const float p0 = exp2_approx(e[0]), p1 = exp2_approx(e[1]);
        const float p2 = exp2_approx(e[2]), p3 = exp2_approx(e[3]);
        ps0 += p0 + p1;
        ps1 += p2 + p3;
        u[jj][0] = p8_bits(__fmul_rn(p0, mul0));
        u[jj][1] = p8_bits(__fmul_rn(p1, mul0));
        u[jj][2] = p8_bits(__fmul_rn(p2, mul1));
        u[jj][3] = p8_bits(__fmul_rn(p3, mul1));
      }
      a[4 * kc] = pack_low_bytes(u[0][0], u[0][1], u[1][0], u[1][1]);
      a[4 * kc + 1] = pack_low_bytes(u[0][2], u[0][3], u[1][2], u[1][3]);
      a[4 * kc + 2] = pack_low_bytes(u[2][0], u[2][1], u[3][0], u[3][1]);
      a[4 * kc + 3] = pack_low_bytes(u[2][2], u[2][3], u[3][2], u[3][3]);
    }
  };

  for (Pv8Fills<BN> f(kv_end, group); !f.done();) {
    bar_wait(&full[r.st], r.ph);
    const uint32_t kt = ring_addr + r.st * C::STAGE;
    const int g0 = f.g0, g1 = f.g1();
#pragma unroll 1
    for (int hs = 0; hs < HS; ++hs) {
      const int c0 = f.k0 + hs * NS;
      float sc[NS / 2];
      qk(sc, kt, hs);
      if (f.pass == 0) {
        // pass 1: the group's row maxima
        scores(c0, sc, 0.f, 0.f);
        pv8_mask<NS>(sc, c0, g0, g1);
#pragma unroll
        for (int j = 0; j < NS / 8; ++j) {
          gm0 = fmaxf(gm0, fmaxf(sc[4 * j], sc[4 * j + 1]));
          gm1 = fmaxf(gm1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
        }
      } else {
        // pass 2: p (summed into l), p8 in registers, z += p8 · v8
        scores(c0, sc, m0, m1);
        pv8_mask<NS>(sc, c0, g0, g1);
        uint32_t a[NS / 8];
        quantize(sc, a);
        const int acc = f.k0 != g0 / BN * BN || hs > 0;   // else z = p8·v8
        const uint32_t vt = kt + C::K_BYTES + hs * NS;
        wg_fence();
#pragma unroll
        for (int kc = 0; kc < NS / 32; ++kc)
          WgS8R<DV>::mma(z, a + 4 * kc, desc_sw128(vt + 32 * kc, 16, 1024),
                         acc | kc);
        wg_commit();
        wg_wait<0>();
        fence_regs(z);
      }
    }
    __syncwarp();
    if (lane == 0) bar_arrive(&empty[r.st]);
    r.next(stages);
    const int pass = f.pass;
    f.next();
    if (pass == 0 && f.pass == 1) {
      // the group's first pass is done: its running maximum, p scale and
      // rescale
      gm0 = quad_max(gm0);
      gm1 = quad_max(gm1);
      const float mn0 = fmaxf(m0, gm0), mn1 = fmaxf(m1, gm1);
      alpha0 = exp2f(m0 - mn0);
      alpha1 = exp2f(m1 - mn1);
      sp0 = fmaxf(exp2f(gm0 - mn0), 1e-30f);
      sp1 = fmaxf(exp2f(gm1 - mn1), 1e-30f);
      mul0 = __fdiv_rn(127.f, sp0);
      mul1 = __fdiv_rn(127.f, sp1);
      m0 = mn0;
      m1 = mn1;
      ps0 = ps1 = 0.f;
    } else if (pass == 1 && (f.done() || f.pass == 0)) {
      // the group is done: o = o·alpha + (z·(sp/127))·sv, l = l·alpha +
      // Σp, in the plain version's order of roundings
      l0 = l0 * alpha0 + quad_sum(ps0);
      l1 = l1 * alpha1 + quad_sum(ps1);
      const float spc0 = __fmul_rn(sp0, 1.f / 127.f);
      const float spc1 = __fmul_rn(sp1, 1.f / 127.f);
#pragma unroll
      for (int j = 0; j < DV / 8; ++j) {
        const float2 s2 =
            __ldg(reinterpret_cast<const float2*>(sv + 8 * j + 2 * t));
        float* oj = o + 4 * j;
        const int* zj = z + 4 * j;
        oj[0] = __fadd_rn(__fmul_rn(oj[0], alpha0),
                          __fmul_rn(__fmul_rn(__int2float_rn(zj[0]), spc0), s2.x));
        oj[1] = __fadd_rn(__fmul_rn(oj[1], alpha0),
                          __fmul_rn(__fmul_rn(__int2float_rn(zj[1]), spc0), s2.y));
        oj[2] = __fadd_rn(__fmul_rn(oj[2], alpha1),
                          __fmul_rn(__fmul_rn(__int2float_rn(zj[2]), spc1), s2.x));
        oj[3] = __fadd_rn(__fmul_rn(oj[3], alpha1),
                          __fmul_rn(__fmul_rn(__int2float_rn(zj[3]), spc1), s2.y));
      }
      gm0 = gm1 = LVV_NEG_BIG;
    }
  }
  l0 = fmaxf(l0, 1e-30f);   // guard, as the JAX kernel's finalize does
  l1 = fmaxf(l1, 1e-30f);
}

// The bias of a score from the rows of the two tables that this thread's
// rows g and g + 8 read: h(i, kh), w(i, kw) for row i (0: g, 1: g + 8),
// log2-domain.
struct Pv8SmemRows {   // fp32 rows in shared memory
  const float *h0, *h1, *w0, *w1;
  __device__ __forceinline__ float h(int i, int kh) const {
    return (i ? h1 : h0)[kh];
  }
  __device__ __forceinline__ float w(int i, int kw) const {
    return (i ? w1 : w0)[kw];
  }
  __device__ __forceinline__ float2 w2(int i, int kw) const {   // kw even
    return *reinterpret_cast<const float2*>((i ? w1 : w0) + kw);
  }
};

struct Pv8GlobalRows { // the caller's bf16 rows, times ts
  const bf16 *h0, *h1, *w0, *w1;
  float ts;
  int ghm;              // gh - 1: keys past S (masked) read the last entry
  __device__ __forceinline__ float h(int i, int kh) const {
    return bf(__ldg((i ? h1 : h0) + min(kh, ghm))) * ts;
  }
  __device__ __forceinline__ float w(int i, int kw) const {
    return bf(__ldg((i ? w1 : w0) + kw)) * ts;
  }
  __device__ __forceinline__ float2 w2(int i, int kw) const {
    return make_float2(w(i, kw), w(i, kw + 1));
  }
};

// How a score finds its (kh, kw) = (kv / gw, kv % gw):
//   kGridG64:  a grid 64 wide: known at compile time up to c0's grid row
//              and the lane;
//   kGridWide: gw >= 64 and a multiple of 8 (SAM's 80 at 1280²): a step of
//              64 columns spans two grid rows at most (128: three) and
//              each 8-column block lies in one, so kh is one of two per
//              step, picked per block, and the width rows are extended NS
//              entries past gw (w[gw + x] = w[x % gw]) so that kw runs on
//              without a wrap;
//   kGridAny:  each lane steps (kh, kw) of its column pair by 8 columns (no
//              division past the first).
enum { kGridAny = 0, kGridWide = 1, kGridG64 = 2 };

// The log2-domain logits of the NS columns from c0 (a multiple of 32) on a
// grid gw wide, less m0 / m1 (rows g / g + 8), in place of their q·kᵀ:
// FUSED, s + (w[kw] - m) (q_aug carries the scale and the height bias);
// otherwise s·sl + ((h[kh] - m) + w[kw]) with sl = scale·log2e.
template <int NS, int GRID, bool FUSED, class Rows>
__device__ __forceinline__ void pv8_bias(float (&sc)[NS / 2], int c0,
                                         float sl, int gw, const Rows& tab,
                                         float m0, float m1) {
  const int t = threadIdx.x & 3;
  // the logits of block j from its q·kᵀ and biases
  auto put = [&](int j, float b00, float b01, float b10, float b11) {
    float* e = sc + 4 * j;
    if constexpr (FUSED) {
      e[0] += b00;
      e[1] += b01;
      e[2] += b10;
      e[3] += b11;
    } else {
      e[0] = fmaf(e[0], sl, b00);
      e[1] = fmaf(e[1], sl, b01);
      e[2] = fmaf(e[2], sl, b10);
      e[3] = fmaf(e[3], sl, b11);
    }
  };
  if constexpr (GRID == kGridG64) {
    static_assert(NS % 64 == 0, "a step is whole grid rows");
#pragma unroll
    for (int j = 0; j < NS / 8; ++j) {
      const int kh = (c0 >> 6) + (j >> 3), kw = ((8 * j) & 63) + 2 * t;
      const float h0 = (FUSED ? 0.f : tab.h(0, kh)) - m0;
      const float h1 = (FUSED ? 0.f : tab.h(1, kh)) - m1;
      const float2 w0 = tab.w2(0, kw), w1 = tab.w2(1, kw);
      put(j, h0 + w0.x, h0 + w0.y, h1 + w1.x, h1 + w1.y);
    }
  } else if constexpr (GRID == kGridWide) {
    constexpr int R = NS <= 64 ? 2 : 3;   // grid rows a step spans at most
    const int kh0 = c0 / gw, kw0 = c0 - kh0 * gw;
    float hr0[R], hr1[R];   // the step's grid rows kh0 .. kh0 + R - 1
#pragma unroll
    for (int k = 0; k < R; ++k) {
      hr0[k] = (FUSED ? 0.f : tab.h(0, kh0 + k)) - m0;
      hr1[k] = (FUSED ? 0.f : tab.h(1, kh0 + k)) - m1;
    }
#pragma unroll
    for (int j = 0; j < NS / 8; ++j) {
      const int x = kw0 + 8 * j;   // the block's kw, run on past gw
      float h0 = hr0[0], h1 = hr1[0];
      if (x >= gw) {
        h0 = hr0[1];
        h1 = hr1[1];
      }
      if (R > 2 && x >= 2 * gw) {
        h0 = hr0[R - 1];
        h1 = hr1[R - 1];
      }
      const float2 w0 = tab.w2(0, x + 2 * t), w1 = tab.w2(1, x + 2 * t);
      put(j, h0 + w0.x, h0 + w0.y, h1 + w1.x, h1 + w1.y);
    }
  } else {
    const int c = c0 + 2 * t;
    int kh = c / gw, kw = c - kh * gw;
    const int q8 = 8 / gw, r8 = 8 - q8 * gw;
    if ((gw & 1) == 0) {
      // c is even, so kw is: kw + 1 lies in the same grid row
#pragma unroll
      for (int j = 0; j < NS / 8; ++j) {
        const float h0 = (FUSED ? 0.f : tab.h(0, kh)) - m0;
        const float h1 = (FUSED ? 0.f : tab.h(1, kh)) - m1;
        const float2 w0 = tab.w2(0, kw), w1 = tab.w2(1, kw);
        put(j, h0 + w0.x, h0 + w0.y, h1 + w1.x, h1 + w1.y);
        kw += r8;
        kh += q8;
        if (kw >= gw) {
          kw -= gw;
          ++kh;
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < NS / 8; ++j) {
        int kw1 = kw + 1, kh1 = kh;
        if (kw1 == gw) {
          kw1 = 0;
          ++kh1;
        }
        const float h00 = (FUSED ? 0.f : tab.h(0, kh)) - m0;
        const float h01 = (FUSED ? 0.f : tab.h(0, kh1)) - m0;
        const float h10 = (FUSED ? 0.f : tab.h(1, kh)) - m1;
        const float h11 = (FUSED ? 0.f : tab.h(1, kh1)) - m1;
        put(j, h00 + tab.w(0, kw), h01 + tab.w(0, kw1), h10 + tab.w(1, kw),
            h11 + tab.w(1, kw1));
        kw += r8;
        kh += q8;
        if (kw >= gw) {
          kw -= gw;
          ++kh;
        }
      }
    }
  }
}

// The V8 operand's tensor map: v8t [B, H, DV, s_pad] int8 (s_pad a multiple
// of 16), boxes of 128 kv by DV channels, 128-byte swizzle, zero past s_pad.
static cudaError_t pv8_vmap(CUtensorMap* map, const void* v8t, int b,
                            int heads, int dv, int s_pad) {
  typedef cuuint64_t u64;
  const u64 dims[4] = {(u64)s_pad, (u64)dv, (u64)heads, (u64)b};
  const u64 strides[3] = {(u64)s_pad, (u64)s_pad * dv,
                          (u64)s_pad * dv * heads};
  return gemm_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, v8t, dims, strides, dv);
}

// ------------------------------------------------ v's int8 operand (glue)
// The wrappers' quantize_v and transposing copy in two kernels, bit-equal
// to the PyTorch versions (ops/attention.py `pv8_v_operands`): per (view,
// head, channel) amax = max |v| over the sequence, sv = max(amax ·
// fl(1/127), 1e-8) (PyTorch divides by a scalar as a multiply by its
// reciprocal on the card), v8 = clamp(rint(v / sv), ±127) (a true
// division), written as v8t [B, H, D, s_pad] with kv in pv8_kv_perm's
// order and zeros past S. v[b, h, s, c] lies at v + b·vs0 + h·vs1 + s·vs2
// + c (bf16, 16-byte aligned rows).

// amax [B, H, D] (zeroed; fp32 bits, |v| >= 0 orders as an int) over 256
// rows a block
template <int D>
__global__ void __launch_bounds__(256)
pv8_v_amax(const bf16* __restrict__ v, long long vs0, long long vs1,
           long long vs2, int s, int* __restrict__ amax) {
  constexpr int CH = D / 8;   // 16-byte chunks a row
  __shared__ int m[D];
  for (int i = threadIdx.x; i < D; i += 256) m[i] = 0;
  __syncthreads();
  const int h = blockIdx.y, b = blockIdx.z, c8 = threadIdx.x % CH;
  const bf16* vb = v + b * vs0 + h * vs1 + 8 * c8;
  const int r1 = min(s, (blockIdx.x + 1) * 256);
  float mx[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int r = blockIdx.x * 256 + threadIdx.x / CH; r < r1; r += 256 / CH) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(vb + r * vs2));
    const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
    for (int k = 0; k < 8; ++k) mx[k] = fmaxf(mx[k], fabsf(bf(e[k])));
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) atomicMax(&m[8 * c8 + k], __float_as_int(mx[k]));
  __syncthreads();
  int* out = amax + ((long long)b * gridDim.y + h) * D;
  for (int i = threadIdx.x; i < D; i += 256) atomicMax(&out[i], m[i]);
}

// v8t's 128 kv of a block for every channel (and sv, from the first block)
template <int D>
__global__ void __launch_bounds__(256)
pv8_v_quant(const bf16* __restrict__ v, long long vs0, long long vs1,
            long long vs2, int s, int s_pad, const int* __restrict__ amax,
            signed char* __restrict__ v8t, float* __restrict__ sv) {
  __shared__ __align__(16) bf16 tile[128][D + 8];
  __shared__ float scale[D];
  const int k0 = blockIdx.x * 128, h = blockIdx.y, b = blockIdx.z;
  const long long bh = (long long)b * gridDim.y + h;
  for (int i = threadIdx.x; i < D; i += 256) {
    const float sc =
        fmaxf(__fmul_rn(__int_as_float(amax[bh * D + i]), 1.f / 127.f), 1e-8f);
    scale[i] = sc;
    if (blockIdx.x == 0) sv[bh * D + i] = sc;
  }
  const bf16* vb = v + b * vs0 + h * vs1;
  for (int i = threadIdx.x; i < 128 * D / 8; i += 256) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (k0 + r < s)
      u = __ldg(reinterpret_cast<const uint4*>(vb + (k0 + r) * vs2 + c));
    *reinterpret_cast<uint4*>(&tile[r][c]) = u;
  }
  __syncthreads();
  // 16 output bytes a thread: channel c, kv positions 16q .. 16q + 15
  for (int i = threadIdx.x; i < D * 8; i += 256) {
    const int c = i / 8, q = i % 8;
    if (k0 + 16 * q >= s_pad) continue;
    uint32_t w[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      int x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // position 4g + e of the 16 holds kv column 2g + (e & 1) + 8 (e >> 1)
        const int kv = 16 * q + 2 * g + (e & 1) + 8 * (e >> 1);
        x[e] = k0 + kv < s ? quant(bf(tile[kv][c]), scale[c]) : 0;
      }
      w[g] = pack_s8(x[0], x[1], x[2], x[3]);
    }
    *reinterpret_cast<uint4*>(v8t + (bh * D + c) * s_pad + k0 + 16 * q) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// Both kernels (amax: B·H·D int32 of scratch). d is 64 or 128.
static cudaError_t pv8_quantize_v(const void* v, const long long* vst, int b,
                                  int heads, int s, int d, int s_pad,
                                  void* amax, void* v8t, void* sv,
                                  cudaStream_t stream) {
  cudaError_t e =
      cudaMemsetAsync(amax, 0, (size_t)b * heads * d * sizeof(int), stream);
  if (e != cudaSuccess) return e;
  const bf16* vp = (const bf16*)v;
  const dim3 g1((s + 255) / 256, heads, b), g2((s_pad + 127) / 128, heads, b);
  if (d == 64) {
    pv8_v_amax<64><<<g1, 256, 0, stream>>>(vp, vst[0], vst[1], vst[2], s,
                                           (int*)amax);
    pv8_v_quant<64><<<g2, 256, 0, stream>>>(vp, vst[0], vst[1], vst[2], s,
                                            s_pad, (const int*)amax,
                                            (signed char*)v8t, (float*)sv);
  } else {
    pv8_v_amax<128><<<g1, 256, 0, stream>>>(vp, vst[0], vst[1], vst[2], s,
                                            (int*)amax);
    pv8_v_quant<128><<<g2, 256, 0, stream>>>(vp, vst[0], vst[1], vst[2], s,
                                             s_pad, (const int*)amax,
                                             (signed char*)v8t, (float*)sv);
  }
  return cudaGetLastError();
}

}  // namespace sm90
