// SAM global attention with int8 scores, for the port (bf16 out):
//   s[q, k] = (z·sq)·sk + qrw[q, k mod gw]     (log2 units)
//   z       = q8_aug[q] · k8_aug[k]   (int32, depth 128)
//   out     = softmax2(s) @ v          (base-2 online softmax, bf16 p@v)
// q_aug = [q·scale·log2e | q·Rh·log2e | 0] and k_aug = [k | onehot(kh) | 0]
// carry the height bias inside the product (depth d + gh <= 128), each
// rounded to bf16 and quantized per (token, head); sq, sk and qrw = q·Rw·
// log2e are rounded to bf16, as the JAX package stashes them in bf16 lanes.
//
// Replaces lvv_tpu/ops/attention.py::_flash_hpacked_qk8_kernel (reached
// through flash_attention_relpos_hpacked(qk8=True)), TPU kernel K-g: the 4
// global SAM layers under the "qk" scope of LVV_Q8_SCOPE, 6 views of 64x64
// tokens, 12 heads of d = 64; and the glue around it that the JAX wrapper
// computes outside its kernel (ops/attention.py `qk8_operands`, the plain
// version of qk8_prep below).
//
// What bounds it on the H100: 2·S²·128 int8 operations for the scores and
// 2·S²·d bf16 operations for p@v, per (view, head): about 0.31 ms at the
// global shape (0.156 ms each). Past the products every score takes an int
// to float conversion, two multiplies and an add in the plain version's
// order (z·sq, ·sk, + qrw), then the softmax's subtract, exp and sum: with
// the wait for each tile's products, that fp32 work sets the time.
//
// Design:
//   - qk8_prep, one launch: a block per (grid row, view) forms the q rows'
//     q·Rh of its row for every head on mma.sync (bf16 products exact, fp32
//     sums), q_aug in bf16, q8 / sq and k8 / sk (max|x| · fl(1/127) floored
//     at 1e-8, x / scale rounded half to even, the scales rounded to bf16);
//     a block per (grid column, view) forms q·Rw of its column's tokens,
//     qrw in bf16. sk goes out transposed, [B, H, s_pad], so that a kv
//     tile's scales are one bulk copy.
//   - qk8_sm90 (the sm_90a core of attn_sm90.cuh / pv8_sm90.cuh): a block
//     per (128 q rows, head, view), two consumer warpgroups of 64 rows and
//     a producer warp. q8 [128 rows, 128 B] arrives by TMA once; the
//     producer keeps a ring of 128-key stages in flight (k8 [128, 128 B]
//     and v [128, 64] bf16 by TMA, straight from the packed qkv; sk by
//     cp.async.bulk), with full / empty mbarriers.
//   - Scores on s8 wgmma m64n128k32 (q8 and k8 are both K-major as stored,
//     which 8-bit wgmma needs), int32 accumulators rescaled in place. Where
//     128 % gw == 0 (gw = 64 on the model path) and gw >= 8 a tile holds
//     whole grid rows, so the qrw column of every accumulator lane is a
//     compile-time offset plus 2·(lane % 4); other grids step each lane's
//     column by 8 keys. The block's qrw rows sit in shared memory as fp32.
//   - p·v as attn_sm90.cuh's bf16 wgmma with p from registers (rounded to
//     bf16 against the running maximum, as the TPU's flash loop does).
#include "gemm_sm90.cuh"
#include "int8.cuh"

using namespace sm90;

constexpr int kDepth = 128;   // augmented depth: bytes of a q8 / k8 row
constexpr int kD = 64;        // head dim (d + gh <= 128 needs d <= 64)
constexpr int kMaxGh = 64;
constexpr int kMaxGw = 128;
constexpr int kPrepLd = kD + 8;   // bf16 pitch of the prep's q rows

// ------------------------------------------------------------------ prep

// One block per (grid row qh < gh, or grid column qw = x - gh, view b);
// R[x] ([g, 64] bf16, row-major) to shared memory once, then a head at a
// time: the tokens' q rows (and, grid rows, k rows) to shared memory,
// their products with R[x] on mma.sync,
// then (grid rows) the int8 operands of every token of the row, or (grid
// columns) qrw.
__global__ void __launch_bounds__(256)
qk8_prep(const bf16* __restrict__ qkv, const bf16* __restrict__ rel_h,
         const bf16* __restrict__ rel_w, signed char* __restrict__ q8,
         signed char* __restrict__ k8, float* __restrict__ sq,
         float* __restrict__ skT, bf16* __restrict__ qrw, int s, int heads,
         int gh, int gw, int s_pad, float c1) {
  extern __shared__ __align__(16) unsigned char prep_smem[];
  bf16* qs = reinterpret_cast<bf16*>(prep_smem);                 // [128][kPrepLd]
  // (a grid row's tokens are gw <= 128, a grid column's gh <= 64)
  bf16* ks = qs + kMaxGw * kPrepLd;                              // [128][kPrepLd]
  bf16* rs = ks + kMaxGw * kPrepLd;                              // R[x] [g][kPrepLd]
  bf16* ps = rs + kMaxGw * kPrepLd;   // q·Rh·log2e in bf16 [128][64]
  const int b = blockIdx.y, c = heads * kD;
  const long long row = 3LL * c;
  const bool hrow = blockIdx.x < gh;
  const int x = hrow ? blockIdx.x : blockIdx.x - gh;
  const int n_tok = hrow ? gw : gh, g = hrow ? gh : gw;
  const bf16* r = hrow ? rel_h + (long long)x * gh * kD
                       : rel_w + (long long)x * gw * kD;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t = lane & 3;
  auto tok = [&](int j) { return hrow ? x * gw + j : j * gw + x; };
  const int rt = (n_tok + 15) / 16, nt = (g + 7) / 8;
  // R[x], every head's B operand, once (zero rows up to whole 8-row tiles)
  for (int i = tid; i < nt * 8 * (kD / 8); i += 256) {
    const int n = i / (kD / 8), c8 = i % (kD / 8);
    *reinterpret_cast<uint4*>(rs + n * kPrepLd + 8 * c8) =
        n < g ? __ldg(reinterpret_cast<const uint4*>(r + n * kD + 8 * c8))
              : make_uint4(0u, 0u, 0u, 0u);
  }

  for (int h = 0; h < heads; ++h) {
    __syncthreads();
    // q rows (and the k rows of a grid row's tokens), all loads in flight
    for (int i = tid; i < (hrow ? 2 : 1) * n_tok * (kD / 8); i += 256) {
      const int kq = i >= n_tok * (kD / 8);
      const int j = i / (kD / 8) - kq * n_tok, c8 = i % (kD / 8);
      *reinterpret_cast<uint4*>((kq ? ks : qs) + j * kPrepLd + 8 * c8) =
          __ldg(reinterpret_cast<const uint4*>(
              qkv + ((long long)b * s + tok(j)) * row + kq * c + h * kD +
              8 * c8));
    }
    __syncthreads();
    // q·R[x]ᵀ by 16-row x 8-column tiles, log2-domain, rounded to bf16
    for (int it = warp; it < rt * nt; it += 8) {
      const int r0 = (it / nt) * 16, n0 = (it % nt) * 8;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        uint32_t a[4], bb[2];
        load_a(a, qs + r0 * kPrepLd + kk * 16, kPrepLd, lane);
        load_b_nk(bb, rs + n0 * kPrepLd + kk * 16, kPrepLd, lane);
        mma16816(acc, a, bb);
      }
      const int n = n0 + 2 * t;
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int j = r0 + gq + 8 * hi;
        if (j >= n_tok) continue;
        const float v0 = round_bf16(__fmul_rn(acc[2 * hi], LVV_LOG2E));
        const float v1 = round_bf16(__fmul_rn(acc[2 * hi + 1], LVV_LOG2E));
        if (hrow) {
          if (n < g) ps[j * kD + n] = __float2bfloat16(v0);
          if (n + 1 < g) ps[j * kD + n + 1] = __float2bfloat16(v1);
        } else {
          bf16* o = qrw + (((long long)b * s + tok(j)) * heads + h) * gw + n;
          if (n + 1 < g && (gw & 1) == 0) {
            *reinterpret_cast<uint32_t*>(o) = pack_f32(v0, v1);   // exact
          } else {
            if (n < g) o[0] = __float2bfloat16(v0);
            if (n + 1 < g) o[1] = __float2bfloat16(v1);
          }
        }
      }
    }
    if (!hrow) continue;
    __syncthreads();
    // a warp a token: lane l holds columns 4l .. 4l + 3 of q_aug / k_aug
    for (int j = warp; j < n_tok; j += 8) {
      const long long th = ((long long)b * s + tok(j)) * heads + h;
      float v[4], kv[4];
      if (lane < 16) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          v[e] = round_bf16(__fmul_rn(bf(qs[j * kPrepLd + 4 * lane + e]), c1));
          kv[e] = bf(ks[j * kPrepLd + 4 * lane + e]);
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = 4 * (lane - 16) + e;
          v[e] = n < gh ? bf(ps[j * kD + n]) : 0.f;
          kv[e] = n == x ? 1.f : 0.f;   // onehot(kh): this grid row
        }
      }
      float am = 0.f, amk = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        am = fmaxf(am, fabsf(v[e]));
        amk = fmaxf(amk, fabsf(kv[e]));
      }
      // PyTorch on the card divides by the scalar 127 as a multiply by
      // fl(1 / 127); x / scale is a true division
      const float sc = fmaxf(__fmul_rn(warp_max(am), 1.f / 127.f), 1e-8f);
      const float sck = fmaxf(__fmul_rn(warp_max(amk), 1.f / 127.f), 1e-8f);
      reinterpret_cast<uint32_t*>(q8 + th * kDepth)[lane] = pack_s8(
          quant(v[0], sc), quant(v[1], sc), quant(v[2], sc), quant(v[3], sc));
      reinterpret_cast<uint32_t*>(k8 + th * kDepth)[lane] =
          pack_s8(quant(kv[0], sck), quant(kv[1], sck), quant(kv[2], sck),
                  quant(kv[3], sck));
      if (lane == 0) {
        sq[th] = round_bf16(sc);
        skT[((long long)b * heads + h) * s_pad + tok(j)] = round_bf16(sck);
      }
    }
  }
}

// ------------------------------------------------------------- attention

struct Qk8Cfg {
  static constexpr int BQ = 128;                   // q rows a block
  static constexpr int BN = 128;                   // keys a tile
  static constexpr int STAGES = 3;
  static constexpr int Q_BYTES = BQ * kDepth;      // q8 [128][128 B]
  static constexpr int K_BYTES = BN * kDepth;      // k8 tile
  static constexpr int V_PB = BN * 128;            // v tile: one 64-col panel
  static constexpr int STAGE = K_BYTES + V_PB;
  static constexpr int SK_OFF = Q_BYTES + STAGES * STAGE;   // sk [STAGES][BN]
  static constexpr int TAB_OFF = SK_OFF + STAGES * BN * 4;  // qrw [BQ][ldw]
  static constexpr int THREADS = 3 * 128;   // 2 consumer warpgroups, producer
};

struct Qk8Args {
  const float *sq, *skT;
  const bf16* qrw;
  bf16* out;
  int s, heads, gw, ldw, s_pad;
};

__host__ __device__ inline int qk8_bar_off(int ldw) {
  return (Qk8Cfg::TAB_OFF + Qk8Cfg::BQ * ldw * 4 + 7) & ~7;
}

// `bytes` from global memory to shared memory, counted on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// GW: a grid width with 128 % GW == 0 and GW >= 8 (a lane's qrw columns
// fixed at compile time), or 0 (any width up to 128)
template <int GW>
__global__ void __launch_bounds__(Qk8Cfg::THREADS, 1)
qk8_sm90(const __grid_constant__ CUtensorMap qmap,
         const __grid_constant__ CUtensorMap kmap,
         const __grid_constant__ CUtensorMap vmap, const Qk8Args a) {
  using C = Qk8Cfg;
  constexpr int BN = C::BN;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  float* sk_s = reinterpret_cast<float*>(smem + C::SK_OFF);
  float* qrw_s = reinterpret_cast<float*>(smem + C::TAB_OFF);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + qk8_bar_off(a.ldw));
  uint64_t* empty = full + C::STAGES;
  uint64_t* q_bar = empty + C::STAGES;

  const int q_start = blockIdx.x * C::BQ, h = blockIdx.y, b = blockIdx.z;
  const int s = a.s, n_t = (s + BN - 1) / BN;
  if (threadIdx.x == 0) {
    for (int i = 0; i < C::STAGES; ++i) {
      bar_init(&full[i], 1);
      bar_init(&empty[i], 8);   // one arrival per consumer warp
    }
    bar_init(q_bar, 1);
    bar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread issues every copy
    regs_dec<40>();
    if (threadIdx.x == 256) {
      const int c = a.heads * kD;
      const float* skb = a.skT + ((long long)b * a.heads + h) * a.s_pad;
      bar_expect_tx(q_bar, C::Q_BYTES);
      tma_load(smem, &qmap, q_bar, 0, q_start, h, b);
      for (int i = 0; i < n_t; ++i) {
        const int st = i % C::STAGES;
        if (i >= C::STAGES) bar_wait(&empty[st], ((i / C::STAGES) - 1) & 1);
        bar_expect_tx(&full[st], C::STAGE + BN * 4);
        unsigned char* kt = smem + C::Q_BYTES + st * C::STAGE;
        tma_load(kt, &kmap, &full[st], 0, i * BN, h, b);
        tma_load(kt + C::K_BYTES, &vmap, &full[st], 2 * c + h * kD, i * BN, b,
                 0);
        bulk_load(sk_s + st * BN, skb + i * BN, BN * 4, &full[st]);
      }
    }
    return;
  }
  // ---- consumers: 64 q rows each
  regs_inc<232>();
  const int tid = threadIdx.x, lane = tid & 31, warp = (tid & 127) >> 5;
  const int t = lane & 3;
  const int rr0 = wg * 64 + warp * 16 + (lane >> 2), rr1 = rr0 + 8;
  const int gw = a.gw;
  // the block's qrw rows, fp32 (0 past S)
  for (int i = tid; i < C::BQ * gw; i += 256) {
    const int r = i / gw, j = i - r * gw, tk = q_start + r;
    qrw_s[r * a.ldw + j] =
        tk < s ? bf(a.qrw[(((long long)b * s + tk) * a.heads + h) * gw + j])
               : 0.f;
  }
  const int tok0 = q_start + rr0, tok1 = q_start + rr1;
  const float sq0 = tok0 < s ? a.sq[((long long)b * s + tok0) * a.heads + h] : 0.f;
  const float sq1 = tok1 < s ? a.sq[((long long)b * s + tok1) * a.heads + h] : 0.f;
  named_sync(1, 256);   // both warpgroups' qrw rows
  bar_wait(q_bar, 0);

  const float* w0 = qrw_s + rr0 * a.ldw;
  const float* w1 = qrw_s + rr1 * a.ldw;
  const int r8 = 8 % gw;   // the general path's column step, mod gw
  float o[kD / 2];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) o[i] = 0.f;
  float m0 = LVV_NEG_BIG, m1 = LVV_NEG_BIG, l0 = 0.f, l1 = 0.f;
  for (int i = 0; i < n_t; ++i) {
    const int st = i % C::STAGES, k0 = i * BN;
    bar_wait(&full[st], (i / C::STAGES) & 1);
    const uint32_t kt = smem_u32(smem + C::Q_BYTES + st * C::STAGE);
    uint32_t qa;   // q's address taken anew: no descriptor held across tiles
    asm volatile("mov.b32 %0, %1;" : "=r"(qa) : "r"(smem_u32(smem) + wg * 64 * 128));
    int z[BN / 2];
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < kDepth / 32; ++ks)
      WgS8<BN>::mma(z, desc_sw128(qa + ks * 32, 16, 1024),
                    desc_sw128(kt + ks * 32, 16, 1024), ks > 0);
    wg_commit();
    wg_wait<0>();
    fence_regs(z);
    // s = (z·sq)·sk + qrw[q, kv mod gw], in that order of roundings
    const float* skt = sk_s + st * BN;
    float sc[BN / 2];
    int kwa = GW ? 0 : (k0 + 2 * t) % gw;   // general path: e = 0's column
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const float2 sk2 = *reinterpret_cast<const float2*>(skt + 8 * j + 2 * t);
      float q00, q01, q10, q11;
      if constexpr (GW > 0) {
        const int kw = (8 * j) % GW + 2 * t;
        const float2 a0 = *reinterpret_cast<const float2*>(w0 + kw);
        const float2 a1 = *reinterpret_cast<const float2*>(w1 + kw);
        q00 = a0.x;
        q01 = a0.y;
        q10 = a1.x;
        q11 = a1.y;
      } else {
        const int kwb = kwa + 1 == gw ? 0 : kwa + 1;
        q00 = w0[kwa];
        q01 = w0[kwb];
        q10 = w1[kwa];
        q11 = w1[kwb];
        kwa += r8;
        if (kwa >= gw) kwa -= gw;
      }
      const int* zj = z + 4 * j;
      float* e = sc + 4 * j;
      e[0] = __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(zj[0]), sq0), sk2.x), q00);
      e[1] = __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(zj[1]), sq0), sk2.y), q01);
      e[2] = __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(zj[2]), sq1), sk2.x), q10);
      e[3] = __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(zj[3]), sq1), sk2.y), q11);
    }
    if (k0 + BN > s) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + 8 * j + 2 * t + (e & 1) >= s) sc[4 * j + e] = LVV_NEG_BIG;
    }
    softmax_tile<BN, kD>(sc, o, m0, m1, l0, l1);
    pv_sm90<kD, BN>(o, sc, kt + C::K_BYTES, C::V_PB);
    __syncwarp();
    if (lane == 0) bar_arrive(&empty[st]);
  }
  l0 = fmaxf(l0, 1e-30f);   // guard, as the JAX kernel's finalize does
  l1 = fmaxf(l1, 1e-30f);
  const int c = a.heads * kD;
  bf16* ob = a.out + (long long)b * s * c + h * kD;
  store_rows<kD>(o, tok0 < s ? ob + (long long)tok0 * c : nullptr,
                 tok1 < s ? ob + (long long)tok1 * c : nullptr, l0, l1);
}

// ------------------------------------------------------------------ host

static int prep_launch(const void* qkv, const void* rel_h, const void* rel_w,
                       void* q8, void* k8, void* sq, void* skT, void* qrw,
                       int b, int s, int heads, int gh, int gw, int s_pad,
                       float c1, cudaStream_t stream) {
  const size_t smem = (3 * kMaxGw * kPrepLd + kMaxGw * kD) * sizeof(bf16);
  cudaError_t e = allow_smem(qk8_prep, smem);
  if (e != cudaSuccess) return (int)e;
  qk8_prep<<<dim3(gh + gw, b), 256, smem, stream>>>(
      (const bf16*)qkv, (const bf16*)rel_h, (const bf16*)rel_w,
      (signed char*)q8, (signed char*)k8, (float*)sq, (float*)skT,
      (bf16*)qrw, s, heads, gh, gw, s_pad, c1);
  return (int)cudaGetLastError();
}

template <int GW>
static int attend_n(const CUtensorMap* maps, const Qk8Args& a, int b,
                    cudaStream_t stream) {
  const int smem = qk8_bar_off(a.ldw) + (2 * Qk8Cfg::STAGES + 1) * 8 +
                   kSmemAlign;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem(qk8_sm90<GW>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.s + Qk8Cfg::BQ - 1) / Qk8Cfg::BQ, a.heads, b);
  qk8_sm90<GW><<<grid, Qk8Cfg::THREADS, smem, stream>>>(maps[0], maps[1],
                                                        maps[2], a);
  return (int)cudaGetLastError();
}

static int attend(const void* q8, const void* k8, const void* sq,
                  const void* skT, const void* qrw, const void* qkv,
                  void* out, int b, int s, int heads, int gw, int s_pad,
                  cudaStream_t stream) {
  typedef cuuint64_t u64;
  const u64 c3 = 3ull * heads * kD;
  CUtensorMap maps[3];
  // q8 / k8 [B, S, H, 128] int8: rows of 128 bytes, tokens heads·128 apart
  const u64 d8[4] = {(u64)kDepth, (u64)s, (u64)heads, (u64)b};
  const u64 s8[3] = {(u64)heads * kDepth, (u64)kDepth,
                     (u64)s * heads * kDepth};
  const u64 dv[4] = {c3, (u64)s, (u64)b, 1};
  const u64 sv[3] = {c3 * 2, c3 * 2 * s, c3 * 2 * s * b};
  cudaError_t e = gemm_map(&maps[0], CU_TENSOR_MAP_DATA_TYPE_UINT8, q8, d8, s8,
                           Qk8Cfg::BQ);
  if (e == cudaSuccess)
    e = gemm_map(&maps[1], CU_TENSOR_MAP_DATA_TYPE_UINT8, k8, d8, s8,
                 Qk8Cfg::BN);
  if (e == cudaSuccess) e = tensor_map(&maps[2], qkv, dv, sv, Qk8Cfg::BN);
  if (e != cudaSuccess) return (int)e;
  Qk8Args a;
  a.sq = (const float*)sq;
  a.skT = (const float*)skT;
  a.qrw = (const bf16*)qrw;
  a.out = (bf16*)out;
  a.s = s;
  a.heads = heads;
  a.gw = gw;
  // even gw: 8 times an odd number of floats (float2 reads of a quad's
  // columns, 8 rows a warp, on distinct 8-bank groups)
  a.ldw = gw % 2 ? gw : ((gw + 7) / 8 | 1) * 8;
  a.s_pad = s_pad;
  switch (gw) {
    case 8: return attend_n<8>(maps, a, b, stream);
    case 16: return attend_n<16>(maps, a, b, stream);
    case 32: return attend_n<32>(maps, a, b, stream);
    case 64: return attend_n<64>(maps, a, b, stream);
    case 128: return attend_n<128>(maps, a, b, stream);
    default: return attend_n<0>(maps, a, b, stream);
  }
}

static bool qk8_shape_ok(int b, int s, int heads, int gh, int gw, int s_pad) {
  return b > 0 && heads > 0 && gh > 0 && gw > 0 && gh * gw == s &&
         kD + gh <= kDepth && gh <= kMaxGh && gw <= kMaxGw &&
         s_pad == (s + Qk8Cfg::BN - 1) / Qk8Cfg::BN * Qk8Cfg::BN;
}

// The prep alone: qkv [B, S, 3·heads·64] bf16, rel_h [gh, gh, 64], rel_w
// [gw, gw, 64] bf16 (S = gh·gw, 64 + gh <= 128, gw <= 128) -> q8, k8 [B,
// S, heads, 128] int8, sq [B, S, heads] fp32, skT [B, heads, s_pad] fp32
// (s_pad = S rounded up to 128; entries past S are not written), qrw [B,
// S, heads, gw] bf16; c1 = fl(scale·log2e). Returns a cudaError_t.
extern "C" int lvv_qk8_prep(const void* qkv, const void* rel_h,
                            const void* rel_w, void* q8, void* k8, void* sq,
                            void* skT, void* qrw, int b, int s, int heads,
                            int gh, int gw, int s_pad, float c1,
                            void* stream) {
  if (!qk8_shape_ok(b, s, heads, gh, gw, s_pad))
    return (int)cudaErrorInvalidValue;
  return prep_launch(qkv, rel_h, rel_w, q8, k8, sq, skT, qrw, b, s, heads,
                     gh, gw, s_pad, c1, (cudaStream_t)stream);
}

// The attention alone on the prep's operands (layouts above), v read from
// qkv; out [B, S, heads·64] bf16. Returns a cudaError_t.
extern "C" int lvv_qk8_attention(const void* q8, const void* k8,
                                 const void* sq, const void* skT,
                                 const void* qrw, const void* qkv, void* out,
                                 int b, int s, int heads, int gw, int s_pad,
                                 void* stream) {
  if (!qk8_shape_ok(b, s, heads, s / gw, gw, s_pad) || s % gw)
    return (int)cudaErrorInvalidValue;
  return attend(q8, k8, sq, skT, qrw, qkv, out, b, s, heads, gw, s_pad,
                (cudaStream_t)stream);
}

// Both: the prep into the caller's scratch (q8, k8, sq, skT, qrw as above),
// then the attention. Returns a cudaError_t.
extern "C" int lvv_relpos_attention_qk8(const void* qkv, const void* rel_h,
                                        const void* rel_w, void* q8,
                                        void* k8, void* sq, void* skT,
                                        void* qrw, void* out, int b, int s,
                                        int heads, int gh, int gw, int s_pad,
                                        float c1, void* stream) {
  if (!qk8_shape_ok(b, s, heads, gh, gw, s_pad))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int e = prep_launch(qkv, rel_h, rel_w, q8, k8, sq, skT, qrw, b, s,
                            heads, gh, gw, s_pad, c1, st);
  if (e) return e;
  return attend(q8, k8, sq, skT, qrw, qkv, out, b, s, heads, gw, s_pad, st);
}
