// SAM attention with the decomposed relative-position bias, straight from the
// packed qkv projection (bf16 in and out, fp32 softmax):
//   out = softmax(scale·q·kᵀ + q·Rh[qh, kh] + q·Rw[qw, kw]) v
// where (qh, qw) / (kh, kw) are the grid coordinates of the query / key token.
//
// Replaces two TPU kernels that compute this one function at two shapes:
//   K-c lvv_tpu/ops/attention.py::_window_packed_kernel (window_attention_packed):
//       the 8 windowed SAM layers, 150 windows of 14x14 tokens;
//   K-d lvv_tpu/ops/attention.py::_flash_hpacked_kernel
//       (flash_attention_relpos_hpacked): the 4 global SAM layers, 6 views of
//       64x64 tokens.
// Both read qkv [B, S, 3C] (C = heads·d, token-major, row-major grid) and
// write [B, S, C], so the head axis is never transposed in device memory.
//
// What bounds it on the H100: the two products, 4·S²·d operations per
// (window or view, head), against reading qkv once: far above the card's
// ~295 operations per byte, so the bf16 tensor-core rate bounds it (the bias
// adds S·(gh + gw)·d multiply-adds, under 2% at the global shape).
//
// Design (the float arm, on the sm_90a core of attn_sm90.cuh): q, k and v
// come by TMA straight out of qkv (a tensor map over [B, S, 3C], boxes of 64
// columns at the head's offset; rows past S read as zero). A block first
// forms the two small bias tables of its q rows in shared memory,
// qRh[t, kh] = q_t·Rh[qh(t), kh] and qRw[t, kw] = q_t·Rw[qw(t), kw], on the
// tensor cores (mma.sync over the rows that share qh, or qw, against that
// slice of R: the bf16 products are exact and summed in fp32), from
// UNSCALED q as SAM defines the bias (only q·k takes 1/√d). The [S, S] bias
// never exists anywhere: each score adds qRh[t, kh] + qRw[t, kw], with no
// division per score:
//   - global grids (streaming regime): one block owns 128 q rows (two
//     consumer warpgroups on wgmma) and a producer warp streams K / V tiles
//     through a TMA ring. On SAM's 64-wide grid the 128 rows are an 8 x 16
//     patch of the grid, so the tables need 8 slices of Rh and 16 of Rw
//     (not 2 and 64), and a 128-key tile is two whole grid rows: kh is the
//     tile's row plus a compile-time step, kw a compile-time column plus
//     2·(lane % 4), and the width table is read as float2 with a row pitch
//     of 72 words (8 rows, 8 banks apart). Other grids take 128 tokens in
//     grid order and read (kh, kw) from a per-block column table.
//   - windows (S <= 256, resident regime): one block per (window, head)
//     loads the window's q, k and v once and keeps them resident; kv is
//     padded only to the 16-row k-step of P·V (196 -> 208), q to whole
//     64-row tiles. Two warpgroups take the q tiles in turn, each an online
//     softmax over kv chunks of 64 rows and the 16-row rest, which keeps a
//     thread within 128 registers so that two blocks share an SM.
// The TPU's base-2 / log2e operand packing is a layout trick of K-d and is
// not copied: the scores are scaled by log2e here only to use exp2. Windows
// are full 196-token sequences (the 64x64 grid is zero-padded to 70x70
// before partitioning and the zero tokens take part, unmasked, as in the
// reference); only the kv columns past S are masked.
//
// The int8 p@v arm (K-d8, LVV_Q8_SCOPE "attn" on the 4 global layers)
// replaces the `quant8` arm of the same TPU kernel (attention.py:717-723).
// v arrives quantized per (view, head, channel) by the wrapper, transposed
// to [B, H, d, S] (kv is the contraction axis of p@v) with kv permuted
// inside each 16 columns; p is quantized in the kernel per row and per
// GROUP of `pv_group` kv columns (1024, the TPU's kv tile) against the
// group's own maximum. It runs on pv8_sm90.cuh's core (two passes a group,
// wgmma s8 with p8 from registers, a TMA ring of K and int8 V tiles), with
// q and K read out of qkv and the bias tables formed as in the float arm's
// streaming regime; SAM's 64-wide grids keep the 8 x 16 q patch and the
// compile-time (kh, kw).
//
// What bounds the int8 arm on the H100: 2·S²·d bf16 operations for q·k and
// 2·S²·d int8 operations for p@v: about 0.24 ms at the global shape (the
// second q·k of the two passes is the design's work, not the bound's).
#include "pv8_sm90.cuh"

constexpr int kMaxGh = 64;
constexpr int kMaxGw = 128;

// ------------------------------------------------------------- float arm

using namespace sm90;

// One group of q rows that share a grid coordinate x (qh for the height
// table, qw for the width table): rows start + stride·i (i < count) of the
// swizzled q panels (q_pb bytes a panel). Their products with R[x] ([g, D],
// row-major in global memory) go to table[row·ld + n], n < g: one warp,
// mma.sync m16n8k16 over 16 rows at a time (rows past `count` repeat the
// last one and are not stored), B fragments straight from R through L1.
// The products are exact and summed in fp32, as in the plain version;
// the tables hold them times log2(e), the scores' base-2 domain.
template <int D>
__device__ void table_group(float* table, int ld,
                            const unsigned char* q_panels, int q_pb,
                            int start, int stride, int count,
                            const bf16* __restrict__ r, int g) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, t = lane & 3;
  for (int i0 = 0; i0 < count; i0 += 16) {
    const int ia = i0 + gq, ib = ia + 8;
    const int ra = start + stride * min(ia, count - 1);
    const int rb = start + stride * min(ib, count - 1);
    uint32_t a[D / 16][4];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const bf16* pan =
          reinterpret_cast<const bf16*>(q_panels + (kk / 4) * q_pb);
      const int ch = 2 * (kk % 4);   // 16-byte chunk of columns 16·kk
      a[kk][0] = *reinterpret_cast<const uint32_t*>(
          pan + ra * 64 + ((ch ^ (ra & 7)) << 3) + 2 * t);
      a[kk][1] = *reinterpret_cast<const uint32_t*>(
          pan + rb * 64 + ((ch ^ (rb & 7)) << 3) + 2 * t);
      a[kk][2] = *reinterpret_cast<const uint32_t*>(
          pan + ra * 64 + (((ch + 1) ^ (ra & 7)) << 3) + 2 * t);
      a[kk][3] = *reinterpret_cast<const uint32_t*>(
          pan + rb * 64 + (((ch + 1) ^ (rb & 7)) << 3) + 2 * t);
    }
    for (int n0 = 0; n0 < g; n0 += 8) {
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      const int nr = n0 + gq;   // the R row of this lane's B fragment
      const uint32_t* rp =
          reinterpret_cast<const uint32_t*>(r + (long long)min(nr, g - 1) * D);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t bb[2];
        bb[0] = nr < g ? __ldg(rp + kk * 8 + t) : 0u;
        bb[1] = nr < g ? __ldg(rp + kk * 8 + 4 + t) : 0u;
        mma16816(c, a[kk], bb);
      }
      const int n = n0 + 2 * t;
      if (ia < count) {
        if (n < g) table[ra * ld + n] = c[0] * LVV_LOG2E;
        if (n + 1 < g) table[ra * ld + n + 1] = c[1] * LVV_LOG2E;
      }
      if (ib < count) {
        if (n < g) table[rb * ld + n] = c[2] * LVV_LOG2E;
        if (n + 1 < g) table[rb * ld + n + 1] = c[3] * LVV_LOG2E;
      }
    }
  }
}

// Both tables of the block's q rows, the groups dealt out to the warps
// (warp `w` of `n_warps`): bh_s[row·ldh + kh] = q·Rh[qh(row), kh] and
// bw_s[row·ldw + kw] = q·Rw[qw(row), kw], from UNSCALED q. PATCH: the rows
// are a PH x PW patch of the grid at (qh0, qw0), row = PW·(qh - qh0) +
// (qw - qw0); otherwise the tokens tok0 .. tok0 + rows - 1 in grid order
// (only those below S).
template <int D, bool PATCH, int PH = 1, int PW = 1>
__device__ void bias_tables(float* bh_s, float* bw_s, int ldh, int ldw,
                            const unsigned char* q_panels, int q_pb, int tok0,
                            int qh0, int qw0, int rows, int s, int gh,
                            int gw, const bf16* __restrict__ rel_h,
                            const bf16* __restrict__ rel_w, int w,
                            int n_warps) {
  if constexpr (PATCH) {
    for (int k = w; k < PH + PW; k += n_warps) {
      if (k < PH)
        table_group<D>(bh_s, ldh, q_panels, q_pb, PW * k, 1, PW,
                       rel_h + (long long)(qh0 + k) * gh * D, gh);
      else
        table_group<D>(bw_s, ldw, q_panels, q_pb, k - PH, PW, PH,
                       rel_w + (long long)(qw0 + k - PH) * gw * D, gw);
    }
  } else {
    const int n = min(rows, s - tok0);   // rows that are tokens
    const int h_first = tok0 / gw, n_h = (tok0 + n - 1) / gw - h_first + 1;
    for (int k = w; k < n_h + gw; k += n_warps) {
      if (k < n_h) {
        const int qh = h_first + k;
        const int start = max(qh * gw - tok0, 0);
        const int end = min((qh + 1) * gw - tok0, n);
        table_group<D>(bh_s, ldh, q_panels, q_pb, start, 1, end - start,
                       rel_h + (long long)qh * gh * D, gh);
      } else {
        const int qw = k - n_h, start = (qw - tok0 % gw + gw) % gw;
        if (start < n)
          table_group<D>(bw_s, ldw, q_panels, q_pb, start, gw,
                         (n - 1 - start) / gw + 1,
                         rel_w + (long long)qw * gw * D, gw);
      }
    }
  }
}

// Shared memory past the tiles, at run-time offsets: the two tables (`rows`
// rows of ldh / ldw floats), the column table (kv -> kh | kw << 8, 16 bits
// each) and the barriers.
struct Tail {
  int bw, ctab, bar, total;
};

__host__ __device__ inline Tail tail_layout(int tab_off, int rows, int ldh,
                                            int ldw, int ctab_n) {
  Tail t;
  t.bw = tab_off + rows * ldh * 4;
  t.ctab = t.bw + rows * ldw * 4;
  t.bar = (t.ctab + ctab_n * 2 + 7) & ~7;
  t.total = t.bar + 8 * 8;
  return t;
}

// the bias of block row `row` at kv column (kh, kw) from the column table
__device__ __forceinline__ float table_bias(const float* bh_s,
                                            const float* bw_s, int ldh,
                                            int ldw, int row, uint32_t hw) {
  return bh_s[row * ldh + (hw & 255)] + bw_s[row * ldw + (hw >> 8)];
}

template <int D, bool G64>
struct StreamCfg {
  static constexpr int BQ = 128;
  static constexpr int BN = D == 64 ? 128 : 64;
  // three stages where the tables leave room (the column table of another
  // grid may take 16 KB)
  static constexpr int STAGES = G64 && D == 64 ? 3 : 2;
  static constexpr int PANELS = D / 64;
  static constexpr int Q_PB = BQ * 128, KV_PB = BN * 128;
  static constexpr int Q_BYTES = PANELS * Q_PB, TILE_BYTES = PANELS * KV_PB;
  static constexpr int TAB_OFF = Q_BYTES + STAGES * 2 * TILE_BYTES;
  static constexpr int THREADS = 3 * 128;   // 2 consumer warpgroups, producer
};

// Streaming regime: 128 q rows a block, K / V tiles through the TMA ring.
// G64 (the grid is 64 wide, gh a multiple of 8): the block's q rows are an
// 8 x 16 patch of the grid (qmap reads [3C, gw, gh, B] in boxes of 16 x 8
// tokens), so its bias tables need 8 slices of Rh and 16 of Rw, not 2 and
// 64; and a 128-key tile is two whole grid rows, so kh and kw of a score are
// fixed at compile time up to the tile's grid row and the lane's column
// pair. Otherwise the q rows are 128 tokens in grid order and (kh, kw) come
// from the column table.
template <int D, bool G64>
__global__ void __launch_bounds__(StreamCfg<D, G64>::THREADS, 1)
relpos_stream_sm90(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kvmap,
                   const bf16* __restrict__ rel_h,
                   const bf16* __restrict__ rel_w, bf16* __restrict__ out,
                   int s, int heads, int gh, int gw, int ldh, int ldw,
                   float scale) {
  using C = StreamCfg<D, G64>;
  constexpr int BN = C::BN;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const Tail tl = tail_layout(C::TAB_OFF, C::BQ, ldh, ldw, G64 ? 0 : s);
  unsigned char* ring = smem + C::Q_BYTES;   // stage i: K then V
  float* bh_s = reinterpret_cast<float*>(smem + C::TAB_OFF);
  float* bw_s = reinterpret_cast<float*>(smem + tl.bw);
  uint16_t* ctab = reinterpret_cast<uint16_t*>(smem + tl.ctab);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + tl.bar);
  uint64_t* empty = full + C::STAGES;
  uint64_t* q_bar = empty + C::STAGES;

  constexpr int PH = 8, PW = 16;   // the G64 patch
  const int q_start = blockIdx.x * C::BQ, h = blockIdx.y, b = blockIdx.z;
  const int qh0 = PH * (blockIdx.x / (64 / PW));
  const int qw0 = PW * (blockIdx.x % (64 / PW));
  const int c = heads * D;
  const int n_t = (s + BN - 1) / BN;
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
    // ---- producer: one thread issues every TMA load
    regs_dec<40>();
    if (threadIdx.x == 256) {
      bar_expect_tx(q_bar, C::Q_BYTES);
      for (int a = 0; a < C::PANELS; ++a) {
        if constexpr (G64)
          tma_load(smem + a * C::Q_PB, &qmap, q_bar, h * D + a * 64, qw0,
                   qh0, b);
        else
          tma_load(smem + a * C::Q_PB, &qmap, q_bar, h * D + a * 64, q_start,
                   b, 0);
      }
      for (int i = 0; i < n_t; ++i) {
        const int st = i % C::STAGES;
        if (i >= C::STAGES) bar_wait(&empty[st], ((i / C::STAGES) - 1) & 1);
        bar_expect_tx(&full[st], 2 * C::TILE_BYTES);
        unsigned char* kt = ring + st * 2 * C::TILE_BYTES;
        for (int a = 0; a < C::PANELS; ++a) {
          tma_load(kt + a * C::KV_PB, &kvmap, &full[st], c + h * D + a * 64,
                   i * BN, b, 0);
          tma_load(kt + C::TILE_BYTES + a * C::KV_PB, &kvmap, &full[st],
                   2 * c + h * D + a * 64, i * BN, b, 0);
        }
      }
    }
  } else {
    // ---- consumers: 64 q rows each
    regs_inc<232>();
    const int tid = threadIdx.x & 127, lane = tid & 31, warp = tid >> 5;
    const int t = lane & 3;
    const int rr0 = wg * 64 + warp * 16 + (lane >> 2), rr1 = rr0 + 8;
    if constexpr (!G64) {
      for (int i = threadIdx.x; i < s; i += 256)
        ctab[i] = (uint16_t)((i / gw) | ((i % gw) << 8));
    }
    bar_wait(q_bar, 0);
    bias_tables<D, G64, PH, PW>(bh_s, bw_s, ldh, ldw, smem, C::Q_PB, q_start,
                                qh0, qw0, C::BQ, s, gh, gw, rel_h, rel_w,
                                threadIdx.x >> 5, 8);
    named_sync(1, 256);   // both warpgroups' tables and the column table

    const uint32_t q_addr = smem_u32(smem) + wg * 64 * 128;
    const float* bh0 = bh_s + rr0 * ldh;
    const float* bh1 = bh_s + rr1 * ldh;
    const float* bw0 = bw_s + rr0 * ldw;
    const float* bw1 = bw_s + rr1 * ldw;
    const float sl = scale * LVV_LOG2E;   // the tables are log2-domain
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m0 = LVV_NEG_BIG, m1 = LVV_NEG_BIG, l0 = 0.f, l1 = 0.f;
    auto tile = [&](int i) {
      const int st = i % C::STAGES;
      bar_wait(&full[st], (i / C::STAGES) & 1);
      return smem_u32(ring + st * 2 * C::TILE_BYTES);
    };
    auto scores = [&](int i, float (&sc)[BN / 2]) {
      const int k0 = i * BN;
      if constexpr (G64) {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int kh = (k0 >> 6) + (j >> 3), kw = ((8 * j) & 63) + 2 * t;
          const float h0 = bh0[kh], h1 = bh1[kh];
          const float2 w0 = *reinterpret_cast<const float2*>(bw0 + kw);
          const float2 w1 = *reinterpret_cast<const float2*>(bw1 + kw);
          sc[4 * j] = fmaf(sc[4 * j], sl, h0 + w0.x);
          sc[4 * j + 1] = fmaf(sc[4 * j + 1], sl, h0 + w0.y);
          sc[4 * j + 2] = fmaf(sc[4 * j + 2], sl, h1 + w1.x);
          sc[4 * j + 3] = fmaf(sc[4 * j + 3], sl, h1 + w1.y);
        }
        if (k0 + BN > s) {
#pragma unroll
          for (int j = 0; j < BN / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (k0 + 8 * j + 2 * t + (e & 1) >= s)
                sc[4 * j + e] = LVV_NEG_BIG;
        }
      } else {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = k0 + 8 * j + 2 * t + e;
            const uint32_t hw = col < s ? ctab[col] : 0u;
            sc[4 * j + e] =
                col < s ? fmaf(sc[4 * j + e], sl,
                               table_bias(bh_s, bw_s, ldh, ldw, rr0, hw))
                        : LVV_NEG_BIG;
            sc[4 * j + 2 + e] =
                col < s ? fmaf(sc[4 * j + 2 + e], sl,
                               table_bias(bh_s, bw_s, ldh, ldw, rr1, hw))
                        : LVV_NEG_BIG;
          }
        }
      }
    };
    auto release = [&](int i) {
      __syncwarp();
      if (lane == 0) bar_arrive(&empty[i % C::STAGES]);
    };
    attn_mainloop<D, D, BN>(n_t, q_addr, C::Q_PB, C::KV_PB, C::TILE_BYTES,
                            tile, scores, release, o, m0, m1, l0, l1);
    l0 = fmaxf(l0, 1e-30f);   // guard, as the JAX kernel's finalize does
    l1 = fmaxf(l1, 1e-30f);
    bf16* ob = out + (long long)b * s * c + h * D;
    const int tok0 = G64 ? (qh0 + rr0 / PW) * 64 + qw0 + rr0 % PW
                         : q_start + rr0;
    const int tok1 = G64 ? (qh0 + rr1 / PW) * 64 + qw0 + rr1 % PW
                         : q_start + rr1;
    store_rows<D>(o, tok0 < s ? ob + (long long)tok0 * c : nullptr,
                  tok1 < s ? ob + (long long)tok1 * c : nullptr, l0, l1);
  }
}

// The log2-domain logits of the kv chunk [k0, k0 + NC) of a window for this
// thread's table rows tr0 and tr1: q·k·scale·log2(e) + the two tables;
// LVV_NEG_BIG past S.
template <int NC>
__device__ __forceinline__ void window_scores(
    float (&sc)[NC / 2], int k0, int s, int gw, float sl,
    const uint16_t* ctab, const float* bh_s, const float* bw_s, int ldh,
    int ldw, int tr0, int tr1) {
  const int t = threadIdx.x & 3;
  if (gw % 2 == 0) {
    // kv 2i and 2i + 1 share kh and take neighbouring kw: one float2
    const float* bh0 = bh_s + tr0 * ldh;
    const float* bh1 = bh_s + tr1 * ldh;
    const float* bw0 = bw_s + tr0 * ldw;
    const float* bw1 = bw_s + tr1 * ldw;
#pragma unroll
    for (int j = 0; j < NC / 8; ++j) {
      const int col = k0 + 8 * j + 2 * t;
      const uint32_t hw = ctab[col], kh = hw & 255, kw = hw >> 8;
      const float h0 = bh0[kh], h1 = bh1[kh];
      const float2 w0 = *reinterpret_cast<const float2*>(bw0 + kw);
      const float2 w1 = *reinterpret_cast<const float2*>(bw1 + kw);
      const bool in = col < s;   // S is even here
      sc[4 * j] = in ? fmaf(sc[4 * j], sl, h0 + w0.x) : LVV_NEG_BIG;
      sc[4 * j + 1] = in ? fmaf(sc[4 * j + 1], sl, h0 + w0.y) : LVV_NEG_BIG;
      sc[4 * j + 2] = in ? fmaf(sc[4 * j + 2], sl, h1 + w1.x) : LVV_NEG_BIG;
      sc[4 * j + 3] = in ? fmaf(sc[4 * j + 3], sl, h1 + w1.y) : LVV_NEG_BIG;
    }
  } else {
#pragma unroll
    for (int j = 0; j < NC / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = k0 + 8 * j + 2 * t + e;
        const uint32_t hw = ctab[col];
        sc[4 * j + e] =
            col < s ? fmaf(sc[4 * j + e], sl,
                           table_bias(bh_s, bw_s, ldh, ldw, tr0, hw))
                    : LVV_NEG_BIG;
        sc[4 * j + 2 + e] =
            col < s ? fmaf(sc[4 * j + 2 + e], sl,
                           table_bias(bh_s, bw_s, ldh, ldw, tr1, hw))
                    : LVV_NEG_BIG;
      }
    }
  }
}

// Resident regime (S <= 256): one block per (window, head) loads the
// window's q (S rows, rounded up to 8), k and v (N rows: S rounded up to 16
// or a power of two) once and keeps them resident; its two warpgroups take
// the qr / 64 q tiles in turn (qr: S rounded up to 64), each an online
// softmax over kv chunks of 64 rows and a last chunk of N % 64 (16 at
// S = 196). The chunks keep a thread's registers within 128, so two blocks
// share an SM at d 64 (at d 128 the tiles take most of the shared memory).
template <int D, int N>
__global__ void __launch_bounds__(256, D == 64 ? 2 : 1)
relpos_window_sm90(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kvmap,
                   const bf16* __restrict__ rel_h,
                   const bf16* __restrict__ rel_w, bf16* __restrict__ out,
                   int s, int heads, int gh, int gw, int ldh, int ldw,
                   float scale, int qr) {
  constexpr int PANELS = D / 64, KV_PB = N * 128, TAIL = N % 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  // q holds S rounded up to 8 rows: the last tile's rows past them read
  // into K's panels (garbage scores in rows that are not written)
  const int q_pb = (s + 7) / 8 * 8 * 128;
  const int k_off = PANELS * q_pb, v_off = k_off + PANELS * KV_PB;
  const Tail tl = tail_layout(v_off + PANELS * KV_PB, s, ldh, ldw, N);
  float* bh_s = reinterpret_cast<float*>(smem + v_off + PANELS * KV_PB);
  float* bw_s = reinterpret_cast<float*>(smem + tl.bw);
  uint16_t* ctab = reinterpret_cast<uint16_t*>(smem + tl.ctab);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + tl.bar);

  const int h = blockIdx.x, b = blockIdx.y, c = heads * D;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) {
    bar_init(bar, 1);
    bar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    bar_expect_tx(bar, PANELS * (q_pb + 2 * KV_PB));
    for (int a = 0; a < PANELS; ++a) {
      tma_load(smem + a * q_pb, &qmap, bar, h * D + a * 64, 0, b, 0);
      tma_load(smem + k_off + a * KV_PB, &kvmap, bar, c + h * D + a * 64, 0,
               b, 0);
      tma_load(smem + v_off + a * KV_PB, &kvmap, bar, 2 * c + h * D + a * 64,
               0, b, 0);
    }
  }
  for (int i = tid; i < N; i += 256)
    ctab[i] = i < s ? (uint16_t)((i / gw) | ((i % gw) << 8)) : 0;
  bar_wait(bar, 0);
  bias_tables<D, false>(bh_s, bw_s, ldh, ldw, smem, q_pb, 0, 0, 0, s, s, gh,
                        gw, rel_h, rel_w, warp, 8);
  __syncthreads();

  const uint32_t base = smem_u32(smem);
  const float sl = scale * LVV_LOG2E;   // the tables are log2-domain
  bf16* ob = out + (long long)b * s * c + h * D;
  for (int qt = tid >> 7; qt < qr / 64; qt += 2) {
    const int rr0 = qt * 64 + (warp & 3) * 16 + (lane >> 2), rr1 = rr0 + 8;
    // rows past S compute on row S - 1's tables and are not written
    const int tr0 = min(rr0, s - 1), tr1 = min(rr1, s - 1);
    const uint32_t q_addr = base + qt * 64 * 128;
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m0 = LVV_NEG_BIG, m1 = LVV_NEG_BIG, l0 = 0.f, l1 = 0.f;
    for (int k0 = 0; k0 + 64 <= N; k0 += 64) {
      float sc[32];
      qk_sm90<D, 64>(sc, q_addr, q_pb, base + k_off + k0 * 128, KV_PB);
      window_scores<64>(sc, k0, s, gw, sl, ctab, bh_s, bw_s, ldh, ldw, tr0,
                        tr1);
      softmax_tile<64, D>(sc, o, m0, m1, l0, l1);
      pv_sm90<D, 64>(o, sc, base + v_off + k0 * 128, KV_PB);
    }
    if constexpr (TAIL > 0) {
      constexpr int k0 = N - TAIL;
      float sc[TAIL / 2];
      qk_sm90<D, TAIL>(sc, q_addr, q_pb, base + k_off + k0 * 128, KV_PB);
      window_scores<TAIL>(sc, k0, s, gw, sl, ctab, bh_s, bw_s, ldh, ldw, tr0,
                          tr1);
      softmax_tile<TAIL, D>(sc, o, m0, m1, l0, l1);
      pv_sm90<D, TAIL>(o, sc, base + v_off + k0 * 128, KV_PB);
    }
    l0 = fmaxf(l0, 1e-30f);
    l1 = fmaxf(l1, 1e-30f);
    store_rows<D>(o, rr0 < s ? ob + (long long)rr0 * c : nullptr,
                  rr1 < s ? ob + (long long)rr1 * c : nullptr, l0, l1);
  }
}

template <int D, int N>
static int launch_window(const CUtensorMap* maps, const void* rel_h,
                         const void* rel_w, void* out, int b, int s,
                         int heads, int gh, int gw, int ldh, int ldw,
                         float scale, int qr, int smem, cudaStream_t stream) {
  cudaError_t e = allow_smem(relpos_window_sm90<D, N>, smem);
  if (e != cudaSuccess) return (int)e;
  relpos_window_sm90<D, N><<<dim3(heads, b), 256, smem, stream>>>(
      maps[0], maps[1], (const bf16*)rel_h, (const bf16*)rel_w, (bf16*)out,
      s, heads, gh, gw, ldh, ldw, scale, qr);
  return (int)cudaGetLastError();
}

template <int D, bool G64>
static int launch_stream(const CUtensorMap* maps, const void* rel_h,
                         const void* rel_w, void* out, int b, int s,
                         int heads, int gh, int gw, int ldh, int ldw,
                         float scale, cudaStream_t stream) {
  using C = StreamCfg<D, G64>;
  const int smem =
      tail_layout(C::TAB_OFF, C::BQ, ldh, ldw, G64 ? 0 : s).total +
      kSmemAlign;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem(relpos_stream_sm90<D, G64>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((s + C::BQ - 1) / C::BQ, heads, b);
  relpos_stream_sm90<D, G64><<<grid, C::THREADS, smem, stream>>>(
      maps[0], maps[1], (const bf16*)rel_h, (const bf16*)rel_w, (bf16*)out,
      s, heads, gh, gw, ldh, ldw, scale);
  return (int)cudaGetLastError();
}

// The float arm: the resident regime where the window fits it (S <= 256 and
// its tiles fit shared memory), the streaming regime otherwise.
template <int D>
static int launch_float(const void* qkv, const void* rel_h, const void* rel_w,
                        void* out, int b, int s, int heads, int gh, int gw,
                        float scale, cudaStream_t stream) {
  typedef cuuint64_t u64;
  const u64 c3 = 3ull * heads * D;
  const u64 dims[4] = {c3, (u64)s, (u64)b, 1};
  const u64 strides[3] = {c3 * 2, c3 * 2 * s, c3 * 2 * s * b};
  const int ldh = gh | 1;   // odd: a column of 8 rows hits 8 banks
  CUtensorMap maps[2];
  const int n = s <= 64 ? 64 : s <= 128 ? 128 : s <= 208 ? 208 : 256;
  if (s <= 256) {
    // even gw: rows of an even pitch for the float2 reads of kw pairs
    const int qr = (s + 63) / 64 * 64, ldw = gw % 2 ? gw : gw + 4;
    const int q_rows = (s + 7) / 8 * 8;
    const int smem =
        tail_layout(D / 64 * (q_rows + 2 * n) * 128, s, ldh, ldw, n).total +
        kSmemAlign;
    if (smem <= kMaxSmem) {
      cudaError_t e = tensor_map(&maps[0], qkv, dims, strides, q_rows);
      if (e == cudaSuccess) e = tensor_map(&maps[1], qkv, dims, strides, n);
      if (e != cudaSuccess) return (int)e;
#define LVV_WINDOW(N)                                                      \
  launch_window<D, N>(maps, rel_h, rel_w, out, b, s, heads, gh, gw, ldh, \
                      ldw, scale, qr, smem, stream)
      switch (n) {
        case 64: return LVV_WINDOW(64);
        case 128: return LVV_WINDOW(128);
        case 208: return LVV_WINDOW(208);
        default: return LVV_WINDOW(256);
      }
#undef LVV_WINDOW
    }
  }
  constexpr int BQ = StreamCfg<D, false>::BQ, BN = StreamCfg<D, false>::BN;
  const bool g64 = gw == 64 && gh % 8 == 0;
  const int ldw = g64 ? 72 : (gw | 1);   // 72: float2 rows 8 banks apart
  cudaError_t e = tensor_map(&maps[1], qkv, dims, strides, BN);
  if (e != cudaSuccess) return (int)e;
  if (!g64) {
    e = tensor_map(&maps[0], qkv, dims, strides, BQ);
    return e != cudaSuccess
               ? (int)e
               : launch_stream<D, false>(maps, rel_h, rel_w, out, b, s, heads,
                                         gh, gw, ldh, ldw, scale, stream);
  }
  // q as [B, gh, gw, 3C], read in patches of 8 grid rows by 16 columns
  const u64 pdims[4] = {c3, (u64)gw, (u64)gh, (u64)b};
  const u64 pstrides[3] = {c3 * 2, c3 * 2 * gw, c3 * 2 * s};
  e = tensor_map(&maps[0], qkv, pdims, pstrides, 16, 8);
  return e != cudaSuccess
             ? (int)e
             : launch_stream<D, true>(maps, rel_h, rel_w, out, b, s, heads,
                                      gh, gw, ldh, ldw, scale, stream);
}

// ------------------------------------------------------------- int8 arm

// K-d8: 128 q rows a block (G64: an 8 x 16 patch of the grid, as
// relpos_stream_sm90), two warpgroups on pv8_consume and a producer warp
// that streams K (out of qkv) and V8 (out of v8t) through the ring.
template <int D, int NS, int WGS, bool G64>
__global__ void __launch_bounds__(Pv8Cfg<D, D, NS, WGS>::THREADS, 1)
relpos_pv8_sm90(const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap kvmap,
                const __grid_constant__ CUtensorMap vmap,
                const bf16* __restrict__ rel_h,
                const bf16* __restrict__ rel_w, const float* __restrict__ sv,
                bf16* __restrict__ out, int s, int heads, int gh, int gw,
                int ldh, int ldw, int group, int stages, float scale) {
  using C = Pv8Cfg<D, D, NS, WGS>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const Pv8Smem L =
      pv8_smem(C::Q_BYTES, C::STAGE, stages, C::BQ * (ldh + ldw) * 4);
  float* bh_s = reinterpret_cast<float*>(smem + L.tab);
  float* bw_s = bh_s + C::BQ * ldh;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L.bar);
  uint64_t* q_bar = bar + 2 * stages;

  constexpr int PH = 8, PW = 16;   // the G64 patch
  const int q_start = blockIdx.x * C::BQ, h = blockIdx.y, b = blockIdx.z;
  const int qh0 = PH * (blockIdx.x / (64 / PW));
  const int qw0 = PW * (blockIdx.x % (64 / PW));
  const int c = heads * D;
  pv8_init_bars(bar, stages, C::CONS / 32);
  if (threadIdx.x >= C::CONS) {
    // ---- producer: one thread issues every TMA load
    if (threadIdx.x == C::CONS) {
      bar_expect_tx(q_bar, C::Q_BYTES);
      for (int a = 0; a < C::QP; ++a) {
        if constexpr (G64)
          tma_load(smem + a * C::Q_PB, &qmap, q_bar, h * D + a * 64, qw0,
                   qh0, b);
        else
          tma_load(smem + a * C::Q_PB, &qmap, q_bar, h * D + a * 64, q_start,
                   b, 0);
      }
      pv8_produce<C>(s, group, stages, smem + C::Q_BYTES, bar, &vmap, h, b,
                     [&](unsigned char* dst, uint64_t* full, int row) {
                       for (int a = 0; a < C::QP; ++a)
                         tma_load(dst + a * C::KV_PB, &kvmap, full,
                                  c + h * D + a * 64, row, b, 0);
                     });
    }
    return;
  }
  // ---- consumers: 64 q rows each
  const int wg = threadIdx.x / 128, lane = threadIdx.x & 31;
  const int rr0 = wg * 64 + ((threadIdx.x & 127) >> 5) * 16 + (lane >> 2);
  const int rr1 = rr0 + 8;
  bar_wait(q_bar, 0);
  bias_tables<D, G64, PH, PW>(bh_s, bw_s, ldh, ldw, smem, C::Q_PB, q_start,
                              qh0, qw0, C::BQ, s, gh, gw, rel_h, rel_w,
                              threadIdx.x >> 5, C::CONS / 32);
  named_sync(1, C::CONS);   // the warpgroups' tables

  const Pv8SmemRows tab{bh_s + rr0 * ldh, bh_s + rr1 * ldh, bw_s + rr0 * ldw,
                        bw_s + rr1 * ldw};
  const float sl = scale * LVV_LOG2E;   // the tables are log2-domain
  auto scores = [&](int c0, float (&sc)[NS / 2], float m0, float m1) {
    pv8_bias<NS, G64 ? kGridG64 : kGridAny, false>(sc, c0, sl, gw, tab, m0,
                                                  m1);
  };
  float o[D / 2];
  float l0, l1;
  pv8_consume<C, D, D>(s, group, stages, smem_u32(smem) + wg * 64 * 128,
                       smem_u32(smem + C::Q_BYTES), bar, scores,
                       sv + ((long long)b * heads + h) * D, o, l0, l1);
  bf16* ob = out + (long long)b * s * c + h * D;
  const int tok0 = G64 ? (qh0 + rr0 / PW) * 64 + qw0 + rr0 % PW
                       : q_start + rr0;
  const int tok1 = G64 ? (qh0 + rr1 / PW) * 64 + qw0 + rr1 % PW
                       : q_start + rr1;
  store_rows<D>(o, tok0 < s ? ob + (long long)tok0 * c : nullptr,
                tok1 < s ? ob + (long long)tok1 * c : nullptr, l0, l1);
}

template <int D, int NS, int WGS, bool G64>
static int launch_pv8_sm90(const CUtensorMap* maps, const void* rel_h,
                           const void* rel_w, const void* sv, void* out,
                           int b, int s, int heads, int gh, int gw, int ldw,
                           int group, int stages, float scale,
                           cudaStream_t stream) {
  using C = Pv8Cfg<D, D, NS, WGS>;
  const int ldh = gh | 1;
  const int smem = pv8_smem_bytes<C>(stages, C::BQ * (ldh + ldw) * 4);
  if (stages < 2 || smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem(relpos_pv8_sm90<D, NS, WGS, G64>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((s + C::BQ - 1) / C::BQ, heads, b);
  relpos_pv8_sm90<D, NS, WGS, G64><<<grid, C::THREADS, smem, stream>>>(
      maps[0], maps[1], maps[2], (const bf16*)rel_h, (const bf16*)rel_w,
      (const float*)sv, (bf16*)out, s, heads, gh, gw, ldh, ldw, group, stages,
      scale);
  return (int)cudaGetLastError();
}

// The int8 arm on the plan the wrapper made (ops/attention.py `pv8_plan`):
// rule (kGridG64 on SAM's 64-wide grids, else kGridAny), the width
// table's pitch, the step, the q rows of a block and the ring's stages.
// Maps over qkv (as the float arm's streaming regime) and v8t, then the
// plan's kernel.
static int launch_pv8(const void* qkv, const void* rel_h, const void* rel_w,
                      const void* v8t, const void* sv, void* out, int b,
                      int s, int heads, int d, int gh, int gw, int s_pad,
                      int group, int rule, int ldw, int step, int rows,
                      int stages, float scale, cudaStream_t stream) {
  typedef cuuint64_t u64;
  const bool g64 = rule == kGridG64;
  if (g64 && (d != 64 || gw != 64 || gh % 8 || step != 128))
    return (int)cudaErrorInvalidValue;
  const u64 c3 = 3ull * heads * d;
  const u64 dims[4] = {c3, (u64)s, (u64)b, 1};
  const u64 strides[3] = {c3 * 2, c3 * 2 * s, c3 * 2 * s * b};
  CUtensorMap maps[3];
  cudaError_t e = tensor_map(&maps[1], qkv, dims, strides, 128);
  if (e == cudaSuccess) e = pv8_vmap(&maps[2], v8t, b, heads, d, s_pad);
  if (e == cudaSuccess && g64) {
    // q as [B, gh, gw, 3C], read in patches of 8 grid rows by 16 columns
    const u64 pdims[4] = {c3, (u64)gw, (u64)gh, (u64)b};
    const u64 pstrides[3] = {c3 * 2, c3 * 2 * gw, c3 * 2 * s};
    e = tensor_map(&maps[0], qkv, pdims, pstrides, 16, 8);
  } else if (e == cudaSuccess) {
    e = tensor_map(&maps[0], qkv, dims, strides, rows);
  }
  if (e != cudaSuccess) return (int)e;
#define LVV_PV8(D, NS, WGS, G64)                                       \
  launch_pv8_sm90<D, NS, WGS, G64>(maps, rel_h, rel_w, sv, out, b, s,  \
                                   heads, gh, gw, ldw, group, stages,  \
                                   scale, stream)
  if (g64 && rows == 128) return LVV_PV8(64, 128, 2, true);
  if (rule == kGridAny && d == 64 && step == 64 && rows == 128)
    return LVV_PV8(64, 64, 2, false);
  if (rule == kGridAny && d == 128 && step == 32 && rows == 64)
    return LVV_PV8(128, 32, 1, false);
#undef LVV_PV8
  return (int)cudaErrorInvalidValue;
}

// ------------------------------------------------------------- entry

// qkv [B, S, 3·heads·d], rel_h [gh, gh, d], rel_w [gw, gw, d], out
// [B, S, heads·d], all contiguous bf16, S = gh·gw, gh <= 64, gw <= 128.
// pv_group 0: the float arm (the int8 arguments unused). Otherwise the int8
// p@v arm with p quantized per pv_group kv columns (a multiple of 64) on
// v8t [B, heads, d, s_pad] int8 (v quantized per channel, transposed, kv
// permuted inside each 16 columns as pv8_sm90.cuh takes it, zero past S;
// s_pad a multiple of 64 and >= S) and sv [B, heads, d] fp32, on the plan
// (rule, ldw, step, rows, stages) of ops/attention.py `pv8_plan`; with amax
// (B·heads·d int32 of scratch) given, v8t and sv are outputs, first made
// from qkv's v by pv8_quantize_v. Returns a cudaError_t (0 on success).
extern "C" int lvv_relpos_attention(const void* qkv, const void* rel_h,
                                    const void* rel_w, void* v8t, void* sv,
                                    void* amax, void* out, int b, int s,
                                    int heads, int d, int gh, int gw,
                                    int s_pad, int pv_group, int rule,
                                    int ldw, int step, int rows, int stages,
                                    float scale, void* stream) {
  if (gh > kMaxGh || gw > kMaxGw || gh * gw != s || pv_group < 0 ||
      pv_group % kBK || (d != 64 && d != 128))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (!pv_group)
    return d == 64 ? launch_float<64>(qkv, rel_h, rel_w, out, b, s, heads, gh,
                                      gw, scale, st)
                   : launch_float<128>(qkv, rel_h, rel_w, out, b, s, heads,
                                       gh, gw, scale, st);
  if (!v8t || !sv || s_pad < s || s_pad % kBK || ldw < gw)
    return (int)cudaErrorInvalidValue;
  if (amax) {
    const long long c3 = 3LL * heads * d, vst[3] = {c3 * s, d, c3};
    const cudaError_t e =
        pv8_quantize_v((const bf16*)qkv + 2LL * heads * d, vst, b, heads, s,
                       d, s_pad, amax, v8t, sv, st);
    if (e != cudaSuccess) return (int)e;
  }
  return launch_pv8(qkv, rel_h, rel_w, v8t, sv, out, b, s, heads, d, gh, gw,
                    s_pad, pv_group, rule, ldw, step, rows, stages, scale,
                    st);
}
