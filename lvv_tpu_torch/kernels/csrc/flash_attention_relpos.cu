// Head-split SAM attention with the decomposed relative-position bias, from
// q, k, v [B, H, S, d] and the caller's bias tables (bf16 in and out, fp32
// softmax, the [S, S] bias never formed):
//   out = softmax(scale·q·kᵀ + q_rh[q, kv / gw] + q_rw[q, kv % gw]) v
// with q_rh [B, H, S, gh] = q·Rh and q_rw [B, H, S, gw] = q·Rw computed and
// rounded to bf16 by the caller, as SAM's third branch (lvv_tpu/models/
// sam.py:202-231) does.
//
// Replaces TPU kernel K-h, lvv_tpu/ops/attention.py, in its three bodies
// (none is the TPU's block structure):
//   kStream  _flash_relpos_kernel (via flash_attention_relpos): SAM's
//            global layers at grids that fail the head-packed test (80x80
//            at 1280²). The TPU picks the bias columns of each kv tile with
//            one-hot matmuls; here each score reads its two table entries
//            through a column table (kv / gw, kv % gw), for any gw. Columns
//            at or past kv_end are masked: the wrapper passes the TPU grid's
//            kv extent, so nothing is padded (the TPU pads S = 6400 to
//            8192).
//   kFused   _flash_relpos_fused_kernel (via flash_attention_relpos_fused):
//            scores from the augmented operands q_aug = [q·scale·log2e |
//            q_rh·log2e | 0] and k_aug = [k | onehot(kv / gw) | 0] at depth
//            128 (so the height bias comes out of the product), plus the
//            width table q_rw·log2e; base 2 as on the TPU. It also runs K-m's
//            attention, _flash_hpacked_kernel with qrw_off = d (via
//            flash_attention_relpos_hpacked_prepped): q_aug, k_aug and v are
//            strided views of qr_prep.cu's [B, S, H·128] lane blocks, read
//            by TMA where they lie, and the width table is read where it
//            lies, in v_aug's lanes d .. d + gw of the query rows.
//   kSmall   _relpos_mh_kernel (S padded to 512 or less): one softmax over
//   kSmall2  all kv with p divided by its row sum BEFORE it is rounded to
//            bf16 for p@v, as the TPU's single-tile kernel does. S <= 256
//            and gh, gw <= 16 (kSmall): window_sm90.cuh's resident
//            whole-row kernel, the bias from the tables times a one-hot
//            expander on the tensor cores. Otherwise (kSmall2, S <= 512):
//            the streaming kernel walks kv twice, row maxima and sums
//            first, then p@v with each p divided before rounding.
// The int8 p@v arm of kStream and kFused (kh_pv8_sm90) runs on
// pv8_sm90.cuh's core, with groups of the TPU's kv tile (1024 columns from
// column 0).
//
// What bounds it on the H100: the two products, 4·S²·d operations per
// (view, head), against reading q, k, v and the tables once: far above the
// card's ~295 operations per byte, so the bf16 tensor-core rate bounds it
// (0.76 ms for the 4·6·12·6400²·64 operations of one 1280² global layer).
//
// Design of the float streaming forms (kh_stream_sm90, on the sm_90a core of
// attn_sm90.cuh, as relpos_attention.cu's streaming regime): one block per
// (128 q rows, head, view); two consumer warpgroups of 64 rows each and a
// producer warp that streams K / V tiles through a TMA ring (tensor maps
// over each view's own strides, so no operand is copied). The block's 128
// rows of the caller's tables go to shared memory once, as fp32 times
// log2(e) (kFused: already log2-domain), the height table at an odd pitch
// and the width table at a pitch 8 mod 16 words (float2 reads of kw pairs
// for even gw). A column table gives each key its (kv / gw, kv % gw) (on
// the H100 the table read beat carrying the pair in registers), except in
// the streaming form at d 64 on 80-wide grids (SAM's 80x80 at 1280²) and
// the fused form on 64-wide grids: there a tile is two whole grid rows
// (160 or 128 keys), so kh and kw are known at compile time up to the
// tile's row and the lane, as in relpos_attention.cu's 64-wide grids, and
// keys past kv_end (whole grid rows) are masked through the height bias.
// Where the block's table rows and the column table do not fit beside the
// tiles (square grids from 112x112 up, or a side of 256 or more, past the
// column table's 8-bit fields), the scores read the caller's bf16 table
// rows where they lie and each lane steps its (kv / gw, kv % gw) by 8 keys,
// as the int8 arm's rule "global" does (ops/attention.py `kh_float_plan`
// picks the form).
// The int8 arm's design (kh_pv8_sm90): the two passes a group of
// pv8_sm90.cuh with K (and v8t's int8 tiles) through the TMA ring, on the
// plan of ops/attention.py `pv8_plan`. The block's rows of the tables lie
// in shared memory as fp32 times log2(e) where they fit beside two stages,
// else they are read from the caller's bf16 tables where they lie (any
// grid the wrapper admits, those 600 wide among them). On SAM's 80x80
// grid (rule "wide") the 128-key tiles do not follow grid rows, so a
// 64-key step spans two of them and each 8-column block picks its row's
// height bias, while the width rows, extended past gw, are read at the
// step's kw plus a compile-time offset; the fused form's 64-wide grid has
// kw at compile time ("g64"); other grids step each lane's (kv / gw,
// kv % gw) by 8 keys ("any").
#include <string.h>

#include "pv8_sm90.cuh"
#include "window_sm90.cuh"

enum { kStream = 0, kFused = 1, kSmall = 2, kSmall2 = 3 };

// The C entry's arguments.
struct KhArgs {
  const bf16 *q, *k, *v, *qrh, *qrw;
  const signed char* v8t;  // [B, H, d, s_pad8] int8 v (int8 arm)
  const float* sv;         // [B, H, d] per-channel scales of v (int8 arm)
  bf16* out;
  long long st[18];        // (view, head, token) strides of q, k, v, out,
                           // qrh, qrw
  int heads, s, gh, gw, kv_end, group, s_pad8;
  float scale;
};

// ------------------------------------------------------------ float arm

using namespace sm90;

struct KhSm90Args {
  bf16* out;
  const bf16 *qrh, *qrw;
  long long ost[3];   // out (view, head, token) strides
  long long tst[6];   // qrh, qrw (view, head, token) strides
  int s, gh, gw, ldh, ldw, kv_end;
  float sl;           // scale·log2e (not kFused)
};

// The key tile: two grid rows on a grid GW wide (80: the streaming form at
// d 64, SAM's 1280² grid; 64: the fused form); otherwise 128 keys where v is 64 deep, 64
// at d 128, where the form walks kv twice and where the tables are read
// from global memory (a thread's registers within 168).
template <int DQ, int DV, int MODE>
__host__ __device__ constexpr int kh_tile(int gw_rows, bool gtab = false) {
  return gw_rows ? 2 * gw_rows
                 : DV == 64 && MODE != kSmall2 && !gtab ? 128 : 64;
}

namespace sm90 {
// wgmma m64n160k16 (A and B from shared memory, both K-major): the
// 160-key tiles of the streaming form on a grid 80 wide.
template <> struct Wgmma<160> {
  // d[80] += A (smem, K-major) · B (smem, K-major)
  static __device__ __forceinline__ void ss(float* d, uint64_t a,
                                            uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %82, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
        "}, %80, %81, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
          "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
        : "l"(a), "l"(b), "r"(acc));
  }
};
}  // namespace sm90

// fp32 loads from a 32-bit shared-memory address
__device__ __forceinline__ float lds(uint32_t addr) {
  float v;
  asm("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ float2 lds2(uint32_t addr) {
  float2 v;
  asm("ld.shared.v2.f32 {%0, %1}, [%2];" : "=f"(v.x), "=f"(v.y) : "r"(addr));
  return v;
}

template <int DQ, int DV, int MODE, int BN_>
struct KhCfg {
  static constexpr int BQ = 128;
  static constexpr int BN = BN_;
  static constexpr int STAGES = 2;
  static constexpr int QP = DQ / 64, VP = DV / 64;
  static constexpr int Q_PB = BQ * 128, KV_PB = BN * 128;
  static constexpr int Q_BYTES = QP * Q_PB, K_BYTES = QP * KV_PB;
  static constexpr int STAGE_BYTES = K_BYTES + VP * KV_PB;
  static constexpr int TAB_OFF = Q_BYTES + STAGES * STAGE_BYTES;
  static constexpr int THREADS = 3 * 128;   // 2 consumer warpgroups, producer
};

// Shared memory past the tiles: the height table (not kFused) and the width
// table, BQ rows of ldh / ldw floats, the column table of n_col keys (kv /
// gw | kv % gw << 8, 8 bits each), the barriers.
struct KhTail {
  int bw, ctab, bar, total;
};

__host__ __device__ inline KhTail kh_tail(int tab_off, bool fused, int ldh,
                                          int ldw, int n_col) {
  KhTail t;
  t.bw = (tab_off + (fused ? 0 : 128 * ldh * 4) + 7) & ~7;
  t.ctab = t.bw + 128 * ldw * 4;
  t.bar = (t.ctab + n_col * 2 + 7) & ~7;
  t.total = t.bar + 8 * 8;
  return t;
}

// kStream / kFused: the online softmax over kv [0, kv_end) in BN-key tiles,
// p rounded to bf16 against the running maximum (as the TPU's flash loop).
// kSmall2: two passes over the tiles (the producer streams them twice, V
// only the second time): the exact row maxima and sums, then p@v with each
// p divided by its row sum before it is rounded.
// GW > 0 (the grid GW wide, kv_end a whole number of grid rows; kFused:
// of tiles): a tile of BN = 2·GW keys is two whole grid rows, so a score's
// kh is the tile's first row (or the next) and its kw a compile-time
// column plus 2·(lane % 4): no column table. GTAB: no tables in shared
// memory; the scores read the caller's rows (pv8_bias's kGridAny).
template <int DQ, int DV, int MODE, int GW, bool GTAB>
__global__ void __launch_bounds__(
    KhCfg<DQ, DV, MODE, kh_tile<DQ, DV, MODE>(GW, GTAB)>::THREADS, 1)
kh_stream_sm90(const __grid_constant__ CUtensorMap qmap,
               const __grid_constant__ CUtensorMap kmap,
               const __grid_constant__ CUtensorMap vmap,
               const KhSm90Args a) {
  constexpr int BN = kh_tile<DQ, DV, MODE>(GW, GTAB);
  using C = KhCfg<DQ, DV, MODE, BN>;
  constexpr bool FUSED = MODE == kFused, NORMED = MODE == kSmall2;
  constexpr bool ROWTILE = GW > 0;
  static_assert(!(ROWTILE && GTAB), "whole-row tiles read shared tables");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const int n_t = (a.kv_end + BN - 1) / BN;
  const KhTail tl = kh_tail(C::TAB_OFF, FUSED, a.ldh, a.ldw,
                            ROWTILE || GTAB ? 0 : n_t * BN);
  unsigned char* ring = smem + C::Q_BYTES;   // stage i: K then V
  float* bh_s = reinterpret_cast<float*>(smem + C::TAB_OFF);
  float* bw_s = reinterpret_cast<float*>(smem + tl.bw);
  uint16_t* ctab = reinterpret_cast<uint16_t*>(smem + tl.ctab);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + tl.bar);
  uint64_t* empty = full + C::STAGES;
  uint64_t* q_bar = empty + C::STAGES;

  const int q_start = blockIdx.x * C::BQ, h = blockIdx.y, b = blockIdx.z;
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
      for (int p = 0; p < C::QP; ++p)
        tma_load(smem + p * C::Q_PB, &qmap, q_bar, p * 64, q_start, h, b);
      const int total = (NORMED ? 2 : 1) * n_t;
      for (int i = 0; i < total; ++i) {
        const int st = i % C::STAGES, row = (i % n_t) * BN;
        const bool with_v = !NORMED || i >= n_t;
        if (i >= C::STAGES) bar_wait(&empty[st], ((i / C::STAGES) - 1) & 1);
        bar_expect_tx(&full[st], with_v ? C::STAGE_BYTES : C::K_BYTES);
        unsigned char* kt = ring + st * C::STAGE_BYTES;
        for (int p = 0; p < C::QP; ++p)
          tma_load(kt + p * C::KV_PB, &kmap, &full[st], p * 64, row, h, b);
        if (with_v)
          for (int p = 0; p < C::VP; ++p)
            tma_load(kt + C::K_BYTES + p * C::KV_PB, &vmap, &full[st],
                     p * 64, row, h, b);
      }
    }
  } else {
    // ---- consumers: 64 q rows each
    regs_inc<232>();
    const int tid = threadIdx.x, lane = tid & 31, warp = (tid & 127) >> 5;
    const int t = lane & 3;
    const int rr0 = wg * 64 + warp * 16 + (lane >> 2), rr1 = rr0 + 8;
    const int s = a.s, gh = a.gh, gw = a.gw;
    if constexpr (!ROWTILE && !GTAB)
      for (int i = tid; i < n_t * BN; i += 256)
        ctab[i] = i < s ? (uint16_t)((i / gw) | (i % gw) << 8) : 0;
    // the block's rows of the tables, log2-domain (0 past S)
    const float ts = FUSED ? 1.f : LVV_LOG2E;
    const bf16* rwb = a.qrw + b * a.tst[3] + h * a.tst[4];
    const bf16* rhb = FUSED ? nullptr : a.qrh + b * a.tst[0] + h * a.tst[1];
    for (int i = tid; i < (GTAB ? 0 : C::BQ * gw); i += 256) {
      const int r = i / gw, j = i - r * gw, tok = q_start + r;
      bw_s[r * a.ldw + j] = tok < s ? bf(rwb[tok * a.tst[5] + j]) * ts : 0.f;
    }
    if constexpr (!FUSED && !GTAB) {
      for (int i = tid; i < C::BQ * gh; i += 256) {
        const int r = i / gh, j = i - r * gh, tok = q_start + r;
        bh_s[r * a.ldh + j] =
            tok < s ? bf(rhb[tok * a.tst[2] + j]) * LVV_LOG2E : 0.f;
      }
    }
    named_sync(1, 256);   // both warpgroups' tables and the column table
    bar_wait(q_bar, 0);

    const uint32_t q_addr = smem_u32(smem) + wg * 64 * 128;
    const float* bh0 = bh_s + rr0 * a.ldh;
    const float* bh1 = bh_s + rr1 * a.ldh;
    const float* bw0 = bw_s + rr0 * a.ldw;
    const float* bw1 = bw_s + rr1 * a.ldw;
    // kv 2i, 2i + 1 share kh
    const bool pairs = (gw & 1) == 0;
    // GTAB: the caller's rows (rows past S read row S - 1 and are not
    // written)
    const long long t0 = min(q_start + rr0, s - 1);
    const long long t1 = min(q_start + rr1, s - 1);
    const Pv8GlobalRows grows{FUSED ? nullptr : rhb + t0 * a.tst[2],
                              FUSED ? nullptr : rhb + t1 * a.tst[2],
                              rwb + t0 * a.tst[5], rwb + t1 * a.tst[5], ts,
                              gh - 1};
    auto tile = [&](int i) {
      const int st = i % C::STAGES;
      bar_wait(&full[st], (i / C::STAGES) & 1);
      return smem_u32(ring + st * C::STAGE_BYTES);
    };
    auto release = [&](int i) {
      __syncwarp();
      if (lane == 0) bar_arrive(&empty[i % C::STAGES]);
    };
    // log2-domain logits of tile i (the i-th load: kv tile i % n_t)
    auto scores = [&](int i, float (&sc)[BN / 2]) {
      const int ti = NORMED ? i % n_t : i;
      const int k0 = ti * BN;
      if constexpr (ROWTILE) {
        // the tile's grid rows; kv_end is a whole number of rows, so a
        // second row at or past it masks its keys through its bias
        // (the rows' 32-bit shared addresses: no 64-bit pointer is held)
        const int kh = 2 * ti;
        const bool in = (kh + 1) * GW < a.kv_end;
        const uint32_t ah0 = smem_u32(bh0) + 4 * kh;
        const uint32_t ah1 = smem_u32(bh1) + 4 * kh;
        const uint32_t aw0 = smem_u32(bw0) + 8 * t;
        const uint32_t aw1 = smem_u32(bw1) + 8 * t;
        float h00 = 0.f, h01 = 0.f, h10 = 0.f, h11 = 0.f;
        if constexpr (!FUSED) {
          h00 = lds(ah0);
          h01 = in ? lds(ah0 + 4) : LVV_NEG_BIG;
          h10 = lds(ah1);
          h11 = in ? lds(ah1 + 4) : LVV_NEG_BIG;
        }
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int kw = (8 * j) % GW;
          const float h0 = j < GW / 8 ? h00 : h01;
          const float h1 = j < GW / 8 ? h10 : h11;
          const float2 w0 = lds2(aw0 + 4 * kw), w1 = lds2(aw1 + 4 * kw);
          float* e = sc + 4 * j;
          if constexpr (FUSED) {   // q_aug carries the scale
            e[0] += w0.x;
            e[1] += w0.y;
            e[2] += w1.x;
            e[3] += w1.y;
          } else {
            e[0] = fmaf(e[0], a.sl, h0 + w0.x);
            e[1] = fmaf(e[1], a.sl, h0 + w0.y);
            e[2] = fmaf(e[2], a.sl, h1 + w1.x);
            e[3] = fmaf(e[3], a.sl, h1 + w1.y);
          }
        }
      } else if constexpr (GTAB) {
        pv8_bias<BN, kGridAny, FUSED>(sc, k0, a.sl, gw, grows, 0.f, 0.f);
        pv8_mask<BN>(sc, k0, 0, a.kv_end);
      } else {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int col = k0 + 8 * j + 2 * t;
          float* e = sc + 4 * j;
          float b00, b01, b10, b11;
          const uint32_t hw = ctab[col], kh = hw & 255, kw = hw >> 8;
          if (pairs) {
            const float2 w0 = *reinterpret_cast<const float2*>(bw0 + kw);
            const float2 w1 = *reinterpret_cast<const float2*>(bw1 + kw);
            const float h0 = FUSED ? 0.f : bh0[kh];
            const float h1 = FUSED ? 0.f : bh1[kh];
            b00 = h0 + w0.x;
            b01 = h0 + w0.y;
            b10 = h1 + w1.x;
            b11 = h1 + w1.y;
          } else {
            const uint32_t hw1 = ctab[col + 1], kh1 = hw1 & 255,
                           kw1 = hw1 >> 8;
            b00 = (FUSED ? 0.f : bh0[kh]) + bw0[kw];
            b01 = (FUSED ? 0.f : bh0[kh1]) + bw0[kw1];
            b10 = (FUSED ? 0.f : bh1[kh]) + bw1[kw];
            b11 = (FUSED ? 0.f : bh1[kh1]) + bw1[kw1];
          }
          if constexpr (FUSED) {
            e[0] += b00;
            e[1] += b01;
            e[2] += b10;
            e[3] += b11;
          } else {
            e[0] = fmaf(e[0], a.sl, b00);
            e[1] = fmaf(e[1], a.sl, b01);
            e[2] = fmaf(e[2], a.sl, b10);
            e[3] = fmaf(e[3], a.sl, b11);
          }
          if (col >= a.kv_end) e[0] = e[2] = LVV_NEG_BIG;
          if (col + 1 >= a.kv_end) e[1] = e[3] = LVV_NEG_BIG;
        }
      }
    };
    float o[DV / 2];
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
    float m0 = LVV_NEG_BIG, m1 = LVV_NEG_BIG, l0 = 0.f, l1 = 0.f;
    if constexpr (!NORMED) {
      // attn_mainloop's loop, with q's address taken anew each tile (the
      // q descriptors, 8 at depth 128, are not held across the loop) and
      // the scores declared in it (the first k-step overwrites them, so no
      // tile's scores stay live into the next)
      for (int i = 0; i < n_t; ++i) {
        float sc[BN / 2];
        const uint32_t kt = tile(i);
        uint32_t qa;
        asm volatile("mov.b32 %0, %1;" : "=r"(qa) : "r"(q_addr));
        qk_sm90<DQ, BN>(sc, qa, C::Q_PB, kt, C::KV_PB);
        scores(i, sc);
        softmax_tile<BN, DV>(sc, o, m0, m1, l0, l1);
        pv_sm90<DV, BN>(o, sc, kt + C::K_BYTES, C::KV_PB);
        release(i);
      }
      l0 = fmaxf(l0, 1e-30f);   // guard, as the JAX kernel's finalize does
      l1 = fmaxf(l1, 1e-30f);
    } else {
      for (int i = 0; i < n_t; ++i) {   // pass 1: row maxima and sums
        float sc[BN / 2];
        qk_sm90<DQ, BN>(sc, q_addr, C::Q_PB, tile(i), C::KV_PB);
        scores(i, sc);
        release(i);
        float mx0 = m0, mx1 = m1;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
          mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
        }
        mx0 = quad_max(mx0);
        mx1 = quad_max(mx1);
        float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          ps0 += exp2_approx(sc[4 * j] - mx0) +
                 exp2_approx(sc[4 * j + 1] - mx0);
          ps1 += exp2_approx(sc[4 * j + 2] - mx1) +
                 exp2_approx(sc[4 * j + 3] - mx1);
        }
        l0 = l0 * exp2_approx(m0 - mx0) + quad_sum(ps0);
        l1 = l1 * exp2_approx(m1 - mx1) + quad_sum(ps1);
        m0 = mx0;
        m1 = mx1;
      }
      const float r0 = rcp_refined(l0), r1 = rcp_refined(l1);
      for (int i = n_t; i < 2 * n_t; ++i) {   // pass 2: normalised p@v
        float sc[BN / 2];
        const uint32_t kt = tile(i);
        qk_sm90<DQ, BN>(sc, q_addr, C::Q_PB, kt, C::KV_PB);
        scores(i, sc);
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          sc[4 * j] = div_rn(exp2_approx(sc[4 * j] - m0), l0, r0);
          sc[4 * j + 1] = div_rn(exp2_approx(sc[4 * j + 1] - m0), l0, r0);
          sc[4 * j + 2] = div_rn(exp2_approx(sc[4 * j + 2] - m1), l1, r1);
          sc[4 * j + 3] = div_rn(exp2_approx(sc[4 * j + 3] - m1), l1, r1);
        }
        pv_sm90<DV, BN>(o, sc, kt + C::K_BYTES, C::KV_PB);
        release(i);
      }
      l0 = l1 = 1.f;   // o is normalised already
    }
    bf16* ob = a.out + b * a.ost[0] + h * a.ost[1];
    const int tok0 = q_start + rr0, tok1 = q_start + rr1;
    store_rows<DV>(o, tok0 < s ? ob + tok0 * a.ost[2] : nullptr,
                   tok1 < s ? ob + tok1 * a.ost[2] : nullptr, l0, l1);
  }
}

template <int DQ, int DV, int MODE, int GW = 0, bool GTAB = false>
static int launch_stream(const CUtensorMap* maps, const KhSm90Args& a, int b,
                         int heads, cudaStream_t stream) {
  constexpr int BN = kh_tile<DQ, DV, MODE>(GW, GTAB);
  using C = KhCfg<DQ, DV, MODE, BN>;
  const int n_col = GW || GTAB ? 0 : (a.kv_end + BN - 1) / BN * BN;
  const int smem =
      kh_tail(C::TAB_OFF, MODE == kFused, a.ldh, a.ldw, n_col).total +
      kSmemAlign;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem(kh_stream_sm90<DQ, DV, MODE, GW, GTAB>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.s + C::BQ - 1) / C::BQ, heads, b);
  kh_stream_sm90<DQ, DV, MODE, GW, GTAB><<<grid, C::THREADS, smem, stream>>>(
      maps[0], maps[1], maps[2], a);
  return (int)cudaGetLastError();
}

// The float arm: maps over the views of q, k, v (boxes of the kernel's q
// rows and kv rows), then the form's kernel.
static int launch_float(const void* q, const void* k, const void* v,
                        const long long* st, const KhArgs& ka, int b, int d,
                        int mode, bool gtab, cudaStream_t stream) {
  const int s = ka.s, heads = ka.heads;
  CUtensorMap maps[3];
  cudaError_t e;
  if (mode == kSmall) {
    WinArgs w;
    memset(&w, 0, sizeof(w));
    w.out = ka.out;
    w.rh = ka.qrh;
    w.rw = ka.qrw;
    memcpy(w.ost, st + 9, sizeof(w.ost));
    memcpy(w.tst, st + 12, sizeof(w.tst));
    w.s = s;
    w.heads = heads;
    w.gh = ka.gh;
    w.gw = ka.gw;
    w.cs = ka.scale;
    e = win_split_maps(maps, q, k, v, st, b, heads, s, d);
    if (e != cudaSuccess) return (int)e;
    return d == 64 ? launch_win<64, kKhSmall>(maps, w, b, stream)
                   : launch_win<128, kKhSmall>(maps, w, b, stream);
  }
  KhSm90Args a;
  memset(&a, 0, sizeof(a));
  a.out = ka.out;
  a.qrh = ka.qrh;
  a.qrw = ka.qrw;
  memcpy(a.ost, st + 9, sizeof(a.ost));
  memcpy(a.tst, st + 12, sizeof(a.tst));
  a.s = s;
  a.gh = ka.gh;
  a.gw = ka.gw;
  // even gw: 8 times an odd number of floats, so that the float2 reads of
  // a half-warp's 4 rows land on distinct 8-bank groups (no rows in shared
  // memory under gtab)
  a.ldh = gtab ? 0 : ka.gh | 1;
  a.ldw = gtab ? 0 : ka.gw % 2 ? ka.gw : ((ka.gw + 7) / 8 | 1) * 8;
  a.kv_end = ka.kv_end;
  a.sl = ka.scale * LVV_LOG2E;
  const int dq = mode == kFused ? 128 : d;
  // whole-row tiles: the streaming form at d 64 on grids 80 wide (kv_end
  // whole rows), the fused form on grids 64 wide (whole tiles)
  const int gw_rows =
      !gtab && ((mode == kStream && d == 64 && ka.gw == 80 &&
                 ka.kv_end % 80 == 0) ||
                (mode == kFused && ka.gw == 64 && ka.kv_end % 128 == 0))
          ? ka.gw
          : 0;
  // the column table's fields are 8 bits
  if (!gtab && !gw_rows && (ka.gh > 255 || ka.gw > 255))
    return (int)cudaErrorInvalidValue;
  if (gtab && mode != kStream && mode != kFused)
    return (int)cudaErrorInvalidValue;
  const int bn =
      gw_rows ? 2 * gw_rows : d == 64 && mode != kSmall2 && !gtab ? 128 : 64;
  e = split_map(&maps[0], q, st, dq, s, heads, b, 128);
  if (e == cudaSuccess) e = split_map(&maps[1], k, st + 3, dq, s, heads, b, bn);
  if (e == cudaSuccess) e = split_map(&maps[2], v, st + 6, d, s, heads, b, bn);
  if (e != cudaSuccess) return (int)e;
  if (gtab)
    return mode == kFused
               ? launch_stream<128, 64, kFused, 0, true>(maps, a, b, heads,
                                                          stream)
           : d == 128
               ? launch_stream<128, 128, kStream, 0, true>(maps, a, b, heads,
                                                           stream)
               : launch_stream<64, 64, kStream, 0, true>(maps, a, b, heads,
                                                         stream);
  if (mode == kFused)
    return gw_rows ? launch_stream<128, 64, kFused, 64>(maps, a, b, heads,
                                                        stream)
                   : launch_stream<128, 64, kFused>(maps, a, b, heads,
                                                    stream);
  if (mode == kStream && d == 128)
    return launch_stream<128, 128, kStream>(maps, a, b, heads, stream);
  if (mode == kStream)
    return gw_rows
               ? launch_stream<64, 64, kStream, 80>(maps, a, b, heads, stream)
               : launch_stream<64, 64, kStream>(maps, a, b, heads, stream);
  return d == 64 ? launch_stream<64, 64, kSmall2>(maps, a, b, heads, stream)
                 : launch_stream<128, 128, kSmall2>(maps, a, b, heads, stream);
}

// ------------------------------------------------------------- int8 arm

struct KhPv8Args {
  bf16* out;
  const bf16 *qrh, *qrw;
  const float* sv;    // [B, H, DV] per-channel scales of v
  long long ost[3];   // out (view, head, token) strides
  long long tst[6];   // qrh, qrw (view, head, token) strides
  int s, heads, gh, gw, ldh, ldw, kv_end, group, stages;
  float sl;           // scale·log2e (not kFused)
};

// the bytes of the block's table rows in shared memory (the fused form has
// no height table)
__host__ __device__ inline int kh_pv8_tab(int rows, bool fused, int ldh,
                                          int ldw) {
  return rows * ((fused ? 0 : ldh) + ldw) * 4;
}

// kStream / kFused int8 arm: 128 q rows a block, two warpgroups on
// pv8_consume and a producer warp streaming K (and v8t's tiles). SMEM: the
// block's rows of the tables in shared memory (fp32, log2-domain;
// kGridWide: the width rows extended, w[gw + x] = w[x]); else read from the
// caller's bf16 rows (kGridAny). GRID: pv8_bias's (kh, kw) rule.
template <int DQ, int DV, int NS, int WGS, int MODE, int GRID, bool SMEM>
__global__ void __launch_bounds__(Pv8Cfg<DQ, DV, NS, WGS>::THREADS, 1)
kh_pv8_sm90(const __grid_constant__ CUtensorMap qmap,
            const __grid_constant__ CUtensorMap kmap,
            const __grid_constant__ CUtensorMap vmap, const KhPv8Args a) {
  using C = Pv8Cfg<DQ, DV, NS, WGS>;
  constexpr bool FUSED = MODE == kFused;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const Pv8Smem L = pv8_smem(C::Q_BYTES, C::STAGE, a.stages,
                             SMEM ? kh_pv8_tab(C::BQ, FUSED, a.ldh, a.ldw) : 0);
  float* bh_s = reinterpret_cast<float*>(smem + L.tab);
  float* bw_s = bh_s + (FUSED ? 0 : C::BQ * a.ldh);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L.bar);
  uint64_t* q_bar = bar + 2 * a.stages;

  const int q_start = blockIdx.x * C::BQ, h = blockIdx.y, b = blockIdx.z;
  pv8_init_bars(bar, a.stages, C::CONS / 32);
  if (threadIdx.x >= C::CONS) {
    // ---- producer: one thread issues every TMA load
    if (threadIdx.x == C::CONS) {
      bar_expect_tx(q_bar, C::Q_BYTES);
      for (int p = 0; p < C::QP; ++p)
        tma_load(smem + p * C::Q_PB, &qmap, q_bar, p * 64, q_start, h, b);
      pv8_produce<C>(a.kv_end, a.group, a.stages, smem + C::Q_BYTES, bar,
                     &vmap, h, b,
                     [&](unsigned char* dst, uint64_t* full, int row) {
                       for (int p = 0; p < C::QP; ++p)
                         tma_load(dst + p * C::KV_PB, &kmap, full, p * 64,
                                  row, h, b);
                     });
    }
    return;
  }
  // ---- consumers: 64 q rows each
  const int tid = threadIdx.x, wg = tid / 128, lane = tid & 31;
  const int rr0 = wg * 64 + ((tid & 127) >> 5) * 16 + (lane >> 2);
  const int rr1 = rr0 + 8;
  const int s = a.s;
  const float ts = FUSED ? 1.f : LVV_LOG2E;   // fused: log2-domain already
  const bf16* rhb = FUSED ? nullptr : a.qrh + b * a.tst[0] + h * a.tst[1];
  const bf16* rwb = a.qrw + b * a.tst[3] + h * a.tst[4];
  if constexpr (SMEM) {
    // the block's rows of the tables, log2-domain (0 past S)
    const int wn = GRID == kGridWide ? a.gw + NS : a.gw;
    for (int i = tid; i < C::BQ * wn; i += C::CONS) {
      const int r = i / wn, j = i - r * wn, tok = q_start + r;
      bw_s[r * a.ldw + j] =
          tok < s ? bf(rwb[tok * a.tst[5] + j % a.gw]) * ts : 0.f;
    }
    if constexpr (!FUSED)
      for (int i = tid; i < C::BQ * a.gh; i += C::CONS) {
        const int r = i / a.gh, j = i - r * a.gh, tok = q_start + r;
        bh_s[r * a.ldh + j] = tok < s ? bf(rhb[tok * a.tst[2] + j]) * ts : 0.f;
      }
    named_sync(1, C::CONS);   // the warpgroups' tables
  }
  bar_wait(q_bar, 0);

  float o[DV / 2];
  float l0, l1;
  const uint32_t q_addr = smem_u32(smem) + wg * 64 * 128;
  const float* sv = a.sv + ((long long)b * a.heads + h) * DV;
  auto run = [&](const auto& tab) {
    auto scores = [&](int c0, float (&sc)[NS / 2], float m0, float m1) {
      pv8_bias<NS, GRID, FUSED>(sc, c0, a.sl, a.gw, tab, m0, m1);
    };
    pv8_consume<C, DQ, DV>(a.kv_end, a.group, a.stages, q_addr,
                           smem_u32(smem + C::Q_BYTES), bar, scores, sv, o,
                           l0, l1);
  };
  if constexpr (SMEM) {
    run(Pv8SmemRows{bh_s + rr0 * a.ldh, bh_s + rr1 * a.ldh,
                    bw_s + rr0 * a.ldw, bw_s + rr1 * a.ldw});
  } else {
    // rows past S read row S - 1 (they are not written)
    const long long t0 = min(q_start + rr0, s - 1);
    const long long t1 = min(q_start + rr1, s - 1);
    run(Pv8GlobalRows{FUSED ? nullptr : rhb + t0 * a.tst[2],
                      FUSED ? nullptr : rhb + t1 * a.tst[2],
                      rwb + t0 * a.tst[5], rwb + t1 * a.tst[5], ts,
                      a.gh - 1});
  }
  bf16* ob = a.out + b * a.ost[0] + h * a.ost[1];
  const int tok0 = q_start + rr0, tok1 = q_start + rr1;
  store_rows<DV>(o, tok0 < s ? ob + tok0 * a.ost[2] : nullptr,
                 tok1 < s ? ob + tok1 * a.ost[2] : nullptr, l0, l1);
}

template <int DQ, int DV, int NS, int WGS, int MODE, int GRID, bool SMEM>
static int launch_pv8_n(const CUtensorMap* maps, const KhPv8Args& a, int b,
                        cudaStream_t stream) {
  using C = Pv8Cfg<DQ, DV, NS, WGS>;
  const int smem = pv8_smem_bytes<C>(
      a.stages, SMEM ? kh_pv8_tab(C::BQ, MODE == kFused, a.ldh, a.ldw) : 0);
  if (a.stages < 2 || smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t e =
      allow_smem(kh_pv8_sm90<DQ, DV, NS, WGS, MODE, GRID, SMEM>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.s + C::BQ - 1) / C::BQ, a.heads, b);
  kh_pv8_sm90<DQ, DV, NS, WGS, MODE, GRID, SMEM>
      <<<grid, C::THREADS, smem, stream>>>(maps[0], maps[1], maps[2], a);
  return (int)cudaGetLastError();
}

// The plan's rules (ops/attention.py `pv8_plan`): pv8_bias's three with the
// block's table rows in shared memory, and kGridAny on the caller's rows.
enum { kRuleGlobal = 3 };

// The int8 arm on the plan the wrapper made (rule, the width table's pitch,
// the step, the ring's stages): maps over the views of q and k (q_aug,
// k_aug in kFused) and over v8t, then the plan's kernel.
static int launch_pv8(const void* q, const void* k, const long long* st,
                      const KhArgs& ka, int b, int d, int mode, int rule,
                      int ldw, int step, int rows, int stages,
                      cudaStream_t stream) {
  KhPv8Args a;
  memset(&a, 0, sizeof(a));
  a.out = ka.out;
  a.qrh = ka.qrh;
  a.qrw = ka.qrw;
  a.sv = ka.sv;
  memcpy(a.ost, st + 9, sizeof(a.ost));
  memcpy(a.tst, st + 12, sizeof(a.tst));
  a.s = ka.s;
  a.heads = ka.heads;
  a.gh = ka.gh;
  a.gw = ka.gw;
  a.ldh = ka.gh | 1;
  a.ldw = ldw;
  a.kv_end = ka.kv_end;
  a.group = ka.group;
  a.stages = stages;
  a.sl = ka.scale * LVV_LOG2E;
  const bool fused = mode == kFused;
  if ((rule == kGridG64 && a.gw != 64) ||
      (rule == kGridWide && (a.gw % 8 || a.gw < 64 || ldw < a.gw + step)) ||
      (rule != kRuleGlobal && ldw < a.gw))
    return (int)cudaErrorInvalidValue;
  CUtensorMap maps[3];
  const int dq = fused ? 128 : d;
  cudaError_t e = split_map(&maps[0], q, st, dq, a.s, a.heads, b, rows);
  if (e == cudaSuccess)
    e = split_map(&maps[1], k, st + 3, dq, a.s, a.heads, b, 128);
  if (e == cudaSuccess)
    e = pv8_vmap(&maps[2], ka.v8t, b, a.heads, d, ka.s_pad8);
  if (e != cudaSuccess) return (int)e;
#define LVV_PV8(DQ, DV, NS, WGS, MODE, GRID, SMEM) \
  launch_pv8_n<DQ, DV, NS, WGS, MODE, GRID, SMEM>(maps, a, b, stream)
  const bool two = rows == 128;   // two consumer warpgroups, else one
  if (fused) {
    if (rule == kGridG64 && step == 128 && two)
      return LVV_PV8(128, 64, 128, 2, kFused, kGridG64, true);
    if (rule == kRuleGlobal && step == 32 && !two)
      return LVV_PV8(128, 64, 32, 1, kFused, kGridAny, false);
  } else if (d == 64) {
    if (rule == kGridWide && step == 64 && two)
      return LVV_PV8(64, 64, 64, 2, kStream, kGridWide, true);
    if (rule == kGridAny && step == 64 && two)
      return LVV_PV8(64, 64, 64, 2, kStream, kGridAny, true);
    if (rule == kRuleGlobal && step == 32 && !two)
      return LVV_PV8(64, 64, 32, 1, kStream, kGridAny, false);
  } else if (rule == kRuleGlobal && step == 32 && !two) {
    return LVV_PV8(128, 128, 32, 1, kStream, kGridAny, false);
  }
#undef LVV_PV8
  return (int)cudaErrorInvalidValue;
}

// q, k, v [B, H, S, *] bf16 with unit stride on the last axis and the
// (view, head, token) strides in `strides` (18 int64: q, k, v, out, qrh,
// qrw), those of q, k, v multiples of 8 elements and their bases 16-byte
// aligned; q / k of depth d (128 in mode kFused, where q, k are q_aug, k_aug
// and d = 64 is v's depth); qrh [B, H, S, gh] (not read in mode kFused) and
// qrw [B, H, S, gw] bf16 with unit stride on the last axis; out [B, H, S,
// d]. Keys at or past kv_end (<= S) are masked. group 0: the float arm,
// its tables in shared memory (rule 0; gh, gw < 256 unless the tiles are
// whole grid rows) or read where they lie (rule 3, kStream / kFused: the
// plan of ops/attention.py `kh_float_plan`); otherwise the int8 p@v arm (kStream, kFused) with p
// quantized per `group` kv columns (a multiple of 64): v8t [B, H, d, s_pad8]
// int8 (kv permuted inside each 16 columns as pv8_sm90.cuh takes it, zero
// past S; s_pad8 a multiple of 64 and >= S) and sv [B, H, d] fp32, on the
// plan (rule, ldw, step, rows, stages) of ops/attention.py `pv8_plan`; with
// amax
// (B·H·d int32 of scratch) given, v8t and sv are outputs, first made from v
// by pv8_quantize_v. kSmall
// takes S <= 256 and gh, gw <= 16, kSmall2 S <= 512, both kv_end = S and
// no int8 arm.
// Returns a cudaError_t (0 on success).
extern "C" int lvv_flash_attention_relpos(
    const void* q, const void* k, const void* v, const void* qrh,
    const void* qrw, void* v8t, void* sv, void* amax, void* out,
    const void* strides, int b, int heads, int s, int d, int gh, int gw,
    int kv_end, int group, int s_pad8, int mode, int rule, int ldw,
    int step, int rows, int stages, float scale, void* stream) {
  const bool small = mode == kSmall || mode == kSmall2;
  if (gh <= 0 || gw <= 0 || gh * gw != s || kv_end <= 0 || kv_end > s || group < 0 ||
      group % kBK || !qrw || (mode != kFused && !qrh) || mode < kStream || mode > kSmall2 ||
      !(d == 64 || (d == 128 && mode != kFused)) ||
      (small && (kv_end != s || s > (mode == kSmall ? 256 : 512))) ||
      (mode == kSmall && (gh > 16 || gw > 16)))
    return (int)cudaErrorInvalidValue;
  if (group && (small || !v8t || !sv || s_pad8 < s || s_pad8 % kBK))
    return (int)cudaErrorInvalidValue;
  KhArgs a;
  a.q = (const bf16*)q;
  a.k = (const bf16*)k;
  a.v = (const bf16*)v;
  a.qrh = (const bf16*)qrh;
  a.qrw = (const bf16*)qrw;
  a.v8t = (const signed char*)v8t;
  a.sv = (const float*)sv;
  a.out = (bf16*)out;
  memcpy(a.st, strides, sizeof(a.st));
  a.heads = heads;
  a.s = s;
  a.gh = gh;
  a.gw = gw;
  a.kv_end = kv_end;
  a.group = group;
  a.s_pad8 = s_pad8;
  a.scale = scale;
  cudaStream_t st = (cudaStream_t)stream;
  if (!group)
    return launch_float(q, k, v, a.st, a, b, d, mode, rule == kRuleGlobal,
                        st);
  if (amax) {
    const cudaError_t e = pv8_quantize_v(v, a.st + 6, b, heads, s, d, s_pad8,
                                         amax, v8t, sv, st);
    if (e != cudaSuccess) return (int)e;
  }
  return launch_pv8(q, k, a.st, a, b, d, mode, rule, ldw, step, rows, stages,
                    st);
}

// The int8 arms' v operands alone (what the entry above makes first when
// given amax): v [B, H, S, d] bf16 at the (view, head, token) strides in
// `strides` (3 int64, multiples of 8 elements, base 16-byte aligned), d 64
// or 128; v8t [B, H, d, s_pad] int8 and sv [B, H, d] fp32 out, amax B·H·d
// int32 of scratch. Returns a cudaError_t (0 on success).
extern "C" int lvv_pv8_quantize_v(const void* v, const void* strides, int b,
                                  int heads, int s, int d, int s_pad,
                                  void* amax, void* v8t, void* sv,
                                  void* stream) {
  if ((d != 64 && d != 128) || s <= 0 || s_pad < s || s_pad % kBK)
    return (int)cudaErrorInvalidValue;
  return (int)pv8_quantize_v(v, (const long long*)strides, b, heads, s, d,
                             s_pad, amax, v8t, sv, (cudaStream_t)stream);
}
