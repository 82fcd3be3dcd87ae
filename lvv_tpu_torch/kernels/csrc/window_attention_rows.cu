// Window attention with the whole row of S <= 256 keys in registers: one
// block per (head, window), bf16 in and out, fp32 scores. One template in
// seven modes (compile-time `MODE`), each the function of some TPU bodies.
//
// Modes kRowsPost / kRowsPre: SAM window attention over precomputed q·R bias
// rows, fp32 softmax in base 2,
//   out = softmax₂(logit) v,  logit[q, kv] = q·k·cs + rh[q, kv / win] + rw[q, kv % win]
// with cs = scale·log2e and the caller's bias rows rh, rw (q·Rh and q·Rw,
// already scaled by log2e and rounded to bf16), S = win². p is divided by its
// row sum, then rounded to bf16 for p@v, as the TPU kernels do. They replace
// five TPU bodies of lvv_tpu/ops/attention.py (K-l), which compute this one
// function and differ only where the scale is rounded and in the layout of
// their bias rows:
//   kRowsPre (q scaled by cs and rounded to bf16 BEFORE the product):
//     _window_fused_kernel  (window_attention_fused)   rows [B, H, S, win] x2
//     _window_fused2_kernel (window_attention_fused2)  rows [B, H, S, 2·win]
//   kRowsPost (the fp32 product scaled by cs):
//     _window_v3_kernel     (window_attention_v3)      rows [B, H, S, 16] x2
//     _window_phased_kernel (window_attention_phased)  rows [B, H, S, 16] x2
//     _window_v4_kernel     (window_attention_v4)      rows [B, S, H·16] x2
// The TPU kernels expand the rows to [S, S] with one-hot matmuls or
// concatenated operands (Mosaic cannot gather); here each score reads its two
// row entries by index from shared memory.
//
// The other five modes are the cost-bisect kernels of two benchmark scripts
// (B-1: benchmarks/winattn_bisect2.py::main.make(variant), B-2:
// benchmarks/winattn_bisect3.py::main.make_hmaj(batched)). With
// s = (q·k in fp32)·cs, cs = scale:
//   kDotsQk    out[:, 0:d] = bf16(s[:, 0:d]·1e-3): the first d key columns of
//              the scores, no p@v (S >= d)
//   kDotsQkPv  out = bf16(bf16(s·1e-3) @ v): no max, no softmax
//   kSoftmax   out = bf16(bf16(p) @ v), p = exp(s − max) / Σ in base e
//   kBias2     kSoftmax after s += qrh @ eh + qrw @ ew: qrh, qrw [S, 16] rows
//              of the (window, head), eh, ew dense [16, S] expanders. The
//              expanders are random, not one-hot, so each adds one
//              m16n8k16 product per 8-key score tile (the table rows are the
//              A operand, the expander the B operand), not a gather.
//   kHmaj      kSoftmax on head-major q, k, v (B-2: both `batched` schedules
//              of the script compute this function)
// Every mode but kHmaj reads packed qkv [B, S, 3C] and writes [B, S, C]
// with compile-time addressing (through runtime strides the K-l modes took
// 6-12% longer on an H100 80GB HBM3 at 700 W, window_rows_ab.py); kHmaj
// reads q, k, v and writes out through their own (window, head, token)
// strides, unit stride over d.
//
// What bounds it on the H100: reading q, k, v and writing the output,
// 2·S·4·d bytes a (window, head), against 4·S²·d operations: about 98
// operations a byte at SAM's 14x14 windows, under the card's ~295, so device
// memory bounds it (0.06 ms for 150 windows of 12 heads).
//
// Design: one block of 4 warps per (head, window). K and V of the window
// (S rows, zero-padded to a multiple of 16) and the mode's tables go to
// shared memory once; each warp then takes 16 query rows at a time and keeps
// the scores of all S keys in registers (mma.sync m16n8k16 from common.cuh):
// row maximum and sum by quad shuffles, exact division, p@v straight from
// the score registers. Nothing goes back to device memory but the output.
#include <string.h>

#include "common.cuh"

constexpr int kWinWarps = 4;
constexpr int kWinThreads = 32 * kWinWarps;
constexpr int kWinMaxS = 256;
constexpr int kExpK = 16;  // kBias2: depth of the expander products

enum WinMode : int {
  kRowsPost = 0,
  kRowsPre = 1,
  kDotsQk = 2,
  kDotsQkPv = 3,
  kSoftmax = 4,
  kBias2 = 5,
  kHmaj = 6,
};

struct WinArgs {
  const bf16 *q, *k, *v;  // packed modes: q is qkv [B, S, 3C], k, v unused
  bf16* out;
  const bf16 *rh, *rw;  // bias rows (kRows*) or expander rows (kBias2)
  const bf16 *eh, *ew;  // kBias2: expanders [16, S] contiguous
  long long st[18];     // (window, head, token) strides: q, k, v, out (kHmaj),
                        // then rh, rw
  int s, heads, win, ldt;
  float cs;
};

// NT: score tiles of 8 keys a warp holds (S padded to 16 fits in 8·NT)
template <int D, int NT, int MODE>
__global__ void __launch_bounds__(kWinThreads) win_rows_kernel(const WinArgs a) {
  constexpr bool ROWS = MODE == kRowsPost || MODE == kRowsPre;
  constexpr bool PRE = MODE == kRowsPre;
  constexpr bool BIAS2 = MODE == kBias2;
  constexpr bool SOFTMAX = ROWS || MODE == kSoftmax || BIAS2 || MODE == kHmaj;
  // every mode but kHmaj reads packed qkv and writes out [B, S, C]
  constexpr bool PACKED = MODE != kHmaj;
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int sk = (a.s + 15) & ~15;
  const int lde = sk + 8;
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);     // [sk][LD]
  bf16* v_s = k_s + sk * LD;                         // [sk][LD]
  bf16* q_s = v_s + sk * LD;                         // [kWinWarps][16][LD]
  bf16* th_s = q_s + kWinWarps * 16 * LD;            // [sk][ldt] rh rows
  bf16* tw_s = th_s + sk * a.ldt;                    // [sk][ldt] rw rows
  // kRows*: the key's (kv / win, kv % win); kBias2: the expanders [16][lde]
  unsigned char* colh_s = reinterpret_cast<unsigned char*>(tw_s + sk * a.ldt);
  unsigned char* colw_s = colh_s + sk;
  bf16* eh_s = tw_s + sk * a.ldt;
  bf16* ew_s = eh_s + kExpK * lde;

  const int h = blockIdx.x, b = blockIdx.y;
  const bf16 *qb, *kb, *vb;
  bf16* ob;
  long long qst, kst, vst, ost;  // token strides
  if constexpr (PACKED) {
    const int c = a.heads * D;
    const long long row = 3LL * c;
    qb = a.q + (long long)b * a.s * row + h * D;
    kb = qb + c;
    vb = qb + 2 * c;
    ob = a.out + (long long)b * a.s * c + h * D;
    qst = kst = vst = row;
    ost = c;
  } else {
    qb = a.q + b * a.st[0] + h * a.st[1];
    kb = a.k + b * a.st[3] + h * a.st[4];
    vb = a.v + b * a.st[6] + h * a.st[7];
    ob = a.out + b * a.st[9] + h * a.st[10];
    qst = a.st[2];
    kst = a.st[5];
    vst = a.st[8];
    ost = a.st[11];
  }

  for (int i = threadIdx.x; i < sk * D / 8; i += kWinThreads) {
    const int r = i / (D / 8), cc = (i % (D / 8)) * 8;
    uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
    if (r < a.s) {
      kv = *reinterpret_cast<const uint4*>(kb + r * kst + cc);
      if constexpr (MODE != kDotsQk)
        vv = *reinterpret_cast<const uint4*>(vb + r * vst + cc);
    }
    *reinterpret_cast<uint4*>(k_s + r * LD + cc) = kv;
    if constexpr (MODE != kDotsQk) *reinterpret_cast<uint4*>(v_s + r * LD + cc) = vv;
  }
  const bf16 zero = __float2bfloat16(0.f);
  if constexpr (ROWS || BIAS2) {
    const bf16* rhb = a.rh + b * a.st[12] + h * a.st[13];
    const bf16* rwb = a.rw + b * a.st[15] + h * a.st[16];
    const int ncol = BIAS2 ? kExpK : a.win;
    for (int i = threadIdx.x; i < sk * ncol; i += kWinThreads) {
      const int r = i / ncol, j = i - r * ncol;
      th_s[r * a.ldt + j] = r < a.s ? rhb[r * a.st[14] + j] : zero;
      tw_s[r * a.ldt + j] = r < a.s ? rwb[r * a.st[17] + j] : zero;
    }
  }
  if constexpr (ROWS) {
    for (int i = threadIdx.x; i < sk; i += kWinThreads) {
      colh_s[i] = (unsigned char)(i / a.win);
      colw_s[i] = (unsigned char)(i % a.win);
    }
  }
  if constexpr (BIAS2) {
    for (int i = threadIdx.x; i < kExpK * sk; i += kWinThreads) {
      const int kk = i / sk, n = i - kk * sk;
      eh_s[kk * lde + n] = n < a.s ? a.eh[kk * a.s + n] : zero;
      ew_s[kk * lde + n] = n < a.s ? a.ew[kk * a.s + n] : zero;
    }
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  bf16* qw = q_s + warp * 16 * LD;
  for (int r0 = warp * 16; r0 < a.s; r0 += kWinWarps * 16) {
    __syncwarp();
    for (int i = lane; i < 16 * D / 8; i += 32) {
      const int r = i / (D / 8), cc = (i % (D / 8)) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r0 + r < a.s) {
        val = *reinterpret_cast<const uint4*>(qb + (r0 + r) * qst + cc);
        if constexpr (PRE) {
          bf16* e = reinterpret_cast<bf16*>(&val);
#pragma unroll
          for (int u = 0; u < 8; ++u) e[u] = __float2bfloat16(bf(e[u]) * a.cs);
        }
      }
      *reinterpret_cast<uint4*>(qw + r * LD + cc) = val;
    }
    __syncwarp();

    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t af[4];
      load_a(af, qw + kk * 16, LD, lane);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (j * 8 < sk) {
          uint32_t bfr[2];
          load_b_nk(bfr, k_s + j * 8 * LD + kk * 16, LD, lane);
          mma16816(s[j], af, bfr);
        }
      }
    }

    const int ra = r0 + g, rb = ra + 8;
    if constexpr (MODE == kDotsQk) {
      // key columns 0 .. D - 1 of (q·k)·cs, times 1e-3 (two fp32 products)
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int col = j * 8 + 2 * t;
        if (ra < a.s)
          *reinterpret_cast<uint32_t*>(ob + ra * ost + col) =
              pack_f32(s[j][0] * a.cs * 1e-3f, s[j][1] * a.cs * 1e-3f);
        if (rb < a.s)
          *reinterpret_cast<uint32_t*>(ob + rb * ost + col) =
              pack_f32(s[j][2] * a.cs * 1e-3f, s[j][3] * a.cs * 1e-3f);
      }
      continue;
    }

    // kBias2: this warp's 16 rows of qrh and qrw, the A operands of the
    // expander products (rows past S are zero in shared memory)
    uint32_t afh[4], afw[4];
    if constexpr (BIAS2) {
      load_a(afh, th_s + r0 * a.ldt, a.ldt, lane);
      load_a(afw, tw_s + r0 * a.ldt, a.ldt, lane);
    }
    // logits of rows ra, rb (the tables are zero past S, so are those rows);
    // their table offsets are taken once here: read inside the tile loop,
    // the table stride is reloaded from the parameters at every tile
    const int ta = ra * a.ldt, tb = ta + 8 * a.ldt;
    float m0 = LVV_NEG_BIG, m1 = LVV_NEG_BIG;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j * 8 < sk) {
        if constexpr (BIAS2) {
          // s = ((q·k)·cs + qrh·eh) + qrw·ew, in the script's order
          float bh[4] = {0.f, 0.f, 0.f, 0.f}, bw[4] = {0.f, 0.f, 0.f, 0.f};
          uint32_t bfr[2];
          load_b_kn(bfr, eh_s + j * 8, lde, lane);
          mma16816(bh, afh, bfr);
          load_b_kn(bfr, ew_s + j * 8, lde, lane);
          mma16816(bw, afw, bfr);
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = (s[j][e] * a.cs + bh[e]) + bw[e];
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = j * 8 + 2 * t + e;
          if (col < a.s) {
            if constexpr (ROWS) {
              const int ch = colh_s[col], cw = colw_s[col];
              const float qa = PRE ? s[j][e] : s[j][e] * a.cs;
              const float qb2 = PRE ? s[j][2 + e] : s[j][2 + e] * a.cs;
              s[j][e] = qa + (bf(th_s[ta + ch]) + bf(tw_s[ta + cw]));
              s[j][2 + e] = qb2 + (bf(th_s[tb + ch]) + bf(tw_s[tb + cw]));
            } else if constexpr (MODE == kSoftmax || MODE == kHmaj) {
              s[j][e] *= a.cs;
              s[j][2 + e] *= a.cs;
            } else if constexpr (MODE == kDotsQkPv) {
              s[j][e] = s[j][e] * a.cs * 1e-3f;
              s[j][2 + e] = s[j][2 + e] * a.cs * 1e-3f;
            }
          } else {
            // padded keys: out of the softmax, or p = 0 (V is zero there)
            s[j][e] = s[j][2 + e] = SOFTMAX ? LVV_NEG_BIG : 0.f;
          }
        }
        if constexpr (SOFTMAX) {
          m0 = fmaxf(m0, fmaxf(s[j][0], s[j][1]));
          m1 = fmaxf(m1, fmaxf(s[j][2], s[j][3]));
        }
      }
    }
    if constexpr (SOFTMAX) {
      m0 = quad_max(m0);
      m1 = quad_max(m1);
      float l0 = 0.f, l1 = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (j * 8 < sk) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if constexpr (ROWS) {
              s[j][e] = exp2f(s[j][e] - m0);
              s[j][2 + e] = exp2f(s[j][2 + e] - m1);
            } else {
              s[j][e] = expf(s[j][e] - m0);
              s[j][2 + e] = expf(s[j][2 + e] - m1);
            }
          }
          l0 += s[j][0] + s[j][1];
          l1 += s[j][2] + s[j][3];
        }
      }
      l0 = quad_sum(l0);
      l1 = quad_sum(l1);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (j * 8 < sk) {
          s[j][0] = __fdiv_rn(s[j][0], l0);
          s[j][1] = __fdiv_rn(s[j][1], l0);
          s[j][2] = __fdiv_rn(s[j][2], l1);
          s[j][3] = __fdiv_rn(s[j][3], l1);
        }
      }
    }

    float o[D / 8][4];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < NT / 2; ++kc) {
      if (kc * 16 < sk) {
        uint32_t af[4];
        af[0] = pack_f32(s[2 * kc][0], s[2 * kc][1]);
        af[1] = pack_f32(s[2 * kc][2], s[2 * kc][3]);
        af[2] = pack_f32(s[2 * kc + 1][0], s[2 * kc + 1][1]);
        af[3] = pack_f32(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          uint32_t bfr[2];
          load_b_kn(bfr, v_s + kc * 16 * LD + j * 8, LD, lane);
          mma16816(o[j], af, bfr);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = j * 8 + 2 * t;
      if (ra < a.s)
        *reinterpret_cast<uint32_t*>(ob + ra * ost + col) =
            pack_f32(o[j][0], o[j][1]);
      if (rb < a.s)
        *reinterpret_cast<uint32_t*>(ob + rb * ost + col) =
            pack_f32(o[j][2], o[j][3]);
    }
  }
}

template <int D, int NT, int MODE>
static int launch(const WinArgs& a, int b, cudaStream_t stream) {
  constexpr bool ROWS = MODE == kRowsPost || MODE == kRowsPre;
  const int sk = (a.s + 15) & ~15;
  size_t smem = (size_t)(2 * sk + kWinWarps * 16) * (D + 8) * sizeof(bf16) +
                (size_t)2 * sk * a.ldt * sizeof(bf16);
  if (ROWS) smem += 2 * (size_t)sk;
  if (MODE == kBias2) smem += (size_t)2 * kExpK * (sk + 8) * sizeof(bf16);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem(win_rows_kernel<D, NT, MODE>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(a.heads, b);
  win_rows_kernel<D, NT, MODE><<<grid, kWinThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int D, int MODE>
static int launch_nt(const WinArgs& a, int b, cudaStream_t stream) {
  const int sk = (a.s + 15) & ~15;
  if (sk <= 64) return launch<D, 8, MODE>(a, b, stream);
  if (sk <= 128) return launch<D, 16, MODE>(a, b, stream);
  return launch<D, 32, MODE>(a, b, stream);
}

// Every mode but kHmaj: q is qkv [B, S, 3·heads·d] and out [B, S, heads·d],
// both contiguous bf16; k, v unused. kHmaj: q, k, v, out bf16 [B, heads, S,
// d] through their (window, head, token) strides (unit stride over d; rows
// 16-byte aligned). S <= 256, d 64 (every mode) or 128 (kRowsPost /
// kRowsPre). `strides`: 18 int64, the strides of q, k, v, out (kHmaj, else
// unused), then rh, rw.
//   kRowsPost / kRowsPre: S = win², rh, rw bias rows with at least win
//     columns (unit column stride); cs = scale·log2e; kRowsPre rounds q·cs
//     to bf16 before q·k.
//   kDotsQk (S >= d), kDotsQkPv, kSoftmax, kHmaj: cs = scale; rh .. ew
//     unused.
//   kBias2: rh, rw the expander rows [.., S, 16] (unit column stride), eh,
//     ew contiguous [16, S]; cs = scale.
// Returns a cudaError_t (0 on success).
extern "C" int lvv_window_attention_rows(const void* q, const void* k,
                                         const void* v, void* out,
                                         const void* rh, const void* rw,
                                         const void* eh, const void* ew,
                                         const void* strides, int b, int s,
                                         int heads, int d, int win, int mode,
                                         float cs, void* stream) {
  const bool rows = mode == kRowsPost || mode == kRowsPre;
  if (!q || (mode == kHmaj && (!k || !v)) || !out || b <= 0 || heads <= 0 ||
      s <= 0 || s > kWinMaxS || mode < kRowsPost || mode > kHmaj ||
      (rows && (win <= 0 || win * win != s || !rh || !rw)) ||
      (mode == kDotsQk && s < d) ||
      (mode == kBias2 && (!rh || !rw || !eh || !ew)) ||
      !(d == 64 || (d == 128 && rows)))
    return (int)cudaErrorInvalidValue;
  WinArgs a;
  a.q = (const bf16*)q;
  a.k = (const bf16*)k;
  a.v = (const bf16*)v;
  a.out = (bf16*)out;
  a.rh = (const bf16*)rh;
  a.rw = (const bf16*)rw;
  a.eh = (const bf16*)eh;
  a.ew = (const bf16*)ew;
  memcpy(a.st, strides, sizeof(a.st));
  a.s = s;
  a.heads = heads;
  a.win = win;
  a.ldt = rows ? (win | 1) : mode == kBias2 ? kExpK + 8 : 0;
  a.cs = cs;
  cudaStream_t st = (cudaStream_t)stream;
  if (d == 128)
    return mode == kRowsPre ? launch_nt<128, kRowsPre>(a, b, st)
                            : launch_nt<128, kRowsPost>(a, b, st);
  switch (mode) {
    case kRowsPost: return launch_nt<64, kRowsPost>(a, b, st);
    case kRowsPre: return launch_nt<64, kRowsPre>(a, b, st);
    case kDotsQk: return launch_nt<64, kDotsQk>(a, b, st);
    case kDotsQkPv: return launch_nt<64, kDotsQkPv>(a, b, st);
    case kSoftmax: return launch_nt<64, kSoftmax>(a, b, st);
    case kBias2: return launch_nt<64, kBias2>(a, b, st);
    default: return launch_nt<64, kHmaj>(a, b, st);
  }
}
