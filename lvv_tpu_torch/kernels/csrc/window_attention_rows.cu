// SAM window attention over precomputed q·R bias rows, from the packed qkv
// projection (bf16 in and out, fp32 softmax in base 2):
//   out = softmax₂(logit) v,  logit[q, kv] = q·k·cs + rh[q, kv / win] + rw[q, kv % win]
// with cs = scale·log2e and the caller's bias rows rh, rw (q·Rh and q·Rw,
// already scaled by log2e and rounded to bf16). The whole row of S = win²
// keys is one tile: p is divided by its row sum, then rounded to bf16 for
// p@v, as the TPU kernels do.
//
// Replaces five TPU bodies of lvv_tpu/ops/attention.py (K-l), which compute
// this one function and differ only where the scale is rounded and in the
// layout of their bias rows:
//   PRE (q scaled by cs and rounded to bf16 BEFORE the product):
//     _window_fused_kernel  (window_attention_fused)   rows [B, H, S, win] x2
//     _window_fused2_kernel (window_attention_fused2)  rows [B, H, S, 2·win]
//   not PRE (the fp32 product scaled by cs):
//     _window_v3_kernel     (window_attention_v3)      rows [B, H, S, 16] x2
//     _window_phased_kernel (window_attention_phased)  rows [B, H, S, 16] x2
//     _window_v4_kernel     (window_attention_v4)      rows [B, S, H·16] x2
// Each table is a pointer with (window, head, token) strides and unit stride
// over its columns, so all five layouts are read where they lie. The TPU
// kernels expand the rows to [S, S] with one-hot matmuls or concatenated
// operands (Mosaic cannot gather); here each score reads its two row entries
// by index from shared memory.
//
// What bounds it on the H100: reading qkv and writing the output, 2·S·4C
// bytes a window, against 4·S²·d operations a (window, head): about 98
// operations a byte at SAM's 14x14 windows, under the card's ~295, so device
// memory bounds it (0.06 ms for 150 windows of 12 heads).
//
// Design: one block of 4 warps per (head, window). K and V of the window
// (S rows, zero-padded to a multiple of 16) and both bias tables go to shared
// memory once; each warp then takes 16 query rows at a time and keeps the
// scores of all S keys in registers (mma.sync m16n8k16 from common.cuh):
// row maximum and sum by quad shuffles, exact division, p@v straight from
// the score registers. Nothing goes back to device memory but the output.
#include <string.h>

#include "common.cuh"

constexpr int kWinWarps = 4;
constexpr int kWinThreads = 32 * kWinWarps;
constexpr int kWinMaxS = 256;

struct WinArgs {
  const bf16* qkv;
  const bf16 *rh, *rw;  // bias rows, unit stride over the columns
  bf16* out;
  long long st[6];      // (window, head, token) strides of rh, then rw
  int s, heads, win, ldt;
  float cs;
};

// NT: score tiles of 8 keys a warp holds (S padded to 16 fits in 8·NT)
template <int D, int NT, bool PRE>
__global__ void __launch_bounds__(kWinThreads) win_rows_kernel(const WinArgs a) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int sk = (a.s + 15) & ~15;
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);     // [sk][LD]
  bf16* v_s = k_s + sk * LD;                         // [sk][LD]
  bf16* q_s = v_s + sk * LD;                         // [kWinWarps][16][LD]
  bf16* th_s = q_s + kWinWarps * 16 * LD;            // [sk][ldt] rh rows
  bf16* tw_s = th_s + sk * a.ldt;                    // [sk][ldt] rw rows
  unsigned char* colh_s = reinterpret_cast<unsigned char*>(tw_s + sk * a.ldt);
  unsigned char* colw_s = colh_s + sk;               // [sk] kv / win, kv % win

  const int h = blockIdx.x, b = blockIdx.y;
  const int c = a.heads * D;
  const long long row = 3LL * c;
  const bf16* base = a.qkv + (long long)b * a.s * row + h * D;

  for (int i = threadIdx.x; i < sk * D / 8; i += kWinThreads) {
    const int r = i / (D / 8), cc = (i % (D / 8)) * 8;
    uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
    if (r < a.s) {
      kv = *reinterpret_cast<const uint4*>(base + r * row + c + cc);
      vv = *reinterpret_cast<const uint4*>(base + r * row + 2 * c + cc);
    }
    *reinterpret_cast<uint4*>(k_s + r * LD + cc) = kv;
    *reinterpret_cast<uint4*>(v_s + r * LD + cc) = vv;
  }
  const bf16* rhb = a.rh + b * a.st[0] + h * a.st[1];
  const bf16* rwb = a.rw + b * a.st[3] + h * a.st[4];
  const bf16 zero = __float2bfloat16(0.f);
  for (int i = threadIdx.x; i < sk * a.win; i += kWinThreads) {
    const int r = i / a.win, j = i - r * a.win;
    th_s[r * a.ldt + j] = r < a.s ? rhb[r * a.st[2] + j] : zero;
    tw_s[r * a.ldt + j] = r < a.s ? rwb[r * a.st[5] + j] : zero;
  }
  for (int i = threadIdx.x; i < sk; i += kWinThreads) {
    colh_s[i] = (unsigned char)(i / a.win);
    colw_s[i] = (unsigned char)(i % a.win);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  bf16* qw = q_s + warp * 16 * LD;
  bf16* ob = a.out + (long long)b * a.s * c + h * D;
  for (int r0 = warp * 16; r0 < a.s; r0 += kWinWarps * 16) {
    __syncwarp();
    for (int i = lane; i < 16 * D / 8; i += 32) {
      const int r = i / (D / 8), cc = (i % (D / 8)) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r0 + r < a.s) {
        val = *reinterpret_cast<const uint4*>(base + (r0 + r) * row + cc);
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

    // logits of rows ra, rb (the tables are zero past S, so are those rows)
    const int ra = r0 + g, rb = ra + 8;
    float m0 = LVV_NEG_BIG, m1 = LVV_NEG_BIG;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j * 8 < sk) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = j * 8 + 2 * t + e;
          if (col < a.s) {
            const int ch = colh_s[col], cw = colw_s[col];
            const float qa = PRE ? s[j][e] : s[j][e] * a.cs;
            const float qb = PRE ? s[j][2 + e] : s[j][2 + e] * a.cs;
            s[j][e] = qa + (bf(th_s[ra * a.ldt + ch]) + bf(tw_s[ra * a.ldt + cw]));
            s[j][2 + e] = qb + (bf(th_s[rb * a.ldt + ch]) + bf(tw_s[rb * a.ldt + cw]));
          } else {
            s[j][e] = s[j][2 + e] = LVV_NEG_BIG;
          }
        }
        m0 = fmaxf(m0, fmaxf(s[j][0], s[j][1]));
        m1 = fmaxf(m1, fmaxf(s[j][2], s[j][3]));
      }
    }
    m0 = quad_max(m0);
    m1 = quad_max(m1);
    float l0 = 0.f, l1 = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j * 8 < sk) {
        s[j][0] = exp2f(s[j][0] - m0);
        s[j][1] = exp2f(s[j][1] - m0);
        s[j][2] = exp2f(s[j][2] - m1);
        s[j][3] = exp2f(s[j][3] - m1);
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
        *reinterpret_cast<uint32_t*>(ob + (long long)ra * c + col) =
            pack_f32(o[j][0], o[j][1]);
      if (rb < a.s)
        *reinterpret_cast<uint32_t*>(ob + (long long)rb * c + col) =
            pack_f32(o[j][2], o[j][3]);
    }
  }
}

template <int D, int NT, bool PRE>
static int launch(const WinArgs& a, int b, cudaStream_t stream) {
  const int sk = (a.s + 15) & ~15;
  const size_t smem = (size_t)(2 * sk + kWinWarps * 16) * (D + 8) * sizeof(bf16) +
                      (size_t)2 * sk * a.ldt * sizeof(bf16) + 2 * (size_t)sk;
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem(win_rows_kernel<D, NT, PRE>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(a.heads, b);
  win_rows_kernel<D, NT, PRE><<<grid, kWinThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int D, bool PRE>
static int launch_nt(const WinArgs& a, int b, cudaStream_t stream) {
  const int sk = (a.s + 15) & ~15;
  if (sk <= 64) return launch<D, 8, PRE>(a, b, stream);
  if (sk <= 128) return launch<D, 16, PRE>(a, b, stream);
  return launch<D, 32, PRE>(a, b, stream);
}

// qkv [B, S, 3·heads·d] contiguous bf16 (S = win², win <= 16, d 64 or
// 128); rh, rw bf16 bias rows with unit column stride and the (window,
// head, token) strides in `strides` (6 int64: rh, then rw), at least win
// columns each; out [B, S, heads·d] contiguous bf16. prescale 1: q is
// scaled by cs and rounded to bf16 before q·k; 0: q·k is scaled by cs.
// Returns a cudaError_t (0 on success).
extern "C" int lvv_window_attention_rows(const void* qkv, const void* rh,
                                         const void* rw, void* out,
                                         const void* strides, int b, int s,
                                         int heads, int d, int win,
                                         int prescale, float cs,
                                         void* stream) {
  if (win <= 0 || win * win != s || s > kWinMaxS || !qkv || !rh || !rw ||
      !out || b <= 0 || heads <= 0)
    return (int)cudaErrorInvalidValue;
  WinArgs a;
  a.qkv = (const bf16*)qkv;
  a.rh = (const bf16*)rh;
  a.rw = (const bf16*)rw;
  a.out = (bf16*)out;
  memcpy(a.st, strides, sizeof(a.st));
  a.s = s;
  a.heads = heads;
  a.win = win;
  a.ldt = win | 1;
  a.cs = cs;
  cudaStream_t st = (cudaStream_t)stream;
  if (d == 64)
    return prescale ? launch_nt<64, true>(a, b, st) : launch_nt<64, false>(a, b, st);
  if (d == 128)
    return prescale ? launch_nt<128, true>(a, b, st)
                    : launch_nt<128, false>(a, b, st);
  return (int)cudaErrorInvalidValue;
}
