// Grouped q·R rows from the packed qkv projection: for each token t, head h
// and table column k,
//   qr[t, h, k] = bf16( Σ_d q[t, h, d] · tab[g(t), k, d] )   (fp32 sum)
// where g(t) is the token's grid row (qh) or column (qw) and tab[g] =
// bf16(rel[g]·log2e) is the caller's table for that coordinate (the same for
// every head). Columns k at or past the table's length are zero.
//
// Replaces three TPU bodies of lvv_tpu/ops/attention.py that compute this
// product as one matmul per coordinate against a block-diagonal
// kron(I_heads, tab[g]) table, each grid step owning the tokens of one
// coordinate (a transposed copy of q serves the qw grouping):
//   kRows  _wbias_prep_kernel (via _window_bias_prep, K-l): both q·Rh and
//          q·Rw rows of SAM's windows, [B, S, H·kp] each (kp = 16 at 14x14).
//   kQK    _gaug_qk_kernel (via hpacked_prep_pallas, K-m): q_aug =
//          [bf16(q·scale·log2e) | q·Rh | 0] and k_aug = [k | onehot(kh) | 0],
//          one 128-lane block a head, [B, S, H·128] each.
//   kV     _gaug_v_kernel (K-m): v_aug = [v | q·Rw | 0], [B, S, H·128].
// Here the function is kept and the TPU's layout tricks are not: there is no
// kron table (a head's q rows meet the one [K, d] table) and no transposed q
// (a block indexes the tokens of its coordinate directly).
//
// What bounds it on the H100: device memory. The products are 2·K·d
// operations per token and head against reading q (and k, v) and writing
// the rows: at most 21 operations a byte.
//
// Design: one block of 4 warps per (coordinate g, 64 of the tokens with that
// coordinate across all windows or views[, table in kRows]). It keeps tab[g]
// in shared memory, and for each head stages its 64 q rows there and takes
// the [64, d] x [d, K] product with mma.sync (one warp per 16 rows), writing
// each result pair straight from the accumulators. The copied lanes of kQK /
// kV go as 16-byte vectors.
#include "common.cuh"

enum { kRows = 0, kQK = 1, kV = 2 };
constexpr int kPrepRows = 64;       // tokens a block (16 per warp)
constexpr int kPrepThreads = 128;
constexpr int kPrepMaxWidth = 64;   // output columns of one head's rows

struct PrepArgs {
  const bf16* qkv;
  const bf16* tab[2];   // [G, K, d]: grouping by grid row (0), by column (1)
  bf16* out[2];         // kRows: q·Rh, q·Rw rows; kQK: q_aug, k_aug; kV: v_aug
  int s, heads, gh, gw, width, n_tok[2];
  float cs;             // scale·log2e (kQK)
};

template <int D, int MODE>
__global__ void __launch_bounds__(kPrepThreads) qr_prep_kernel(const PrepArgs a) {
  constexpr int LD = D + 8;
  __shared__ __align__(16) bf16 t_s[kPrepMaxWidth * LD];
  __shared__ __align__(16) bf16 q_s[kPrepRows * LD];
  __shared__ long long row_s[kPrepRows];   // view·S + token, -1 past the end

  const int g = blockIdx.x;
  const int which = MODE == kRows ? blockIdx.z : (MODE == kQK ? 0 : 1);
  const int per_view = which == 0 ? a.gw : a.gh;   // tokens of g in a view
  const int k_n = which == 0 ? a.gh : a.gw;        // table rows
  const int c = a.heads * D;
  const long long row = 3LL * c;
  const bf16* tab = a.tab[which] + (long long)g * k_n * D;
  bf16* out = a.out[which];
  const int pitch = MODE == kRows ? a.heads * a.width : a.heads * 128;
  const int head_pitch = MODE == kRows ? a.width : 128;
  const int col0 = MODE == kRows ? 0 : D;

  for (int r = threadIdx.x; r < kPrepRows; r += kPrepThreads) {
    const int m = blockIdx.y * kPrepRows + r;
    long long idx = -1;
    if (m < a.n_tok[which]) {
      const int view = m / per_view, i = m - view * per_view;
      const int tok = which == 0 ? g * a.gw + i : i * a.gw + g;
      idx = (long long)view * a.s + tok;
    }
    row_s[r] = idx;
  }
  for (int i = threadIdx.x; i < a.width * D / 8; i += kPrepThreads) {
    const int k = i / (D / 8), cc = (i % (D / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (k < k_n) val = *reinterpret_cast<const uint4*>(tab + k * D + cc);
    *reinterpret_cast<uint4*>(t_s + k * LD + cc) = val;
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, t = lane & 3;
  for (int h = 0; h < a.heads; ++h) {
    __syncthreads();   // the previous head's q rows are read; row_s is written
    for (int i = threadIdx.x; i < kPrepRows * D / 8; i += kPrepThreads) {
      const int r = i / (D / 8), cc = (i % (D / 8)) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (row_s[r] >= 0)
        val = *reinterpret_cast<const uint4*>(a.qkv + row_s[r] * row + h * D + cc);
      *reinterpret_cast<uint4*>(q_s + r * LD + cc) = val;
    }
    __syncthreads();
    float acc[kPrepMaxWidth / 8][4];
#pragma unroll
    for (int j = 0; j < kPrepMaxWidth / 8; ++j)
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t af[4];
      load_a(af, q_s + warp * 16 * LD + kk * 16, LD, lane);
#pragma unroll
      for (int j = 0; j < kPrepMaxWidth / 8; ++j) {
        if (j * 8 < a.width) {
          uint32_t bfr[2];
          load_b_nk(bfr, t_s + j * 8 * LD + kk * 16, LD, lane);
          mma16816(acc[j], af, bfr);
        }
      }
    }
    const long long ra = row_s[warp * 16 + gq], rb = row_s[warp * 16 + gq + 8];
#pragma unroll
    for (int j = 0; j < kPrepMaxWidth / 8; ++j) {
      if (j * 8 < a.width) {
        const int col = h * head_pitch + col0 + j * 8 + 2 * t;
        if (ra >= 0)
          *reinterpret_cast<uint32_t*>(out + ra * pitch + col) =
              pack_f32(acc[j][0], acc[j][1]);
        if (rb >= 0)
          *reinterpret_cast<uint32_t*>(out + rb * pitch + col) =
              pack_f32(acc[j][2], acc[j][3]);
      }
    }
  }

  if constexpr (MODE != kRows) {
    // the copied lanes: q·cs and k (kQK) or v (kV) in lanes [0, d) of each
    // head's block, and kQK's onehot(kh) in lanes [d, 128)
    constexpr int V8 = D / 8;
    for (int i = threadIdx.x; i < kPrepRows * a.heads * V8; i += kPrepThreads) {
      const int r = i / (a.heads * V8), rest = i - r * a.heads * V8;
      const int h = rest / V8, cc = (rest % V8) * 8;
      const long long idx = row_s[r];
      if (idx < 0) continue;
      const bf16* src = a.qkv + idx * row + h * D + cc;
      bf16* dst = out + idx * pitch + h * 128 + cc;
      if constexpr (MODE == kQK) {
        uint4 qv = *reinterpret_cast<const uint4*>(src);
        bf16* e = reinterpret_cast<bf16*>(&qv);
#pragma unroll
        for (int u = 0; u < 8; ++u) e[u] = __float2bfloat16(bf(e[u]) * a.cs);
        *reinterpret_cast<uint4*>(dst) = qv;
        *reinterpret_cast<uint4*>(a.out[1] + idx * pitch + h * 128 + cc) =
            *reinterpret_cast<const uint4*>(src + c);
      } else {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src + 2 * c);
      }
    }
    if constexpr (MODE == kQK) {
      constexpr int P8 = (128 - D) / 8;
      const bf16 one = __float2bfloat16(1.f), zero = __float2bfloat16(0.f);
      for (int i = threadIdx.x; i < kPrepRows * a.heads * P8; i += kPrepThreads) {
        const int r = i / (a.heads * P8), rest = i - r * a.heads * P8;
        const int h = rest / P8, p0 = (rest % P8) * 8;
        const long long idx = row_s[r];
        if (idx < 0) continue;
        uint4 val;
        bf16* e = reinterpret_cast<bf16*>(&val);
#pragma unroll
        for (int u = 0; u < 8; ++u) e[u] = p0 + u == g ? one : zero;
        *reinterpret_cast<uint4*>(a.out[1] + idx * pitch + h * 128 + D + p0) = val;
      }
    }
  }
}

template <int D, int MODE>
static int launch(const PrepArgs& a, int groups, int tables, cudaStream_t stream) {
  const int n = a.n_tok[MODE == kV ? 1 : 0];
  dim3 grid(groups, (n + kPrepRows - 1) / kPrepRows, tables);
  qr_prep_kernel<D, MODE><<<grid, kPrepThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// qkv [B, S, 3·heads·d] contiguous bf16 over a gh x gw grid of tokens
// (row-major); tab_h [gh, gh, d], tab_w [gw, gw, d] contiguous bf16.
// mode kRows (d 64 or 128, gh == gw == win, width = kp, a multiple of 8 and
// >= win): out0 = q·Rh rows, out1 = q·Rw rows, [B, S, heads·width] each.
// mode kQK (d 64, width 128 - d >= gh): out0 = q_aug, out1 = k_aug; mode
// kV (d 64, width 128 - d >= gw): out0 = v_aug; [B, S, heads·128] each, cs
// = scale·log2e. Returns a cudaError_t (0 on success).
extern "C" int lvv_qr_prep(const void* qkv, const void* tab_h,
                           const void* tab_w, void* out0, void* out1, int b,
                           int s, int heads, int d, int gh, int gw, int width,
                           int mode, float cs, void* stream) {
  if (gh <= 0 || gw <= 0 || gh * gw != s || b <= 0 || heads <= 0 || !qkv ||
      !out0 || width <= 0 || width % 8 || width > kPrepMaxWidth)
    return (int)cudaErrorInvalidValue;
  PrepArgs a;
  a.qkv = (const bf16*)qkv;
  a.tab[0] = (const bf16*)tab_h;
  a.tab[1] = (const bf16*)tab_w;
  a.out[0] = (bf16*)out0;
  a.out[1] = (bf16*)out1;
  a.s = s;
  a.heads = heads;
  a.gh = gh;
  a.gw = gw;
  a.width = width;
  a.n_tok[0] = b * gw;
  a.n_tok[1] = b * gh;
  a.cs = cs;
  cudaStream_t st = (cudaStream_t)stream;
  if (mode == kRows) {
    if (gh != gw || width < gh || !tab_h || !tab_w || !out1)
      return (int)cudaErrorInvalidValue;
    // table 1 (the qw grouping) writes out[1]: kRows passes both
    if (d == 64) return launch<64, kRows>(a, gh, 2, st);
    if (d == 128) return launch<128, kRows>(a, gh, 2, st);
    return (int)cudaErrorInvalidValue;
  }
  if (d != 64 || d + width != 128) return (int)cudaErrorInvalidValue;
  if (mode == kQK) {
    if (gh > width || !tab_h || !out1) return (int)cudaErrorInvalidValue;
    return launch<64, kQK>(a, gh, 1, st);
  }
  if (mode == kV) {
    if (gw > width || !tab_w) return (int)cudaErrorInvalidValue;
    a.out[1] = a.out[0];   // the qw grouping writes out[1]
    return launch<64, kV>(a, gw, 1, st);
  }
  return (int)cudaErrorInvalidValue;
}
