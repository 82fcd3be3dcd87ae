// Grouped q·R rows from the packed qkv projection: for each token t, head h
// and table column k,
//   qr[t, h, k] = bf16( Σ_d q[t, h, d] · tab[g(t), k, d] )   (fp32 sum)
// where g(t) is the token's grid row (qh) or column (qw) and tab[g] =
// bf16(rel[g]·log2e) is the table for that coordinate (the same for every
// head), made here from the caller's rel_h / rel_w as the kernel loads it.
// Columns k at or past the table's length are zero.
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
// (a block gathers the tokens of its coordinate itself).
//
// What bounds it on the H100: device memory. The products are 2·K·d
// operations per token and head against reading q (and k, v) and writing
// the rows: at most 21 operations a byte.
//
// Design. A block owns a slab of tokens and walks a run of heads (kQK /
// kV) or of (window, head) steps (kRows); for each step its threads copy
// the slab's q (and k or v) rows for that head into shared memory with
// cp.async, into a ring of kStages stages, so that the next steps' loads
// are in flight while one is computed; one __syncthreads a step. Each warp
// takes 16-token tiles of the slab and runs the [16, d] x [d, K] product
// with mma.sync (A rows addressed one by one, so a tile may gather strided
// tokens), writes the fp32 sums rounded to bf16 into its own staging rows,
// then stores each token's output block with 16-byte stores. Each input
// byte is read once from device memory.
//   kQK / kV (qr_lanes_kernel): a block is one grid row (kQK: gw
//     contiguous tokens, table tab_h[row]) or one grid column (kV: gh
//     tokens gw rows apart, tab_w[col]) of one view, and a run of heads, its
//     one table in shared memory. The whole 256-byte lane block of a token
//     and head goes out at once: the copied lanes (q·cs, rounded, or v) from
//     the slab, the q·R lanes from the staging rows, zero and one-hot lanes
//     as constants; kQK's k_aug the same way from the slab's k rows.
//   kRows (qr_rows_kernel): a block holds a whole window (win² <= 256
//     tokens) a step, so its win row lines (table tab_h[row]) and win
//     column lines (tab_w[col]) both read the one copy of q. The blocks are
//     persistent and each warp owns the same lines at every (window, head)
//     step, so its lines' tables stay in registers as B fragments and a
//     line costs one ldmatrix and two mma a k16 step: the lines are many
//     (28 a step at 14x14) and short, and their instructions, not the
//     bytes, set this mode's time otherwise.
#include <algorithm>

#include "common.cuh"

enum { kRows = 0, kQK = 1, kV = 2 };
constexpr int kTile = 16;           // token slots of a warp tile
constexpr int kMaxWidth = 64;       // q·R columns of one head
constexpr int kStLd = kMaxWidth + 8;
constexpr int kStages = 3;          // ring stages
constexpr int kLaneWarps = 4;       // qr_lanes_kernel: one tile a warp
constexpr int kMaxWindow = 16;      // kRows: win² slab rows <= 256
constexpr int kSms = 132;
constexpr int kTargetBlocks = 8 * kSms;
constexpr size_t kMaxSmem = 227 * 1024;

struct PrepArgs {
  const bf16* qkv;
  const bf16* tab[2];   // [G, K, d]: grouping by grid row (0), by column (1)
  bf16* out[2];         // kRows: q·Rh, q·Rw rows; kQK: q_aug, k_aug; kV: v_aug
  int s, heads, gh, gw, width;
  int hpb;              // qr_lanes_kernel: heads a block
  int items;            // qr_rows_kernel: (window, head) steps
  float cs;             // scale·log2e (kQK)
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Two bf16 table entries r -> bf16(r·log2e) each (the fp32 product
// rounded once, as the wrappers' plain versions make the table: `_log2e_
// table` in ops/attention.py)
__device__ __forceinline__ uint32_t log2e_pair(uint32_t w) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&w);
  return pack_f32(__low2float(v) * LVV_LOG2E, __high2float(v) * LVV_LOG2E);
}

// Issue the cp.async copies of n slab rows (qkv rows row(r)) of head h into
// one ring stage: q, then with OPS == 2 the part at offset `second` (k or
// v) after them.
template <int D, int OPS, int THREADS, class Row>
__device__ __forceinline__ void load_slab(const PrepArgs& a, bf16* stage,
                                          int h, int n, int second, Row row) {
  constexpr int V8 = D / 8, LD = D + 8;
  const long long pitch = 3LL * a.heads * D;
  for (int i = threadIdx.x; i < OPS * n * V8; i += THREADS) {
    const int op = i / (n * V8), rest = i - op * n * V8;
    const int r = rest / V8, cc = (rest - r * V8) * 8;
    cp_async16(stage + (op * n + r) * LD + cc,
               a.qkv + row(r) * pitch + (op ? second : 0) + h * D + cc);
  }
}

// acc = q rows of the tile x tab^T for this warp: 16 slots whose slab rows
// are base + slot·step (slots at or past `valid` read row `base`), table
// rows n of `tab` (pitch tld) below k_n, zeros past them; `nch` 8-column
// chunks. The fp32 sums go to the warp's staging rows as bf16.
template <int D>
__device__ __forceinline__ void tile_product(const bf16* q_s, int ld, int base,
                                             int step, int valid,
                                             const bf16* tab, int tld,
                                             int k_n, int nch, bf16* stg,
                                             int lane) {
  const int gq = lane >> 2, t = lane & 3;
  const int r0 = base + (gq < valid ? gq : 0) * step;
  const int r1 = base + (gq + 8 < valid ? gq + 8 : 0) * step;
  float acc[kMaxWidth / 8][4];
#pragma unroll
  for (int j = 0; j < kMaxWidth / 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const bf16* p0 = q_s + r0 * ld + kk * 16 + 2 * t;
    const bf16* p1 = q_s + r1 * ld + kk * 16 + 2 * t;
    uint32_t af[4];
    af[0] = *reinterpret_cast<const uint32_t*>(p0);
    af[1] = *reinterpret_cast<const uint32_t*>(p1);
    af[2] = *reinterpret_cast<const uint32_t*>(p0 + 8);
    af[3] = *reinterpret_cast<const uint32_t*>(p1 + 8);
#pragma unroll
    for (int j = 0; j < kMaxWidth / 8; ++j) {
      if (j < nch) {
        const int n = j * 8 + gq;
        uint32_t bfr[2] = {0u, 0u};
        if (n < k_n) {
          const bf16* p = tab + n * tld + kk * 16 + 2 * t;
          bfr[0] = *reinterpret_cast<const uint32_t*>(p);
          bfr[1] = *reinterpret_cast<const uint32_t*>(p + 8);
        }
        mma16816(acc[j], af, bfr);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kMaxWidth / 8; ++j) {
    if (j < nch) {
      *reinterpret_cast<uint32_t*>(stg + gq * kStLd + j * 8 + 2 * t) =
          pack_f32(acc[j][0], acc[j][1]);
      *reinterpret_cast<uint32_t*>(stg + (gq + 8) * kStLd + j * 8 + 2 * t) =
          pack_f32(acc[j][2], acc[j][3]);
    }
  }
}

// kQK / kV: q_aug and k_aug, or v_aug, of one grid row or column of one
// view (blockIdx.x the line, y the view, z the run of heads).
template <int MODE>
__global__ void __launch_bounds__(32 * kLaneWarps)
    qr_lanes_kernel(const PrepArgs a) {
  constexpr int D = 64, LD = D + 8, V8 = D / 8, THREADS = 32 * kLaneWarps;
  extern __shared__ __align__(16) unsigned char smem[];
  const int g = blockIdx.x;
  const int n = MODE == kQK ? a.gw : a.gh;       // the line's tokens
  const int k_n = MODE == kQK ? a.gh : a.gw;     // its table's rows
  const long long view0 = (long long)blockIdx.y * a.s;
  auto row = [&](int r) -> long long {
    return view0 + (MODE == kQK ? g * a.gw + r : r * a.gw + g);
  };
  const int stage_elems = 2 * n * LD;
  bf16* slab = reinterpret_cast<bf16*>(smem);
  bf16* tab_s = slab + kStages * stage_elems;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  bf16* stg = tab_s + kMaxWidth * LD + warp * kTile * kStLd;

  const int h0 = blockIdx.z * a.hpb;
  const int nh = min(a.hpb, a.heads - h0);
  const int c = a.heads * D, second = MODE == kQK ? c : 2 * c;
  {   // the block's table, zero rows past its length
    const bf16* tab = (MODE == kQK ? a.tab[0] : a.tab[1]) +
                      (long long)g * k_n * D;
    for (int i = threadIdx.x; i < kMaxWidth * V8; i += THREADS) {
      const int k = i / V8, cc = (i % V8) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (k < k_n) {
        val = *reinterpret_cast<const uint4*>(tab + k * D + cc);
        val = make_uint4(log2e_pair(val.x), log2e_pair(val.y),
                         log2e_pair(val.z), log2e_pair(val.w));
      }
      *reinterpret_cast<uint4*>(tab_s + k * LD + cc) = val;
    }
  }
  const int nch = (k_n + 7) / 8;
  const int pitch = a.heads * 128;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nh)
      load_slab<D, 2, THREADS>(a, slab + st * stage_elems, h0 + st, n, second,
                               row);
    cp_async_commit();
  }
  for (int i = 0; i < nh; ++i) {
    cp_async_wait<kStages - 2>();
    // head i's rows have landed (and the table, the first time); every
    // warp is done with head i - 1's stage, which the next load reuses,
    // and with its staging rows
    __syncthreads();
    if (i + kStages - 1 < nh)
      load_slab<D, 2, THREADS>(
          a, slab + ((i + kStages - 1) % kStages) * stage_elems,
          h0 + i + kStages - 1, n, second, row);
    cp_async_commit();
    const int h = h0 + i;
    const bf16* q_s = slab + (i % kStages) * stage_elems;
    const bf16* x_s = q_s + n * LD;   // k (kQK) or v (kV) rows
    for (int tile = warp; tile * kTile < n; tile += kLaneWarps) {
      const int base = tile * kTile;
      const int valid = min(kTile, n - base);
      tile_product<D>(q_s, LD, base, 1, valid, tab_s, LD, k_n, nch, stg,
                      lane);
      __syncwarp();
      for (int v = lane; v < valid * 16; v += 32) {
        const int r = v >> 4, cv = v & 15;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (cv < V8) {
          val = *reinterpret_cast<const uint4*>(
              (MODE == kQK ? q_s : x_s) + (base + r) * LD + cv * 8);
          if constexpr (MODE == kQK) {
            // q·cs, rounded, from the q rows staged for the product
            bf16* e = reinterpret_cast<bf16*>(&val);
#pragma unroll
            for (int u = 0; u < 8; ++u) e[u] = __float2bfloat16(bf(e[u]) * a.cs);
          }
        } else if (cv - V8 < nch) {
          val = *reinterpret_cast<const uint4*>(stg + r * kStLd +
                                                (cv - V8) * 8);
        }
        *reinterpret_cast<uint4*>(a.out[0] + row(base + r) * pitch + h * 128 +
                                  cv * 8) = val;
      }
      if constexpr (MODE == kQK) {
        // k_aug: k's rows, then onehot(kh), kh = this block's grid row
        const bf16 one = __float2bfloat16(1.f), zero = __float2bfloat16(0.f);
        for (int v = lane; v < valid * 16; v += 32) {
          const int r = v >> 4, cv = v & 15;
          uint4 val;
          if (cv < V8) {
            val = *reinterpret_cast<const uint4*>(x_s + (base + r) * LD +
                                                  cv * 8);
          } else {
            bf16* e = reinterpret_cast<bf16*>(&val);
#pragma unroll
            for (int u = 0; u < 8; ++u)
              e[u] = (cv - V8) * 8 + u == g ? one : zero;
          }
          *reinterpret_cast<uint4*>(a.out[1] + row(base + r) * pitch +
                                    h * 128 + cv * 8) = val;
        }
      }
      __syncwarp();   // the staging rows are rewritten by the next tile
    }
  }
}

// A fragment of a 16x16 tile whose row `slot` lies at rows[slot]: ldmatrix
// .x4, lane l giving the address of slot l % 16, columns 8·(l / 16) on.
__device__ __forceinline__ void ldsm_a(uint32_t (&a)[4], const bf16* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(s));
}

// kRows' launch shape: warps a block, and lines (of the 2·win <= 32) a warp
template <int D>
struct RowsCfg {
  static constexpr int WARPS = D == 64 ? 8 : 16;
  static constexpr int LPW = (2 * kMaxWindow + WARPS - 1) / WARPS;
  static constexpr int ST_LD = kMaxWindow + 8;   // staging row pitch
};

// kRows: persistent blocks, each walking the (window, head) steps k =
// blockIdx.x, + gridDim.x, ... (k / heads the window, k % heads the head).
// Warp w owns lines w, w + WARPS, ... of every step (lines 0 .. win - 1:
// grid rows, table tab_h[row]; win .. 2·win - 1: grid columns, tab_w[col]),
// so it holds their tables' B fragments in registers for the whole launch;
// a line's A fragments come by ldmatrix from the step's slab, one per k16
// step, its rows gathered (a column line's tokens lie win rows apart).
template <int D>
__global__ void __launch_bounds__(32 * RowsCfg<D>::WARPS, D == 64 ? 2 : 1)
    qr_rows_kernel(const PrepArgs a) {
  constexpr int WARPS = RowsCfg<D>::WARPS, LPW = RowsCfg<D>::LPW;
  constexpr int LD = D + 8, KS = D / 16, NCH = kMaxWindow / 8;
  constexpr int THREADS = 32 * WARPS;
  extern __shared__ __align__(16) unsigned char smem[];
  const int win = a.gw, n = win * win, wv = a.width / 8, nch = (win + 7) / 8;
  const int stage_elems = n * LD;
  bf16* slab = reinterpret_cast<bf16*>(smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, t = lane & 3;
  constexpr int SLD = RowsCfg<D>::ST_LD;
  bf16* stg = slab + kStages * stage_elems + warp * kTile * SLD;

  // this warp's lines' B fragments: table rows j·8 + gq (zero past win)
  uint32_t bfr[LPW][NCH][KS][2];
#pragma unroll
  for (int li = 0; li < LPW; ++li) {
    const int line = warp + li * WARPS;
    const int col = line >= win, g = line - col * win;
    const bf16* tab = (col ? a.tab[1] : a.tab[0]) + (long long)g * win * D;
#pragma unroll
    for (int j = 0; j < NCH; ++j)
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const int row = j * 8 + gq;
        const bool ok = line < 2 * win && row < win;
        const bf16* p = tab + row * D + kk * 16 + 2 * t;
        bfr[li][j][kk][0] =
            ok ? log2e_pair(*reinterpret_cast<const uint32_t*>(p)) : 0u;
        bfr[li][j][kk][1] =
            ok ? log2e_pair(*reinterpret_cast<const uint32_t*>(p + 8)) : 0u;
      }
  }

  const int steps = (a.items - (int)blockIdx.x + (int)gridDim.x - 1) /
                    (int)gridDim.x;
  const int pitch = a.heads * a.width;
  auto load = [&](int j) {
    const int k = blockIdx.x + j * gridDim.x;
    const long long view0 = (long long)(k / a.heads) * a.s;
    load_slab<D, 1, THREADS>(a, slab + (j % kStages) * stage_elems,
                             k % a.heads, n, 0,
                             [&](int r) -> long long { return view0 + r; });
  };

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < steps) load(st);
    cp_async_commit();
  }
  for (int i = 0; i < steps; ++i) {
    cp_async_wait<kStages - 2>();
    // step i's rows have landed; every warp is done with step i - 1's
    // stage and its staging rows
    __syncthreads();
    if (i + kStages - 1 < steps) load(i + kStages - 1);
    cp_async_commit();
    const int k = blockIdx.x + i * gridDim.x;
    const long long view0 = (long long)(k / a.heads) * a.s;
    const int h = k % a.heads;
    const bf16* q_s = slab + (i % kStages) * stage_elems;
#pragma unroll
    for (int li = 0; li < LPW; ++li) {
      const int line = warp + li * WARPS;
      if (line >= 2 * win) break;
      const int col = line >= win, g = line - col * win;
      const int base = col ? g : g * win, step = col ? win : 1;
      const int slot = lane & 15;      // slots past win read row `base`
      const bf16* arow = q_s + (base + (slot < win ? slot : 0) * step) * LD +
                         (lane >> 4) * 8;
      float acc[NCH][4] = {};
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t af[4];
        ldsm_a(af, arow + kk * 16);
#pragma unroll
        for (int j = 0; j < NCH; ++j) mma16816(acc[j], af, bfr[li][j][kk]);
      }
#pragma unroll
      for (int j = 0; j < NCH; ++j) {
        *reinterpret_cast<uint32_t*>(stg + gq * SLD + j * 8 + 2 * t) =
            pack_f32(acc[j][0], acc[j][1]);
        *reinterpret_cast<uint32_t*>(stg + (gq + 8) * SLD + j * 8 + 2 * t) =
            pack_f32(acc[j][2], acc[j][3]);
      }
      __syncwarp();
      bf16* out = col ? a.out[1] : a.out[0];
      for (int v = lane; v < win * wv; v += 32) {
        const int r = v / wv, cv = v - r * wv;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (cv < nch)
          val = *reinterpret_cast<const uint4*>(stg + r * SLD + cv * 8);
        *reinterpret_cast<uint4*>(out + (view0 + base + r * step) * pitch +
                                  h * a.width + cv * 8) = val;
      }
      __syncwarp();   // the staging rows are rewritten by the next line
    }
  }
}

static int launch_lanes(PrepArgs a, int mode, int views, cudaStream_t st) {
  constexpr int LD = 64 + 8;
  const int lines = mode == kQK ? a.gh : a.gw;
  const int n = mode == kQK ? a.gw : a.gh;
  // heads a block: enough blocks to fill the card several times over
  const int base = lines * views;
  const int groups =
      std::min(a.heads, std::max(1, (kTargetBlocks + base - 1) / base));
  a.hpb = (a.heads + groups - 1) / groups;
  const size_t smem = sizeof(bf16) * ((size_t)kStages * 2 * n * LD +
                                      kMaxWidth * LD +
                                      (size_t)kLaneWarps * kTile * kStLd);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kernel = mode == kQK ? qr_lanes_kernel<kQK> : qr_lanes_kernel<kV>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(lines, views, (a.heads + a.hpb - 1) / a.hpb);
  kernel<<<grid, 32 * kLaneWarps, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <int D>
static int launch_rows(PrepArgs a, int views, cudaStream_t st) {
  constexpr int LD = D + 8, WARPS = RowsCfg<D>::WARPS;
  const int n = a.gw * a.gw;
  const size_t smem = sizeof(bf16) * ((size_t)kStages * n * LD +
                                      (size_t)WARPS * kTile *
                                          RowsCfg<D>::ST_LD);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  a.items = views * a.heads;
  cudaError_t err = allow_smem(qr_rows_kernel<D>, smem);
  if (err != cudaSuccess) return (int)err;
  // as many blocks as fit on the card at once (two an SM at head dim 64)
  const int per_sm = D == 64 ? 2 : 1;
  qr_rows_kernel<D><<<std::min(a.items, per_sm * kSms), 32 * WARPS, smem,
                      st>>>(a);
  return (int)cudaGetLastError();
}

// qkv [B, S, 3·heads·d] contiguous bf16 over a gh x gw grid of tokens
// (row-major); tab_h = rel_h [gh, gh, d], tab_w = rel_w [gw, gw, d]
// contiguous bf16 (the kernel scales them by log2e).
// mode kRows (d 64 or 128, gh == gw == win <= 16, width = kp, a multiple
// of 8 and >= win): out0 = q·Rh rows, out1 = q·Rw rows, [B, S,
// heads·width] each. mode kQK (d 64, width 128 - d >= gh, gw <= 64): out0
// = q_aug, out1 = k_aug; mode kV (d 64, width 128 - d >= gw, gh <= 64):
// out0 = v_aug; [B, S, heads·128] each, cs = scale·log2e. Returns a
// cudaError_t (0 on success).
extern "C" int lvv_qr_prep(const void* qkv, const void* tab_h,
                           const void* tab_w, void* out0, void* out1, int b,
                           int s, int heads, int d, int gh, int gw, int width,
                           int mode, float cs, void* stream) {
  if (gh <= 0 || gw <= 0 || gh * gw != s || b <= 0 || heads <= 0 || !qkv ||
      !out0 || width <= 0 || width % 8 || width > kMaxWidth)
    return (int)cudaErrorInvalidValue;
  PrepArgs a = {};
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
  a.cs = cs;
  cudaStream_t st = (cudaStream_t)stream;
  if (mode == kRows) {
    if (gh != gw || gh > kMaxWindow || width < gh || !tab_h || !tab_w ||
        !out1)
      return (int)cudaErrorInvalidValue;
    if (d == 64) return launch_rows<64>(a, b, st);
    if (d == 128) return launch_rows<128>(a, b, st);
    return (int)cudaErrorInvalidValue;
  }
  if (d != 64 || d + width != 128 || gh > kMaxWidth || gw > kMaxWidth)
    return (int)cudaErrorInvalidValue;
  if (mode == kQK && tab_h && out1) return launch_lanes(a, kQK, b, st);
  if (mode == kV && tab_w) return launch_lanes(a, kV, b, st);
  return (int)cudaErrorInvalidValue;
}
