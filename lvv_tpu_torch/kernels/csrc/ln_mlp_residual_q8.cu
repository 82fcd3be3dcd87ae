// W8A8 fused pre-LN transformer MLP for the port (bf16 in and out):
//   y  = LN(x) (fp32), y8 = int8(y / sy) with one scale sy per token row
//   for each hidden chunk j of width BH:
//     z  = (y8 @ W1q[:, j]) (int32) * sy * s1[j] + b1[j]       (fp32)
//     h  = act(bf16(z)) rounded to bf16, then fp32
//     h8 = int8(h / sh) with one scale sh per token row OF THIS CHUNK
//     acc += (h8 @ W2q[j, :]) (int32) * sh * s2
//   out = bf16(x + acc + b2)
// act = tanh-GELU (SAM) or QuickGELU (CLIP), gemm_sm90.cuh's mlp_act.
// Quantization divides, rounds half to even and clips to +-127; scales are
// max|row| / 127 floored at 1e-8 (the weights' max|column| · fl(1 / 127),
// below). Products accumulate in int32 (exact: at most 4096 · 127² < 2³¹).
//
// Replaces lvv_tpu/ops/fused_mlp.py::_kernel_q8 (reached through
// _fused_fwd_q8 and ln_mlp_residual(quant8=True)), TPU kernel K-f: the MLP
// half of the 12 SAM blocks ([24576, 768] x [768, 3072], one chunk) and the
// 24 CLIP layers ([1542, 1024] x [1024, 4096], two chunks of 2048) on the
// serving path.
//
// What bounds it on the H100: 4·N·C·H int8 operations against reading x
// and the int8 weights once and writing out once, far above the ~590
// operations per byte where int8 tensor cores overtake memory: the int8
// tensor-core rate, which only wgmma reaches.
//
// Design. A block that kept a whole chunk of h (up to 3072 columns) in
// shared memory for its row scale would hold only ~16 token rows and
// re-read the weights from L2 for each (~7 GB a SAM call). So, as in
// ln_mlp_residual.cu, h goes through device memory and both products run
// on the sm_90a GEMM core (gemm_sm90.cuh: [128, 128] output tiles on
// persistent blocks, two an SM; a TMA ring; int8 wgmma m64n128k32 with
// both operands K-major, W1q and W2q handed over transposed; the int8
// second product is slower on K-b's 256-wide tiles, PERF.md). Five
// launches at most a call, after the wrapper's two for the weights:
//   1. mlp_ln_q8: y8 int8 [N, C] and sy [N], straight from the fp32 LN (a
//      bf16 LN in front would change the function);
//   2. mlp_gemm_sm90 y8 · W1qᵀ, epilogue z, h = bf16(act(bf16(z))) [N, H]
//      and the maxima of |h| over each 64-column panel of each row
//      [N, H / 64]: no column tile sees a whole chunk of up to 3072;
//   3. mlp_quant_h: sh [N, H / BH] from the panels' maxima, h8 int8 [N, H];
//   4. mlp_gemm_sm90 h8 · W2qᵀ, one grid slice z per chunk (the chunk is
//      the third dimension of the tensor maps, so a k tile never crosses a
//      chunk): epilogue part = i32 · sh · s2, the order of the plain
//      version's fold; with one chunk (SAM) out = bf16((x + part) + b2)
//      directly, with several (CLIP's two) part goes to fp32 scratch
//      [chunks, N, C] and
//   5. mlp_combine adds the parts in chunk order, acc = part0 + part1 ...,
//      then out = bf16((x + acc) + b2): the plain version's order exactly,
//      so the split costs nothing in agreement. At CLIP's 13 token tiles it
//      also doubles the second product's tiles (104 -> 208).
// The schedule is the wrapper's `mlp_plan`. The wrapper quantizes the
// weights on every call (as the JAX package does outside its kernel) with
// quant_weight.cuh's mlp_wmax / mlp_wquant, which also write them
// transposed. h, h8 and the maxima cost 6·N·H + N·H / 8 bytes of traffic
// more (~0.46 GB a SAM call), not counted in the bound.
#include "gemm_sm90.cuh"
#include "int8.cuh"
#include "quant_weight.cuh"

using namespace sm90;

// LayerNorm (fp32) and per-row int8 quantization, one warp per row; each
// lane holds NI groups of 4 columns (C = 128 NI). ls / lb of type P: bf16,
// or fp32 as the model keeps them.
template <int NI, typename P>
__global__ void __launch_bounds__(256)
mlp_ln_q8(const bf16* __restrict__ x, const P* __restrict__ ls,
          const P* __restrict__ lb, signed char* __restrict__ y8,
          float* __restrict__ sy, int n, float eps) {
  constexpr int C = NI * 128;
  const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x & 31;
  if (row >= n) return;
  const bf16* xr = x + (long long)row * C;
  float v[NI][4];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const uint2 raw = *reinterpret_cast<const uint2*>(xr + 128 * i + 4 * lane);
    const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[i][k] = bf(e[k]);
      sum += v[i][k];
    }
  }
  const float mean = __fdiv_rn(warp_sum(sum), (float)C);
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float d = v[i][k] - mean;
      sq += d * d;
    }
  const float rstd = rsqrtf(__fdiv_rn(warp_sum(sq), (float)C) + eps);
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = 128 * i + 4 * lane + k;
      v[i][k] = __fadd_rn(__fmul_rn(__fmul_rn(v[i][k] - mean, rstd),
                                    param_f(ls[c])),
                          param_f(lb[c]));
      amax = fmaxf(amax, fabsf(v[i][k]));
    }
  const float s = row_scale(warp_max(amax));
#pragma unroll
  for (int i = 0; i < NI; ++i)
    *reinterpret_cast<uint32_t*>(y8 + (long long)row * C + 128 * i +
                                 4 * lane) =
        pack_s8(quant(v[i][0], s), quant(v[i][1], s), quant(v[i][2], s),
                quant(v[i][3], s));
  if (lane == 0) sy[row] = s;
}

// First product's epilogue: z = i32 · sy · s1 + b1, h [m, n] = bf16(act(
// bf16(z))), and pmax [m, n / 64] = max |h| over each 64-column panel.
template <int ACT>
struct EpiQ8Act {
  const float* sy;
  const float* s1;
  const bf16* b1;
  bf16* h;
  float* pmax;
  int m, n;
  __device__ __forceinline__ float hval(int i, float s, float sc,
                                        float b) const {
    const float z = __fadd_rn(
        __fmul_rn(__fmul_rn(__int2float_rn(i), s), sc), b);
    return round_bf16(mlp_act<ACT>(round_bf16(z)));
  }
  template <int BN>
  __device__ __forceinline__ void run(const int (&acc)[BN / 2], int r0,
                                      int n0, int) const {
    const int t = threadIdx.x & 3;
    const float sy0 = r0 < m ? __ldg(sy + r0) : 0.f;
    const float sy1 = r0 + 8 < m ? __ldg(sy + r0 + 8) : 0.f;
#pragma unroll
    for (int p = 0; p < BN / 64; ++p) {
      if (n0 + 64 * p >= n) break;      // n is a multiple of 64
      float mx0 = 0.f, mx1 = 0.f;
#pragma unroll
      for (int j = 8 * p; j < 8 * p + 8; ++j) {
        const int col = n0 + 8 * j + 2 * t;
        const float2 sc = __ldg(reinterpret_cast<const float2*>(s1 + col));
        const float2 bb = load_bf2(b1 + col);
        const float h0 = hval(acc[4 * j], sy0, sc.x, bb.x);
        const float h1 = hval(acc[4 * j + 1], sy0, sc.y, bb.y);
        const float h2 = hval(acc[4 * j + 2], sy1, sc.x, bb.x);
        const float h3 = hval(acc[4 * j + 3], sy1, sc.y, bb.y);
        mx0 = fmaxf(mx0, fmaxf(fabsf(h0), fabsf(h1)));
        mx1 = fmaxf(mx1, fmaxf(fabsf(h2), fabsf(h3)));
        if (r0 < m)
          *reinterpret_cast<uint32_t*>(h + (long long)r0 * n + col) =
              pack_f32(h0, h1);
        if (r0 + 8 < m)
          *reinterpret_cast<uint32_t*>(h + (long long)(r0 + 8) * n + col) =
              pack_f32(h2, h3);
      }
      mx0 = quad_max(mx0);
      mx1 = quad_max(mx1);
      const int panel = n0 / 64 + p;
      if (t == 0 && r0 < m) pmax[(long long)r0 * (n / 64) + panel] = mx0;
      if (t == 0 && r0 + 8 < m)
        pmax[(long long)(r0 + 8) * (n / 64) + panel] = mx1;
    }
  }
};

// sh [m, n / bh] and h8 [m, n]: one warp per row, chunk after chunk.
__global__ void __launch_bounds__(256)
mlp_quant_h(const bf16* __restrict__ h, const float* __restrict__ pmax,
            signed char* __restrict__ h8, float* __restrict__ sh, int m,
            int n, int bh) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x & 31;
  if (row >= m) return;
  const int panels = bh / 64, chunks = n / bh;
  for (int c = 0; c < chunks; ++c) {
    float mx = 0.f;
    for (int p = lane; p < panels; p += 32)
      mx = fmaxf(mx, pmax[(long long)row * (n / 64) + c * panels + p]);
    const float s = row_scale(warp_max(mx));
    if (lane == 0) sh[(long long)row * chunks + c] = s;
    for (int col = c * bh + 8 * lane; col < (c + 1) * bh; col += 256) {
      const long long off = (long long)row * n + col;
      const uint4 raw = *reinterpret_cast<const uint4*>(h + off);
      const bf16* e = reinterpret_cast<const bf16*>(&raw);
      *reinterpret_cast<uint2*>(h8 + off) = make_uint2(
          pack_s8(quant(bf(e[0]), s), quant(bf(e[1]), s), quant(bf(e[2]), s),
                  quant(bf(e[3]), s)),
          pack_s8(quant(bf(e[4]), s), quant(bf(e[5]), s), quant(bf(e[6]), s),
                  quant(bf(e[7]), s)));
    }
  }
}

// Second product's epilogue, chunk z: part = i32 · sh[:, z] · s2; with one
// chunk out [m, n] = bf16((x + part) + b2), else part [chunks, m, n] fp32.
struct EpiQ8Residual {
  const float* sh;
  const float* s2;
  const bf16* x;
  const bf16* b2;
  bf16* out;
  float* part;
  int m, n, chunks;
  // the two columns col, col + 1 of row r
  __device__ __forceinline__ void put(int r, int col, int z, float s,
                                      int a0, int a1, float2 sc) const {
    const float p0 = __fmul_rn(__fmul_rn(__int2float_rn(a0), s), sc.x);
    const float p1 = __fmul_rn(__fmul_rn(__int2float_rn(a1), s), sc.y);
    const long long off = (long long)r * n + col;
    if (chunks > 1) {
      *reinterpret_cast<float2*>(part + (long long)z * m * n + off) =
          make_float2(p0, p1);
    } else {
      const float2 xv = load_bf2(x + off), bb = load_bf2(b2 + col);
      *reinterpret_cast<uint32_t*>(out + off) =
          pack_f32(__fadd_rn(__fadd_rn(xv.x, p0), bb.x),
                   __fadd_rn(__fadd_rn(xv.y, p1), bb.y));
    }
  }
  template <int BN>
  __device__ __forceinline__ void run(const int (&acc)[BN / 2], int r0,
                                      int n0, int z) const {
    const int t = threadIdx.x & 3;
    const bool live0 = r0 < m, live1 = r0 + 8 < m;
    const float sh0 = live0 ? __ldg(sh + (long long)r0 * chunks + z) : 0.f;
    const float sh1 =
        live1 ? __ldg(sh + (long long)(r0 + 8) * chunks + z) : 0.f;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * t;
      if (col >= n) break;
      const float2 sc = __ldg(reinterpret_cast<const float2*>(s2 + col));
      if (live0) put(r0, col, z, sh0, acc[4 * j], acc[4 * j + 1], sc);
      if (live1) put(r0 + 8, col, z, sh1, acc[4 * j + 2], acc[4 * j + 3], sc);
    }
  }
};

// out = bf16((x + (part0 + part1 + ...)) + b2), the chunks' parts added in
// chunk order; two columns a thread.
__global__ void __launch_bounds__(256)
mlp_combine(const float* __restrict__ part, const bf16* __restrict__ x,
            const bf16* __restrict__ b2, bf16* __restrict__ out, long long mn,
            int n, int chunks) {
  const long long i = 2 * ((long long)blockIdx.x * 256 + threadIdx.x);
  if (i >= mn) return;
  float2 acc = *reinterpret_cast<const float2*>(part + i);
  for (int c = 1; c < chunks; ++c) {
    const float2 p = *reinterpret_cast<const float2*>(part + c * mn + i);
    acc.x = __fadd_rn(acc.x, p.x);
    acc.y = __fadd_rn(acc.y, p.y);
  }
  const float2 xv = load_bf2(x + i), bb = load_bf2(b2 + i % n);
  *reinterpret_cast<uint32_t*>(out + i) =
      pack_f32(__fadd_rn(__fadd_rn(xv.x, acc.x), bb.x),
               __fadd_rn(__fadd_rn(xv.y, acc.y), bb.y));
}

template <int NI>
static int launch_ln(const void* x, const void* ls, const void* lb,
                     void* y8, void* sy, int n, float eps, int pfp32,
                     cudaStream_t st) {
  if (pfp32)
    mlp_ln_q8<NI, float><<<(n + 7) / 8, 256, 0, st>>>(
        (const bf16*)x, (const float*)ls, (const float*)lb, (signed char*)y8,
        (float*)sy, n, eps);
  else
    mlp_ln_q8<NI, bf16><<<(n + 7) / 8, 256, 0, st>>>(
        (const bf16*)x, (const bf16*)ls, (const bf16*)lb, (signed char*)y8,
        (float*)sy, n, eps);
  return (int)cudaGetLastError();
}

// x / out [n, c] bf16; ls / lb [c] bf16 (pfp32 = 0) or fp32 (pfp32 = 1);
// b2 [c] bf16; w1t [h, c] and w2t [c, h]
// int8 (the per-column quantized W1 [c, h] and W2 [h, c], transposed);
// s1 [h], s2 [c] fp32; b1 [h] bf16; all contiguous and 16-byte aligned.
// Scratch: y8 [n, c] int8, sy [n] fp32, hb [n, h] bf16, pmax [n, h / 64]
// fp32, h8 [n, h] int8, sh [n, h / bh] fp32, and with more than one chunk
// part [h / bh, n, c] fp32. c a multiple of 128 up to 1024; bh (the chunk
// that shares a row scale of h) a multiple of 64 up to 4096 that divides
// h. act 0 = tanh GELU, 1 = QuickGELU. Returns a cudaError_t (0 on
// success).
extern "C" int lvv_ln_mlp_residual_q8(
    const void* x, const void* ls, const void* lb, const void* w1t,
    const void* s1, const void* b1, const void* w2t, const void* s2,
    const void* b2, void* out, void* y8, void* sy, void* hb, void* pmax,
    void* h8, void* sh, void* part, int n, int c, int h, int bh, float eps,
    int act, int pfp32, void* stream) {
  if (n <= 0 || c % 128 || c > 1024 || bh <= 0 || bh % 64 || bh > 4096 ||
      h % bh || act < 0 || act > 1 || (h / bh > 1 && !part))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int e = (int)cudaErrorInvalidValue;
  switch (c / 128) {
#define LVV_LN(NI) \
  case NI:         \
    e = launch_ln<NI>(x, ls, lb, y8, sy, n, eps, pfp32, st); \
    break;
    LVV_LN(1) LVV_LN(2) LVV_LN(3) LVV_LN(4)
    LVV_LN(5) LVV_LN(6) LVV_LN(7) LVV_LN(8)
#undef LVV_LN
  }
  if (e) return e;
  const float *syf = (const float*)sy, *s1f = (const float*)s1;
  e = act == 0
          ? gemm_launch<OpS8, 128>(y8, c, w1t, c, n, h, c, 1,
                                   EpiQ8Act<0>{syf, s1f, (const bf16*)b1,
                                               (bf16*)hb, (float*)pmax, n, h},
                                   st)
          : gemm_launch<OpS8, 128>(y8, c, w1t, c, n, h, c, 1,
                                   EpiQ8Act<1>{syf, s1f, (const bf16*)b1,
                                               (bf16*)hb, (float*)pmax, n, h},
                                   st);
  if (e) return e;
  mlp_quant_h<<<(n + 7) / 8, 256, 0, st>>>((const bf16*)hb,
                                           (const float*)pmax,
                                           (signed char*)h8, (float*)sh, n,
                                           h, bh);
  e = (int)cudaGetLastError();
  if (e) return e;
  const int chunks = h / bh;
  const EpiQ8Residual epi{(const float*)sh, (const float*)s2, (const bf16*)x,
                          (const bf16*)b2,  (bf16*)out,       (float*)part,
                          n,                c,                chunks};
  e = gemm_launch<OpS8, 128>(h8, h, w2t, h, n, c, bh, chunks, epi, st);
  if (e || chunks == 1) return e;
  const long long mn = (long long)n * c;
  mlp_combine<<<(unsigned)((mn / 2 + 255) / 256), 256, 0, st>>>(
      (const float*)part, (const bf16*)x, (const bf16*)b2, (bf16*)out, mn, c,
      chunks);
  return (int)cudaGetLastError();
}

// quant.quantize_weight of w [k, n] (contiguous; wkind 0 fp32, 1 bf16),
// transposed: wt [n, k] int8 and s [n] fp32, through pm [ceil(k / 128), n]
// fp32 scratch; k and n multiples of 64. The weight prep of K-f's wrapper,
// and K-i's own (w8a8_matmul.cu launches the same kernels itself). Returns
// a cudaError_t (0 on success).
extern "C" int lvv_ln_mlp_residual_q8_weight(const void* w, void* wt,
                                             void* s, void* pm, int k, int n,
                                             int wkind, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (wkind == 0) return quantize_weight_t<float>(w, wt, s, pm, k, n, st);
  if (wkind == 1) return quantize_weight_t<bf16>(w, wt, s, pm, k, n, st);
  return (int)cudaErrorInvalidValue;
}
