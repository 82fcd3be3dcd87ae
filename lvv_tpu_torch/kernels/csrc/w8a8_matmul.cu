// W8A8 matrix product with the bias, for the port (x bf16 or fp32, the
// float weight bf16 or fp32, the output in x's type):
//   sx[m]  = max(max_k |x[m, k]| / 127, 1e-8)       (one scale per row)
//   x8     = clip(round(x / sx), -127, 127)         (division, half to even)
//   wq, sw = quantize_weight(w)                     (per column, every call)
//   out    = ((x8 @ wq) (int32) · sx) · sw + b      (fp32, unfused, this order)
//
// Replaces lvv_tpu/ops/quant.py::_w8a8_kernel (reached through w8a8_matmul),
// TPU kernel K-i: SAM's qkv and proj projections under the "dense" scope of
// LVV_Q8_SCOPE, x [29400 or 24576, 768] @ [768, 2304] or [768, 768] at
// 1024² ([42336 or 38400, 768] at 1280²).
//
// What bounds it on the H100: 2·M·K·N int8 operations against reading x
// and w once and writing out once. At SAM's shapes the two are close (qkv of
// the windowed layers: 104 G operations, 0.053 ms at 1,979 TOP/s, against
// 181 MB, 0.054 ms at 3.35 TB/s, 135 MB of it the output), so both the int8
// rate, which only wgmma reaches, and the output's stores matter.
//
// Design. Four launches a call, from one C entry:
//   1. mlp_wmax / mlp_wquant (quant_weight.cuh, shared with K-f): the
//      weight's column scales sw and wq transposed to wt [N, K], K-major as
//      int8 wgmma reads B, bit-equal to quantize_weight on the card;
//   2. w8a8_rows: one warp a row of x (all its loads issued at once) writes
//      x8 [M, K] int8 and sx [M], so x is quantized once, not once for each
//      column tile as the TPU grid does it (2·M·K bytes of traffic more,
//      not counted in the bound);
//   3. the product on the sm_90a GEMM core (gemm_sm90.cuh): persistent
//      blocks, two an SM, [128, 128] output tiles (`w8a8_plan`), a TMA ring
//      of 128-byte-swizzled x8 / wt stages fed by a producer warp, two
//      consumer warpgroups on wgmma m64n128k32 s8 with exact int32
//      accumulators. The epilogue (EpiW8A8) rescales in the plain version's
//      order and rounds once to the output type; the four lanes of a quad
//      exchange their columns (a 4 x 4 transpose by shuffles) so that each
//      lane stores 16 contiguous bytes (bf16; two stores of 16 bytes for
//      fp32), never 4. It needs no shared memory, so one block's epilogue
//      runs beside the other block's products. On the H100 the epilogue,
//      not the products, sets most of the GEMM's time.
// Tried on the H100 and dropped as slower at every SAM shape: [128, 256]
// tiles (one block an SM) and clusters of two blocks sharing A by TMA
// multicast.
#include "gemm_sm90.cuh"
#include "int8.cuh"
#include "quant_weight.cuh"

using namespace sm90;

constexpr int kMaxK = 1536;   // the first version's limit, kept

// Four values of x at p (8- or 16-byte aligned) as floats.
__device__ __forceinline__ void load4(float* v, const float* p) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
}
__device__ __forceinline__ void load4(float* v, const bf16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
}

// x8 [m, K] and sx [m] from x [m, K], K = 128 NI: one warp a row, each lane
// NI groups of 4 columns, every load issued before the row's maximum. The
// quantization reads the row again (from L1), a group at a time, rather
// than keeping it in registers: the true division's slow path is a call,
// and values live across it would spill.
template <class T, int NI>
__global__ void __launch_bounds__(256)
w8a8_rows(const T* __restrict__ x, signed char* __restrict__ x8,
          float* __restrict__ sx, int m) {
  constexpr int K = NI * 128;
  const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x & 31;
  if (row >= m) return;
  const T* xr = x + (long long)row * K + 4 * lane;
  float amax = 0.f;
  {
    float v[NI][4];
#pragma unroll
    for (int i = 0; i < NI; ++i) load4(v[i], xr + 128 * i);
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) amax = fmaxf(amax, fabsf(v[i][e]));
  }
  const float s = row_scale(warp_max(amax));
  signed char* qr = x8 + (long long)row * K + 4 * lane;
#pragma unroll 1
  for (int i = 0; i < NI; ++i) {
    float v[4];
    load4(v, xr + 128 * i);
    *reinterpret_cast<uint32_t*>(qr + 128 * i) = pack_s8(
        quant(v[0], s), quant(v[1], s), quant(v[2], s), quant(v[3], s));
  }
  if (lane == 0) sx[row] = s;
}

// The quad's 4 x 4 transpose: in, u[i] is this lane's word of n8 tile i;
// out, u[s] is lane s's word of tile t (t = this lane's place in the quad).
// Permuting by xor t makes every exchange a fixed shfl.xor.
__device__ __forceinline__ void xor_perm(uint32_t (&u)[4], int t) {
  if (t & 1) {
    uint32_t a = u[0]; u[0] = u[1]; u[1] = a;
    a = u[2]; u[2] = u[3]; u[3] = a;
  }
  if (t & 2) {
    uint32_t a = u[0]; u[0] = u[2]; u[2] = a;
    a = u[1]; u[1] = u[3]; u[3] = a;
  }
}
__device__ __forceinline__ void quad_transpose(uint32_t (&u)[4], int t) {
  xor_perm(u, t);                        // u[i] = word t ^ i
#pragma unroll
  for (int i = 1; i < 4; ++i) u[i] = __shfl_xor_sync(0xffffffffu, u[i], i);
  xor_perm(u, t);                        // u[s] = lane s's word t
}

// One row's 8 columns of n8 tile t as 16 bytes (bf16) or 32 (fp32) at
// out + 8 t, from v[i][0..1], this lane's two columns of tile i = 0..3. Every
// lane of the warp takes part in the shuffles; only live rows store.
__device__ __forceinline__ void store_quad(bf16* out, const float (&v)[4][2],
                                           int t, bool live) {
  uint32_t u[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) u[i] = pack_f32(v[i][0], v[i][1]);
  quad_transpose(u, t);
  if (live)
    *reinterpret_cast<uint4*>(out + 8 * t) = make_uint4(u[0], u[1], u[2], u[3]);
}
__device__ __forceinline__ void store_quad(float* out, const float (&v)[4][2],
                                           int t, bool live) {
  uint32_t lo[4], hi[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lo[i] = __float_as_uint(v[i][0]);
    hi[i] = __float_as_uint(v[i][1]);
  }
  quad_transpose(lo, t);
  quad_transpose(hi, t);
  if (live) {
    float4* p = reinterpret_cast<float4*>(out + 8 * t);
    p[0] = make_float4(__uint_as_float(lo[0]), __uint_as_float(hi[0]),
                       __uint_as_float(lo[1]), __uint_as_float(hi[1]));
    p[1] = make_float4(__uint_as_float(lo[2]), __uint_as_float(hi[2]),
                       __uint_as_float(lo[3]), __uint_as_float(hi[3]));
  }
}

// out [m, n] = T(((float(i32) · sx) · sw) + b); BK 0: no bias (b = 0 adds
// nothing: y is never -0, as |z| >= 1 and both scales are >= 1e-8), 1:
// fp32, 2: bf16. The bias kind is a template argument: a branch on it per
// column keeps the compiler from interleaving the 32-column groups, and
// the registers that costs spill. The whole warp runs every step (the quad
// shuffles); rows past m are computed and not stored.
template <class T, int BK>
struct EpiW8A8 {
  const float* sx;
  const float* sw;
  const void* bias;
  T* out;
  int m, n;
  template <int BN>
  __device__ __forceinline__ void run(const int (&acc)[BN / 2], int r0,
                                      int n0, int) const {
    static_assert(BN % 32 == 0, "groups of four n8 tiles");
    const int t = threadIdx.x & 3;
    const bool live0 = r0 < m, live1 = r0 + 8 < m;
    const float sx0 = live0 ? __ldg(sx + r0) : 0.f;
    const float sx1 = live1 ? __ldg(sx + r0 + 8) : 0.f;
    T* row0 = out + (long long)r0 * n + n0;
    T* row1 = row0 + 8ll * n;
#pragma unroll
    for (int j0 = 0; j0 < BN / 8; j0 += 4) {   // 32 columns at a time
      float v0[4][2], v1[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = n0 + 8 * (j0 + i) + 2 * t;
        const float2 sc = __ldg(reinterpret_cast<const float2*>(sw + col));
        float2 bb = make_float2(0.f, 0.f);
        if constexpr (BK == 1)
          bb = __ldg(reinterpret_cast<const float2*>(bias) + col / 2);
        if constexpr (BK == 2)
          bb = load_bf2(reinterpret_cast<const bf16*>(bias) + col);
        const int* z = acc + 4 * (j0 + i);
        v0[i][0] = val(z[0], sx0, sc.x, bb.x);
        v0[i][1] = val(z[1], sx0, sc.y, bb.y);
        v1[i][0] = val(z[2], sx1, sc.x, bb.x);
        v1[i][1] = val(z[3], sx1, sc.y, bb.y);
      }
      store_quad(row0 + 8 * j0, v0, t, live0);
      store_quad(row1 + 8 * j0, v1, t, live1);
    }
  }
  static __device__ __forceinline__ float val(int z, float s, float sc,
                                              float b) {
    return __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(z), s), sc), b);
  }
};

template <class T, int NI>
static int launch_rows(const void* x, void* x8, void* sx, int m,
                       cudaStream_t st) {
  w8a8_rows<T, NI><<<(m + 7) / 8, 256, 0, st>>>((const T*)x,
                                                (signed char*)x8,
                                                (float*)sx, m);
  return (int)cudaGetLastError();
}

template <class T>
static int rows_k(const void* x, void* x8, void* sx, int m, int k,
                  cudaStream_t st) {
  switch (k / 128) {
#define LVV_ROWS(NI) \
  case NI:           \
    return launch_rows<T, NI>(x, x8, sx, m, st);
    LVV_ROWS(1) LVV_ROWS(2) LVV_ROWS(3) LVV_ROWS(4) LVV_ROWS(5) LVV_ROWS(6)
    LVV_ROWS(7) LVV_ROWS(8) LVV_ROWS(9) LVV_ROWS(10) LVV_ROWS(11)
    LVV_ROWS(12)
#undef LVV_ROWS
  }
  return (int)cudaErrorInvalidValue;
}

static bool bad_shape(int m, int k, int n) {
  return m <= 0 || k <= 0 || n <= 0 || k % 128 || n % 128 || k > kMaxK;
}

template <class T, int BK>
static int gemm_bk(const void* x8, const void* wt, const void* sx,
                   const void* sw, const void* bias, void* out, int m, int k,
                   int n, cudaStream_t st) {
  const EpiW8A8<T, BK> epi{(const float*)sx, (const float*)sw, bias,
                           (T*)out, m, n};
  return gemm_launch<OpS8, 128>(x8, k, wt, k, m, n, k, 1, epi, st);
}

template <class T>
static int gemm(const void* x8, const void* wt, const void* sx,
                const void* sw, const void* bias, int bkind, void* out, int m,
                int k, int n, cudaStream_t st) {
  if (bkind == 1) return gemm_bk<T, 1>(x8, wt, sx, sw, bias, out, m, k, n, st);
  if (bkind == 2) return gemm_bk<T, 2>(x8, wt, sx, sw, bias, out, m, k, n, st);
  return gemm_bk<T, 0>(x8, wt, sx, sw, bias, out, m, k, n, st);
}

// The whole call. x [m, k] (xkind 0 fp32, 1 bf16) and out [m, n] of x's
// type; w [k, n] (wkind 0 fp32, 1 bf16); bias [n] (bkind 0 none, 1 fp32,
// 2 bf16); scratch x8 [m, k] int8, sx [m] fp32, wt [n, k] int8, sw [n]
// fp32, pm [k / 128, n] fp32; all contiguous and 16-byte aligned. k and n
// multiples of 128, k at most 1536 (`w8a8_plan` is the schedule). Returns
// a cudaError_t (0 on success).
extern "C" int lvv_w8a8_matmul(const void* x, const void* w, const void* bias,
                               void* out, void* x8, void* sx, void* wt,
                               void* sw, void* pm, int m, int k, int n,
                               int xkind, int wkind, int bkind,
                               void* stream) {
  if (bad_shape(m, k, n) || xkind < 0 || xkind > 1 || wkind < 0 ||
      wkind > 1 || bkind < 0 || bkind > 2 || (bkind && !bias))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int e = wkind ? quantize_weight_t<bf16>(w, wt, sw, pm, k, n, st)
                : quantize_weight_t<float>(w, wt, sw, pm, k, n, st);
  if (e) return e;
  e = xkind ? rows_k<bf16>(x, x8, sx, m, k, st)
            : rows_k<float>(x, x8, sx, m, k, st);
  if (e) return e;
  return xkind ? gemm<bf16>(x8, wt, sx, sw, bias, bkind, out, m, k, n, st)
               : gemm<float>(x8, wt, sx, sw, bias, bkind, out, m, k, n, st);
}

// The row pass alone, for the timings (the weight prep alone is K-f's
// lvv_ln_mlp_residual_q8_weight).
extern "C" int lvv_w8a8_rows(const void* x, void* x8, void* sx, int m, int k,
                             int xkind, void* stream) {
  if (bad_shape(m, k, 128) || xkind < 0 || xkind > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return xkind ? rows_k<bf16>(x, x8, sx, m, k, st)
               : rows_k<float>(x, x8, sx, m, k, st);
}
