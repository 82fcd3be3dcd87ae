// Weight-only int8 matmul with the weight stored [N, K], for the tied
// unembed of the port's serving decode:
//   out[m, n] = T( sum_k x[m, k] * q[n, k] * s[n] )
// x [M, K] bf16 or fp32, q [N, K] int8 as stored (one scale per row n,
// s [N] fp32), fp32 sums, the scale applied once on the output side and one
// rounding to x's type. The table is never transposed or copied.
//
// Replaces lvv_tpu/ops/quant.py::_qmv_nk_kernel (reached through
// quantized_matmul_nk), TPU kernel K-k. On the serving path it is the
// decode's unembed over the [151,940 x 896] table, once per step at M = 1
// (M = 8 at serving-batch[8]).
//
// What bounds it on the H100: 2·M·N·K operations on N·K weight bytes, 136
// MB a call at the path's shape: device memory, 41 us at 3.35 TB/s, at
// every M <= 8, as long as the table is read once and the arithmetic per
// byte stays under what the SMs issue in that time.
//
// Design (the plan comes from ops/quant.py `qmv_nk_plan`):
//   - One pass over the table for all of x's rows (up to 8; more rows take
//     more passes). No grid.y: one wave of persistent blocks, each warp
//     walking vocabulary tiles gw, gw + W, ... (W warps in the grid).
//   - x's rows are staged once a block in shared memory and read as
//     broadcasts (fp32 for the fma form, bf16 for the tensor-core form).
//   - Each lane keeps a ring of D 16-byte weight loads in flight
//     (ld.global.nc.L1::no_allocate.v4), issued before x is staged and
//     refilled as each is used, across tile boundaries.
//   - Dequantization by byte permute: w ^ 0x80 under the exponent of 2^23
//     (0x4B0000xx = 2^23 + w + 128), less 2^23 + 128, is w exactly; no cvt.
//   - fma form (fp32 x at any M, bf16 x at M = 1; `qmv_nk_fma`): a warp
//     takes 4 vocabulary rows, 8 lanes a row; lane l owns the 16-byte
//     pieces l, l + 8, ... of its row (896 bytes: 7 pieces), so each load
//     of the warp reads 128 contiguous bytes of 4 rows. fp32 fma chains per
//     piece, then 3 shuffles fold the 8 lanes of a row.
//   - tensor-core form (bf16 x at 2 to 8 rows; `qmv_nk_mma`): a warp takes
//     16 vocabulary rows, mma.sync m16n8k16 bf16 with the weight tile as A
//     (int8 values are exact in bf16) and x's rows as the n8 B operand
//     (rows past M are zeros), fp32 accumulators. Lane (g, t) loads bytes
//     16t .. 16t + 15 of each 64-byte group of rows g and g + 8; the k
//     order inside a k16 step is permuted alike in A and B (step s takes
//     bytes 4s .. 4s + 3 of each lane's piece), so no fragment needs a
//     shuffle. The per-byte cost falls from 2 + M ops to ~2.5 at any M.
//   - Stores: adjacent lanes (fma: lanes 0-3; mma: the 8 quads) own
//     adjacent rows n.
#include "common.cuh"

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Units (16-byte loads a lane) in flight, and the blocks an SM the launch
// bounds keep room for: `qmv_nk_plan` sizes the grid to one wave of those.
// The fma form's sums and x values take registers from the ring as the
// rows grow (8 rows: 2 units, or the 128 registers spill).
template <int MT, bool MMA>
struct NkCfg {
  static constexpr int D = MMA ? 4 : MT >= 8 ? 2 : MT >= 4 ? 4 : 8;
  static constexpr int BLOCKS = (MMA || MT <= 2) ? 3 : 2;
};

// 16 bytes of the table at p, read once, not kept in L1
__device__ __forceinline__ uint4 load_q16(const signed char* p) {
  uint4 w;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(w.x), "=r"(w.y), "=r"(w.z), "=r"(w.w)
      : "l"(p));
  return w;
}

// the four int8 of a word as exact floats, lowest byte first
__device__ __forceinline__ void dequant4(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;
  f[0] = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)),
                   8388736.f);
  f[1] = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)),
                   8388736.f);
  f[2] = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)),
                   8388736.f);
  f[3] = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)),
                   8388736.f);
}

// the four int8 of a word as two bf16 pairs (bytes 0, 1 and 2, 3): the
// exact floats' upper halves
__device__ __forceinline__ void dequant_bf2(uint32_t w, uint32_t& lo,
                                            uint32_t& hi) {
  float f[4];
  dequant4(w, f);
  lo = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
  hi = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(bf16* p, float v) {
  *p = __float2bfloat16(v);
}

// fma form: a warp's tile is 4 rows (lane & 3) x 8 lanes (lane >> 2); x's
// rows [m0, m0 + MT) staged as fp32 [MT][loads · 128].
template <class T, int MT>
__global__ void __launch_bounds__(kThreads, (NkCfg<MT, false>::BLOCKS))
qmv_nk_fma(const T* __restrict__ x, const signed char* __restrict__ q,
           const float* __restrict__ s, T* __restrict__ out, int m, int k,
           int n) {
  constexpr int D = NkCfg<MT, false>::D;
  extern __shared__ __align__(16) unsigned char smem_nk[];
  float* xs = reinterpret_cast<float*>(smem_nk);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rw = lane & 3, l = lane >> 2;
  const int W = gridDim.x * kWarps, gw = blockIdx.x * kWarps + warp;
  const int loads = (k + 127) / 128, ld = loads * 128;
  const int tiles = (n + 3) / 4;
  const int units = tiles > gw ? (tiles - gw + W - 1) / W * loads : 0;
  for (int m0 = 0; m0 < m; m0 += MT) {
    uint4 buf[D];
    int ft = gw, fi = 0;                 // the next unit to load
    auto fetch = [&](uint4& b) {
      const int row = 4 * ft + rw, off = 16 * (l + 8 * fi);
      b = (row < n && off < k) ? load_q16(q + (long long)row * k + off)
                               : make_uint4(0u, 0u, 0u, 0u);
      if (++fi == loads) fi = 0, ft += W;
    };
#pragma unroll
    for (int d = 0; d < D; ++d)
      if (d < units) fetch(buf[d]);
    if (m0 > 0) __syncthreads();         // the last group's x is read
    for (int i = threadIdx.x; i < MT * ld; i += kThreads) {
      const int mm = i / ld, kk = i - mm * ld;
      xs[i] = (m0 + mm < m && kk < k)
                  ? to_f(x[(long long)(m0 + mm) * k + kk]) : 0.f;
    }
    __syncthreads();
    float acc[MT];
#pragma unroll
    for (int mm = 0; mm < MT; ++mm) acc[mm] = 0.f;
    int ct = gw, ci = 0;                 // the next unit to use
    for (int u0 = 0; u0 < units; u0 += D) {
#pragma unroll
      for (int d = 0; d < D; ++d) {
        if (u0 + d >= units) break;
        float w[16];
#pragma unroll
        for (int c = 0; c < 4; ++c)
          dequant4(reinterpret_cast<const uint32_t*>(&buf[d])[c], w + 4 * c);
        if (u0 + d + D < units) fetch(buf[d]);
        const float* xp = xs + 16 * (l + 8 * ci);
#pragma unroll
        for (int mm = 0; mm < MT; ++mm) {
          float xv[16];
#pragma unroll
          for (int c = 0; c < 4; ++c)
            *reinterpret_cast<float4*>(xv + 4 * c) =
                reinterpret_cast<const float4*>(xp + mm * ld)[c];
#pragma unroll
          for (int e = 0; e < 16; ++e) acc[mm] = fmaf(xv[e], w[e], acc[mm]);
        }
        if (++ci == loads) {             // the tile's last piece: fold, store
          const int row = 4 * ct + rw;
#pragma unroll
          for (int mm = 0; mm < MT; ++mm) {
            float v = acc[mm];
            v += __shfl_xor_sync(0xffffffffu, v, 4);
            v += __shfl_xor_sync(0xffffffffu, v, 8);
            v += __shfl_xor_sync(0xffffffffu, v, 16);
            if (l == 0 && row < n && m0 + mm < m)
              put(out + (long long)(m0 + mm) * n + row, v * __ldg(s + row));
            acc[mm] = 0.f;
          }
          ci = 0, ct += W;
        }
      }
    }
  }
}

// tensor-core form: a warp's tile is 16 rows, lane (g, t) = (lane / 4,
// lane % 4) loads rows g and g + 8; x's rows [m0, m0 + 8) staged as bf16
// [8][loads · 64 + 8] (the 16-byte pad puts the 8 rows' reads on distinct
// banks), rows past m and columns past k zero.
template <int MT>
__global__ void __launch_bounds__(kThreads, (NkCfg<MT, true>::BLOCKS))
qmv_nk_mma(const bf16* __restrict__ x, const signed char* __restrict__ q,
           const float* __restrict__ s, bf16* __restrict__ out, int m, int k,
           int n) {
  static_assert(MT == 8, "x's rows are the 8 columns of the n8 operand");
  constexpr int D = NkCfg<MT, true>::D;
  extern __shared__ __align__(16) unsigned char smem_nk[];
  bf16* xb = reinterpret_cast<bf16*>(smem_nk);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int W = gridDim.x * kWarps, gw = blockIdx.x * kWarps + warp;
  const int loads = (k + 63) / 64, ld = loads * 64 + 8;
  const int tiles = (n + 15) / 16;
  const int units = tiles > gw ? (tiles - gw + W - 1) / W * loads : 0;
  for (int m0 = 0; m0 < m; m0 += MT) {
    uint4 buf[D][2];
    int ft = gw, fi = 0;
    auto fetch = [&](uint4 (&b)[2]) {
      const int r0 = 16 * ft + g, off = 64 * fi + 16 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        b[h] = (r0 + 8 * h < n && off < k)
                   ? load_q16(q + (long long)(r0 + 8 * h) * k + off)
                   : make_uint4(0u, 0u, 0u, 0u);
      if (++fi == loads) fi = 0, ft += W;
    };
#pragma unroll
    for (int d = 0; d < D; ++d)
      if (d < units) fetch(buf[d]);
    if (m0 > 0) __syncthreads();
    const int vecs = ld / 8;             // 16-byte pieces a staged row
    for (int i = threadIdx.x; i < MT * vecs; i += kThreads) {
      const int mm = i / vecs, kk = 8 * (i - mm * vecs);
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + mm < m && kk < k)
        v = *reinterpret_cast<const uint4*>(x + (long long)(m0 + mm) * k + kk);
      *reinterpret_cast<uint4*>(xb + mm * ld + kk) = v;
    }
    __syncthreads();
    float c[4] = {0.f, 0.f, 0.f, 0.f};
    int ct = gw, ci = 0;
    for (int u0 = 0; u0 < units; u0 += D) {
#pragma unroll
      for (int d = 0; d < D; ++d) {
        if (u0 + d >= units) break;
        uint32_t b[8];                   // x[g][64 ci + 16 t .. + 15]
        const uint4* xp =
            reinterpret_cast<const uint4*>(xb + g * ld + 64 * ci + 16 * t);
        *reinterpret_cast<uint4*>(b) = xp[0];
        *reinterpret_cast<uint4*>(b + 4) = xp[1];
#pragma unroll
        for (int st = 0; st < 4; ++st) {  // step st: word st of each row
          uint32_t a[4];
          dequant_bf2(reinterpret_cast<const uint32_t*>(&buf[d][0])[st],
                      a[0], a[2]);
          dequant_bf2(reinterpret_cast<const uint32_t*>(&buf[d][1])[st],
                      a[1], a[3]);
          mma16816(c, a, b + 2 * st);
        }
        if (u0 + d + D < units) fetch(buf[d]);
        if (++ci == loads) {             // the tile's last group: store
          const int r0 = 16 * ct + g;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = r0 + 8 * h;
            if (row < n) {
              const float sc = __ldg(s + row);
#pragma unroll
              for (int e = 0; e < 2; ++e)
                if (m0 + 2 * t + e < m)
                  put(out + (long long)(m0 + 2 * t + e) * n + row,
                      c[2 * h + e] * sc);
            }
          }
          c[0] = c[1] = c[2] = c[3] = 0.f;
          ci = 0, ct += W;
        }
      }
    }
  }
}

template <class T, int MT>
static int launch_fma(const void* x, const void* q, const void* s, void* out,
                      int m, int k, int n, int blocks, cudaStream_t st) {
  const size_t smem = (size_t)MT * ((k + 127) / 128) * 128 * sizeof(float);
  const cudaError_t e = allow_smem(qmv_nk_fma<T, MT>, smem);
  if (e != cudaSuccess) return (int)e;
  qmv_nk_fma<T, MT><<<blocks, kThreads, smem, st>>>(
      (const T*)x, (const signed char*)q, (const float*)s, (T*)out, m, k, n);
  return (int)cudaGetLastError();
}

static int launch_mma(const void* x, const void* q, const void* s, void* out,
                      int m, int k, int n, int blocks, cudaStream_t st) {
  const size_t smem = (size_t)8 * ((k + 63) / 64 * 64 + 8) * sizeof(bf16);
  const cudaError_t e = allow_smem(qmv_nk_mma<8>, smem);
  if (e != cudaSuccess) return (int)e;
  qmv_nk_mma<8><<<blocks, kThreads, smem, st>>>(
      (const bf16*)x, (const signed char*)q, (const float*)s, (bf16*)out, m,
      k, n);
  return (int)cudaGetLastError();
}

// x [m, k] (kind 0 = fp32, 1 = bf16; 16-byte aligned), q [n, k] int8
// (16-byte aligned), s [n] fp32, out [m, n] of x's type; all contiguous, k
// a multiple of 16. The plan of ops/quant.py `qmv_nk_plan`: `mma` 1 for
// the tensor-core form (bf16 only; `rows` 8), else the fma form with
// `rows` (1, 2, 4 or 8 for fp32 x, 1 for bf16) rows of x a pass; `blocks`
// persistent blocks.
// Returns a cudaError_t.
extern "C" int lvv_int8_matmul_nk(const void* x, const void* q, const void* s,
                                  void* out, int m, int k, int n, int kind,
                                  int mma, int rows, int blocks,
                                  void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || k % 16 || kind < 0 || kind > 1 ||
      blocks <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (mma)
    return kind == 1 && rows == 8
               ? launch_mma(x, q, s, out, m, k, n, blocks, st)
               : (int)cudaErrorInvalidValue;
  if (kind == 1)                 // bf16 x takes the fma form at one row
    return rows == 1 ? launch_fma<bf16, 1>(x, q, s, out, m, k, n, blocks, st)
                     : (int)cudaErrorInvalidValue;
#define LVV_FMA(MT) \
  if (rows == MT)   \
    return launch_fma<float, MT>(x, q, s, out, m, k, n, blocks, st);
  LVV_FMA(1) LVV_FMA(2) LVV_FMA(4) LVV_FMA(8)
#undef LVV_FMA
  return (int)cudaErrorInvalidValue;
}
