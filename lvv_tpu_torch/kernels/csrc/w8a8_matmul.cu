// W8A8 matrix product with the bias, for the port (bf16 or fp32 in and out):
//   sx[m]  = max(max_k |x[m, k]| / 127, 1e-8)       (one scale per row)
//   x8     = clip(round(x / sx), -127, 127)         (division, half to even)
//   out    = ((x8 @ wq) (int32) · sx) · sw + b      (fp32, unfused, this order)
// wq [K, N] / sw [N] is the per-column quantized weight (quantize_weight),
// made by the wrapper on every call, as the JAX package does.
//
// Replaces lvv_tpu/ops/quant.py::_w8a8_kernel (reached through w8a8_matmul),
// TPU kernel K-i: SAM's qkv and proj projections under the "dense" scope of
// LVV_Q8_SCOPE, x [29400 or 24576, 768] @ [768, 2304] or [768, 768].
//
// What bounds it on the H100: 2·M·K·N int8 operations against reading x
// once and writing out once. At SAM's shapes the two are close (qkv of the
// windowed layers: 104 G operations, 0.053 ms at 1,979 TOP/s, against 181
// MB, 0.054 ms at 3.35 TB/s), so both bytes and the int8 rate matter.
//
// Design against the TPU version. The TPU grid re-quantizes an x tile for
// every N tile in VMEM. Here a block owns 128 whole rows of x: it reads them
// once from device memory into registers (two rows a warp at a time, for
// loads in flight), takes the row maxima there and writes an int8 copy to
// shared memory (128 x (K + 16) bytes), and then walks all of N in
// 128-column tiles against that copy, so x is quantized once. Each warp owns
// 32 rows x 64 columns (two m16 x eight n8 tiles, 64 int32 accumulators)
// and runs mma.sync m16n8k32 s8 on fragments read with ldmatrix. The weight
// arrives transposed ([N, K]) and is
// staged in shared memory in [128 n x 128 k] chunks, double-buffered with
// cp.async 16-byte copies, so each chunk crosses from L2 once per block and
// all 8 warps read their B fragments from it (B fragments read straight
// from L2 by every warp measured 1.43 ms on the H100 at the windowed qkv
// shape: L2
// bandwidth, 8 warps fetching the same bytes in 4-byte pieces).
#include "common.cuh"
#include "int8.cuh"

constexpr int kRows = 128;      // x rows per block (16 per warp)
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTileN = 128;     // output columns per step
constexpr int kChunkK = 128;    // k per staged weight chunk
constexpr int kLDW = kChunkK + 16;  // shared row of a weight chunk, bytes
constexpr int kMaxK = 1536;     // x8 of 128 rows fits shared memory

__device__ __forceinline__ float ld_f(const float* p) { return *p; }
__device__ __forceinline__ float ld_f(const bf16* p) { return bf(*p); }

__device__ __forceinline__ void st_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void st_pair(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_f32(a, b);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

template <class T>
__global__ void __launch_bounds__(kThreads)
w8a8_kernel(const T* __restrict__ x, const signed char* __restrict__ wt,
            const float* __restrict__ sw, const float* __restrict__ bias,
            T* __restrict__ out, int m, int k, int n) {
  const int LDX = k + 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sx_s = reinterpret_cast<float*>(smem_raw);                 // [128]
  signed char* w_s = reinterpret_cast<signed char*>(sx_s + kRows);  // [2][128][kLDW]
  signed char* x8_s = w_s + 2 * kTileN * kLDW;                      // [128][k+16]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * kRows;
  const int chunks_k = k / kChunkK, chunks = (n / kTileN) * chunks_k;

  // weight chunk c (n tile c / chunks_k, k chunk c % chunks_k) into buffer
  // c & 1: 128 rows of 64 bytes, two 16-byte copies a thread
  auto fetch = [&](int c) {
    if (c < chunks) {
      const int n0 = (c / chunks_k) * kTileN, k0 = (c % chunks_k) * kChunkK;
      signed char* dst = w_s + (c & 1) * kTileN * kLDW;
      for (int i = threadIdx.x; i < kTileN * kChunkK / 16; i += kThreads) {
        const int r = i / (kChunkK / 16), cc = (i % (kChunkK / 16)) * 16;
        cp_async16(dst + r * kLDW + cc, wt + (long long)(n0 + r) * k + k0 + cc);
      }
    }
    cp_async_commit();
  };
  fetch(0);  // overlaps the quantization below

  // per-row quantization, two rows per warp at a time held in registers
  // (16 bytes a lane and load, all issued at once); rows past m are zeros
  // (scale 1e-8, never stored)
  constexpr int VEC = 16 / sizeof(T);            // elements per 16 bytes
  constexpr int MAXV = kMaxK / (32 * VEC);       // loads a lane at k = kMaxK
  for (int r0 = 2 * warp; r0 < kRows; r0 += 2 * kWarps) {
    uint4 buf[2][MAXV];
    float amax[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bool live = row0 + r0 + h < m;
      const T* xr = x + (long long)(row0 + r0 + h) * k;
#pragma unroll
      for (int i = 0; i < MAXV; ++i) {
        const int c = (i * 32 + lane) * VEC;
        buf[h][i] = make_uint4(0u, 0u, 0u, 0u);
        if (live && c < k) buf[h][i] = *reinterpret_cast<const uint4*>(xr + c);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int i = 0; i < MAXV; ++i) {
        const T* e = reinterpret_cast<const T*>(&buf[h][i]);
#pragma unroll
        for (int v = 0; v < VEC; ++v) amax[h] = fmaxf(amax[h], fabsf(ld_f(e + v)));
      }
      const float sx = row_scale(warp_max(amax[h]));
      signed char* dst = x8_s + (r0 + h) * LDX;
#pragma unroll
      for (int i = 0; i < MAXV; ++i) {
        const int c = (i * 32 + lane) * VEC;
        if (c < k) {
          const T* e = reinterpret_cast<const T*>(&buf[h][i]);
          uint32_t q[VEC / 4];
#pragma unroll
          for (int v = 0; v < VEC; v += 4)
            q[v / 4] = pack_s8(quant(ld_f(e + v), sx), quant(ld_f(e + v + 1), sx),
                               quant(ld_f(e + v + 2), sx), quant(ld_f(e + v + 3), sx));
          if constexpr (VEC == 8)
            *reinterpret_cast<uint2*>(dst + c) = make_uint2(q[0], q[1]);
          else
            *reinterpret_cast<uint32_t*>(dst + c) = q[0];
        }
      }
      if (lane == 0) sx_s[r0 + h] = sx;
    }
  }
  __syncthreads();

  // warp tile: 32 rows (two m16 tiles) x 64 columns (8 n8 tiles) of the
  // block's 128 x 128 output tile
  const int wr = (warp & 3) * 32, wc = (warp >> 2) * 64;
  const float sxr[4] = {sx_s[wr + g], sx_s[wr + g + 8], sx_s[wr + g + 16],
                        sx_s[wr + g + 24]};
  // ldmatrix addressing: lane l points at row l % 8 of matrix l / 8
  const int lr = lane & 7, lm = lane >> 3;
  int z[2][8][4];
  for (int c = 0; c < chunks; ++c) {
    const int kc = c % chunks_k;
    if (kc == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) z[i][j][0] = z[i][j][1] = z[i][j][2] = z[i][j][3] = 0;
    }
    fetch(c + 1);          // the other buffer, freed by the last sync
    cp_async_wait_one();   // chunk c has landed (this thread's copies)
    __syncthreads();       // ... and every thread's
    const signed char* wb = w_s + (c & 1) * kTileN * kLDW;
#pragma unroll
    for (int kk = 0; kk < kChunkK; kk += 32) {
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldsm_x4(a[i], x8_s + (wr + i * 16 + (lm & 1) * 8 + lr) * LDX +
                          kc * kChunkK + kk + (lm >> 1) * 16);
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        uint32_t b[4];   // b0, b1 of n8 tile j, then of tile j + 1
        ldsm_x4(b, wb + (wc + (j + (lm >> 1)) * 8 + lr) * kLDW + kk +
                       (lm & 1) * 16);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_s8(z[i][j], a[i], b);
          mma_s8(z[i][j + 1], a[i], b + 2);
        }
      }
    }
    __syncthreads();       // every warp is done with buffer c & 1
    if (kc == chunks_k - 1) {
      const int n0 = (c / chunks_k) * kTileN + wc;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int cc = n0 + j * 8 + 2 * t;
        const float s0 = sw[cc], s1 = sw[cc + 1];
        const float b0 = bias[cc], b1 = bias[cc + 1];
#pragma unroll
        for (int h = 0; h < 4; ++h) {          // rows g, g + 8, g + 16, g + 24
          const int r = row0 + wr + g + 8 * h;
          const int* zz = z[h >> 1][j] + 2 * (h & 1);
          if (r < m)
            st_pair(out + (long long)r * n + cc,
                    __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(zz[0]), sxr[h]), s0), b0),
                    __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(zz[1]), sxr[h]), s1), b1));
        }
      }
    }
  }
}

template <class T>
static int launch(const void* x, const void* wt, const void* sw,
                  const void* bias, void* out, int m, int k, int n,
                  cudaStream_t stream) {
  const size_t smem = kRows * sizeof(float) + 2 * kTileN * kLDW +
                      (size_t)kRows * (k + 16);
  cudaError_t e = allow_smem(w8a8_kernel<T>, smem);
  if (e != cudaSuccess) return (int)e;
  w8a8_kernel<T><<<(m + kRows - 1) / kRows, kThreads, smem, stream>>>(
      (const T*)x, (const signed char*)wt, (const float*)sw,
      (const float*)bias, (T*)out, m, k, n);
  return (int)cudaGetLastError();
}

// x / out [m, k] / [m, n] (kind 0 fp32, 1 bf16), wt [n, k] int8 (the
// per-column quantized weight, transposed), sw and bias [n] fp32; all
// contiguous. k and n multiples of 128, k at most 1536. Returns a
// cudaError_t (0 on success).
extern "C" int lvv_w8a8_matmul(const void* x, const void* wt, const void* sw,
                               const void* bias, void* out, int m, int k,
                               int n, int kind, void* stream) {
  if (m <= 0 || k % 128 || n % 128 || k > kMaxK || n <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (kind == 0) return launch<float>(x, wt, sw, bias, out, m, k, n, st);
  if (kind == 1) return launch<bf16>(x, wt, sw, bias, out, m, k, n, st);
  return (int)cudaErrorInvalidValue;
}
