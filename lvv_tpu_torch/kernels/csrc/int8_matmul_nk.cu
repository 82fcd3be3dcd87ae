// Weight-only int8 matmul with the weight stored [N, K], for the tied
// unembed of the port's serving decode:
//   out[m, n] = T( sum_k x[m, k] * q[n, k] * s[n] )
// x [M, K] bf16 or fp32, q [N, K] int8 as stored (one scale per row n,
// s [N] fp32), fp32 accumulation, the scale applied once on the output
// side and one rounding to x's type. The table is never transposed.
//
// Replaces lvv_tpu/ops/quant.py::_qmv_nk_kernel (reached through
// quantized_matmul_nk), TPU kernel K-k. On the serving path it is the
// decode's unembed over the [151,940 x 896] table, once per step at M = 1
// (where the JAX decode uses an XLA dot over the int8 table).
//
// What bounds it on the H100: 2·M·N·K operations on N·K weight bytes:
// device memory, 136 MB a call at the path's shape.
//
// Design: one warp per output row n. Each lane reads 16 contiguous weight
// bytes per step (one 512-byte stretch of the row per warp step) and the
// matching 16 x values of each of up to kMT rows of x (L1-resident),
// accumulates in fp32, and the warp reduces with shuffles. 8 warps a block;
// rows of x beyond kMT take grid.y.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kWarps = 8;
constexpr int kMT = 4;

__device__ __forceinline__ void load16(float* dst, const float* src) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(src) + i);
    dst[4 * i] = v.x;
    dst[4 * i + 1] = v.y;
    dst[4 * i + 2] = v.z;
    dst[4 * i + 3] = v.w;
  }
}

__device__ __forceinline__ void load16(float* dst, const __nv_bfloat16* src) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(src) + i);
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(p[j]);
      dst[8 * i + 2 * j] = f.x;
      dst[8 * i + 2 * j + 1] = f.y;
    }
  }
}

template <class T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <class T>
__global__ void __launch_bounds__(kWarps * 32)
qmv_nk_kernel(const T* __restrict__ x, const signed char* __restrict__ q,
              const float* __restrict__ s, T* __restrict__ out, int m, int k,
              int n) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int m0 = blockIdx.y * kMT;
  const int rows = min(kMT, m - m0);
  if (row >= n) return;  // whole warps leave; no block-wide barrier below
  const signed char* wr = q + (long long)row * k;
  float acc[kMT] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = lane * 16; k0 < k; k0 += 32 * 16) {
    const int4 wv = __ldg(reinterpret_cast<const int4*>(wr + k0));
    const signed char* wb = reinterpret_cast<const signed char*>(&wv);
    float wf[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) wf[i] = (float)wb[i];
#pragma unroll
    for (int r = 0; r < kMT; ++r) {
      if (r < rows) {
        float xv[16];
        load16(xv, x + (long long)(m0 + r) * k + k0);
#pragma unroll
        for (int i = 0; i < 16; ++i) acc[r] += xv[i] * wf[i];
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kMT; ++r) {
    float v = acc[r];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0 && r < rows)
      out[(long long)(m0 + r) * n + row] = from_f<T>(v * s[row]);
  }
}

// x [m, k] (kind 0 = fp32, 1 = bf16; rows 16-byte aligned), q [n, k] int8,
// s [n] fp32, out [m, n] of x's type; all contiguous, k a multiple of 16.
// Returns a cudaError_t.
extern "C" int lvv_int8_matmul_nk(const void* x, const void* q, const void* s,
                                  void* out, int m, int k, int n, int kind,
                                  void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || k % 16) return (int)cudaErrorInvalidValue;
  const dim3 grid((n + kWarps - 1) / kWarps, (m + kMT - 1) / kMT);
  cudaStream_t st = (cudaStream_t)stream;
  if (kind == 0)
    qmv_nk_kernel<float><<<grid, kWarps * 32, 0, st>>>(
        (const float*)x, (const signed char*)q, (const float*)s, (float*)out,
        m, k, n);
  else if (kind == 1)
    qmv_nk_kernel<__nv_bfloat16><<<grid, kWarps * 32, 0, st>>>(
        (const __nv_bfloat16*)x, (const signed char*)q, (const float*)s,
        (__nv_bfloat16*)out, m, k, n);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
