// Weight-only int8 matmul for the port's serving decode:
//   out[m, n] = T( sum_k x[m, k] * q[k, n] * s[n] )
// x [M, K] bf16 or fp32, q [K, N] int8 as stored (per-column scales s [N]
// fp32), fp32 accumulation, the scale applied once on the output side and
// one rounding to x's type.
//
// Replaces lvv_tpu/ops/quant.py::_qmv_kernel (reached through
// quantized_matmul), TPU kernel K-j. On the serving path it is every int8
// product of the packed decode at M = 1: qkv 896 -> 1152, o 896 -> 896,
// gate|up 896 -> 9728 and down 4864 -> 896, 4 per layer and step (where the
// JAX decode lets XLA fuse the int8 -> bf16 convert into its dots).
//
// What bounds it on the H100: at decode batch sizes it does 2·M·K·N
// operations on K·N weight bytes, far below ~295 operations per byte:
// device memory bounds it, and the only gain is to read the weight once, as
// int8, which this kernel does (the dequantize happens in registers).
//
// Design: a block owns 32 output columns and all of K. Its 1,024 threads
// are 8 column groups of 4 columns x 128 lanes over K: each thread reads 4
// consecutive int8 weights of one row (8 threads cover the row's 32-byte
// sector) and the matching x values (L1-resident broadcasts), for up to
// kMT rows of x at once. The 128 partial sums per column are reduced with
// two warp shuffles and then in shared memory. Rows of x beyond kMT take
// grid.y. A small N gives few blocks (28 at N = 896): split-K across blocks
// is later tuning.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kCols = 32;      // output columns per block
constexpr int kThreads = 1024;
constexpr int kLanesK = kThreads / 8;  // lanes over K
constexpr int kMT = 4;         // rows of x per block

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <class T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <class T>
__global__ void __launch_bounds__(kThreads)
qmv_kn_kernel(const T* __restrict__ x, const signed char* __restrict__ q,
              const float* __restrict__ s, T* __restrict__ out, int m, int k,
              int n) {
  __shared__ float red[kThreads / 32][kMT][kCols];  // per warp partials
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cg = tid & 7, kl = tid >> 3;
  const int col = blockIdx.x * kCols + cg * 4;
  const int m0 = blockIdx.y * kMT;
  const int rows = min(kMT, m - m0);
  float acc[kMT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  if (col < n) {
#pragma unroll 4
    for (int kk = kl; kk < k; kk += kLanesK) {
      const char4 w = __ldg(reinterpret_cast<const char4*>(
          q + (long long)kk * n + col));
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        if (i < rows) {
          const float xv = to_f(x[(long long)(m0 + i) * k + kk]);
          acc[i][0] += xv * (float)w.x;
          acc[i][1] += xv * (float)w.y;
          acc[i][2] += xv * (float)w.z;
          acc[i][3] += xv * (float)w.w;
        }
      }
    }
  }
  // lanes 8 and 16 apart share a column group: fold the warp's 4 K lanes
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float v = acc[i][j];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (lane < 8) red[warp][i][cg * 4 + j] = v;
    }
  __syncthreads();
  if (tid < kMT * kCols) {
    const int i = tid / kCols, c = tid % kCols;
    const int oc = blockIdx.x * kCols + c;
    if (i < rows && oc < n) {
      float v = 0.f;
#pragma unroll 8
      for (int w = 0; w < kThreads / 32; ++w) v += red[w][i][c];
      out[(long long)(m0 + i) * n + oc] = from_f<T>(v * s[oc]);
    }
  }
}

// x [m, k] (kind 0 = fp32, 1 = bf16), q [k, n] int8, s [n] fp32, out [m, n]
// of x's type; all contiguous, n a multiple of 4. Returns a cudaError_t.
extern "C" int lvv_int8_matmul(const void* x, const void* q, const void* s,
                               void* out, int m, int k, int n, int kind,
                               void* stream) {
  if (m <= 0 || k <= 0 || n <= 0 || n % 4) return (int)cudaErrorInvalidValue;
  const dim3 grid((n + kCols - 1) / kCols, (m + kMT - 1) / kMT);
  cudaStream_t st = (cudaStream_t)stream;
  if (kind == 0)
    qmv_kn_kernel<float><<<grid, kThreads, 0, st>>>(
        (const float*)x, (const signed char*)q, (const float*)s, (float*)out,
        m, k, n);
  else if (kind == 1)
    qmv_kn_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        (const __nv_bfloat16*)x, (const signed char*)q, (const float*)s,
        (__nv_bfloat16*)out, m, k, n);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
