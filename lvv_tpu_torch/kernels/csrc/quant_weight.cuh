// The per-call weight quantization that the two W8A8 kernels share,
// ln_mlp_residual_q8.cu (K-f) and w8a8_matmul.cu (K-i):
// quant.quantize_weight of w [k, n] (bf16 or fp32) as PyTorch computes it on
// the card, transposed. s [n] = max(max_r |w[r, col]| · fl(1 / 127), 1e-8)
// (a tensor divided by a Python scalar is a multiply by its reciprocal
// there) and wt [n, k] int8 = quant(w, s) (a true division): K-major, as
// int8 wgmma reads B. Two launches: mlp_wmax writes the column maxima of
// each 128-row slab, pm [ceil(k / 128), n]; mlp_wquant reduces them to s and
// writes [64, 64] tiles of wt through shared memory, 16 bytes a thread.
#pragma once

#include "common.cuh"
#include "int8.cuh"

// Two neighbouring values (8- or 4-byte aligned) of read-only w as floats.
__device__ __forceinline__ float2 load_w2(const bf16* p) {
  return __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(p)));
}
__device__ __forceinline__ float2 load_w2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}

template <class W>
__global__ void __launch_bounds__(256)
mlp_wmax(const W* __restrict__ w, float* __restrict__ pm, int k, int n) {
  __shared__ float red[8][64];
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  const int col = blockIdx.x * 64 + 2 * lane, r0 = blockIdx.y * 128;
  float m0 = 0.f, m1 = 0.f;
#pragma unroll 4
  for (int i = 0; i < 16; ++i) {
    const int r = r0 + warp + 8 * i;
    if (r < k) {
      const float2 v = load_w2(w + (long long)r * n + col);
      m0 = fmaxf(m0, fabsf(v.x));
      m1 = fmaxf(m1, fabsf(v.y));
    }
  }
  red[warp][2 * lane] = m0;
  red[warp][2 * lane + 1] = m1;
  __syncthreads();
  if (threadIdx.x < 64) {
    float m = red[0][threadIdx.x];
#pragma unroll
    for (int i = 1; i < 8; ++i) m = fmaxf(m, red[i][threadIdx.x]);
    pm[(long long)blockIdx.y * n + blockIdx.x * 64 + threadIdx.x] = m;
  }
}

template <class W>
__global__ void __launch_bounds__(256)
mlp_wquant(const W* __restrict__ w, const float* __restrict__ pm,
           signed char* __restrict__ wt, float* __restrict__ s, int k,
           int n) {
  __shared__ float sc[64];
  __shared__ __align__(16) signed char q_s[64][64 + 16];
  const int c0 = blockIdx.x * 64, k0 = blockIdx.y * 64;
  if (threadIdx.x < 64) {
    float m = 0.f;
    for (int p = 0; p < (k + 127) / 128; ++p)
      m = fmaxf(m, pm[(long long)p * n + c0 + threadIdx.x]);
    sc[threadIdx.x] = fmaxf(__fmul_rn(m, 1.f / 127.f), 1e-8f);
    if (blockIdx.y == 0) s[c0 + threadIdx.x] = sc[threadIdx.x];
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = warp + 8 * i;       // row of the tile, k0 + r < k
    const float2 v = load_w2(w + (long long)(k0 + r) * n + c0 + 2 * lane);
    q_s[2 * lane][r] = quant(v.x, sc[2 * lane]);
    q_s[2 * lane + 1][r] = quant(v.y, sc[2 * lane + 1]);
  }
  __syncthreads();
  const int c = threadIdx.x / 4, off = (threadIdx.x % 4) * 16;
  *reinterpret_cast<uint4*>(wt + (long long)(c0 + c) * k + k0 + off) =
      *reinterpret_cast<const uint4*>(&q_s[c][off]);
}

// w [k, n] contiguous -> wt [n, k] int8, s [n] fp32, through pm [ceil(k /
// 128), n] fp32 scratch; k and n multiples of 64. Returns a cudaError_t.
template <class W>
static int quantize_weight_t(const void* w, void* wt, void* s, void* pm,
                             int k, int n, cudaStream_t st) {
  if (k <= 0 || n <= 0 || k % 64 || n % 64) return (int)cudaErrorInvalidValue;
  mlp_wmax<W><<<dim3(n / 64, (k + 127) / 128), 256, 0, st>>>(
      (const W*)w, (float*)pm, k, n);
  mlp_wquant<W><<<dim3(n / 64, k / 64), 256, 0, st>>>(
      (const W*)w, (const float*)pm, (signed char*)wt, (float*)s, k, n);
  return (int)cudaGetLastError();
}
