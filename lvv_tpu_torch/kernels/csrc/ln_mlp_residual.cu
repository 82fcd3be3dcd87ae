// Fused pre-LN transformer MLP for the port (bf16 in and out; the LN's
// scale and bias bf16 or fp32):
//   out = x + act(LN(x) @ W1 + b1) @ W2 + b2
// with the LayerNorm and both accumulations in fp32, act = tanh-GELU (SAM)
// or x / (1 + exp(-1.702 x)) (CLIP's QuickGELU).
//
// Replaces lvv_tpu/ops/fused_mlp.py::_kernel (reached through _fused_fwd and
// ln_mlp_residual), TPU kernel K-b: the MLP half of the 12 SAM blocks
// ([24576, 768] x [768, 3072] at 1024²) and the 24 CLIP layers ([1542,
// 1024] x [1024, 4096]) on the float path.
//
// What bounds it on the H100: 4·N·C·H operations against reading x and the
// weights once and writing out once, far above ~295 operations per byte:
// the bf16 tensor-core rate, which only wgmma reaches.
//
// Design. The TPU kernel keeps a [block_t, C] fp32 accumulator in VMEM
// while it streams hidden chunks. A [128, C] fp32 accumulator does not fit
// a block's registers at C = 768 / 1024, and a block of fewer token rows
// re-reads both weight matrices from L2 for every few rows (~7 GB a SAM
// call at 32 rows). So the hidden activation goes through device memory,
// as bf16: it is a bf16 value in the TPU kernel too, so storing it changes
// nothing of the function. Three launches a call:
//   1. mlp_ln_bf16: y = bf16(LN(x)) [N, C], one warp a row;
//   2. mlp_gemm_sm90 (gemm_sm90.cuh) y · W1, epilogue h = bf16(act(bf16(
//      acc + b1))) [N, H];
//   3. mlp_gemm_sm90 h · W2, epilogue out = bf16(x + (acc + b2)).
// Each GEMM takes [128, 128] output tiles (two consumer warpgroups) on
// persistent blocks, two an SM, fed by a TMA ring, or [128, 256] tiles one
// block an SM for the second product where that leaves two waves
// (gemm_sm90.cuh says why); W1 and W2 are read as they lie ([C, H], [H,
// C]: MN-major, wgmma's transpose bit). The weights
// are re-read once per 128-row tile, by TMA in bulk. h costs 2·N·H·2 bytes
// more (151 MB written and read a SAM call), not counted in the bound.
// CLIP's 13 token tiles give 416 and 104 output tiles; a split of H across
// blocks would not raise the second product's 104 above the 132 SMs' one
// wave by enough to pay for its fp32 partials, so there is none (the
// wrapper's `mlp_plan`).
#include "gemm_sm90.cuh"

using namespace sm90;

// y = bf16(LN(x)), one warp per row; each lane holds NI groups of 4
// columns (C = 128 NI). ls / lb of type P: bf16, or fp32 as the model
// keeps them.
template <int NI, typename P>
__global__ void __launch_bounds__(256)
mlp_ln_bf16(const bf16* __restrict__ x, const P* __restrict__ ls,
            const P* __restrict__ lb, bf16* __restrict__ y, int n,
            float eps) {
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
  const float mean = warp_sum(sum) / C;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float d = v[i][k] - mean;
      sq += d * d;
    }
  const float rstd = rsqrtf(warp_sum(sq) / C + eps);
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int c = 128 * i + 4 * lane;
    float o[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      o[k] = (v[i][k] - mean) * rstd * param_f(ls[c + k]) +
             param_f(lb[c + k]);
    *reinterpret_cast<uint2*>(y + (long long)row * C + c) =
        make_uint2(pack_f32(o[0], o[1]), pack_f32(o[2], o[3]));
  }
}

// First product's epilogue: h [m, n] = bf16(act(bf16(acc + b1)))
template <int ACT>
struct EpiAct {
  const bf16* b1;
  bf16* h;
  int m, n;
  template <int BN>
  __device__ __forceinline__ void run(const float (&acc)[BN / 2], int r0,
                                      int n0, int) const {
    const int t = threadIdx.x & 3;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * t;
      if (col >= n) break;              // n is a multiple of 64
      const float2 bb = load_bf2(b1 + col);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = r0 + 8 * half;
        if (r < m)
          *reinterpret_cast<uint32_t*>(h + (long long)r * n + col) = pack_f32(
              mlp_act<ACT>(round_bf16(acc[4 * j + 2 * half] + bb.x)),
              mlp_act<ACT>(round_bf16(acc[4 * j + 2 * half + 1] + bb.y)));
      }
    }
  }
};

// Second product's epilogue: out [m, n] = bf16(x + (acc + b2))
struct EpiResidual {
  const bf16* x;
  const bf16* b2;
  bf16* out;
  int m, n;
  template <int BN>
  __device__ __forceinline__ void run(const float (&acc)[BN / 2], int r0,
                                      int n0, int) const {
    const int t = threadIdx.x & 3;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * t;
      if (col >= n) break;
      const float2 bb = load_bf2(b2 + col);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = r0 + 8 * half;
        if (r < m) {
          const long long off = (long long)r * n + col;
          const float2 xv = load_bf2(x + off);
          *reinterpret_cast<uint32_t*>(out + off) =
              pack_f32(xv.x + (acc[4 * j + 2 * half] + bb.x),
                       xv.y + (acc[4 * j + 2 * half + 1] + bb.y));
        }
      }
    }
  }
};

template <int NI>
static int launch_ln(const void* x, const void* ls, const void* lb, void* y,
                     int n, float eps, int pfp32, cudaStream_t st) {
  if (pfp32)
    mlp_ln_bf16<NI, float><<<(n + 7) / 8, 256, 0, st>>>(
        (const bf16*)x, (const float*)ls, (const float*)lb, (bf16*)y, n, eps);
  else
    mlp_ln_bf16<NI, bf16><<<(n + 7) / 8, 256, 0, st>>>(
        (const bf16*)x, (const bf16*)ls, (const bf16*)lb, (bf16*)y, n, eps);
  return (int)cudaGetLastError();
}

// x / out [n, c], b2 [c], w1 [c, h], b1 [h], w2 [h, c], all contiguous
// bf16, 16-byte aligned; ls / lb [c] bf16 (pfp32 = 0) or fp32 (pfp32 = 1);
// y [n, c] and hb [n, h] bf16 scratch.
// c a multiple of 128 up to 1024, h a multiple of 64. act 0 = tanh GELU,
// 1 = QuickGELU; bn2 the second product's tile width, 128 or 256. Returns
// a cudaError_t (0 on success).
extern "C" int lvv_ln_mlp_residual(const void* x, const void* ls,
                                   const void* lb, const void* w1,
                                   const void* b1, const void* w2,
                                   const void* b2, void* out, void* y,
                                   void* hb, int n, int c, int h, float eps,
                                   int act, int bn2, int pfp32,
                                   void* stream) {
  if (n <= 0 || c % 128 || c > 1024 || h <= 0 || h % 64 || act < 0 ||
      act > 1 || (bn2 != 128 && bn2 != 256))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int e = (int)cudaErrorInvalidValue;
  switch (c / 128) {
#define LVV_LN(NI) \
  case NI:         \
    e = launch_ln<NI>(x, ls, lb, y, n, eps, pfp32, st); \
    break;
    LVV_LN(1) LVV_LN(2) LVV_LN(3) LVV_LN(4)
    LVV_LN(5) LVV_LN(6) LVV_LN(7) LVV_LN(8)
#undef LVV_LN
  }
  if (e) return e;
  e = act == 0 ? gemm_launch<OpBf16, 128>(
                     y, c, w1, h, n, h, c, 1,
                     EpiAct<0>{(const bf16*)b1, (bf16*)hb, n, h}, st)
               : gemm_launch<OpBf16, 128>(
                     y, c, w1, h, n, h, c, 1,
                     EpiAct<1>{(const bf16*)b1, (bf16*)hb, n, h}, st);
  if (e) return e;
  const EpiResidual epi{(const bf16*)x, (const bf16*)b2, (bf16*)out, n, c};
  return bn2 == 256
             ? gemm_launch<OpBf16, 256>(hb, h, w2, c, n, c, h, 1, epi, st)
             : gemm_launch<OpBf16, 128>(hb, h, w2, c, n, c, h, 1, epi, st);
}
