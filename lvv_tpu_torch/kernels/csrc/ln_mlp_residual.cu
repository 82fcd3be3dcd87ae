// Fused pre-LN transformer MLP for the port (bf16 in and out):
//   out = x + act(LN(x) @ W1 + b1) @ W2 + b2
// with the LayerNorm and both accumulations in fp32, act = tanh-GELU (SAM)
// or x / (1 + exp(-1.702 x)) (CLIP's QuickGELU).
//
// Replaces lvv_tpu/ops/fused_mlp.py::_kernel (reached through _fused_fwd and
// ln_mlp_residual), TPU kernel K-b: the MLP half of the 12 SAM blocks
// ([24576, 768] x [768, 3072]) and the 24 CLIP layers ([1542, 1024] x
// [1024, 4096]) on the main path.
//
// What bounds it on the H100: 4·N·C·H operations against reading x and the
// weights once and writing out once: far above ~295 operations per byte, so
// the bf16 tensor-core rate bounds it. The unfused form also moves the
// [N, H] hidden activation through device memory twice; here it lives only
// in shared memory.
//
// Design against the TPU version: the TPU keeps a [block_t, C] fp32
// accumulator in VMEM, which at C = 1024 and 64 tokens (256 KB) exceeds a
// block's 227 KB of shared memory. Here a block owns 32 token rows and the
// [32, C] accumulator lives in registers, split by output columns across
// the 8 warps (C / 8 columns per warp, at most 128 floats per thread). As on
// the TPU, the weights stream in 64-wide hidden chunks: per chunk the block
// computes z = LN(x) @ W1[:, chunk] (one 16x16 tile per warp), applies bias
// and activation into a bf16 shared tile, and accumulates that tile times
// W2[chunk, :]. Weight slabs are staged through shared memory with 16-byte
// loads and shared by all 8 warps; MMAs are mma.sync m16n8k16 (no
// wgmma/TMA/pipelining yet). Each block re-reads the weights from L2, so
// small token tiles cost L2 bandwidth: a later version should grow the tile.
// CLIP's 1,542 tokens make only 49 blocks for 132 SMs, so that call
// under-fills the card.
#include "common.cuh"

constexpr int kBT = 32;      // token rows per block
constexpr int kBH = 64;      // hidden chunk
constexpr int kKT = 64;      // W1 rows staged per step
constexpr int kW2R = 32;     // W2 rows staged per step
constexpr int kThreads = 256;
constexpr int kPad = 8;

template <int ACT>
__device__ __forceinline__ float act_fn(float z) {
  if (ACT == 0) {  // tanh GELU (jax.nn.gelu's default approximation)
    const float k0 = 0.7978845608028654f;
    return 0.5f * z * (1.f + tanhf(k0 * (z + 0.044715f * z * z * z)));
  }
  return z / (1.f + __expf(-1.702f * z));  // QuickGELU
}

// NT = C / 64: the n8 tiles each warp owns in the second product.
template <int NT, int ACT>
__global__ void __launch_bounds__(kThreads, 1)
ln_mlp_kernel(const bf16* __restrict__ x, const bf16* __restrict__ ls,
              const bf16* __restrict__ lb, const bf16* __restrict__ w1,
              const bf16* __restrict__ b1, const bf16* __restrict__ w2,
              const bf16* __restrict__ b2, bf16* __restrict__ out, int n,
              int h, float eps) {
  constexpr int C = NT * 64;
  constexpr int LDY = C + kPad, LDW1 = kBH + kPad, LDH = kBH + kPad,
                LDW2 = C + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* y_s = reinterpret_cast<bf16*>(smem_raw);  // [kBT][LDY]  LN(x)
  bf16* w1_s = y_s + kBT * LDY;                    // [kKT][LDW1] W1 slab
  bf16* h_s = w1_s + kKT * LDW1;                   // [kBT][LDH]  act chunk
  bf16* w2_s = h_s + kBT * LDH;                    // [kW2R][LDW2] W2 slab

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * kBT;

  // LayerNorm in fp32, one warp per row; rows past n are zeros (finite LN).
  for (int r = warp; r < kBT; r += kThreads / 32) {
    bf16* yr = y_s + r * LDY;
    const bool live = row0 + r < n;
    float sum = 0.f;
    for (int c0 = lane * 8; c0 < C; c0 += 256) {
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (live)
        v = *reinterpret_cast<const uint4*>(x + (long long)(row0 + r) * C + c0);
      *reinterpret_cast<uint4*>(yr + c0) = v;
      const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
      for (int i = 0; i < 8; ++i) sum += bf(e[i]);
    }
    const float mean = warp_sum(sum) / C;
    float sq = 0.f;
    for (int c0 = lane * 8; c0 < C; c0 += 256) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float d = bf(yr[c0 + i]) - mean;
        sq += d * d;
      }
    }
    const float rstd = rsqrtf(warp_sum(sq) / C + eps);
    for (int c0 = lane * 8; c0 < C; c0 += 256) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int c = c0 + i;
        yr[c] = __float2bfloat16((bf(yr[c]) - mean) * rstd * bf(ls[c]) + bf(lb[c]));
      }
    }
  }
  __syncthreads();

  float acc[2][NT][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[m][j][0] = acc[m][j][1] = acc[m][j][2] = acc[m][j][3] = 0.f;

  const int m1 = warp >> 2;          // first product: row tile of this warp
  const int n1 = (warp & 3) * 16;    // and its 16 columns of the chunk
  const int ncol = warp * (C / 8);   // second product: this warp's columns

  for (int hc = 0; hc < h; hc += kBH) {
    // z = LN(x) @ W1[:, hc : hc + kBH]
    float z[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    for (int k0 = 0; k0 < C; k0 += kKT) {
      for (int i = tid; i < kKT * kBH / 8; i += kThreads) {
        const int r = i / (kBH / 8), cc = (i % (kBH / 8)) * 8;
        *reinterpret_cast<uint4*>(w1_s + r * LDW1 + cc) =
            *reinterpret_cast<const uint4*>(w1 + (long long)(k0 + r) * h + hc + cc);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kKT; kk += 16) {
        uint32_t a[4];
        load_a(a, y_s + m1 * 16 * LDY + k0 + kk, LDY, lane);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          uint32_t b[2];
          load_b_kn(b, w1_s + kk * LDW1 + n1 + j * 8, LDW1, lane);
          mma16816(z[j], a, b);
        }
      }
      __syncthreads();
    }
    // bias, round to bf16 (the TPU kernel's storage cast), activation
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = n1 + j * 8 + 2 * t;
      const float bb0 = bf(b1[hc + col]), bb1 = bf(b1[hc + col + 1]);
      const int r = m1 * 16 + g;
      *reinterpret_cast<uint32_t*>(h_s + r * LDH + col) =
          pack_f32(act_fn<ACT>(round_bf16(z[j][0] + bb0)),
                   act_fn<ACT>(round_bf16(z[j][1] + bb1)));
      *reinterpret_cast<uint32_t*>(h_s + (r + 8) * LDH + col) =
          pack_f32(act_fn<ACT>(round_bf16(z[j][2] + bb0)),
                   act_fn<ACT>(round_bf16(z[j][3] + bb1)));
    }
    __syncthreads();
    // acc += act_chunk @ W2[hc : hc + kBH, :]
    for (int r0 = 0; r0 < kBH; r0 += kW2R) {
      for (int i = tid; i < kW2R * C / 8; i += kThreads) {
        const int r = i / (C / 8), cc = (i % (C / 8)) * 8;
        *reinterpret_cast<uint4*>(w2_s + r * LDW2 + cc) =
            *reinterpret_cast<const uint4*>(w2 + (long long)(hc + r0 + r) * C + cc);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kW2R; kk += 16) {
        uint32_t a0[4], a1[4];
        load_a(a0, h_s + r0 + kk, LDH, lane);
        load_a(a1, h_s + 16 * LDH + r0 + kk, LDH, lane);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          uint32_t b[2];
          load_b_kn(b, w2_s + kk * LDW2 + ncol + j * 8, LDW2, lane);
          mma16816(acc[0][j], a0, b);
          mma16816(acc[1][j], a1, b);
        }
      }
      __syncthreads();
    }
  }

  // out = x + acc + b2, straight from the accumulator registers
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = ncol + j * 8 + 2 * t;
      const float bb0 = bf(b2[col]), bb1 = bf(b2[col + 1]);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = row0 + m * 16 + g + half * 8;
        if (r < n) {
          const long long off = (long long)r * C + col;
          const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(x + off);
          *reinterpret_cast<uint32_t*>(out + off) =
              pack_f32(__low2float(xv) + acc[m][j][2 * half] + bb0,
                       __high2float(xv) + acc[m][j][2 * half + 1] + bb1);
        }
      }
    }
  }
}

template <int NT, int ACT>
static int launch(const void* x, const void* ls, const void* lb,
                  const void* w1, const void* b1, const void* w2,
                  const void* b2, void* out, int n, int h, float eps,
                  cudaStream_t stream) {
  constexpr int C = NT * 64;
  const size_t smem = (size_t)(kBT * (C + kPad) + kKT * (kBH + kPad) +
                               kBT * (kBH + kPad) + kW2R * (C + kPad)) *
                      sizeof(bf16);
  cudaError_t e = allow_smem(ln_mlp_kernel<NT, ACT>, smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (n + kBT - 1) / kBT;
  ln_mlp_kernel<NT, ACT><<<blocks, kThreads, smem, stream>>>(
      (const bf16*)x, (const bf16*)ls, (const bf16*)lb, (const bf16*)w1,
      (const bf16*)b1, (const bf16*)w2, (const bf16*)b2, (bf16*)out, n, h,
      eps);
  return (int)cudaGetLastError();
}

template <int ACT>
static int dispatch(int c, const void* x, const void* ls, const void* lb,
                    const void* w1, const void* b1, const void* w2,
                    const void* b2, void* out, int n, int h, float eps,
                    cudaStream_t st) {
#define LVV_CASE(NT)                                                   \
  case NT * 64:                                                        \
    return launch<NT, ACT>(x, ls, lb, w1, b1, w2, b2, out, n, h, eps, st);
  switch (c) {
    LVV_CASE(2) LVV_CASE(4) LVV_CASE(6) LVV_CASE(8)
    LVV_CASE(10) LVV_CASE(12) LVV_CASE(14) LVV_CASE(16)
  }
#undef LVV_CASE
  return (int)cudaErrorInvalidValue;
}

// x / out [n, c], ls / lb / b2 [c], w1 [c, h], b1 [h], w2 [h, c], all
// contiguous bf16; c a multiple of 128 up to 1024, h a multiple of 64.
// act 0 = tanh GELU, 1 = QuickGELU. Returns a cudaError_t (0 on success).
extern "C" int lvv_ln_mlp_residual(const void* x, const void* ls,
                                   const void* lb, const void* w1,
                                   const void* b1, const void* w2,
                                   const void* b2, void* out, int n, int c,
                                   int h, float eps, int act, void* stream) {
  if (h % kBH != 0 || n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (act == 0) return dispatch<0>(c, x, ls, lb, w1, b1, w2, b2, out, n, h, eps, st);
  if (act == 1) return dispatch<1>(c, x, ls, lb, w1, b1, w2, b2, out, n, h, eps, st);
  return (int)cudaErrorInvalidValue;
}
