// W8A8 fused pre-LN transformer MLP for the port (bf16 in and out):
//   y  = LN(x) (fp32), y8 = int8(y / sy) with one scale sy per token row
//   for each hidden chunk j of width BH:
//     z  = (y8 @ W1q[:, j]) (int32) * sy * s1[j] + b1[j]       (fp32)
//     h  = act(bf16(z)) rounded to bf16, then fp32
//     h8 = int8(h / sh) with one scale sh per token row OF THIS CHUNK
//     acc += (h8 @ W2q[j, :]) (int32) * sh * s2
//   out = bf16(x + acc + b2)
// act = tanh-GELU (SAM) or QuickGELU (CLIP). Quantization divides, rounds
// half to even and clips to +-127; scales are max|row| / 127 floored at
// 1e-8. Products accumulate in int32 (exact: at most 4096 * 127^2 < 2^31).
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
// tensor-core rate bounds it.
//
// Design against the TPU version. The TPU holds a [block_t, block_h] tile
// of h in VMEM and quantizes it per row there. The scale of h belongs to a
// whole chunk of up to 3072 columns, so a block here owns 16 token rows and
// keeps the chunk's h in shared memory (bf16, exact: h is a bf16 value),
// takes the row maxima, quantizes it into an int8 copy, and only then runs
// the second product. Both products are mma.sync m16n8k32 s8 x s8 -> s32
// (wgmma comes later). The weights arrive transposed ([H, C] and [C, H],
// made by the wrapper from the per-call quantization), so each B fragment
// is one 32-bit load per lane straight from device memory / L2: nothing of
// the weights is staged in shared memory, and every block re-reads them
// from L2. 16 rows a block keep the h chunk within 227 KB at BH = 4096 but
// leave one block per SM; CLIP's 1,542 tokens make 97 blocks for 132 SMs.
#include "common.cuh"
#include "int8.cuh"

constexpr int kRows = 16;       // token rows per block (one m16 tile)
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

template <int ACT>
__device__ __forceinline__ float act_fn(float z) {
  if (ACT == 0) {  // tanh GELU (jax.nn.gelu's default approximation)
    const float k0 = 0.7978845608028654f;
    return 0.5f * z * (1.f + tanhf(k0 * (z + 0.044715f * z * z * z)));
  }
  return z / (1.f + expf(-1.702f * z));  // QuickGELU
}

// NT = C / 64: output n8 tiles each warp owns in the second product.
template <int NT, int ACT>
__global__ void __launch_bounds__(kThreads, 1)
ln_mlp_q8_kernel(const bf16* __restrict__ x, const bf16* __restrict__ ls,
                 const bf16* __restrict__ lb,
                 const signed char* __restrict__ w1t,  // [H, C]
                 const float* __restrict__ s1, const bf16* __restrict__ b1,
                 const signed char* __restrict__ w2t,  // [C, H]
                 const float* __restrict__ s2, const bf16* __restrict__ b2,
                 bf16* __restrict__ out, int n, int h, int bh, float eps) {
  constexpr int C = NT * 64;
  constexpr int PER_LANE = C / 32;
  const int LDY = C + 16, LDH8 = bh + 16, LDH = bh + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sy_s = reinterpret_cast<float*>(smem_raw);        // [16]
  float* sh_s = sy_s + kRows;                               // [16]
  float* red_s = sh_s + kRows;                              // [8][16]
  signed char* y8_s = reinterpret_cast<signed char*>(red_s + kWarps * kRows);
  signed char* h8_s = y8_s + kRows * LDY;                   // [16][bh + 16]
  bf16* h_s = reinterpret_cast<bf16*>(h8_s + kRows * LDH8); // [16][bh + 8]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * kRows;

  // LayerNorm (fp32) and per-row int8 quantization, one warp per 2 rows;
  // rows past n are zeros (their LN is the bias: finite, never stored).
  for (int r = warp; r < kRows; r += kWarps) {
    const bool live = row0 + r < n;
    float v[PER_LANE];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) {
      v[i] = live ? bf(x[(long long)(row0 + r) * C + lane + 32 * i]) : 0.f;
      sum += v[i];
    }
    const float mean = __fdiv_rn(warp_sum(sum), (float)C);
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) {
      const float d = v[i] - mean;
      sq += d * d;
    }
    const float rstd = rsqrtf(__fdiv_rn(warp_sum(sq), (float)C) + eps);
    float amax = 0.f;
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) {
      const int c = lane + 32 * i;
      v[i] = __fadd_rn(__fmul_rn(__fmul_rn(v[i] - mean, rstd), bf(ls[c])),
                       bf(lb[c]));
      amax = fmaxf(amax, fabsf(v[i]));
    }
    const float sy = row_scale(warp_max(amax));
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i)
      y8_s[r * LDY + lane + 32 * i] = quant(v[i], sy);
    if (lane == 0) sy_s[r] = sy;
  }
  __syncthreads();

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int hc = 0; hc < h; hc += bh) {
    // first product over this chunk: warp w takes n8 tiles w, w + 8, ...
    float m0 = 0.f, m1 = 0.f;  // |h| maxima of rows g and g + 8
    for (int tile = warp; tile < bh / 8; tile += kWarps) {
      const int col = hc + tile * 8;  // first hidden column of the tile
      int z[4] = {0, 0, 0, 0};
#pragma unroll 4
      for (int k0 = 0; k0 < C; k0 += 32) {
        uint32_t a[4], b[2];
        load_a8(a, y8_s + k0, LDY, lane);
        load_b8(b, w1t + (long long)col * C + k0, C, lane);
        mma_s8(z, a, b);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = g + (i >> 1) * 8, cc = col + 2 * t + (i & 1);
        const float zf = __fadd_rn(
            __fmul_rn(__fmul_rn(__int2float_rn(z[i]), sy_s[r]), s1[cc]),
            bf(b1[cc]));
        const bf16 hv = __float2bfloat16(act_fn<ACT>(round_bf16(zf)));
        h_s[r * LDH + cc - hc] = hv;
        if (i < 2) m0 = fmaxf(m0, fabsf(bf(hv)));
        else m1 = fmaxf(m1, fabsf(bf(hv)));
      }
    }
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 1));
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 2));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 1));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 2));
    if (t == 0) {
      red_s[warp * kRows + g] = m0;
      red_s[warp * kRows + g + 8] = m1;
    }
    __syncthreads();
    if (tid < kRows) {
      float m = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) m = fmaxf(m, red_s[w * kRows + tid]);
      sh_s[tid] = row_scale(m);
    }
    __syncthreads();
    for (int i = tid; i < kRows * bh; i += kThreads) {
      const int r = i / bh, c = i % bh;
      h8_s[r * LDH8 + c] = quant(bf(h_s[r * LDH + c]), sh_s[r]);
    }
    __syncthreads();

    // second product: acc[:, warp's tiles] += (h8 @ W2q[chunk, :]) * sh * s2
    int z2[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) z2[j][0] = z2[j][1] = z2[j][2] = z2[j][3] = 0;
    for (int k0 = 0; k0 < bh; k0 += 32) {
      uint32_t a[4];
      load_a8(a, h8_s + k0, LDH8, lane);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t b[2];
        load_b8(b, w2t + (long long)((warp + kWarps * j) * 8) * h + hc + k0,
                h, lane);
        mma_s8(z2[j], a, b);
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = g + (i >> 1) * 8;
        const int cc = (warp + kWarps * j) * 8 + 2 * t + (i & 1);
        acc[j][i] = __fadd_rn(acc[j][i], __fmul_rn(
            __fmul_rn(__int2float_rn(z2[j][i]), sh_s[r]), s2[cc]));
      }
    }
    // the next chunk's row maxima overwrite red_s / sh_s only after the
    // __syncthreads that follows its first product
  }

  // out = x + acc + b2
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + g + (i >> 1) * 8;
      const int cc = (warp + kWarps * j) * 8 + 2 * t + (i & 1);
      if (r < n) {
        const long long off = (long long)r * C + cc;
        out[off] = __float2bfloat16(
            __fadd_rn(__fadd_rn(bf(x[off]), acc[j][i]), bf(b2[cc])));
      }
    }
  }
}

static size_t smem_bytes(int c, int bh) {
  return (size_t)(2 * kRows + kWarps * kRows) * sizeof(float) +
         (size_t)kRows * (c + 16) + (size_t)kRows * (bh + 16) +
         (size_t)kRows * (bh + 8) * sizeof(bf16);
}

template <int NT, int ACT>
static int launch(const void* x, const void* ls, const void* lb,
                  const void* w1t, const void* s1, const void* b1,
                  const void* w2t, const void* s2, const void* b2, void* out,
                  int n, int h, int bh, float eps, cudaStream_t stream) {
  const size_t smem = smem_bytes(NT * 64, bh);
  cudaError_t e = allow_smem(ln_mlp_q8_kernel<NT, ACT>, smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (n + kRows - 1) / kRows;
  ln_mlp_q8_kernel<NT, ACT><<<blocks, kThreads, smem, stream>>>(
      (const bf16*)x, (const bf16*)ls, (const bf16*)lb,
      (const signed char*)w1t, (const float*)s1, (const bf16*)b1,
      (const signed char*)w2t, (const float*)s2, (const bf16*)b2,
      (bf16*)out, n, h, bh, eps);
  return (int)cudaGetLastError();
}

template <int ACT>
static int dispatch(int c, const void* x, const void* ls, const void* lb,
                    const void* w1t, const void* s1, const void* b1,
                    const void* w2t, const void* s2, const void* b2,
                    void* out, int n, int h, int bh, float eps,
                    cudaStream_t st) {
#define LVV_CASE(NT)                                                     \
  case NT * 64:                                                          \
    return launch<NT, ACT>(x, ls, lb, w1t, s1, b1, w2t, s2, b2, out, n, \
                           h, bh, eps, st);
  switch (c) {
    LVV_CASE(2) LVV_CASE(4) LVV_CASE(6) LVV_CASE(8)
    LVV_CASE(10) LVV_CASE(12) LVV_CASE(14) LVV_CASE(16)
  }
#undef LVV_CASE
  return (int)cudaErrorInvalidValue;
}

// x / out [n, c] bf16; ls / lb / b2 [c] bf16; w1t [h, c] and w2t [c, h]
// int8 (the per-column quantized W1 [c, h] and W2 [h, c], transposed);
// s1 [h], s2 [c] fp32; b1 [h] bf16; all contiguous. c a multiple of 128 up
// to 1024; bh (the chunk that shares a row scale of h) a multiple of 64 up
// to 4096 that divides h. act 0 = tanh GELU, 1 = QuickGELU. Returns a
// cudaError_t (0 on success).
extern "C" int lvv_ln_mlp_residual_q8(const void* x, const void* ls,
                                      const void* lb, const void* w1t,
                                      const void* s1, const void* b1,
                                      const void* w2t, const void* s2,
                                      const void* b2, void* out, int n, int c,
                                      int h, int bh, float eps, int act,
                                      void* stream) {
  if (n <= 0 || bh <= 0 || bh % 64 || bh > 4096 || h % bh)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (act == 0)
    return dispatch<0>(c, x, ls, lb, w1t, s1, b1, w2t, s2, b2, out, n, h, bh,
                       eps, st);
  if (act == 1)
    return dispatch<1>(c, x, ls, lb, w1t, s1, b1, w2t, s2, b2, out, n, h, bh,
                       eps, st);
  return (int)cudaErrorInvalidValue;
}
