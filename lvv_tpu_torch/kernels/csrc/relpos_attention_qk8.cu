// SAM global attention with int8 scores, for the port (bf16 out):
//   s[q, k] = (z[q, k] · sq[q]) · sk[k] + qrw[q, k mod gw]     (log2 units)
//   z       = q8_aug[q] · k8_aug[k]   (int32, depth 128)
//   out     = softmax2(s) @ v          (base-2 online softmax, bf16 p@v)
// q_aug = [q·scale·log2e | q·Rh·log2e | 0] and k_aug = [k | onehot(kh) | 0]
// carry the height bias inside the product (depth d + gh <= 128); they are
// quantized per (token, head) by the wrapper's glue (`qk8_operands`), which
// also rounds sq, sk and qrw = q·Rw·log2e to the working dtype, as the JAX
// package stashes them in bf16 lanes.
//
// Replaces lvv_tpu/ops/attention.py::_flash_hpacked_qk8_kernel (reached
// through flash_attention_relpos_hpacked(qk8=True)), TPU kernel K-g: the 4
// global SAM layers under the "qk" scope of LVV_Q8_SCOPE, 6 views of 64x64
// tokens, 12 heads of d = 64.
//
// What bounds it on the H100: 2·S²·128 int8 operations for the scores and
// 2·S²·d bf16 operations for p@v, per (view, head): about 0.31 ms at the
// global shape (0.156 ms each).
//
// Design: the float arm of relpos_attention (common.cuh flash_loop) with
// another score: one block per (64-row q tile, head, view), 4 warps of 16
// rows. The int8 q tile and each int8 k tile sit in shared memory as stored
// (rows of 128 bytes, padded to 144 against bank conflicts); a row-major k8
// tile is already the s8 MMA's B layout for q·kᵀ (4 consecutive depth bytes
// of one key), so each 32-deep step is one 32-bit load per fragment. The
// scales and the q tile's qrw rows are staged in shared memory; v is read
// from the packed qkv as the float arm reads it.
#include "common.cuh"
#include "int8.cuh"

constexpr int kDepth = 128;           // augmented depth (one head's lanes)
constexpr int kLD8 = kDepth + 16;     // shared row of q8 / k8, bytes
constexpr int kD = 64;                // head dim (d + gh <= 128 needs d <= 64)
constexpr int kMaxGw = 128;

__global__ void __launch_bounds__(kAttnThreads)
qk8_kernel(const signed char* __restrict__ q8, const signed char* __restrict__ k8,
           const float* __restrict__ sq, const float* __restrict__ sk,
           const float* __restrict__ qrw, const bf16* __restrict__ qkv,
           bf16* __restrict__ out, int s, int heads, int gw) {
  constexpr int LDV = kD + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qrw_s = reinterpret_cast<float*>(smem_raw);          // [kBQ][gw]
  float* sq_s = qrw_s + kBQ * kMaxGw;                          // [kBQ]
  float* sk_s = sq_s + kBQ;                                    // [kBK]
  signed char* q8_s = reinterpret_cast<signed char*>(sk_s + kBK);  // [kBQ][kLD8]
  signed char* k8_s = q8_s + kBQ * kLD8;                       // [kBK][kLD8]
  bf16* v_s = reinterpret_cast<bf16*>(k8_s + kBK * kLD8);      // [kBK][LDV]

  const int q_start = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int c = heads * kD;
  const long long row = 3LL * c;
  const long long tok0 = (long long)b * s;   // first token of this view

  // rows of 128 int8 of token `tok` (0.. past s are zeros) into dst
  auto load8 = [&](signed char* dst, const signed char* src, int first) {
    for (int i = threadIdx.x; i < kBK * kDepth / 16; i += kAttnThreads) {
      const int r = i / (kDepth / 16), cc = (i % (kDepth / 16)) * 16;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (first + r < s)
        val = *reinterpret_cast<const uint4*>(
            src + ((tok0 + first + r) * heads + h) * kDepth + cc);
      *reinterpret_cast<uint4*>(dst + r * kLD8 + cc) = val;
    }
  };
  load8(q8_s, q8, q_start);
  for (int i = threadIdx.x; i < kBQ; i += kAttnThreads)
    sq_s[i] = q_start + i < s ? sq[(tok0 + q_start + i) * heads + h] : 0.f;
  for (int i = threadIdx.x; i < kBQ * gw; i += kAttnThreads) {
    const int r = i / gw, j = i % gw;
    qrw_s[r * kMaxGw + j] =
        q_start + r < s ? qrw[((tok0 + q_start + r) * heads + h) * gw + j] : 0.f;
  }
  // (flash_loop synchronises before its first read of these)

  const bf16* vb = qkv + tok0 * row + 2 * c + h * kD;
  auto load_kv = [&](int k0) {
    load8(k8_s, k8, k0);
    for (int i = threadIdx.x; i < kBK; i += kAttnThreads)
      sk_s[i] = k0 + i < s ? sk[(tok0 + k0 + i) * heads + h] : 0.f;
    load_rows<kD>(v_s, vb + k0 * row, row, s - k0);
  };

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = lane & 3;
  const int r0 = warp * 16 + (lane >> 2), r1 = r0 + 8;
  auto scores = [&](int k0, float (&sc)[kBK / 8][4]) {
    int z[kBK / 8][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) z[j][0] = z[j][1] = z[j][2] = z[j][3] = 0;
#pragma unroll
    for (int kk = 0; kk < kDepth / 32; ++kk) {
      uint32_t a[4];
      load_a8(a, q8_s + warp * 16 * kLD8 + kk * 32, kLD8, lane);
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        uint32_t bb[2];
        load_b8_s(bb, k8_s + j * 8 * kLD8 + kk * 32, kLD8, lane);
        mma_s8(z[j], a, bb);
      }
    }
    const float sq0 = sq_s[r0], sq1 = sq_s[r1];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int cl = j * 8 + 2 * t + (i & 1);   // column within the tile
        const int r = i < 2 ? r0 : r1;
        const int col = k0 + cl;
        sc[j][i] = col >= s ? LVV_NEG_BIG
                 : __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(z[j][i]),
                                                 i < 2 ? sq0 : sq1),
                                       sk_s[cl]),
                             qrw_s[r * kMaxGw + col % gw]);
      }
    }
  };
  float o[kD / 8][4];
  float l0, l1;
  flash_loop<kD>(v_s, s, load_kv, scores, o, l0, l1);

  bf16* ob = out + tok0 * c + h * kD;
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) {
    const int col = j * 8 + 2 * t;
    if (q_start + r0 < s)
      *reinterpret_cast<uint32_t*>(ob + (long long)(q_start + r0) * c + col) =
          pack_f32(o[j][0] / l0, o[j][1] / l0);
    if (q_start + r1 < s)
      *reinterpret_cast<uint32_t*>(ob + (long long)(q_start + r1) * c + col) =
          pack_f32(o[j][2] / l1, o[j][3] / l1);
  }
}

// q8 / k8 [B, S, heads, 128] int8 (the augmented operands, quantized per
// token and head), sq / sk [B, S, heads] fp32, qrw [B, S, heads, gw] fp32,
// qkv [B, S, 3·heads·64] bf16 (v is read from it), out [B, S, heads·64]
// bf16; all contiguous; gw <= 128. Returns a cudaError_t (0 on success).
extern "C" int lvv_relpos_attention_qk8(const void* q8, const void* k8,
                                        const void* sq, const void* sk,
                                        const void* qrw, const void* qkv,
                                        void* out, int b, int s, int heads,
                                        int gw, void* stream) {
  if (b <= 0 || s <= 0 || gw <= 0 || gw > kMaxGw)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(kBQ * kMaxGw + kBQ + kBK) * sizeof(float) +
                      (size_t)(kBQ + kBK) * kLD8 +
                      (size_t)kBK * (kD + 8) * sizeof(bf16);
  cudaError_t e = allow_smem(qk8_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((s + kBQ - 1) / kBQ, heads, b);
  qk8_kernel<<<grid, kAttnThreads, smem, (cudaStream_t)stream>>>(
      (const signed char*)q8, (const signed char*)k8, (const float*)sq,
      (const float*)sk, (const float*)qrw, (const bf16*)qkv, (bf16*)out, s,
      heads, gw);
  return (int)cudaGetLastError();
}
