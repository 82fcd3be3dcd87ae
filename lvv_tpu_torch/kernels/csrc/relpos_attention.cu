// SAM attention with the decomposed relative-position bias, straight from the
// packed qkv projection (bf16 in and out, fp32 softmax):
//   out = softmax(scale·q·kᵀ + q·Rh[qh, kh] + q·Rw[qw, kw]) v
// where (qh, qw) / (kh, kw) are the grid coordinates of the query / key token.
//
// Replaces two TPU kernels that compute this one function at two shapes:
//   K-c lvv_tpu/ops/attention.py::_window_packed_kernel (window_attention_packed):
//       the 8 windowed SAM layers, 150 windows of 14x14 tokens;
//   K-d lvv_tpu/ops/attention.py::_flash_hpacked_kernel
//       (flash_attention_relpos_hpacked): the 4 global SAM layers, 6 views of
//       64x64 tokens.
// Both read qkv [B, S, 3C] (C = heads·d, token-major, row-major grid) and
// write [B, S, C], so the head axis is never transposed in device memory.
//
// What bounds it on the H100: the two products, 4·S²·d operations per
// (window or view, head), against reading qkv once: far above the card's
// ~295 operations per byte, so the bf16 tensor-core rate bounds it (the bias
// adds S·(gh + gw)·d multiply-adds, under 2% at the global shape).
//
// Design: one block per (q tile of 64 tokens, head, window or view). The
// block first forms the two small bias tables of its q rows in shared
// memory, qRh[t, kh] = q_t·Rh[qh(t), kh] and qRw[t, kw] = q_t·Rw[qw(t), kw]
// (at most 64 x 64 and 64 x 128 floats), from UNSCALED q as SAM defines the
// bias (only q·k takes 1/√d). The flash loop over kv tiles (common.cuh) then
// adds bias[t, k] = qRh[t, k / gw] + qRw[t, k % gw] to each score, so the
// [S, S] bias never exists anywhere. The TPU's base-2 / log2e operand packing
// is a layout trick of K-d and is not copied: the scores are scaled by log2e
// here only to use exp2. Windows are full 196-token sequences (the 64x64 grid
// is zero-padded to 70x70 before partitioning and the zero tokens take part,
// unmasked, as in the reference); only the tile edge past S is masked.
//
// The int8 p@v arm (PV8) replaces the `quant8` arm of the same TPU kernel
// (K-d8, attention.py:717-723, LVV_Q8_SCOPE "attn" on the 4 global layers):
// v arrives quantized per (view, head, channel) by the wrapper, transposed
// to [B, H, d, S] (kv is the contraction axis of p@v, and the s8 MMA's B
// fragment wants 4 consecutive kv of one channel); p is quantized in the
// kernel per row and per GROUP of `pv_group` kv columns (1024, the TPU's kv
// tile), against the group's own maximum, each group walked twice
// (pv8_loop.cuh; q·k is computed twice, so the products are 1.5x those of
// the float arm).
//
// What bounds the int8 arm on the H100: 2·S²·d bf16 operations for q·k and
// 2·S²·d int8 operations for p@v: about 0.24 ms at the global shape.
#include "common.cuh"
#include "pv8_loop.cuh"

constexpr int kMaxGh = 64;
constexpr int kMaxGw = 128;

template <int D, bool PV8>
__global__ void __launch_bounds__(kAttnThreads)
relpos_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ rel_h,
              const bf16* __restrict__ rel_w,
              const signed char* __restrict__ v8t,
              const float* __restrict__ sv, bf16* __restrict__ out, int s,
              int heads, int gh, int gw, int s_pad, int group, float scale) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* bh_s = reinterpret_cast<float*>(smem_raw);   // [kBQ][kMaxGh]
  float* bw_s = bh_s + kBQ * kMaxGh;                   // [kBQ][kMaxGw]
  bf16* q_s = reinterpret_cast<bf16*>(bw_s + kBQ * kMaxGw);
  bf16* k_s = q_s + kBQ * LD;
  bf16* v_s = k_s + kBK * LD;

  const int q_start = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int c = heads * D;
  const long long row = 3LL * c;
  const bf16* base = qkv + (long long)b * s * row + h * D;

  for (int i = threadIdx.x; i < kBQ * D / 8; i += kAttnThreads) {
    const int r = i / (D / 8), cc = (i % (D / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (q_start + r < s)
      val = *reinterpret_cast<const uint4*>(base + (q_start + r) * row + cc);
    *reinterpret_cast<uint4*>(q_s + r * LD + cc) = val;
  }
  __syncthreads();

  // bias tables of this q tile (rows past S hold q = 0, so their bias is 0)
  for (int i = threadIdx.x; i < kBQ * (gh + gw); i += kAttnThreads) {
    const int r = i / (gh + gw), j = i % (gh + gw);
    const int tok = min(q_start + r, s - 1);
    const bf16* rel =
        j < gh ? rel_h + ((long long)(tok / gw) * gh + j) * D
               : rel_w + ((long long)(tok % gw) * gw + (j - gh)) * D;
    const bf16* qr = q_s + r * LD;
    float acc = 0.f;
    for (int cc = 0; cc < D; cc += 8) {
      const uint4 qa = *reinterpret_cast<const uint4*>(qr + cc);
      const uint4 ra = *reinterpret_cast<const uint4*>(rel + cc);
      const bf16* qe = reinterpret_cast<const bf16*>(&qa);
      const bf16* re = reinterpret_cast<const bf16*>(&ra);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc += bf(qe[e]) * bf(re[e]);
    }
    if (j < gh)
      bh_s[r * kMaxGh + j] = acc;
    else
      bw_s[r * kMaxGw + (j - gh)] = acc;
  }
  // (flash_tile synchronises before its first read of the tables)

  const bf16* kb = base + c;
  const bf16* vb = base + 2 * c;
  auto load_kv = [&](int k0) {
    load_rows<D>(k_s, kb + k0 * row, row, s - k0);
    load_rows<D>(v_s, vb + k0 * row, row, s - k0);
  };
  auto score = [&](float acc, int r, int col) {
    if (col >= s) return LVV_NEG_BIG;
    const float bias = bh_s[r * kMaxGh + col / gw] + bw_s[r * kMaxGw + col % gw];
    return (acc * scale + bias) * LVV_LOG2E;
  };
  float o[D / 8][4];
  float l0, l1;
  if constexpr (PV8) {
    // the v region holds the int8 v tile instead (it is large enough)
    signed char* v8_s = reinterpret_cast<signed char*>(v_s);
    const signed char* v8b = v8t + ((long long)b * heads + h) * D * s_pad;
    auto load_k = [&](int k0) { load_rows<D>(k_s, kb + k0 * row, row, s - k0); };
    auto load_v8 = [&](int k0) {
      for (int i = threadIdx.x; i < D * kBK / 16; i += kAttnThreads) {
        const int n = i / (kBK / 16), cc = (i % (kBK / 16)) * 16;
        *reinterpret_cast<uint4*>(v8_s + n * kLDV8 + cc) =
            *reinterpret_cast<const uint4*>(v8b + (long long)n * s_pad + k0 + cc);
      }
    };
    auto scores = [&](int k0, float (&sc)[kBK / 8][4]) {
      qk_scores<D>(sc, q_s, k_s, k0, score);
    };
    pv8_loop<D>(v8_s, s, group, load_k, load_v8, scores,
                sv + ((long long)b * heads + h) * D, o, l0, l1);
  } else {
    flash_tile<D>(q_s, k_s, v_s, s, load_kv, score, o, l0, l1);
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = warp * 16 + (lane >> 2);
  bf16* ob = out + (long long)b * s * c + h * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = j * 8 + 2 * (lane & 3);
    if (q_start + r0 < s)
      *reinterpret_cast<uint32_t*>(ob + (long long)(q_start + r0) * c + col) =
          pack_f32(o[j][0] / l0, o[j][1] / l0);
    if (q_start + r0 + 8 < s)
      *reinterpret_cast<uint32_t*>(ob + (long long)(q_start + r0 + 8) * c + col) =
          pack_f32(o[j][2] / l1, o[j][3] / l1);
  }
}

template <int D, bool PV8>
static int launch(const void* qkv, const void* rel_h, const void* rel_w,
                  const void* v8t, const void* sv, void* out, int b, int s,
                  int heads, int gh, int gw, int s_pad, int group,
                  float scale, cudaStream_t stream) {
  static_assert(D * kLDV8 <= kBK * (D + 8) * (int)sizeof(bf16),
                "the int8 v tile must fit the bf16 v region");
  const size_t smem = (size_t)kBQ * (kMaxGh + kMaxGw) * sizeof(float) +
                      (size_t)(kBQ + 2 * kBK) * (D + 8) * sizeof(bf16);
  cudaError_t e = allow_smem(relpos_kernel<D, PV8>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((s + kBQ - 1) / kBQ, heads, b);
  relpos_kernel<D, PV8><<<grid, kAttnThreads, smem, stream>>>(
      (const bf16*)qkv, (const bf16*)rel_h, (const bf16*)rel_w,
      (const signed char*)v8t, (const float*)sv, (bf16*)out, s, heads, gh,
      gw, s_pad, group, scale);
  return (int)cudaGetLastError();
}

template <int D>
static int launch_arm(const void* qkv, const void* rel_h, const void* rel_w,
                      const void* v8t, const void* sv, void* out, int b,
                      int s, int heads, int gh, int gw, int s_pad, int group,
                      float scale, cudaStream_t st) {
  if (group == 0)
    return launch<D, false>(qkv, rel_h, rel_w, v8t, sv, out, b, s, heads, gh,
                            gw, s_pad, group, scale, st);
  return launch<D, true>(qkv, rel_h, rel_w, v8t, sv, out, b, s, heads, gh, gw,
                         s_pad, group, scale, st);
}

// qkv [B, S, 3·heads·d], rel_h [gh, gh, d], rel_w [gw, gw, d], out
// [B, S, heads·d], all contiguous bf16, S = gh·gw, gh <= 64, gw <= 128.
// pv_group 0: the float arm (v8t, sv unused). Otherwise the int8 p@v arm
// with p quantized per pv_group kv columns (a multiple of 64): v8t [B,
// heads, d, s_pad] int8 (v quantized per channel, transposed, zero past S;
// s_pad a multiple of 64 and >= S) and sv [B, heads, d] fp32. Returns a
// cudaError_t (0 on success).
extern "C" int lvv_relpos_attention(const void* qkv, const void* rel_h,
                                    const void* rel_w, const void* v8t,
                                    const void* sv, void* out, int b, int s,
                                    int heads, int d, int gh, int gw,
                                    int s_pad, int pv_group, float scale,
                                    void* stream) {
  if (gh > kMaxGh || gw > kMaxGw || gh * gw != s || pv_group < 0 ||
      pv_group % kBK)
    return (int)cudaErrorInvalidValue;
  if (pv_group && (!v8t || !sv || s_pad < s || s_pad % kBK))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (d) {
    case 64:
      return launch_arm<64>(qkv, rel_h, rel_w, v8t, sv, out, b, s, heads, gh,
                            gw, s_pad, pv_group, scale, st);
    case 128:
      return launch_arm<128>(qkv, rel_h, rel_w, v8t, sv, out, b, s, heads, gh,
                             gw, s_pad, pv_group, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}
