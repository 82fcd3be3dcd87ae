// Head-split SAM attention with the decomposed relative-position bias, from
// q, k, v [B, H, S, d] and the caller's bias tables (bf16 in and out, fp32
// softmax, the [S, S] bias never formed):
//   out = softmax(scale·q·kᵀ + q_rh[q, kv / gw] + q_rw[q, kv % gw]) v
// with q_rh [B, H, S, gh] = q·Rh and q_rw [B, H, S, gw] = q·Rw computed and
// rounded to bf16 by the caller, as SAM's third branch (lvv_tpu/models/
// sam.py:202-231) does.
//
// Replaces TPU kernel K-h, lvv_tpu/ops/attention.py, in its three bodies,
// which are three modes of one template here (each walks the kv tiles of
// common.cuh; none is the TPU's block structure):
//   kStream  _flash_relpos_kernel (via flash_attention_relpos): SAM's
//            global layers at grids that fail the head-packed test (80x80
//            at 1280²). The TPU picks the bias columns of each kv tile with
//            one-hot matmuls; here each score reads its two table entries
//            by index (kv / gw, kv % gw, from a per-tile column table), for
//            any gw. Columns at or past kv_end are masked: the wrapper
//            passes the TPU grid's kv extent, so nothing is padded (the TPU
//            pads S = 6400 to 8192). Int8 arm (PV8): pv8_loop.cuh with
//            groups of the TPU's kv tile (1024 columns from column 0).
//   kFused   _flash_relpos_fused_kernel (via flash_attention_relpos_fused):
//            scores from the augmented operands q_aug = [q·scale·log2e |
//            q_rh·log2e | 0] and k_aug = [k | onehot(kv / gw) | 0] at depth
//            128 (so the height bias comes out of the product), plus the
//            width table q_rw·log2e; base 2 as on the TPU. Same int8 arm.
//            It also runs K-m's attention, _flash_hpacked_kernel with
//            qrw_off = d (via flash_attention_relpos_hpacked_prepped): q_aug,
//            k_aug and v are strided views of qr_prep.cu's [B, S, H·128]
//            lane blocks, and the width table is read where it lies, in
//            v_aug's lanes d .. d + gw of the query rows.
//   kSmall   _relpos_mh_kernel (S padded to 512 or less): one softmax over
//            all kv with p divided by its row sum BEFORE it is rounded to
//            bf16 for p@v, as the TPU's single-tile kernel does; so each
//            block walks kv twice (row maxima and sums, then p@v).
//
// What bounds it on the H100: the two products, 4·S²·d operations per
// (view, head), against reading q, k, v and the tables once: far above the
// card's ~295 operations per byte, so the bf16 tensor-core rate bounds it
// (0.76 ms for the 4·6·12·6400²·64 operations of one 1280² global layer).
// The int8 arm computes q·k twice (pv8_loop). This first version runs
// mma.sync from shared memory with 64-row tiles and one warp per 16 rows,
// as the port's other attention kernels do; wgmma and TMA are later work.
//
// Design: one block per (64-row q tile, head, view). It copies its q rows
// and its rows of both tables (as fp32, odd row pitch against bank
// conflicts) into shared memory, then runs the loop of its mode; each kv
// tile's load also writes the tile's 64 (kv / gw, kv % gw) pairs, so the
// score epilogue does no integer division.
#include <string.h>

#include "common.cuh"
#include "pv8_loop.cuh"

enum { kStream = 0, kFused = 1, kSmall = 2 };

struct KhArgs {
  const bf16 *q, *k, *v, *qrh, *qrw;
  const signed char* v8t;  // [B, H, d, s_pad8] int8 v (int8 arm)
  const float* sv;         // [B, H, d] per-channel scales of v (int8 arm)
  bf16* out;
  long long st[18];        // (view, head, token) strides of q, k, v, out,
                           // qrh, qrw
  int heads, s, gh, gw, kv_end, group, s_pad8, ldh, ldw;
  float scale;
};

// kSmall's softmax: pass 1 takes each row's maximum m and sum l over kv
// [0, kv_end), pass 2 recomputes the scores and accumulates
// bf16(exp2(s - m) / l) @ V into o (normalised already).
template <int D, class LoadK, class LoadKV, class Scores>
__device__ __forceinline__ void normed_loop(const bf16* v_s, int kv_end,
                                            LoadK load_k, LoadKV load_kv,
                                            Scores scores,
                                            float (&o)[D / 8][4]) {
  float m0 = LVV_NEG_BIG, m1 = LVV_NEG_BIG, l0 = 0.f, l1 = 0.f;
  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();
    load_k(k0);
    __syncthreads();
    float s[kBK / 8][4];
    scores(k0, s);
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      ps0 += exp2f(s[j][0] - mx0) + exp2f(s[j][1] - mx0);
      ps1 += exp2f(s[j][2] - mx1) + exp2f(s[j][3] - mx1);
    }
    l0 = l0 * exp2f(m0 - mx0) + quad_sum(ps0);
    l1 = l1 * exp2f(m1 - mx1) + quad_sum(ps1);
    m0 = mx0;
    m1 = mx1;
  }
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();
    load_kv(k0);
    __syncthreads();
    float s[kBK / 8][4];
    scores(k0, s);
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      s[j][0] = __fdiv_rn(exp2f(s[j][0] - m0), l0);
      s[j][1] = __fdiv_rn(exp2f(s[j][1] - m0), l0);
      s[j][2] = __fdiv_rn(exp2f(s[j][2] - m1), l1);
      s[j][3] = __fdiv_rn(exp2f(s[j][3] - m1), l1);
    }
    pv_bf16<D>(o, s, v_s);
  }
}

// DQ: depth of the score product (d, or 128 in kFused); DV: head dim of v.
template <int DQ, int DV, int MODE, bool PV8>
__global__ void __launch_bounds__(kAttnThreads) kh_kernel(const KhArgs a) {
  constexpr int LDQ = DQ + 8, LDV = DV + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* colh_s = reinterpret_cast<int*>(smem_raw);      // [kBK] kv / gw
  int* colw_s = colh_s + kBK;                          // [kBK] kv % gw
  bf16* q_s = reinterpret_cast<bf16*>(colw_s + kBK);   // [kBQ][LDQ]
  bf16* k_s = q_s + kBQ * LDQ;                         // [kBK][LDQ]
  bf16* v_s = k_s + kBK * LDQ;                         // [kBK][LDV]
  float* bw_s = reinterpret_cast<float*>(v_s + kBK * LDV);  // [kBQ][ldw]
  float* bh_s = bw_s + kBQ * a.ldw;                    // [kBQ][ldh]

  const int q_start = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const bf16* qb = a.q + b * a.st[0] + h * a.st[1];
  const bf16* kb = a.k + b * a.st[3] + h * a.st[4];
  const bf16* vb = a.v + b * a.st[6] + h * a.st[7];

  for (int i = threadIdx.x; i < kBQ * DQ / 8; i += kAttnThreads) {
    const int r = i / (DQ / 8), c = (i % (DQ / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (q_start + r < a.s)
      val = *reinterpret_cast<const uint4*>(qb + (q_start + r) * a.st[2] + c);
    *reinterpret_cast<uint4*>(q_s + r * LDQ + c) = val;
  }
  // this q tile's rows of the tables (0 past S: those rows are not written)
  const bf16* rwb = a.qrw + b * a.st[15] + h * a.st[16];
  for (int i = threadIdx.x; i < kBQ * a.gw; i += kAttnThreads) {
    const int r = i / a.gw, j = i - r * a.gw;
    bw_s[r * a.ldw + j] =
        q_start + r < a.s ? bf(rwb[(q_start + r) * a.st[17] + j]) : 0.f;
  }
  if constexpr (MODE != kFused) {
    const bf16* rhb = a.qrh + b * a.st[12] + h * a.st[13];
    for (int i = threadIdx.x; i < kBQ * a.gh; i += kAttnThreads) {
      const int r = i / a.gh, j = i - r * a.gh;
      bh_s[r * a.ldh + j] =
          q_start + r < a.s ? bf(rhb[(q_start + r) * a.st[14] + j]) : 0.f;
    }
  }
  // (each loop synchronises before its first read of shared memory)

  auto load_k = [&](int k0) {
    load_rows<DQ>(k_s, kb + k0 * a.st[5], a.st[5], a.kv_end - k0);
    for (int c = threadIdx.x; c < kBK; c += kAttnThreads) {
      const int kh = (k0 + c) / a.gw;
      colh_s[c] = kh;
      colw_s[c] = k0 + c - kh * a.gw;
    }
  };
  auto load_kv = [&](int k0) {
    load_k(k0);
    load_rows<DV>(v_s, vb + k0 * a.st[8], a.st[8], a.kv_end - k0);
  };
  // log2-domain logit of tile row r at kv column col (k0 is a multiple of
  // kBK, so col % kBK indexes the tile's column table)
  auto score = [&](float acc, int r, int col) {
    if (col >= a.kv_end) return LVV_NEG_BIG;
    const int c = col & (kBK - 1);
    if constexpr (MODE == kFused) {
      return acc + bw_s[r * a.ldw + colw_s[c]];
    } else {
      return ((acc * a.scale + bh_s[r * a.ldh + colh_s[c]]) +
              bw_s[r * a.ldw + colw_s[c]]) * LVV_LOG2E;
    }
  };
  auto scores = [&](int k0, float (&sc)[kBK / 8][4]) {
    qk_scores<DQ>(sc, q_s, k_s, k0, score);
  };

  float o[DV / 8][4];
  float l0 = 1.f, l1 = 1.f;
  if constexpr (MODE == kSmall) {
    normed_loop<DV>(v_s, a.kv_end, load_k, load_kv, scores, o);
  } else if constexpr (PV8) {
    // the v region holds the int8 v tile instead (it is large enough)
    signed char* v8_s = reinterpret_cast<signed char*>(v_s);
    const signed char* v8b =
        a.v8t + ((long long)b * a.heads + h) * DV * a.s_pad8;
    auto load_v8 = [&](int k0) {
      for (int i = threadIdx.x; i < DV * kBK / 16; i += kAttnThreads) {
        const int n = i / (kBK / 16), cc = (i % (kBK / 16)) * 16;
        *reinterpret_cast<uint4*>(v8_s + n * kLDV8 + cc) =
            *reinterpret_cast<const uint4*>(v8b + (long long)n * a.s_pad8 +
                                            k0 + cc);
      }
    };
    pv8_loop<DV>(v8_s, a.kv_end, a.group, load_k, load_v8, scores,
                 a.sv + ((long long)b * a.heads + h) * DV, o, l0, l1);
  } else {
    flash_loop<DV>(v_s, a.kv_end, load_kv, scores, o, l0, l1);
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = q_start + warp * 16 + (lane >> 2);
  bf16* ob = a.out + b * a.st[9] + h * a.st[10];
#pragma unroll
  for (int j = 0; j < DV / 8; ++j) {
    const int col = j * 8 + 2 * (lane & 3);
    if (r0 < a.s)
      *reinterpret_cast<uint32_t*>(ob + r0 * a.st[11] + col) =
          pack_f32(o[j][0] / l0, o[j][1] / l0);
    if (r0 + 8 < a.s)
      *reinterpret_cast<uint32_t*>(ob + (r0 + 8) * a.st[11] + col) =
          pack_f32(o[j][2] / l1, o[j][3] / l1);
  }
}

template <int DQ, int DV, int MODE, bool PV8>
static int launch(const KhArgs& a, int b, cudaStream_t stream) {
  static_assert(DV * kLDV8 <= kBK * (DV + 8) * (int)sizeof(bf16),
                "the int8 v tile must fit the bf16 v region");
  const size_t smem = 2 * kBK * sizeof(int) +
                      (size_t)(kBQ + kBK) * (DQ + 8) * sizeof(bf16) +
                      (size_t)kBK * (DV + 8) * sizeof(bf16) +
                      (size_t)kBQ * (a.ldw + (MODE == kFused ? 0 : a.ldh)) *
                          sizeof(float);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem(kh_kernel<DQ, DV, MODE, PV8>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.s + kBQ - 1) / kBQ, a.heads, b);
  kh_kernel<DQ, DV, MODE, PV8><<<grid, kAttnThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int DQ, int DV, int MODE>
static int launch_arm(const KhArgs& a, int b, cudaStream_t stream) {
  if (a.group) return launch<DQ, DV, MODE, true>(a, b, stream);
  return launch<DQ, DV, MODE, false>(a, b, stream);
}

// q, k, v [B, H, S, *] bf16 with unit stride on the last axis and the
// (view, head, token) strides in `strides` (18 int64: q, k, v, out, qrh,
// qrw), rows of q, k, v 16-byte aligned; q / k of depth d (128 in mode
// kFused, where q, k are q_aug, k_aug and d = 64 is v's depth); qrh
// [B, H, S, gh] (not read in mode kFused) and qrw [B, H, S, gw] bf16 with
// unit stride on the last axis; out [B, H, S, d].
// Keys at or past kv_end (<= S) are masked. group 0: the float arm;
// otherwise the int8 p@v arm with p quantized per `group` kv columns (a
// multiple of 64): v8t [B, H, d, s_pad8] int8 (zero past S; s_pad8 a
// multiple of 64 and >= S) and sv [B, H, d] fp32. mode kSmall has no int8
// arm. Returns a cudaError_t (0 on success).
extern "C" int lvv_flash_attention_relpos(
    const void* q, const void* k, const void* v, const void* qrh,
    const void* qrw, const void* v8t, const void* sv, void* out,
    const void* strides, int b, int heads, int s, int d, int gh, int gw,
    int kv_end, int group, int s_pad8, int mode, float scale, void* stream) {
  if (gh <= 0 || gw <= 0 || gh * gw != s || kv_end <= 0 || kv_end > s ||
      group < 0 || group % kBK || !qrw || (mode != kFused && !qrh))
    return (int)cudaErrorInvalidValue;
  if (group && (mode == kSmall || !v8t || !sv || s_pad8 < s || s_pad8 % kBK))
    return (int)cudaErrorInvalidValue;
  KhArgs a;
  a.q = (const bf16*)q;
  a.k = (const bf16*)k;
  a.v = (const bf16*)v;
  a.qrh = (const bf16*)qrh;
  a.qrw = (const bf16*)qrw;
  a.v8t = (const signed char*)v8t;
  a.sv = (const float*)sv;
  a.out = (bf16*)out;
  memcpy(a.st, strides, sizeof(a.st));
  a.heads = heads;
  a.s = s;
  a.gh = gh;
  a.gw = gw;
  a.kv_end = kv_end;
  a.group = group;
  a.s_pad8 = s_pad8;
  a.ldh = gh | 1;
  a.ldw = gw | 1;
  a.scale = scale;
  cudaStream_t st = (cudaStream_t)stream;
  if (mode == kStream && d == 64) return launch_arm<64, 64, kStream>(a, b, st);
  if (mode == kStream && d == 128)
    return launch_arm<128, 128, kStream>(a, b, st);
  if (mode == kFused && d == 64) return launch_arm<128, 64, kFused>(a, b, st);
  if (mode == kSmall && d == 64)
    return launch<64, 64, kSmall, false>(a, b, st);
  if (mode == kSmall && d == 128)
    return launch<128, 128, kSmall, false>(a, b, st);
  return (int)cudaErrorInvalidValue;
}
