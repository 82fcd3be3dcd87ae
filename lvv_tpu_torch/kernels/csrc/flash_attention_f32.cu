// Flash attention forward in fp32 for the port (fp32 in and out, head dim up
// to 64): the fp32 form of kernel K-e.
//
// Replaces lvv_tpu/ops/attention.py::_flash_kernel as `_flash_padded`
// (:188) runs it on fp32 q / k / v: the kernel keeps s, p and the
// accumulator in fp32 and `_flash_padded` pads any head dim <= 64 to 64. On
// the detector path it runs TransFusion's cross-attention (q [1, 4, 200, 32]
// over the 32,400 BEV tokens of a 180 x 180 map, fp32), which `attention()`
// sends to the flash kernel as every bias-free call with kv >= 1024.
//
// What bounds it on the H100: the score and value products, 4·Sq·Sk·D
// operations a head, in fp32 outside the tensor cores (67 TFLOP/s; TF32
// would keep ~3 decimal digits, and the reference is true fp32), against
// reading q, k, v once: operations, by ~5x at TransFusion's shape.
//
// Design: one block owns 64 q rows of one (batch, head) and a range of
// 64-key tiles; 256 threads, each with 4 rows x 4 key columns of a tile's
// scores (rows ty + 16i, keys tx + 16j) and 4 rows x D/16 columns of the
// accumulator. A tile of K and of V is staged in shared memory (K rows
// padded by one float so the 16 lanes of a row group read 16 banks), the
// scores are fp32 FMAs over q·scale (staged once), the online softmax
// (m, l) runs per row with shuffles across the 16 lanes that share it, and
// p goes through shared memory to the p·v products. Masked scores are
// -1e30, as in the TPU kernel; tiles past the row block's limit (kv_len,
// and the causal bound with the sk - sq offset) are skipped. GQA reads kv
// head h / (Hq / Hkv). At TransFusion's shape the q tiles and heads give 16
// blocks, so the kv axis is split across blocks (the wrapper's count, from
// the shapes alone): each split writes fp32 (o, m, l) partials and a
// combine kernel merges them, weights exp(m - M) over the splits that saw a
// key, as `flash_attention_split_plain` does in base 2.
#include <cuda_runtime.h>
#include <math.h>

#define LVV_NEG_BIG (-1e30f)   // masked score, as the JAX kernels use

namespace {

constexpr int BQ = 64;          // q rows a block
constexpr int BN = 64;          // keys a tile
constexpr int THREADS = 256;    // 16 row groups x 16 lanes

// (batch, head, seq) element strides of q, k, v and out, in that order
struct Strides {
  long long s[12];
};

template <int DP>
struct F32Smem {
  static constexpr int KP = DP + 1;                        // K row pitch
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + BQ * DP;
  static constexpr int V_OFF = K_OFF + BN * KP;
  static constexpr int P_OFF = V_OFF + BN * DP;
  static constexpr int FLOATS = P_OFF + BQ * BN;
  static constexpr int BYTES = FLOATS * 4;
};

// The first `rows` rows of a [*, d] slab with row stride `rs` into shared
// memory at pitch `pitch`, times `mul`; columns past d and rows past
// `valid` as zero.
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      long long rs, int rows, int valid,
                                      int d, int dp, int pitch, float mul) {
  for (int e = threadIdx.x; e < rows * dp; e += THREADS) {
    const int r = e / dp, c = e % dp;
    float x = 0.f;
    if (r < valid && c < d) x = src[r * rs + c] * mul;
    dst[r * pitch + c] = x;
  }
}

__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int o = 8; o >= 1; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int o = 8; o >= 1; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int DP>
__global__ void __launch_bounds__(THREADS)
flash_f32(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const int* __restrict__ kv_len,
          float* __restrict__ out, float* __restrict__ part_o,
          float* __restrict__ part_ml, int hq, int hkv, int sq, int sk, int d,
          int causal, float scale, int n_split, int tiles_per_split,
          const Strides strides) {
  const long long* st = strides.s;
  using S = F32Smem<DP>;
  constexpr int CPT = DP / 16;                   // accumulator columns
  extern __shared__ float smem[];
  float* qs = smem + S::Q_OFF;
  float* ks = smem + S::K_OFF;
  float* vs = smem + S::V_OFF;
  float* ps = smem + S::P_OFF;

  const int qt = blockIdx.x, h = blockIdx.y;
  const int b = blockIdx.z / n_split, split = blockIdx.z % n_split;
  const int hk = h / (hq / hkv);
  const int q0 = qt * BQ;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int offset = sk - sq;                    // causal alignment

  int limit = kv_len ? min(kv_len[b], sk) : sk;
  if (causal) limit = min(limit, q0 + BQ + offset);
  const int t_begin = split * tiles_per_split;
  const int t_end = min(t_begin + tiles_per_split, (sk + BN - 1) / BN);

  const float* qb = q + b * st[0] + h * st[1] + (long long)q0 * st[2];
  const float* kb = k + b * st[3] + hk * st[4];
  const float* vb = v + b * st[6] + hk * st[7];
  stage(qs, qb, st[2], BQ, sq - q0, d, DP, DP, scale);

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = LVV_NEG_BIG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * BN;
    if (k0 >= limit) break;
    __syncthreads();                   // the previous tile's K, V, P read
    stage(ks, kb + (long long)k0 * st[5], st[5], BN, sk - k0, d, DP, S::KP,
          1.f);
    stage(vs, vb + (long long)k0 * st[8], st[8], BN, sk - k0, d, DP, DP,
          1.f);
    __syncthreads();
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int kk = 0; kk < DP; ++kk) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * DP + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = ks[(tx + 16 * j) * S::KP + kk];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i + offset;
      float mx = LVV_NEG_BIG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        if (kj >= limit || kj >= sk || (causal && kj > qi))
          s[i][j] = LVV_NEG_BIG;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[(ty + 16 * i) * BN + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = alpha * l[i] + row_sum16(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();
#pragma unroll 8
    for (int j = 0; j < BN; ++j) {
      float vv[CPT], pp[4];
#pragma unroll
      for (int c = 0; c < CPT; ++c) vv[c] = vs[j * DP + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) pp[i] = ps[(ty + 16 * i) * BN + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(pp[i], vv[c],
                                                       acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= sq) continue;
    if (n_split == 1) {
      float* o = out + b * st[9] + h * st[10] + (long long)row * st[11];
      const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        if (tx + 16 * c < d) o[tx + 16 * c] = acc[i][c] * inv;
    } else {
      const int nb = gridDim.z / n_split;
      const long long r = (((long long)split * nb + b) * hq + h) * sq + row;
      float* o = part_o + r * d;
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        if (tx + 16 * c < d) o[tx + 16 * c] = acc[i][c];
      if (tx == 0) {
        part_ml[2 * r] = m[i];
        part_ml[2 * r + 1] = l[i];
      }
    }
  }
}

// One warp a row: out = sum_s w_s o_s / max(sum_s w_s l_s, 1e-30) with
// w_s = exp(m_s - M) over the splits that saw a key (l_s > 0).
__global__ void flash_f32_combine(const float* __restrict__ part_o,
                                  const float* __restrict__ part_ml,
                                  float* __restrict__ out, int n_split,
                                  int rows, int hq, int sq, int d,
                                  long long osb, long long osh,
                                  long long oss) {
  const int row = blockIdx.x * 4 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  float mx = LVV_NEG_BIG;
  for (int sp = 0; sp < n_split; ++sp) {
    const long long r = (long long)sp * rows + row;
    if (part_ml[2 * r + 1] > 0.f) mx = fmaxf(mx, part_ml[2 * r]);
  }
  float acc[2] = {0.f, 0.f}, l = 0.f;
  for (int sp = 0; sp < n_split; ++sp) {
    const long long r = (long long)sp * rows + row;
    const float ls = part_ml[2 * r + 1];
    if (!(ls > 0.f)) continue;
    const float w = expf(part_ml[2 * r] - mx);
    l += w * ls;
#pragma unroll
    for (int c = 0; c < 2; ++c)
      if (lane + 32 * c < d) acc[c] += w * part_o[r * d + lane + 32 * c];
  }
  l = fmaxf(l, 1e-30f);
  const int qi = row % sq, h = (row / sq) % hq, b = row / (sq * hq);
  float* o = out + b * osb + h * osh + qi * oss;
#pragma unroll
  for (int c = 0; c < 2; ++c)
    if (lane + 32 * c < d) o[lane + 32 * c] = acc[c] / l;
}

template <int DP>
int launch(const float* q, const float* k, const float* v, const int* kv_len,
           float* out, float* part_o, float* part_ml, int b, int hq, int hkv,
           int sq, int sk, int d, int causal, int n_split, float scale,
           const long long* st, cudaStream_t stream) {
  using S = F32Smem<DP>;
  cudaError_t e = cudaFuncSetAttribute(
      flash_f32<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, S::BYTES);
  if (e != cudaSuccess) return (int)e;
  const int kv_tiles = (sk + BN - 1) / BN;
  const int tps = (kv_tiles + n_split - 1) / n_split;
  Strides strides;
  for (int i = 0; i < 12; ++i) strides.s[i] = st[i];
  dim3 grid((sq + BQ - 1) / BQ, hq, b * n_split);
  flash_f32<DP><<<grid, THREADS, S::BYTES, stream>>>(
      q, k, v, kv_len, out, part_o, part_ml, hq, hkv, sq, sk, d, causal,
      scale, n_split, tps, strides);
  e = cudaGetLastError();
  if (e != cudaSuccess || n_split == 1) return (int)e;
  const int rows = b * hq * sq;
  flash_f32_combine<<<(rows + 3) / 4, 128, 0, stream>>>(
      part_o, part_ml, out, n_split, rows, hq, sq, d, st[9], st[10], st[11]);
  return (int)cudaGetLastError();
}

}  // namespace

// q [B, Hq, Sq, D], k / v [B, Hkv, Sk, D], out [B, Hq, Sq, D], all fp32 with
// unit stride on D and D <= 64. `strides` holds the (batch, head, seq)
// element strides of q, k, v and out in that order. kv_len is a device
// int32 [B] or null.
// n_split > 1 splits the kv axis: part_o (fp32 [n_split, B, Hq, Sq, D]) and
// part_ml (fp32 [n_split, B, Hq, Sq, 2]) are the caller's scratch, unused
// otherwise. Returns a cudaError_t (0 on success).
extern "C" int lvv_flash_attention_f32(const void* q, const void* k,
                                       const void* v, const void* kv_len,
                                       void* out, void* part_o, void* part_ml,
                                       int b, int hq, int hkv, int sq, int sk,
                                       int d, int causal, int n_split,
                                       float scale, const long long* strides,
                                       void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n_split < 1 || (n_split > 1 && (!part_o || !part_ml)) || d < 1 ||
      d > 64 || hkv < 1 || hq % hkv)
    return (int)cudaErrorInvalidValue;
  const float* qf = (const float*)q;
  const float* kf = (const float*)k;
  const float* vf = (const float*)v;
  if (d <= 32)
    return launch<32>(qf, kf, vf, (const int*)kv_len, (float*)out,
                      (float*)part_o, (float*)part_ml, b, hq, hkv, sq, sk, d,
                      causal, n_split, scale, strides, s);
  return launch<64>(qf, kf, vf, (const int*)kv_len, (float*)out,
                    (float*)part_o, (float*)part_ml, b, hq, hkv, sq, sk, d,
                    causal, n_split, scale, strides, s);
}
