// Flash attention forward in fp32 for the port (fp32 in and out, head dim up
// to 64): the fp32 form of kernel K-e, on the tensor cores in 3xTF32.
//
// Replaces lvv_tpu/ops/attention.py::_flash_kernel as `_flash_padded`
// (:188) runs it on fp32 q / k / v: s, p and the accumulator in fp32. On
// the detector path it runs TransFusion's and BEVFusion's query-head
// cross-attention (q [1, 4, 200, 32] over the 32,400 BEV tokens of a
// 180 x 180 map), which `attention()` sends to the flash kernel as every
// bias-free call with kv >= 1024.
//
// What bounds it on the H100: the score and value products, 4·Sq·Sk·D
// operations a head, held to true fp32 (1e-5 relative L2 against the plain
// version; a single TF32 pass lands ~4.5e-4 off). In 3xTF32 every operand
// is split, x = big + small with big = tf32(x) and small = tf32(x - big)
// (round to nearest, ties away, as cvt.rna.tf32.f32), and each product is
// big·big + big·small + small·big into fp32 accumulators (small·small
// dropped): fp32's accuracy at three TF32 passes, 3 x 4·Sq·Sk·D operations
// at 495 TFLOP/s, against reading q, k, v once: operations, by ~2x at
// TransFusion's shape. mma.sync reaches ~318 TFLOP/s of TF32 on this card,
// and a warp's 16 rows make each K / V fragment read from shared memory
// feed three products: those two hold it (PERF.md).
//
// Design, against what held the SIMT kernel it replaces:
// - fp32 FMAs fed by scalar shared loads -> the tensor cores: mma.sync
//   m16n8k8 tf32, three a product. q is scaled by scale·log2 e and split
//   once into A fragments that stay in registers. The scores' C fragments
//   are p·v's A fragments in place: lane t holds keys 2t and 2t + 1 of each
//   8, and V's pairs are laid out in that key order (k-slot t = key 2t,
//   slot t + 4 = key 2t + 1), so p needs neither a shuffle nor shared
//   memory. Each step runs a pass over 4 (scores) or up to 4 (p·v)
//   independent accumulators before the next pass.
// - One block of 8 warps an SM, loads not hidden -> a warp owns 16 q rows
//   (one m16 tile), a block the fewest warps, at most 7, that even out the
//   row tiles (sq 200: 2 blocks of 7), two blocks an SM at 128 registers.
//   K and V tiles of 32 keys come through a 2-stage cp.async ring (16-byte
//   copies where d, the pointers and strides allow, else 4-byte ones;
//   zero-filled past sk and d), and each is split once into a second,
//   double-buffered ring of (big, small) pairs: one barrier a tile, tile
//   i + 1 split and tile i + 2 loading while tile i's products run.
// - 200 rows padded to 256 -> 13 row tiles of 16 (208 rows).
// - expf -> ex2.approx with log2 e folded into q's scale; the online
//   softmax runs in base 2 per row, shuffles across the 4 lanes of a row.
// - The pairs are laid out so that one 16-byte read is a lane's whole B
//   fragment, (big, big, small, small), with pitches that keep each
//   quarter warp on distinct banks.
// - Each tile's p·v starts from zero and joins o by an fp32 fma: the
//   tensor cores' accumulation does not round to nearest, and one chain
//   over a split's ~1,000 keys drifts ~1e-5.
// The kv axis is split across blocks by the wrapper's count
// (`flash_f32_plan`, from the shapes alone: 33 splits, 264 blocks at
// TransFusion's shape): each split writes fp32 (o, m, l) partials, m in
// base 2, and a combine kernel merges them, weights 2^(m - M) over the
// splits that saw a key, as `flash_attention_split_plain` does. Masked
// scores are -1e30, as in the TPU kernel, and only tiles that straddle a
// row's limit compute masks; tiles past the block's limit (kv_len, and the
// causal bound with the sk - sq offset) are skipped. GQA reads kv head
// h / (Hq / Hkv). Head dims are padded to a multiple of 8 with zeros.
#include <cuda_runtime.h>
#include <stdint.h>

#define LVV_NEG_BIG (-1e30f)   // masked score, as the JAX kernels use

namespace {

constexpr int ROWS = 16;        // q rows a warp: one m16 tile
constexpr int MAX_WARPS = 7;    // warps a block: two blocks an SM at 128
                                // registers a thread
constexpr int BN = 32;          // keys a tile
constexpr float LOG2E = 1.4426950408889634f;

// (batch, head, seq) element strides of q, k, v and out, in that order
struct Strides {
  long long s[12];
};

template <int DP>
struct Tile {
  // K pairs: a key's row holds, for each 8 columns and lane t, the 16
  // bytes (big d_t, big d_t+4, small d_t, small d_t+4); V pairs: a row per
  // key pair (2j, 2j + 1) holds, for each column, (big 2j, big 2j + 1,
  // small 2j, small 2j + 1). One 16-byte read is a lane's B fragment for
  // the three products; the pitches keep each quarter warp on distinct
  // banks.
  static constexpr int KP = 2 * DP + (DP % 16 ? 0 : 16);
  static constexpr int VP = 4 * DP + 8;
  static constexpr int RAW = BN * DP;             // floats of a raw tile
  static constexpr int PAIRS = BN * KP + BN / 2 * VP;  // floats
  static constexpr int P_OFF = 2 * 2 * RAW;       // two raw stages of K, V
  static constexpr int BYTES = (P_OFF + 2 * PAIRS) * 4;
};

// x rounded to TF32 (to nearest, ties away from zero) in fp32's format, as
// cvt.rna.tf32.f32 gives it for finite x, by two integer operations
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = big + small, both TF32 values: 3xTF32's operand split
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = tf32(x);
  small = tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ float4 split2(float a, float b) {
  uint32_t ba, sa, bb, sb;
  split(a, ba, sa);
  split(b, bb, sb);
  return make_float4(__uint_as_float(ba), __uint_as_float(bb),
                     __uint_as_float(sa), __uint_as_float(sb));
}

__device__ __forceinline__ float pow2(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void mma(float* c, const uint32_t* a, float b0,
                                    float b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(__float_as_uint(b0)),
        "r"(__float_as_uint(b1)));
}

// c[i] += a·b_i in 3xTF32 for N B fragments f_i = (big b0, big b1, small
// b0, small b1): each pass over the N in turn, so that N independent
// accumulations follow each other on the tensor cores; the small products
// first, big·big last
template <int N>
__device__ __forceinline__ void mma3(float (*c)[4], const uint32_t* ab,
                                     const uint32_t* as, const float4* f) {
#pragma unroll
  for (int i = 0; i < N; ++i) mma(c[i], as, f[i].x, f[i].y);
#pragma unroll
  for (int i = 0; i < N; ++i) mma(c[i], ab, f[i].z, f[i].w);
#pragma unroll
  for (int i = 0; i < N; ++i) mma(c[i], ab, f[i].x, f[i].y);
}

__device__ __forceinline__ void cp16(float* dst, const float* src, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp4(float* dst, const float* src, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Keys k0 .. k0 + BN - 1 of K and V (rows `ks` / `vs` floats apart) into a
// raw stage [BN, DP]; rows past sk and columns past d as zero.
template <int DP>
__device__ __forceinline__ void load_tile(float* kd, float* vd,
                                          const float* kb, const float* vb,
                                          long long ks, long long vs, int k0,
                                          int sk, int d, bool vec) {
  if (vec) {                        // d % 4 == 0, 16-byte aligned rows
    constexpr int C4 = DP / 4;
    for (int e = threadIdx.x; e < BN * C4; e += blockDim.x) {
      const int r = e / C4, c = e % C4 * 4;
      const bool ok = k0 + r < sk && c < d;
      cp16(kd + r * DP + c, ok ? kb + (k0 + r) * ks + c : kb, ok);
      cp16(vd + r * DP + c, ok ? vb + (k0 + r) * vs + c : vb, ok);
    }
  } else {
    for (int e = threadIdx.x; e < BN * DP; e += blockDim.x) {
      const int r = e / DP, c = e % DP;
      const bool ok = k0 + r < sk && c < d;
      cp4(kd + e, ok ? kb + (k0 + r) * ks + c : kb, ok);
      cp4(vd + e, ok ? vb + (k0 + r) * vs + c : vb, ok);
    }
  }
}

// A raw stage split once into the pair layouts the products read
template <int DP>
__device__ __forceinline__ void split_tile(float* pairs, const float* kr,
                                           const float* vr) {
  using T = Tile<DP>;
  constexpr int H = DP / 2;
  for (int e = threadIdx.x; e < BN * H; e += blockDim.x) {
    const int r = e / H, w = e % H, c = w / 4 * 8 + w % 4;
    *reinterpret_cast<float4*>(pairs + r * T::KP + w * 4) =
        split2(kr[r * DP + c], kr[r * DP + c + 4]);
  }
  float* vp = pairs + BN * T::KP;
  for (int e = threadIdx.x; e < BN / 2 * DP; e += blockDim.x) {
    const int j = e / DP, c = e % DP;
    *reinterpret_cast<float4*>(vp + j * T::VP + c * 4) =
        split2(vr[2 * j * DP + c], vr[(2 * j + 1) * DP + c]);
  }
}

// A K tile's scores for the warp's 16 rows and the online softmax step in
// base 2: p into s (c0 / c1 row g, c2 / c3 row g + 8, keys 2t, 2t + 1), the
// rows' rescale into alpha
template <int DP>
__device__ __forceinline__ void scores(
    const float* pairs, int k0, int limit, int causal, int r0, int offset,
    int g, int t, const uint32_t (&qb)[DP / 8][4],
    const uint32_t (&qs)[DP / 8][4], float (&m)[2], float (&l)[2],
    float (&s)[BN / 8][4], float (&alpha)[2]) {
  using T = Tile<DP>;
  constexpr int KS = DP / 8, NT = BN / 8;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[n][j] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    float4 f[NT];
#pragma unroll
    for (int n = 0; n < NT; ++n)
      f[n] = reinterpret_cast<const float4*>(
          pairs + (n * 8 + g) * T::KP)[kk * 4 + t];
    mma3<NT>(s, qb[kk], qs[kk], f);
  }
  // masks only where a key of the tile lies past a row's limit
  const bool edge =
      k0 + BN > limit || (causal && k0 + BN - 1 > r0 + offset);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = r0 + g + 8 * r + offset;
    float mx = LVV_NEG_BIG;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float& x = s[n][2 * r + j];
        if (edge) {
          const int kj = k0 + n * 8 + 2 * t + j;
          if (kj >= limit || (causal && kj > qi)) x = LVV_NEG_BIG;
        }
        mx = fmaxf(mx, x);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[r], mx);
    alpha[r] = pow2(m[r] - m_new);
    float sum = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float p = pow2(s[n][2 * r + j] - m_new);
        s[n][2 * r + j] = p;
        sum += p;
      }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l[r] = alpha[r] * l[r] + sum;
    m[r] = m_new;
  }
}

// A V tile's p·v for the warp's 16 rows into o, after o's rescale by alpha
template <int DP>
__device__ __forceinline__ void values(const float* pairs, int g, int t,
                                       const float (&s)[BN / 8][4],
                                       const float (&alpha)[2],
                                       float (&o)[DP / 8][4]) {
  using T = Tile<DP>;
  constexpr int KS = DP / 8, NT = BN / 8;
  const float* vp = pairs + BN * T::KP;
  // p·v: the score fragment of keys 8n .. 8n + 7 is the A fragment with
  // k-slot t = key 2t, slot t + 4 = key 2t + 1; V's pairs follow that
  // order. The tile's sum starts from zero and joins o by an fp32 fma: the
  // tensor cores' accumulation does not round to nearest, and a chain of
  // every tile's products in one accumulator drifts (~1e-5 relative over
  // a 1,000-key split).
  float ot[KS][4];
#pragma unroll
  for (int c = 0; c < KS; ++c)
#pragma unroll
    for (int j = 0; j < 4; ++j) ot[c][j] = 0.f;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    uint32_t pb[4], ps[4];
    split(s[n][0], pb[0], ps[0]);
    split(s[n][2], pb[1], ps[1]);
    split(s[n][1], pb[2], ps[2]);
    split(s[n][3], pb[3], ps[3]);
    const float4* vr =
        reinterpret_cast<const float4*>(vp + (n * 4 + t) * T::VP) + g;
    constexpr int C1 = KS < 4 ? KS : 4, C2 = KS - C1;   // KS <= 8
    float4 f[C1];
#pragma unroll
    for (int c = 0; c < C1; ++c) f[c] = vr[c * 8];
    mma3<C1>(ot, pb, ps, f);
    if constexpr (C2 > 0) {
      float4 f2[C2];
#pragma unroll
      for (int c = 0; c < C2; ++c) f2[c] = vr[(C1 + c) * 8];
      mma3<C2>(ot + C1, pb, ps, f2);
    }
  }
#pragma unroll
  for (int c = 0; c < KS; ++c)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      o[c][j] = fmaf(o[c][j], alpha[j >> 1], ot[c][j]);
}

template <int DP>
__global__ void __launch_bounds__(MAX_WARPS * 32, DP <= 32 ? 2 : 1)
flash_f32_tc(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const int* __restrict__ kv_len,
             float* __restrict__ out, float* __restrict__ part_o,
             float* __restrict__ part_ml, int hq, int hkv, int sq, int sk,
             int d, int causal, float qscale, int n_split,
             int tiles_per_split, int vec, const Strides strides) {
  using T = Tile<DP>;
  constexpr int KS = DP / 8;
  const long long* st = strides.s;
  extern __shared__ __align__(16) float smem[];
  float* pairs = smem + T::P_OFF;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;    // the fragments' group, lane
  const int bq = (blockDim.x >> 5) * ROWS;
  const int q0 = blockIdx.x * bq, h = blockIdx.y;
  const int b = blockIdx.z / n_split, split_i = blockIdx.z % n_split;
  const int hk = h / (hq / hkv);
  const int offset = sk - sq;                // causal alignment
  const int r0 = q0 + warp * ROWS;           // the warp's first row
  const bool active = r0 < sq;

  int limit = kv_len ? min(kv_len[b], sk) : sk;
  if (causal) limit = min(limit, min(q0 + bq, sq) + offset);
  limit = max(limit, 0);
  const int t_begin = split_i * tiles_per_split;
  const int t_end = min(min(t_begin + tiles_per_split, (sk + BN - 1) / BN),
                        (limit + BN - 1) / BN);
  const int n_tiles = max(t_end - t_begin, 0);

  // q·scale·log2 e as split A fragments: a0 (g, t), a1 (g + 8, t),
  // a2 (g, t + 4), a3 (g + 8, t + 4) of each 8 columns
  uint32_t qb[KS][4], qs[KS][4];
  {
    const float* qp = q + b * st[0] + h * st[1];
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = r0 + g + (i & 1) * 8, col = kk * 8 + t + (i >> 1) * 4;
        const float x =
            row < sq && col < d ? qp[row * st[2] + col] * qscale : 0.f;
        split(x, qb[kk][i], qs[kk][i]);
      }
  }
  float o[KS][4], m[2] = {LVV_NEG_BIG, LVV_NEG_BIG}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int c = 0; c < KS; ++c)
#pragma unroll
    for (int j = 0; j < 4; ++j) o[c][j] = 0.f;

  // One barrier a tile: tile i + 1 is split into the other pair buffer
  // while tile i's products run, and tile i + 2 loads into the raw stage
  // that tile i left.
  const float* kb = k + b * st[3] + hk * st[4];
  const float* vb = v + b * st[6] + hk * st[7];
  auto raw = [&](int i) { return smem + 2 * (i % 2) * T::RAW; };
  auto load = [&](int i) {
    if (i < n_tiles)
      load_tile<DP>(raw(i), raw(i) + T::RAW, kb, vb, st[5], st[8],
                    (t_begin + i) * BN, sk, d, vec);
    cp_commit();
  };
  load(0);
  load(1);
  cp_wait<1>();
  __syncthreads();
  if (n_tiles > 0) split_tile<DP>(pairs, raw(0), raw(0) + T::RAW);
  auto buf = [&](int i) { return pairs + i % 2 * T::PAIRS; };
  for (int i = 0; i < n_tiles; ++i) {
    cp_wait<0>();                      // tile i + 1's copies (this thread's)
    __syncthreads();                   // everyone's; tile i split, i - 1 read
    load(i + 2);
    if (i + 1 < n_tiles)
      split_tile<DP>(buf(i + 1), raw(i + 1), raw(i + 1) + T::RAW);
    if (!active) continue;
    float p[BN / 8][4], alpha[2];
    scores<DP>(buf(i), (t_begin + i) * BN, limit, causal, r0, offset, g, t,
               qb, qs, m, l, p, alpha);
    values<DP>(buf(i), g, t, p, alpha, o);
  }
  if (!active) return;

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    if (row >= sq) continue;
    if (n_split == 1) {
      float* op = out + b * st[9] + h * st[10] + (long long)row * st[11];
      const float inv = 1.f / fmaxf(l[r], 1e-30f);
#pragma unroll
      for (int c = 0; c < KS; ++c)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = c * 8 + 2 * t + j;
          if (col < d) op[col] = o[c][2 * r + j] * inv;
        }
    } else {
      const int nb = gridDim.z / n_split;
      const long long rr = (((long long)split_i * nb + b) * hq + h) * sq + row;
      float* op = part_o + rr * d;
#pragma unroll
      for (int c = 0; c < KS; ++c)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = c * 8 + 2 * t + j;
          if (col < d) op[col] = o[c][2 * r + j];
        }
      if (t == 0) {
        part_ml[2 * rr] = m[r];
        part_ml[2 * rr + 1] = l[r];
      }
    }
  }
}

// One warp a row: out = sum_s w_s o_s / max(sum_s w_s l_s, 1e-30) with
// w_s = 2^(m_s - M) over the splits that saw a key (l_s > 0). The lanes
// take the splits for M, the weights and the sum of w·l, then the columns
// (2 a lane), each split's weight passed round by a shuffle.
__global__ void flash_f32_combine(const float* __restrict__ part_o,
                                  const float2* __restrict__ part_ml,
                                  float* __restrict__ out, int n_split,
                                  int rows, int hq, int sq, int d,
                                  long long osb, long long osh,
                                  long long oss) {
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  float mx = LVV_NEG_BIG;
  for (int sp = lane; sp < n_split; sp += 32) {
    const float2 ml = part_ml[(long long)sp * rows + row];
    if (ml.y > 0.f) mx = fmaxf(mx, ml.x);
  }
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  float den = 0.f, acc0 = 0.f, acc1 = 0.f;
  for (int s0 = 0; s0 < n_split; s0 += 32) {
    float w = 0.f;
    if (s0 + lane < n_split) {
      const float2 ml = part_ml[(long long)(s0 + lane) * rows + row];
      if (ml.y > 0.f) {
        w = exp2f(ml.x - mx);
        den += w * ml.y;
      }
    }
    const int cnt = min(32, n_split - s0);
#pragma unroll 8
    for (int j = 0; j < cnt; ++j) {
      const float wj = __shfl_sync(0xffffffffu, w, j);
      const float* po = part_o + ((long long)(s0 + j) * rows + row) * d;
      if (lane < d) acc0 += wj * po[lane];
      if (lane + 32 < d) acc1 += wj * po[lane + 32];
    }
  }
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1)
    den += __shfl_xor_sync(0xffffffffu, den, o);
  const float inv = 1.f / fmaxf(den, 1e-30f);
  const int qi = row % sq, h = (row / sq) % hq, b = row / (sq * hq);
  float* op = out + b * osb + h * osh + (long long)qi * oss;
  if (lane < d) op[lane] = acc0 * inv;
  if (lane + 32 < d) op[lane + 32] = acc1 * inv;
}

template <int DP>
int launch(const float* q, const float* k, const float* v, const int* kv_len,
           float* out, float* part_o, float* part_ml, int b, int hq, int hkv,
           int sq, int sk, int d, int causal, int n_split, float scale,
           const long long* st, cudaStream_t stream) {
  using T = Tile<DP>;
  cudaError_t e = cudaFuncSetAttribute(
      flash_f32_tc<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::BYTES);
  if (e != cudaSuccess) return (int)e;
  // flash_f32_plan's rule: the fewest blocks of at most 7 row tiles, the
  // row tiles evened out over them
  const int row_tiles = (sq + ROWS - 1) / ROWS;
  const int q_blocks = (row_tiles + MAX_WARPS - 1) / MAX_WARPS;
  const int warps = (row_tiles + q_blocks - 1) / q_blocks;
  const int kv_tiles = (sk + BN - 1) / BN;
  const int tps = (kv_tiles + n_split - 1) / n_split;
  // 16-byte copies where every K / V row starts 16-byte aligned
  bool vec = d % 4 == 0 && (uintptr_t)k % 16 == 0 && (uintptr_t)v % 16 == 0;
  for (int i = 3; i < 9; ++i) vec = vec && st[i] % 4 == 0;
  Strides strides;
  for (int i = 0; i < 12; ++i) strides.s[i] = st[i];
  dim3 grid(q_blocks, hq, b * n_split);
  flash_f32_tc<DP><<<grid, warps * 32, T::BYTES, stream>>>(
      q, k, v, kv_len, out, part_o, part_ml, hq, hkv, sq, sk, d, causal,
      scale * LOG2E, n_split, tps, (int)vec, strides);
  e = cudaGetLastError();
  if (e != cudaSuccess || n_split == 1) return (int)e;
  const long long rows = (long long)b * hq * sq;
  flash_f32_combine<<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
      part_o, reinterpret_cast<const float2*>(part_ml), out, n_split,
      (int)rows, hq, sq, d, st[9], st[10], st[11]);
  return (int)cudaGetLastError();
}

}  // namespace

// q [B, Hq, Sq, D], k / v [B, Hkv, Sk, D], out [B, Hq, Sq, D], all fp32 with
// unit stride on D and D <= 64. `strides` holds the (batch, head, seq)
// element strides of q, k, v and out in that order. kv_len is a device
// int32 [B] or null.
// n_split > 1 splits the kv axis (flash_f32_plan's count): part_o (fp32
// [n_split, B, Hq, Sq, D]) and part_ml (fp32 [n_split, B, Hq, Sq, 2]) are
// the caller's scratch, unused otherwise. Returns a cudaError_t (0 on
// success).
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
  if (b < 1 || hq < 1 || sq < 1) return 0;
  const float* qf = (const float*)q;
  const float* kf = (const float*)k;
  const float* vf = (const float*)v;
  const int* kl = (const int*)kv_len;
  float* of = (float*)out;
  float* po = (float*)part_o;
  float* pm = (float*)part_ml;
#define LVV_F32_CASE(DP)                                                   \
  case DP:                                                                 \
    return launch<DP>(qf, kf, vf, kl, of, po, pm, b, hq, hkv, sq, sk, d,   \
                      causal, n_split, scale, strides, s);
  switch ((d + 7) / 8 * 8) {
    LVV_F32_CASE(8)
    LVV_F32_CASE(16)
    LVV_F32_CASE(24)
    LVV_F32_CASE(32)
    LVV_F32_CASE(40)
    LVV_F32_CASE(48)
    LVV_F32_CASE(56)
    LVV_F32_CASE(64)
  }
#undef LVV_F32_CASE
  return (int)cudaErrorInvalidValue;
}
