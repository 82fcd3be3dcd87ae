// Flash attention forward for the port (bf16 in and out, fp32 softmax).
//
// Replaces lvv_tpu/ops/attention.py::_flash_kernel (reached through
// _flash_attention_tpu and flash_attention), TPU kernel K-e. On the main path
// it runs the VAT cross-attentions (q 768 over kv 1536 at head dim 256, and
// over kv 32,400 at head dim 112) and the causal Qwen prefill (1564 tokens,
// 14 q heads over 2 kv heads, head dim 64).
//
// What bounds it on the H100: the score and value products, 4·Sq·Sk·D
// operations per head, against reading q, k, v once. At these shapes that is
// far above the card's ~295 operations per byte, so the bf16 tensor-core rate
// bounds it, and only wgmma reaches that rate.
//
// Design (attn_sm90.cuh): one block owns 128 q rows of one (batch, head) and
// a range of kv tiles. Two consumer warpgroups own 64 q rows each: S = q·kᵀ
// and O += P·V are wgmma, the online softmax runs on the accumulators in
// registers. A producer warp keeps a ring of K / V tiles full with TMA
// (mbarrier full / empty per stage), so loads overlap the products; the
// producer warpgroup gives its registers to the consumers (setmaxnreg).
// The TPU walks kv tiles as a sequential grid axis with its softmax state in
// VMEM; here the kv axis is also split across blocks when the q tiles, heads
// and batch alone give too few blocks to fill the 132 SMs (VATLiDAR: 48).
// Each split then writes fp32 (o, m, l) partials and a combine kernel merges
// them and rounds to bf16 once. The split count comes from the shapes only
// (the wrapper's `flash_splits`), so results repeat run to run. GQA reads kv
// head h / (Hq / Hkv) directly. The causal mask keeps the Sk - Sq offset;
// kv_len masks per batch row and, with causal, bounds the kv loop as the TPU
// kernel's `limit` does; a split wholly past that bound has l = 0 and weight
// 0 in the combine. Head dim 112 reads two 64-column panels (TMA zero-fills
// the columns past 112) and issues the 7 k-steps of 112 only.
#include "attn_sm90.cuh"

using namespace sm90;

template <int D>
struct FlashCfg {
  static constexpr int BQ = 128;                   // q rows a block
  static constexpr int BN = D > 128 ? 64 : 128;    // kv rows a tile
  static constexpr int STAGES = D > 128 ? 2 : 3;
  static constexpr int PANELS = (D + 63) / 64;
  static constexpr int DP = PANELS * 64;           // O's columns
  static constexpr int Q_PB = BQ * 128;            // bytes of a q panel
  static constexpr int KV_PB = BN * 128;           // bytes of a K / V panel
  static constexpr int Q_BYTES = PANELS * Q_PB;
  static constexpr int TILE_BYTES = PANELS * KV_PB;   // K or V
  static constexpr int BAR_OFF = Q_BYTES + STAGES * 2 * TILE_BYTES;
  static constexpr int SMEM = BAR_OFF + (2 * STAGES + 1) * 8 + kSmemAlign;
  static constexpr int THREADS = 3 * 128;   // 2 consumer warpgroups, producer
};

template <int D>
__global__ void __launch_bounds__(FlashCfg<D>::THREADS, 1)
flash_sm90(const __grid_constant__ CUtensorMap qmap,
           const __grid_constant__ CUtensorMap kmap,
           const __grid_constant__ CUtensorMap vmap,
           const int* __restrict__ kv_len, bf16* __restrict__ out,
           float* __restrict__ part_o, float* __restrict__ part_ml, int hq,
           int hkv, int sq, int sk, int causal, float scale_log2, int n_split,
           int tiles_per_split, long long osb, long long osh, long long oss) {
  using C = FlashCfg<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  unsigned char* ring = smem + C::Q_BYTES;   // stage i: K then V
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::BAR_OFF);
  uint64_t* empty = full + C::STAGES;
  uint64_t* q_bar = empty + C::STAGES;

  const int q_start = blockIdx.x * C::BQ, h = blockIdx.y;
  const int b = blockIdx.z / n_split, split = blockIdx.z % n_split;
  const int hk = h / (hq / hkv);
  const int offset = sk - sq;
  const int limit = kv_len ? min(kv_len[b], sk) : sk;
  const int kv_end = causal ? min(limit, q_start + C::BQ + offset) : limit;
  const int n_tiles = kv_end > 0 ? (kv_end + C::BN - 1) / C::BN : 0;
  const int t_begin = split * tiles_per_split;
  const int n_t = max(0, min(n_tiles, t_begin + tiles_per_split) - t_begin);

  if (threadIdx.x == 0) {
    for (int i = 0; i < C::STAGES; ++i) {
      bar_init(&full[i], 1);
      bar_init(&empty[i], 8);   // one arrival per consumer warp
    }
    bar_init(q_bar, 1);
    bar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread issues every TMA load
    regs_dec<40>();
    if (threadIdx.x == 256) {
      bar_expect_tx(q_bar, C::Q_BYTES);
      for (int a = 0; a < C::PANELS; ++a)
        tma_load(smem + a * C::Q_PB, &qmap, q_bar, a * 64, q_start, h, b);
      for (int i = 0; i < n_t; ++i) {
        const int st = i % C::STAGES;
        if (i >= C::STAGES) bar_wait(&empty[st], ((i / C::STAGES) - 1) & 1);
        bar_expect_tx(&full[st], 2 * C::TILE_BYTES);
        unsigned char* kt = ring + st * 2 * C::TILE_BYTES;
        const int k0 = (t_begin + i) * C::BN;
        for (int a = 0; a < C::PANELS; ++a) {
          tma_load(kt + a * C::KV_PB, &kmap, &full[st], a * 64, k0, hk, b);
          tma_load(kt + C::TILE_BYTES + a * C::KV_PB, &vmap, &full[st],
                   a * 64, k0, hk, b);
        }
      }
    }
  } else {
    // ---- consumers: 64 q rows each
    regs_inc<232>();
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const int t = lane & 3;
    const int r0 = q_start + wg * 64 + warp * 16 + (lane >> 2), r1 = r0 + 8;
    const int wg_first = q_start + wg * 64;   // the warpgroup's first row
    const uint32_t q_addr = smem_u32(smem) + wg * 64 * 128;
    float o[C::DP / 2];
#pragma unroll
    for (int i = 0; i < C::DP / 2; ++i) o[i] = 0.f;
    float m0 = LVV_NEG_BIG, m1 = LVV_NEG_BIG, l0 = 0.f, l1 = 0.f;
    auto tile = [&](int i) {
      const int st = i % C::STAGES;
      bar_wait(&full[st], (i / C::STAGES) & 1);
      return smem_u32(ring + st * 2 * C::TILE_BYTES);
    };
    auto scores = [&](int i, float (&s)[C::BN / 2]) {
      const int k0 = (t_begin + i) * C::BN;
      if (k0 + C::BN > limit ||
          (causal && k0 + C::BN - 1 > wg_first + offset)) {
#pragma unroll
        for (int j = 0; j < C::BN / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = k0 + 8 * j + 2 * t + (e & 1);
            const int row = e < 2 ? r0 : r1;
            const bool ok = col < limit && (!causal || col <= row + offset);
            s[4 * j + e] = ok ? s[4 * j + e] * scale_log2 : LVV_NEG_BIG;
          }
        }
      } else {
#pragma unroll
        for (int e = 0; e < C::BN / 2; ++e) s[e] *= scale_log2;
      }
    };
    auto release = [&](int i) {
      __syncwarp();
      if (lane == 0) bar_arrive(&empty[i % C::STAGES]);
    };
    bar_wait(q_bar, 0);
    attn_mainloop<D, C::DP, C::BN>(n_t, q_addr, C::Q_PB, C::KV_PB,
                                   C::TILE_BYTES, tile, scores, release, o,
                                   m0, m1, l0, l1);
    if (n_split == 1) {
      l0 = fmaxf(l0, 1e-30f);   // guard, as the JAX kernel's finalize does
      l1 = fmaxf(l1, 1e-30f);
      bf16* ob = out + b * osb + h * osh;
      store_rows<D>(o, r0 < sq ? ob + r0 * oss : nullptr,
                    r1 < sq ? ob + r1 * oss : nullptr, l0, l1);
    } else {
      // fp32 partials of this split: unnormalised o, and (m, l)
      const int nb = gridDim.z / n_split;
      const long long row_base =
          (((long long)split * nb + b) * hq + h) * (long long)sq;
      float* po = part_o + row_base * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        if (r0 < sq)
          *reinterpret_cast<float2*>(po + (long long)r0 * D + 8 * j + 2 * t) =
              make_float2(o[4 * j], o[4 * j + 1]);
        if (r1 < sq)
          *reinterpret_cast<float2*>(po + (long long)r1 * D + 8 * j + 2 * t) =
              make_float2(o[4 * j + 2], o[4 * j + 3]);
      }
      if (t == 0) {
        if (r0 < sq)
          *reinterpret_cast<float2*>(part_ml + 2 * (row_base + r0)) =
              make_float2(m0, l0);
        if (r1 < sq)
          *reinterpret_cast<float2*>(part_ml + 2 * (row_base + r1)) =
              make_float2(m1, l1);
      }
    }
  }
}

// Merge the splits of each row (one warp a row): weights exp2(m_s - M)
// over the splits with l_s > 0 (a split past the row's last key has weight
// 0), then out = sum w·o_s / max(sum w·l_s, 1e-30), rounded to bf16 once.
template <int D>
__global__ void __launch_bounds__(128)
flash_combine(const float* __restrict__ part_o,
              const float* __restrict__ part_ml, bf16* __restrict__ out,
              int n_split, int rows, int hq, int sq, long long osb,
              long long osh, long long oss) {
  const int row = blockIdx.x * 4 + threadIdx.x / 32, lane = threadIdx.x & 31;
  if (row >= rows) return;
  constexpr int PER = (D + 31) / 32;
  float mx = LVV_NEG_BIG;
  for (int sp = 0; sp < n_split; ++sp) {
    const float2 ml = *reinterpret_cast<const float2*>(
        part_ml + 2 * ((long long)sp * rows + row));
    if (ml.y > 0.f) mx = fmaxf(mx, ml.x);
  }
  float acc[PER], l = 0.f;
#pragma unroll
  for (int k = 0; k < PER; ++k) acc[k] = 0.f;
  for (int sp = 0; sp < n_split; ++sp) {
    const long long r = (long long)sp * rows + row;
    const float2 ml = *reinterpret_cast<const float2*>(part_ml + 2 * r);
    if (!(ml.y > 0.f)) continue;
    const float w = exp2f(ml.x - mx);
    l += w * ml.y;
#pragma unroll
    for (int k = 0; k < PER; ++k)
      if (lane + 32 * k < D) acc[k] += w * part_o[r * D + lane + 32 * k];
  }
  l = fmaxf(l, 1e-30f);
  const int q = row % sq, h = (row / sq) % hq, b = row / (sq * hq);
  bf16* o = out + b * osb + h * osh + q * oss;
#pragma unroll
  for (int k = 0; k < PER; ++k)
    if (lane + 32 * k < D) o[lane + 32 * k] = __float2bfloat16(acc[k] / l);
}

template <int D>
static int launch(const void* q, const void* k, const void* v,
                  const int* kv_len, void* out, void* part_o, void* part_ml,
                  int b, int hq, int hkv, int sq, int sk, int causal,
                  int n_split, float scale, const long long* st,
                  cudaStream_t stream) {
  using C = FlashCfg<D>;
  typedef cuuint64_t u64;
  const u64 qd[4] = {(u64)D, (u64)sq, (u64)hq, (u64)b};
  const u64 kd[4] = {(u64)D, (u64)sk, (u64)hkv, (u64)b};
  // byte strides of (seq, head, batch)
  const u64 qs[3] = {(u64)st[2] * 2, (u64)st[1] * 2, (u64)st[0] * 2};
  const u64 ks[3] = {(u64)st[5] * 2, (u64)st[4] * 2, (u64)st[3] * 2};
  const u64 vs[3] = {(u64)st[8] * 2, (u64)st[7] * 2, (u64)st[6] * 2};
  CUtensorMap qm, km, vm;
  cudaError_t e = tensor_map(&qm, q, qd, qs, C::BQ);
  if (e == cudaSuccess) e = tensor_map(&km, k, kd, ks, C::BN);
  if (e == cudaSuccess) e = tensor_map(&vm, v, kd, vs, C::BN);
  if (e == cudaSuccess) e = allow_smem(flash_sm90<D>, C::SMEM);
  if (e != cudaSuccess) return (int)e;
  const int kv_tiles = (sk + C::BN - 1) / C::BN;
  const int tps = (kv_tiles + n_split - 1) / n_split;
  dim3 grid((sq + C::BQ - 1) / C::BQ, hq, b * n_split);
  flash_sm90<D><<<grid, C::THREADS, C::SMEM, stream>>>(
      qm, km, vm, kv_len, (bf16*)out, (float*)part_o, (float*)part_ml, hq,
      hkv, sq, sk, causal, scale * LVV_LOG2E, n_split, tps, st[9], st[10],
      st[11]);
  e = cudaGetLastError();
  if (e != cudaSuccess || n_split == 1) return (int)e;
  const int rows = b * hq * sq;
  flash_combine<D><<<(rows + 3) / 4, 128, 0, stream>>>(
      (const float*)part_o, (const float*)part_ml, (bf16*)out, n_split, rows,
      hq, sq, st[9], st[10], st[11]);
  return (int)cudaGetLastError();
}

// q [B, Hq, Sq, D], k / v [B, Hkv, Sk, D], out [B, Hq, Sq, D], all bf16 with
// unit stride on D, 16-byte aligned, and the other strides multiples of 8;
// `strides` holds the (batch, head, seq) element strides of q, k, v and out
// in that order. kv_len is a device int32 [B] or null. n_split > 1 splits
// the kv axis: part_o (fp32 [n_split, B, Hq, Sq, D]) and part_ml (fp32
// [n_split, B, Hq, Sq, 2]) are the caller's scratch, unused otherwise.
// Returns a cudaError_t (0 on success).
extern "C" int lvv_flash_attention(const void* q, const void* k,
                                   const void* v, const void* kv_len,
                                   void* out, void* part_o, void* part_ml,
                                   int b, int hq, int hkv, int sq, int sk,
                                   int d, int causal, int n_split,
                                   float scale, const long long* strides,
                                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int* kl = (const int*)kv_len;
  if (n_split < 1 || (n_split > 1 && (!part_o || !part_ml)))
    return (int)cudaErrorInvalidValue;
#define LVV_FLASH(D)                                                       \
  case D:                                                                  \
    return launch<D>(q, k, v, kl, out, part_o, part_ml, b, hq, hkv, sq, sk, \
                     causal, n_split, scale, strides, st)
  switch (d) {
    LVV_FLASH(64);
    LVV_FLASH(112);
    LVV_FLASH(128);
    LVV_FLASH(256);
  }
#undef LVV_FLASH
  return (int)cudaErrorInvalidValue;
}
