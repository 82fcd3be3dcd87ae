// Weight-only int8 matmul for the port's serving decode:
//   out[m, n] = T( sum_k x[m, k] * q[k, n] * s[n] )
// x [M, K] bf16 or fp32, q [K, N] int8 as stored (per-column scales s [N]
// fp32), fp32 accumulation, the scale applied once on the output side and
// one rounding to x's type.
//
// Replaces lvv_tpu/ops/quant.py::_qmv_kernel (reached through
// quantized_matmul), TPU kernel K-j. On the serving path it is every int8
// product of the packed decode at M = 1: qkv 896 -> 1152, o 896 -> 896,
// gate|up 896 -> 9728 and down 4864 -> 896, 4 per layer and step (where the
// JAX decode lets XLA fuse the int8 -> bf16 convert into its dots).
//
// What bounds it on the H100: at decode batch sizes (M <= 8) it does
// 2·M·K·N operations on K·N weight bytes, far below ~295 operations per
// byte: device memory bounds it, and the weight has to stream at HBM's rate
// from every SM at once. At these sizes (0.8-8.7 MB) the call is also short
// enough that filling the card and the launch's fixed costs matter.
//
// Design (the plan comes from ops/quant.py `qmv_plan`):
//   - The grid is (N tiles of NT columns, K splits, row groups of MT <= 8
//     rows): K is split as well as N, so that N = 896 or 1152 still gives
//     ~224-288 blocks. All of x's rows go through one pass over the weight.
//   - The splits of one N tile are one thread-block cluster (<= 8 blocks).
//     Each block folds its 256 threads' sums into one [MT, NT] partial and
//     stores each share of it into the shared memory of the block that
//     owns that share of the tile (distributed shared memory: mapa /
//     st.shared::cluster); after one cluster barrier, block r adds the
//     partials of ranks 0, 1, ... in that order for its share, scales and
//     stores. No atomics and no second launch; the order of every fp32 sum
//     is fixed, so the result is the same run to run. (Pulling the
//     partials after the barrier instead takes a second barrier and a
//     remote load's latency per rank: 1.4-1.7 us more a call on the H100.)
//   - A thread owns VEC consecutive columns (16, or 8 at MT = 8 where the
//     sums take 64 registers; 4 where N is no multiple of them) of one row
//     of every KL-th weight row of the split: 16-byte loads
//     (ld.global.nc.L1::no_allocate.v4), 8 of them (4 past 16 sums a
//     thread) issued before any is used: at the decode's shapes that is
//     all of a thread's rows at batch 1 (32 KB a block in flight), so each
//     block waits for device memory once. The first loads go out before x
//     is staged. The grid is one wave of the blocks that the registers let
//     an SM hold.
//   - x's rows of the split are staged once in shared memory as fp32
//     [k][MT] (a chunk of K at a time; one chunk at the decode's shapes),
//     read as broadcasts.
//   - Dequantization without cvt: a byte permute puts w ^ 0x80 under the
//     exponent of 2^23 (0x4B0000xx = 2^23 + w + 128) and one subtract of
//     2^23 + 128 leaves w exactly; then one fp32 fma per row of x.
//   - The lanes of a warp that share columns fold their sums by recursive
//     halving (each exchange sends half of the values still held), then
//     the 8 warps' folds are added in warp order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kXFloats = 8192;       // x staging, fp32 values (32 KB)

// A thread's MT·VEC sums set its registers: STAGES weight loads issued
// ahead (8 where the sums take 16 registers, else 4) and the blocks an SM
// the launch bounds keep room for (3 up to 32 sums, else 2). ops/quant.py
// `qmv_plan` sizes the grid to one wave of those.
template <int MT, int VEC>
struct QmvRegs {
  static constexpr int STAGES = MT * VEC <= 16 ? 8 : 4;
  static constexpr int BLOCKS = MT * VEC <= 32 ? 3 : 2;
};

// VEC int8 weights at p (16-, 8- or 4-byte aligned), read once, not kept
// in L1
template <int VEC>
__device__ __forceinline__ void load_w(uint32_t (&w)[VEC / 4],
                                       const signed char* p) {
  if constexpr (VEC == 16)
    asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
        : "=r"(w[0]), "=r"(w[1]), "=r"(w[2]), "=r"(w[3])
        : "l"(p));
  else if constexpr (VEC == 8)
    asm("ld.global.nc.L1::no_allocate.v2.u32 {%0, %1}, [%2];"
        : "=r"(w[0]), "=r"(w[1])
        : "l"(p));
  else
    asm("ld.global.nc.L1::no_allocate.u32 %0, [%1];" : "=r"(w[0]) : "l"(p));
}

// the four int8 of a word as exact floats, lowest byte first
__device__ __forceinline__ void dequant4(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;
  f[0] = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)),
                   8388736.f);
  f[1] = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)),
                   8388736.f);
  f[2] = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)),
                   8388736.f);
  f[3] = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)),
                   8388736.f);
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// a cluster barrier split in two: every block has started (its shared
// memory may be written) once the wait after this arrival returns
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// v to p in the shared memory of the cluster's block `rank`
__device__ __forceinline__ void st_cluster(float* p, uint32_t rank, float v) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  uint32_t ra;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(ra) : "r"(a), "r"(rank));
  asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(ra), "f"(v) : "memory");
}

__device__ __forceinline__ float ld_x(const void* x, long long i, int kind) {
  return kind ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(x)[i])
              : reinterpret_cast<const float*>(x)[i];
}

// One block: N tile blockIdx.x, K split blockIdx.y (rows [ka, ka +
// k_split)), x rows [MT·blockIdx.z, +MT); the cluster is the tile's splits.
template <int MT, int VEC, int NT>
__global__ void __launch_bounds__(kThreads, (QmvRegs<MT, VEC>::BLOCKS))
qmv_kn(const void* __restrict__ x, const signed char* __restrict__ q,
       const float* __restrict__ s, void* __restrict__ out, int m, int k,
       int n, int k_split, int kind) {
  constexpr int CT = NT / VEC;        // threads across the tile's columns
  constexpr int KL = kThreads / CT;   // lanes over K
  constexpr int SH = 32 / CT;         // lanes of a warp on the same columns
  constexpr int V = MT * VEC;         // a thread's sums
  // x staging, then the warps' folded sums [kWarps][MT][NT]
  constexpr int XS = kXFloats > kWarps * MT * NT ? kXFloats : kWarps * MT * NT;
  constexpr int XC = XS / MT;         // rows of x a staging chunk
  constexpr int kStages = QmvRegs<MT, VEC>::STAGES;
  static_assert(V >= SH && XC % KL == 0, "the fold and the chunk walk");
  __shared__ __align__(16) float xs[XS];
  __shared__ float part[MT * NT + 8];   // [rank][share]: the ranks' shares

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ct = tid % CT, kl = tid / CT, lrow = lane / CT;
  const int col = blockIdx.x * NT + ct * VEC;     // the thread's first column
  const bool on = col < n;                         // n is a multiple of VEC
  const int m0 = blockIdx.z * MT, rows = min(MT, m - m0);
  const int ka = blockIdx.y * k_split, kb = min(k, ka + k_split);

  cluster_arrive_relaxed();   // waited for before the first remote store
  float acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.f;
  uint32_t w[kStages][VEC / 4];
  // the loads of a batch of rows [r0, r0 + KL·kStages) of the chunk at kc
  auto fetch = [&](int kc, int cnt, int r0) {
    const signed char* qc = q + (long long)kc * n + col;
#pragma unroll
    for (int u = 0; u < kStages; ++u)
      if (on && r0 + u * KL < cnt)
        load_w<VEC>(w[u], qc + (long long)(r0 + u * KL) * n);
  };
  fetch(ka, min(XC, kb - ka), kl);   // under the staging of x
  for (int kc = ka; kc < kb; kc += XC) {
    const int cnt = min(XC, kb - kc);
    if (kc > ka) __syncthreads();
    for (int i = tid; i < MT * cnt; i += kThreads) {
      const int mm = i / cnt, r = i - mm * cnt;
      xs[r * MT + mm] =
          mm < rows ? ld_x(x, (long long)(m0 + mm) * k + kc + r, kind) : 0.f;
    }
    __syncthreads();
    for (int r0 = kl; r0 < cnt; r0 += KL * kStages) {
      if (kc > ka || r0 > kl) fetch(kc, cnt, r0);
#pragma unroll
      for (int u = 0; u < kStages; ++u) {
        const int r = r0 + u * KL;
        if (!on || r >= cnt) break;
        float xv[MT];
#pragma unroll
        for (int mm = 0; mm < MT; ++mm) xv[mm] = xs[r * MT + mm];
#pragma unroll
        for (int c4 = 0; c4 < VEC / 4; ++c4) {
          float f[4];
          dequant4(w[u][c4], f);
#pragma unroll
          for (int mm = 0; mm < MT; ++mm)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[mm * VEC + 4 * c4 + e] =
                  fmaf(xv[mm], f[e], acc[mm * VEC + 4 * c4 + e]);
        }
      }
    }
  }

  // the SH lanes on the same columns: recursive halving, lane-row bit s at
  // step s; a lane then holds sums base .. base + V / SH - 1
  constexpr int LOG = SH >= 32 ? 5 : SH >= 16 ? 4 : SH >= 8 ? 3
                    : SH >= 4 ? 2 : SH >= 2 ? 1 : 0;
  int base = 0;
#pragma unroll
  for (int st = 0; st < LOG; ++st) {
    const int half = V >> (st + 1);
    const bool up = (lrow >> st) & 1;
#pragma unroll
    for (int i = 0; i < V / 2; ++i) {
      if (i < half) {
        const float send = up ? acc[i] : acc[i + half];
        const float keep = up ? acc[i + half] : acc[i];
        acc[i] = keep + __shfl_xor_sync(0xffffffffu, send, CT << st);
      }
    }
    base += up ? half : 0;
  }
  __syncthreads();   // x's chunk is read: its room takes the warps' sums
#pragma unroll
  for (int i = 0; i < V / SH; ++i) {
    const int idx = base + i, mm = idx / VEC;
    xs[(warp * MT + mm) * NT + ct * VEC + idx % VEC] = acc[i];
  }
  __syncthreads();
  // the block's partial, each element to the block that owns its share
  const int ranks = gridDim.y;                 // the cluster is the splits
  const int rank = (int)cluster_rank();
  const int share = (MT * NT + ranks - 1) / ranks;
  cluster_wait();             // every block of the cluster has started
  for (int e = tid; e < MT * NT; e += kThreads) {
    float v = xs[e];
#pragma unroll
    for (int wp = 1; wp < kWarps; ++wp) v += xs[wp * MT * NT + e];
    const int owner = e / share;
    st_cluster(part + rank * share + e - owner * share, owner, v);
  }
  cluster_sync();
  // this block's share of the tile: the ranks' partials in rank order
  for (int i = tid; i < share && rank * share + i < MT * NT; i += kThreads) {
    float v = part[i];
    for (int r = 1; r < ranks; ++r) v += part[r * share + i];
    const int e = rank * share + i;
    const int mm = e / NT, oc = blockIdx.x * NT + e % NT;
    if (mm < rows && oc < n) {
      const float y = v * s[oc];
      const long long o = (long long)(m0 + mm) * n + oc;
      if (kind)
        reinterpret_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16(y);
      else
        reinterpret_cast<float*>(out)[o] = y;
    }
  }
}

template <int MT, int VEC, int NT>
static int launch(const void* x, const void* q, const void* s, void* out,
                  int m, int k, int n, int k_split, int splits, int stages,
                  int kind, cudaStream_t st) {
  if (stages != QmvRegs<MT, VEC>::STAGES) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n + NT - 1) / NT, splits, (m + MT - 1) / MT);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, qmv_kn<MT, VEC, NT>, x, (const signed char*)q, (const float*)s,
      out, m, k, n, k_split, kind);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

template <int MT, int VEC>
static int launch_nt(int n_tile, const void* x, const void* q, const void* s,
                     void* out, int m, int k, int n, int k_split, int splits,
                     int stages, int kind, cudaStream_t st) {
  if (n_tile == 32)
    return launch<MT, VEC, 32>(x, q, s, out, m, k, n, k_split, splits, stages,
                               kind, st);
  if (n_tile == 128)
    return launch<MT, VEC, 128>(x, q, s, out, m, k, n, k_split, splits,
                                stages, kind, st);
  return (int)cudaErrorInvalidValue;
}

// x [m, k] (kind 0 = fp32, 1 = bf16), q [k, n] int8, s [n] fp32, out [m, n]
// of x's type; all contiguous, q 16-byte aligned. The plan of ops/quant.py
// `qmv_plan`: N tiles of n_tile (32 or 128) columns, `splits` K ranges of
// k_split rows (one cluster of `cluster` == splits <= 8 blocks), `stages`
// loads ahead (QmvRegs), `rows` rows of x a block (1, 2, 4 or 8), `vec`
// columns a thread (16; 8 where rows is 8; 4), n a multiple of vec.
// Returns a cudaError_t.
extern "C" int lvv_int8_matmul(const void* x, const void* q, const void* s,
                               void* out, int m, int k, int n, int kind,
                               int n_tile, int splits, int cluster,
                               int k_split, int stages, int rows, int vec,
                               void* stream) {
  if (m <= 0 || k <= 0 || n <= 0 || kind < 0 || kind > 1 || n % vec ||
      splits < 1 || splits > 8 || cluster != splits ||
      k_split <= 0 || (long long)k_split * (splits - 1) >= k ||
      (long long)k_split * splits < k)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define LVV_QMV(MT, VEC)                                                   \
  if (rows == MT && vec == VEC)                                            \
    return launch_nt<MT, VEC>(n_tile, x, q, s, out, m, k, n, k_split,      \
                              splits, stages, kind, st);
  LVV_QMV(1, 16) LVV_QMV(2, 16) LVV_QMV(4, 16) LVV_QMV(8, 8)
  LVV_QMV(1, 4) LVV_QMV(2, 4) LVV_QMV(4, 4) LVV_QMV(8, 4)
#undef LVV_QMV
  return (int)cudaErrorInvalidValue;
}
