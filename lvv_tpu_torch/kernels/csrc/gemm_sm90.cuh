// The GEMM core for sm_90a that the two MLP kernels, ln_mlp_residual.cu
// (K-b, bf16) and ln_mlp_residual_q8.cu (K-f, int8), and SAM's W8A8
// projection w8a8_matmul.cu (K-i, int8) share: a block computes
// [128, BN] tiles of D = A · B with A [M, K] K-major (the token rows) and B
// either [K, N] row-major (bf16 weights, read MN-major through wgmma's
// transpose bit) or [N, K] (int8 weights, K-major: 8-bit wgmma has no
// transpose bit), and hands the accumulators to an epilogue functor.
//
// Block: two consumer warpgroups of 64 rows each and one producer warp, 288
// threads. Tiles are [128, BN]:
//   BN = 128: two blocks an SM (at most 112 registers a thread: the
//     m64n128 accumulators take 64), so that one block's epilogue runs
//     beside the other block's products: the products with a heavy
//     epilogue (the activation) take these;
//   BN = 256: one block an SM (the accumulators take 128 registers). Its
//     wgmma reads 10 KB of shared memory for 2^19 operations where two
//     m64n128 read 12 KB, and shared memory's 128 bytes a clock (the TMA
//     writes included) bounds both: faster for bf16 at SAM's second
//     product, slower at CLIP's few tiles and for int8 (mlp_ab.py, PERF.md).
//     K-b's second product takes it where it leaves at least two waves of
//     tiles (`mlp_plan`).
// The producer keeps a ring of A / B stages in flight by TMA (mbarriers
// full / empty per stage, as attn_sm90.cuh); each stage holds 128 bytes of
// K a row (64 bf16 or 128 int8 values) in 128-byte-swizzled panels:
//   A: [128 rows][128 B], one TMA box;
//   B, bf16 [K, N]: BN / 64 panels of [64 k rows][64 n], one box each,
//     wgmma descriptor with LBO = the panel stride and SBO = 8 k rows;
//   B, int8 [N, K]: [BN rows][128 B], one box.
// A consumer warpgroup issues the stage's four k-steps (k16 bf16, k32
// int8) as one wgmma group, keeps one group in flight (wait_group 1) and
// frees the stage before. The blocks walk over the output tiles
// (persistent), so the ring refills while the consumers run an epilogue.
// Tensor maps are 4-d (dims innermost first): a GEMM over a slice z of K
// reads boxes at (k, row, z, 0), so a K range split into slices of their
// own (K-f's hidden chunks) is a third map dimension whose first extent is
// the slice: TMA zero-fills past it.
//
// Accumulator layout of m64nN (both types), warp w of the warpgroup,
// g = lane / 4, t = lane % 4: d[4j + 0..1] = row 16w + g, columns 8j + 2t,
// +1; d[4j + 2..3] = row 16w + g + 8, the same columns.
#pragma once

#include "attn_sm90.cuh"

namespace sm90 {

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// attn_sm90.cuh's fence_regs for the int32 accumulators
template <int N>
__device__ __forceinline__ void fence_regs(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// wgmma m64nNk16 bf16 (A K-major, B MN-major) and m64nNk32 s8 (both
// K-major), A and B from shared memory; `acc` 0 overwrites d. The operand
// lists are spelled out for the N the kernels use.
template <int N>
struct WgBf16T;
template <int N>
struct WgS8;

template <> struct WgBf16T<128> {
  static __device__ __forceinline__ void mma(float* d, uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(acc));
  }
};

template <> struct WgS8<128> {
  static __device__ __forceinline__ void mma(int* d, uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
          "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
          "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
          "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
          "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(a), "l"(b), "r"(acc));
  }
};

template <> struct WgBf16T<256> {
  static __device__ __forceinline__ void mma(float* d, uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
          "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
          "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
          "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
          "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(a), "l"(b), "r"(acc));
  }
};

// The MLP's activation on an fp32 value: tanh GELU (jax.nn.gelu's default
// approximation) as 0.5 z (1 + tanh u) = z / (1 + exp(-2u)), a few fp32
// ulps from the tanhf form (far under the bf16 ulp h is rounded to), without
// its cancellation for negative z and at a third of its instructions (the
// first product's epilogue is issue-bound); QuickGELU z / (1 + exp(-1.702
// z)).
template <int ACT>
__device__ __forceinline__ float mlp_act(float z) {
  if (ACT == 0) {
    const float u = 0.7978845608028654f * (z + 0.044715f * z * z * z);
    return __fdividef(z, 1.f + __expf(-2.f * u));
  }
  return __fdividef(z, 1.f + __expf(-1.702f * z));
}

// Two neighbouring bf16 values (4-byte aligned) of read-only data as
// floats. The epilogues load their biases, scales and residual through the
// read-only path (ld.global.nc): the compiler cannot tell that the output
// does not alias them, and plain loads would wait behind every store before
// them (K-f's first epilogue, with an activation between load and store,
// was the slowest part of K-f at serving-batch[8]'s shapes).
__device__ __forceinline__ float2 load_bf2(const bf16* p) {
  return __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(p)));
}

// bf16 operands: B [K, N] row-major, fp32 accumulators
struct OpBf16 {
  typedef float Acc;
  static constexpr int BK = 64;          // K values a stage (128 bytes)
  static constexpr bool kBKMajor = false;
  static constexpr CUtensorMapDataType kType = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  template <int BN>
  static __device__ __forceinline__ void mma(float* d, uint32_t a,
                                             uint32_t b, int ks) {
    WgBf16T<BN>::mma(d, desc_sw128(a + ks * 32, 16, 1024),
                     desc_sw128(b + ks * 2048, 64 * 128, 1024), 1);
  }
};

// int8 operands: B [N, K], exact int32 accumulators
struct OpS8 {
  typedef int Acc;
  static constexpr int BK = 128;
  static constexpr bool kBKMajor = true;
  static constexpr CUtensorMapDataType kType = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  template <int BN>
  static __device__ __forceinline__ void mma(int* d, uint32_t a, uint32_t b,
                                             int ks) {
    WgS8<BN>::mma(d, desc_sw128(a + ks * 32, 16, 1024),
                  desc_sw128(b + ks * 32, 16, 1024), 1);
  }
};

// The block's tile and ring: [128, 128] tiles two blocks an SM (at most
// 112 registers a thread) with 3 stages each, [128, 256] tiles one block
// an SM with 4.
template <int BN_>
struct GemmCfg {
  static constexpr int BM = 128;                 // token rows a tile
  static constexpr int BN = BN_;                 // columns a tile
  static constexpr int CTAS = BN == 256 ? 1 : 2; // blocks an SM
  static constexpr int A_BYTES = BM * 128;
  static constexpr int STAGE = A_BYTES + BN * 128;
  static constexpr int STAGES = BN == 256 ? 4 : 3;
  static constexpr int BAR_OFF = STAGES * STAGE;
  static constexpr int SMEM = BAR_OFF + 2 * STAGES * 8 + kSmemAlign;
  static constexpr int THREADS = 288;            // 2 consumer warpgroups + 1
};

// Persistent: block b computes the [128, BN] tiles b, b + gridDim.x, ...
// of the (slice, row tile, column tile) grid, column tiles fastest (the
// blocks in flight share their A rows and the whole of B in L2), each over
// k_tiles stages. The producer runs on into the next tile while the
// consumers finish one, so the ring refills under the epilogue.
// epi.run(acc, row, n0, z) gets the accumulators with the thread's first
// row (its second is row + 8) and the tile's first column and slice.
template <class Op, int BN, class Epi>
__global__ void __launch_bounds__(288, GemmCfg<BN>::CTAS)
mlp_gemm_sm90(const __grid_constant__ CUtensorMap amap,
              const __grid_constant__ CUtensorMap bmap, int tiles_n,
              int tiles_m, int slices, int k_tiles, const Epi epi) {
  using C = GemmCfg<BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::BAR_OFF);
  uint64_t* empty = full + C::STAGES;
  const int tiles = tiles_n * tiles_m * slices;
  if (threadIdx.x == 0) {
    for (int i = 0; i < C::STAGES; ++i) {
      bar_init(&full[i], 1);
      bar_init(&empty[i], 8);   // one arrival per consumer warp
    }
    bar_fence_init();
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  if (warp == 8) {
    // ---- producer: one thread issues every TMA load
    if (lane == 0) {
      int it = 0;                 // stages filled so far, over all tiles
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int n0 = (tile % tiles_n) * BN;
        const int m0 = (tile / tiles_n % tiles_m) * C::BM;
        const int z = tile / (tiles_n * tiles_m);
        for (int i = 0; i < k_tiles; ++i, ++it) {
          const int st = it % C::STAGES;
          if (it >= C::STAGES)
            bar_wait(&empty[st], ((it / C::STAGES) - 1) & 1);
          bar_expect_tx(&full[st], C::STAGE);
          unsigned char* a = smem + st * C::STAGE;
          unsigned char* b = a + C::A_BYTES;
          tma_load(a, &amap, &full[st], i * Op::BK, m0, z, 0);
          if (Op::kBKMajor) {
            tma_load(b, &bmap, &full[st], i * Op::BK, n0, z, 0);
          } else {
#pragma unroll
            for (int p = 0; p < BN / 64; ++p)
              tma_load(b + p * 64 * 128, &bmap, &full[st], n0 + 64 * p,
                       i * Op::BK, z, 0);
          }
        }
      }
    }
    return;
  }
  // ---- consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of a tile
  const int wg = warp / 4;
  int it = 0;                     // stages consumed so far
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    typename Op::Acc acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    for (int i = 0; i < k_tiles; ++i, ++it) {
      const int st = it % C::STAGES;
      bar_wait(&full[st], (it / C::STAGES) & 1);
      const uint32_t a = smem_u32(smem + st * C::STAGE) + wg * 64 * 128;
      const uint32_t b = smem_u32(smem + st * C::STAGE + C::A_BYTES);
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) Op::template mma<BN>(acc, a, b, ks);
      wg_commit();
      wg_wait<1>();           // the previous stage's group is done
      if (i > 0) {
        __syncwarp();
        if (lane == 0) bar_arrive(&empty[(it - 1) % C::STAGES]);
      }
    }
    wg_wait<0>();
    __syncwarp();
    if (lane == 0) bar_arrive(&empty[(it - 1) % C::STAGES]);
    fence_regs(acc);
    epi.template run<BN>(acc,
                         (tile / tiles_n % tiles_m) * C::BM + wg * 64 +
                             (warp & 3) * 16 + (lane >> 2),
                         (tile % tiles_n) * BN, tile / (tiles_n * tiles_m));
  }
}

// A 4-d tensor map over `base` (dims innermost first, byte strides of dims
// 1..3 multiples of 16) read in boxes of 128 bytes by box1 by 1 by 1 with the
// 128-byte swizzle; zero past the bounds.
static cudaError_t gemm_map(CUtensorMap* map, CUtensorMapDataType type,
                            const void* base, const cuuint64_t (&dims)[4],
                            const cuuint64_t (&strides)[3], uint32_t box1) {
  EncodeTiledFn encode;
  const cudaError_t e = tiled_encoder(&encode);
  if (e != cudaSuccess) return e;
  const cuuint32_t box[4] = {
      type == CU_TENSOR_MAP_DATA_TYPE_UINT8 ? 128u : 64u, box1, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, type, 4, const_cast<void*>(base), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Launch D = A · B over a grid of (column tiles, row tiles, slices).
//   A: [M, K] rows of `lda` elements; slice z covers K values
//      [z·kc, z·kc + kc) (kc = K for one slice).
//   B: OpBf16 [K, N] rows of ldb elements; OpS8 [N, K] rows of ldb.
template <class Op, int BN, class Epi>
static int gemm_launch(const void* a, long long lda, const void* b,
                       long long ldb, int m, int n, int kc, int slices,
                       const Epi& epi, cudaStream_t stream) {
  using C = GemmCfg<BN>;
  typedef cuuint64_t u64;
  const u64 es = Op::kBKMajor ? 1 : 2;
  const u64 ad[4] = {(u64)kc, (u64)m, (u64)slices, 1};
  const u64 as[3] = {(u64)lda * es, (u64)kc * es, (u64)kc * es * slices};
  CUtensorMap am, bm;
  cudaError_t e = gemm_map(&am, Op::kType, a, ad, as, C::BM);
  if (e != cudaSuccess) return (int)e;
  if (Op::kBKMajor) {
    const u64 bd[4] = {(u64)kc, (u64)n, (u64)slices, 1};
    const u64 bs[3] = {(u64)ldb * es, (u64)kc * es, (u64)kc * es * slices};
    e = gemm_map(&bm, Op::kType, b, bd, bs, C::BN);
  } else {
    const u64 bd[4] = {(u64)n, (u64)kc, (u64)slices, 1};
    const u64 bs[3] = {(u64)ldb * es, (u64)kc * ldb * es,
                       (u64)kc * ldb * es * slices};
    e = gemm_map(&bm, Op::kType, b, bd, bs, Op::BK);
  }
  if (e == cudaSuccess) e = allow_smem(mlp_gemm_sm90<Op, BN, Epi>, C::SMEM);
  static int sms = 0;           // the card's SMs, asked once
  if (e == cudaSuccess && !sms) {
    int dev = 0;
    e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e != cudaSuccess) return (int)e;
  const int tiles_n = (n + C::BN - 1) / C::BN;
  const int tiles_m = (m + C::BM - 1) / C::BM;
  const int blocks = min(tiles_n * tiles_m * slices, sms * C::CTAS);
  mlp_gemm_sm90<Op, BN, Epi><<<blocks, C::THREADS, C::SMEM, stream>>>(
      am, bm, tiles_n, tiles_m, slices, (kc + Op::BK - 1) / Op::BK, epi);
  return (int)cudaGetLastError();
}

}  // namespace sm90
