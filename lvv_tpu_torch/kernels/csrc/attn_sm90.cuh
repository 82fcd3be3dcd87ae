// The attention core for sm_90a that flash_attention.cu (K-e) and the float
// arm of relpos_attention.cu (K-c / K-d) share: warpgroup MMA (wgmma) on
// 128-byte-swizzled shared-memory tiles filled by the Tensor Memory
// Accelerator (TMA), mbarriers, and the online softmax on the wgmma
// accumulators in registers.
//
// Shared-memory tiles. A [rows, D] bf16 operand is kept as ceil(D / 64)
// "panels" of [rows, 64] (128 bytes a row, rows*128 bytes a panel, each
// 1024-byte aligned), in the layout that TMA writes with
// CU_TENSOR_MAP_SWIZZLE_128B: the 16-byte chunk c of row r lies at chunk
// c ^ (r % 8). A head dim that is not a multiple of 64 (112) fills its last
// panel in part; TMA zero-fills the columns past D and only the k-steps
// inside D are issued.
//
// Products (PTX ISA, "Asynchronous Warpgroup Level Matrix Multiply"):
//   S = q·kᵀ: wgmma m64nNk16 with A = q and B = the K tile, both from shared
//     memory and K-major (the head dim contiguous);
//   O += P·V: A = P from registers (rounded to bf16 where the mma.sync loop
//     of common.cuh rounds it), B = the V tile, MN-major (the transpose bit):
//     one m64n64 wgmma per 64-column panel of V, so O spans the head dim
//     rounded up to whole panels (DP = 128 for 112; the zero columns of V
//     give zero columns of O that are not stored).
// Accumulator layout of m64nN, for warp w of the warpgroup, g = lane / 4 and
// t = lane % 4: d[4j + 0..1] = row 16w + g, columns 8j + 2t, +1;
// d[4j + 2..3] = row 16w + g + 8, the same columns. Each row's values lie in
// the four lanes of one quad, as in mma.sync's C fragment, so the quad
// max / sum of common.cuh carry over; and the register A operand of m64k16
// takes, per warp, mma.sync m16n8k16's A layout, so P goes from the
// accumulators of S to the A operand of P·V without leaving registers.
#pragma once

#include <cuda.h>   // CUtensorMap and its enums (types only: no -lcuda)

#include "common.cuh"

namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- mbarrier

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// arrive and expect `bytes` of TMA transactions on this phase
__device__ __forceinline__ void bar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Wait until the phase of parity `parity` has completed. A phase that does
// not complete within ~2^34 cycles (seconds) traps: a fault, not a hang.
__device__ __forceinline__ void bar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  const long long start = clock64();
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (!done && clock64() - start > (1ll << 34)) __trap();
  }
}

// --------------------------------------------------------------------- TMA

// One box of a 4-d tensor map into shared memory; completion is counted on
// `bar` in bytes (the whole box, zero-filled where it lies out of bounds).
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ------------------------------------------------------------------- wgmma

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads of wgmma accumulators above the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1 (B128).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// named barrier over `count` threads (id 0 is __syncthreads')
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// wgmma m64nNk16, bf16 in, fp32 accumulate: Wgmma<N>::ss (A and B from
// shared memory, both K-major) and Wgmma<N>::rs_t (A from registers, B
// MN-major). `acc` 0 overwrites d. The operand lists are spelled out for
// each N that the kernels use.
template <int N>
struct Wgmma;

template <> struct Wgmma<16> {
  // d[8] += A (smem, K-major) · B (smem, K-major)
  static __device__ __forceinline__ void ss(float* d, uint64_t a,
                                            uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(acc));
  }
};

template <> struct Wgmma<64> {
  // d[32] += A (smem, K-major) · B (smem, K-major)
  static __device__ __forceinline__ void ss(float* d, uint64_t a,
                                            uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(acc));
  }
  // d[32] += A (registers, m16n8k16 A layout per warp) · B (smem,
  // MN-major: the transpose bit set)
  static __device__ __forceinline__ void rs_t(float* d, const uint32_t* a,
                                              uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(acc));
  }
};

template <> struct Wgmma<128> {
  // d[64] += A (smem, K-major) · B (smem, K-major)
  static __device__ __forceinline__ void ss(float* d, uint64_t a,
                                            uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
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

// ------------------------------------------------------------ the products

// The 16-byte chunk c (columns 8c .. 8c + 7) of row r of a swizzled panel.
__device__ __forceinline__ const uint4* panel_chunk(const bf16* panel, int r,
                                                    int c) {
  return reinterpret_cast<const uint4*>(panel + r * 64 + ((c ^ (r & 7)) << 3));
}

// S = q·kᵀ for this warpgroup's 64 q rows against an N-row K tile. q_addr,
// k_addr: shared addresses of the first panel of q (at the warpgroup's
// first row) and of K; q_pb, k_pb: the bytes of one panel of each. Only the
// D / 16 k-steps inside the head dim are issued.
template <int D, int N>
__device__ __forceinline__ void qk_sm90(float (&s)[N / 2], uint32_t q_addr,
                                        uint32_t q_pb, uint32_t k_addr,
                                        uint32_t k_pb) {
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t in = (kk % 4) * 32;   // 16 columns = 32 bytes
    Wgmma<N>::ss(s, desc_sw128(q_addr + (kk / 4) * q_pb + in, 16, 1024),
                 desc_sw128(k_addr + (kk / 4) * k_pb + in, 16, 1024),
                 kk > 0);
  }
  wg_commit();
  wg_wait_all();
  fence_regs(s);
}

// O += P·V over an N-row V tile at v_addr (panel bytes v_pb); p holds the
// tile's probabilities in the accumulator layout of S and is rounded to
// bf16 pairs here, for each k-step of 16 kv rows mma.sync's A fragment of
// those columns. DP: the head dim in whole 64-column panels.
template <int DP, int N>
__device__ __forceinline__ void pv_sm90(float (&o)[DP / 2],
                                        const float (&p)[N / 2],
                                        uint32_t v_addr, uint32_t v_pb) {
  uint32_t a[N / 4];
#pragma unroll
  for (int i = 0; i < N / 4; ++i) a[i] = pack_f32(p[2 * i], p[2 * i + 1]);
  wg_fence();
#pragma unroll
  for (int kc = 0; kc < N / 16; ++kc)     // 16 kv rows = 2 atoms of 8 rows
#pragma unroll
    for (int pn = 0; pn < DP / 64; ++pn)
      Wgmma<64>::rs_t(o + 32 * pn, a + 4 * kc,
                      desc_sw128(v_addr + pn * v_pb + kc * 2048, v_pb, 1024),
                      1);
  wg_commit();
  wg_wait_all();
  fence_regs(o);
}

// 2^x by the SFU alone (ex2.approx, flushing subnormal results to 0): the
// exp2f of the mma.sync loop adds a range fix-up around the same
// instruction for results below 2^-126, which a softmax weight there does
// not need.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One kv tile of the online softmax (common.cuh flash_loop's arithmetic) on
// this thread's rows g (m0, l0) and g + 8 (m1, l1): s holds the tile's
// log2-domain scores and returns their probabilities; o (DP columns) is
// rescaled.
template <int N, int DP>
__device__ __forceinline__ void softmax_tile(float (&s)[N / 2],
                                             float (&o)[DP / 2], float& m0,
                                             float& m1, float& l0,
                                             float& l1) {
  float mx0 = m0, mx1 = m1;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  mx0 = quad_max(mx0);
  mx1 = quad_max(mx1);
  const float alpha0 = exp2_approx(m0 - mx0);
  const float alpha1 = exp2_approx(m1 - mx1);
  m0 = mx0;
  m1 = mx1;
  float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    s[4 * j] = exp2_approx(s[4 * j] - m0);
    s[4 * j + 1] = exp2_approx(s[4 * j + 1] - m0);
    s[4 * j + 2] = exp2_approx(s[4 * j + 2] - m1);
    s[4 * j + 3] = exp2_approx(s[4 * j + 3] - m1);
    ps0 += s[4 * j] + s[4 * j + 1];
    ps1 += s[4 * j + 2] + s[4 * j + 3];
  }
  l0 = l0 * alpha0 + quad_sum(ps0);
  l1 = l1 * alpha1 + quad_sum(ps1);
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    o[4 * j] *= alpha0;
    o[4 * j + 1] *= alpha0;
    o[4 * j + 2] *= alpha1;
    o[4 * j + 3] *= alpha1;
  }
}

// The online-softmax attention of this warpgroup's 64 q rows over n_t kv
// tiles of BN rows.
//   tile(i):       waits for tile i and returns the shared address of its
//                  K; its V lies v_off bytes further
//   scores(i, s):  turns tile i's q·kᵀ into log2-domain logits in place
//                  (LVV_NEG_BIG where masked)
//   release(i):    tile i's buffers may be refilled
// On return o holds the unnormalised rows g and g + 8 of each warp and
// l0 / l1 their denominators (not yet guarded). (Issuing tile i's q·kᵀ
// with tile i - 1's P·V, so that the softmax runs under the products,
// measured slower on the H100: the two consumer warpgroups already overlap
// each other's softmax.)
template <int D, int DP, int BN, class Tile, class Scores, class Release>
__device__ __forceinline__ void attn_mainloop(
    int n_t, uint32_t q_addr, uint32_t q_pb, uint32_t kv_pb, uint32_t v_off,
    Tile tile, Scores scores, Release release, float (&o)[DP / 2],
    float& m0, float& m1, float& l0, float& l1) {
  float s[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) s[i] = 0.f;
  for (int i = 0; i < n_t; ++i) {
    const uint32_t kt = tile(i);
    qk_sm90<D, BN>(s, q_addr, q_pb, kt, kv_pb);
    scores(i, s);
    softmax_tile<BN, DP>(s, o, m0, m1, l0, l1);
    pv_sm90<DP, BN>(o, s, kt + v_off, kv_pb);
    release(i);
  }
}

// Write this thread's two rows of o / l as bf16, the first D columns: row
// pointers (null for a row past the end), columns 8j + 2t.
template <int D>
__device__ __forceinline__ void store_rows(const float* o,
                                           bf16* row0, bf16* row1, float l0,
                                           float l1) {
  const int c = 2 * (threadIdx.x & 3);
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    if (row0)
      *reinterpret_cast<uint32_t*>(row0 + 8 * j + c) =
          pack_f32(o[4 * j] / l0, o[4 * j + 1] / l0);
    if (row1)
      *reinterpret_cast<uint32_t*>(row1 + 8 * j + c) =
          pack_f32(o[4 * j + 2] / l1, o[4 * j + 3] / l1);
  }
}

// ------------------------------------------------------------------ host

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, fetched through the runtime (the libraries are
// not linked against libcuda).
static cudaError_t tiled_encoder(EncodeTiledFn* out) {
  static EncodeTiledFn encode = nullptr;
  if (!encode) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (e != cudaSuccess) return e;
    if (found != cudaDriverEntryPointSuccess || !fn)
      return cudaErrorSymbolNotFound;
    encode = reinterpret_cast<EncodeTiledFn>(fn);
  }
  *out = encode;
  return cudaSuccess;
}

// A 4-d bf16 tensor map over `base`: dims innermost first (dims[0]
// contiguous), the byte strides of dims 1..3 (multiples of 16), read in
// boxes of 64 columns by box_rows of dim 1 by box_rows2 of dim 2 (rows of
// the tile in that order) with the 128-byte swizzle; zero past the bounds.
static cudaError_t tensor_map(CUtensorMap* map, const void* base,
                              const cuuint64_t (&dims)[4],
                              const cuuint64_t (&strides)[3],
                              uint32_t box_rows, uint32_t box_rows2 = 1) {
  EncodeTiledFn encode;
  const cudaError_t e = tiled_encoder(&encode);
  if (e != cudaSuccess) return e;
  const cuuint32_t box[4] = {64, box_rows, box_rows2, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Shared memory of a kernel: `bytes` of 1024-aligned panels and barriers,
// plus the slack to align the dynamic base.
constexpr int kSmemAlign = 1024;

// the most dynamic shared memory a block may take (H100: 227 KB)
constexpr int kMaxSmem = 232448;

__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(raw) + kSmemAlign - 1) &
      ~uintptr_t(kSmemAlign - 1));
}

}  // namespace sm90
