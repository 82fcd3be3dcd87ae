// Window attention with the whole row of S <= 256 keys in registers: one
// block per (head, window), bf16 in and out, fp32 scores. One template in
// seven modes (compile-time `MODE`, window_sm90.cuh), each the function of
// some TPU bodies.
//
// Modes kRowsPost / kRowsPre: SAM window attention over precomputed q·R bias
// rows, fp32 softmax in base 2,
//   out = softmax₂(logit) v,  logit[q, kv] = q·k·cs + rh[q, kv / win] + rw[q, kv % win]
// with cs = scale·log2e and the caller's bias rows rh, rw (q·Rh and q·Rw,
// already scaled by log2e and rounded to bf16), S = win². p is divided by its
// row sum, then rounded to bf16 for p@v, as the TPU kernels do. They replace
// five TPU bodies of lvv_tpu/ops/attention.py (K-l), which compute this one
// function and differ only where the scale is rounded and in the layout of
// their bias rows:
//   kRowsPre (q scaled by cs and rounded to bf16 BEFORE the product):
//     _window_fused_kernel  (window_attention_fused)   rows [B, H, S, win] x2
//     _window_fused2_kernel (window_attention_fused2)  rows [B, H, S, 2·win]
//   kRowsPost (the fp32 product scaled by cs):
//     _window_v3_kernel     (window_attention_v3)      rows [B, H, S, 16] x2
//     _window_phased_kernel (window_attention_phased)  rows [B, H, S, 16] x2
//     _window_v4_kernel     (window_attention_v4)      rows [B, S, H·16] x2
// The TPU kernels expand the rows to [S, S] with one-hot matmuls or
// concatenated operands (Mosaic cannot gather); here too the bias comes out
// of the tensor cores: the rows times a one-hot expander, as two more wgmma
// k-steps into the score accumulators.
//
// The other five modes are the cost-bisect kernels of two benchmark scripts
// (B-1: benchmarks/winattn_bisect2.py::main.make(variant), B-2:
// benchmarks/winattn_bisect3.py::main.make_hmaj(batched)). With
// s = (q·k in fp32)·cs, cs = scale:
//   kDotsQk    out[:, 0:d] = bf16(s[:, 0:d]·1e-3): the first d key columns of
//              the scores, no p@v (S >= d)
//   kDotsQkPv  out = bf16(bf16(s·1e-3) @ v): no max, no softmax
//   kSoftmax   out = bf16(bf16(p) @ v), p = exp(s − max) / Σ in base e
//   kBias2     kSoftmax after s += qrh @ eh + qrw @ ew: qrh, qrw [S, 16] rows
//              of the (window, head), eh, ew dense [16, S] expanders. The
//              expanders are random, not one-hot: the rows are the A
//              operand of two more wgmma k-steps and [eh; ew] their B
//              operand, real products, not a gather.
//   kHmaj      kSoftmax on head-major q, k, v (B-2: both `batched` schedules
//              of the script compute this function)
// Every mode but kHmaj reads packed qkv [B, S, 3C] and writes [B, S, C]; the
// Tensor Memory Accelerator reads the window's q, k and v where they lie (a
// tensor map over [3C, S, B], or for kHmaj one over each head-major view's
// own strides), so addressing costs the threads nothing in either layout.
//
// What bounds it on the H100: reading q, k, v and writing the output,
// 2·S·4·d bytes a (window, head), against 4·S²·d operations: about 98
// operations a byte at SAM's 14x14 windows, under the card's ~295, so device
// memory bounds it (0.054 ms for 150 windows of 12 heads).
//
// Design (window_sm90.cuh): one block of two warpgroups per (head, window)
// loads q, k, v once by TMA into swizzled panels; a 64-row q tile's whole
// score row stays in wgmma accumulators (at d 64 split between the two
// warpgroups, which exchange row maxima, sums and partial O through shared
// memory), the bias comes from two more wgmma k-steps, and the exact row
// maximum and sum are taken before p is divided, rounded and multiplied by
// V from registers. Nothing goes back to device memory but the output.
#include <string.h>

#include "window_sm90.cuh"

using namespace sm90;

template <int D>
static int launch_mode(const CUtensorMap* maps, const WinArgs& a, int b,
                       int mode, cudaStream_t st) {
  switch (mode) {
    case kRowsPost: return launch_win<D, kRowsPost>(maps, a, b, st);
    case kRowsPre: return launch_win<D, kRowsPre>(maps, a, b, st);
  }
  if constexpr (D == 64) {
    switch (mode) {
      case kDotsQk: return launch_win<64, kDotsQk>(maps, a, b, st);
      case kDotsQkPv: return launch_win<64, kDotsQkPv>(maps, a, b, st);
      case kSoftmax: return launch_win<64, kSoftmax>(maps, a, b, st);
      case kBias2: return launch_win<64, kBias2>(maps, a, b, st);
      case kHmaj: return launch_win<64, kHmaj>(maps, a, b, st);
    }
  }
  return (int)cudaErrorInvalidValue;
}

// Every mode but kHmaj: q is qkv [B, S, 3·heads·d] and out [B, S, heads·d],
// both contiguous bf16; k, v unused. kHmaj: q, k, v, out bf16 [B, heads, S,
// d] through their (window, head, token) strides (unit stride over d;
// strides multiples of 8 elements, 16-byte aligned). S <= 256, d 64 (every
// mode) or 128 (kRowsPost / kRowsPre). `strides`: 18 int64, the strides of
// q, k, v, out (kHmaj, else unused), then rh, rw.
//   kRowsPost / kRowsPre: S = win², rh, rw bias rows with at least win
//     columns (unit column stride); cs = scale·log2e; kRowsPre rounds q·cs
//     to bf16 before q·k.
//   kDotsQk (S >= d), kDotsQkPv, kSoftmax, kHmaj: cs = scale; rh .. ew
//     unused.
//   kBias2: rh, rw the expander rows [.., S, 16] (unit column stride), eh,
//     ew contiguous [16, S]; cs = scale.
// Returns a cudaError_t (0 on success).
extern "C" int lvv_window_attention_rows(const void* q, const void* k,
                                         const void* v, void* out,
                                         const void* rh, const void* rw,
                                         const void* eh, const void* ew,
                                         const void* strides, int b, int s,
                                         int heads, int d, int win, int mode,
                                         float cs, void* stream) {
  const bool rows = mode == kRowsPost || mode == kRowsPre;
  if (!q || (mode == kHmaj && (!k || !v)) || !out || b <= 0 || heads <= 0 ||
      s <= 0 || s > 256 || mode < kRowsPost || mode > kHmaj ||
      (rows && (win <= 0 || win * win != s || !rh || !rw)) ||
      (mode == kDotsQk && s < d) ||
      (mode == kBias2 && (!rh || !rw || !eh || !ew)) ||
      !(d == 64 || (d == 128 && rows)))
    return (int)cudaErrorInvalidValue;
  long long st[18];
  memcpy(st, strides, sizeof(st));
  WinArgs a;
  memset(&a, 0, sizeof(a));
  a.out = (bf16*)out;
  a.rh = (const bf16*)rh;
  a.rw = (const bf16*)rw;
  a.eh = (const bf16*)eh;
  a.ew = (const bf16*)ew;
  memcpy(a.ost, st + 9, sizeof(a.ost));
  memcpy(a.tst, st + 12, sizeof(a.tst));
  a.s = s;
  a.heads = heads;
  a.gh = a.gw = rows ? win : mode == kBias2 ? kExpK : 1;
  a.cs = cs;
  CUtensorMap maps[3];
  cudaError_t e;
  if (mode == kHmaj) {
    e = win_split_maps(maps, q, k, v, st, b, heads, s, d);
  } else {
    typedef cuuint64_t u64;
    const u64 c3 = 3ull * heads * d;
    const u64 dims[4] = {c3, (u64)s, (u64)b, 1};
    const u64 pst[3] = {c3 * 2, c3 * 2 * s, c3 * 2 * s * b};
    e = tensor_map(&maps[0], q, dims, pst, (s + 7) / 8 * 8);
    if (e == cudaSuccess) e = tensor_map(&maps[1], q, dims, pst, win_rows(s));
    maps[2] = maps[1];
  }
  if (e != cudaSuccess) return (int)e;
  cudaStream_t cst = (cudaStream_t)stream;
  return d == 128 ? launch_mode<128>(maps, a, b, mode, cst)
                  : launch_mode<64>(maps, a, b, mode, cst);
}
