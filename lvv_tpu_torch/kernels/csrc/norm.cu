// Row LayerNorm / RMSNorm, alone or after a residual add (bf16 or fp32 in
// and out, fp32 math; the scale and bias of x's type or fp32):
//   row form:  n = norm(x)
//   add form:  s = T(x + y)          (fp32 sum, one rounding to x's type:
//                                     bit-equal to PyTorch's x + y)
//              n = norm(s)           (from the rounded s)
// with norm = LayerNorm (mean, then the centred variance, as _ln_f32 of
// lvv_tpu/ops/fused_mlp.py:49-53) or RMSNorm (x · rsqrt(mean(x²) + eps)),
// then the scale (and LayerNorm's bias), one rounding to the output type.
//
// Replaces lvv_tpu/ops/fused_mlp.py::_ln_only_kernel (:203) and
// _rms_only_kernel (:209), reached through _norm_fwd / norm_fast, TPU
// kernel K-a: every LayerNorm and RMSNorm of the main path. The add form
// also takes in the residual add that precedes 48 of the 49 RMS norms of
// each Qwen pass (the JAX package leaves that add to XLA, qwen.py:145-149):
// one launch in place of two.
//
// What bounds it on the H100: x (and y) read once, n (and s) written once,
// ~8 operations an element: device memory for the encoders' norms (0.3 to
// 94 MB a call); the launch and its chain of latencies for the decode's
// [1..8, 896] rows and the other calls of a wave or less.
//
// Design (norm_kernel, 16-byte vectors):
//   - A row is split over a power-of-two team of `tpr` threads (8 to 512),
//     the fewest that leave at most NV vectors a thread; vector j of thread
//     i is vector j·tpr + i of the row, so one load instruction of a team
//     reads tpr·16 contiguous bytes, and a row whose vector count is not a
//     multiple of tpr (C = 896 at NV = 4: 112 vectors over 32 threads, 3.5
//     a thread) loads its ragged share in the same pass, masked.
//   - The row stays in registers as loaded (raw bf16: half the registers of
//     fp32 copies) between the reductions; fp32 partial sums a lane, then
//     shuffles within a warp and shared memory across the warps of a team.
//   - A block holds 128 / tpr rows (fewer when the call has fewer). Every
//     load of a thread is issued before its first use. The shape follows
//     the call's size (`dispatch`): a call of a wave or less is a chain of
//     latencies, so it takes one vector a thread (NV = 1) or, where that
//     would be more than a wave, four, and loads its scale with x (PRE); a
//     larger call takes four vectors a thread and reads the scale through
//     L1 in the epilogue.
//   - A width that is not a whole number of 16-byte vectors, or a pointer
//     off 16 bytes, takes norm_elem_kernel: one element at a time, each
//     pass reading the row again (through L1).
//   - fp32 parameters beside bf16 x (the model keeps its norms' parameters
//     in fp32, as the JAX package does): a vector of 8 bf16 elements takes
//     its 8 scales (and biases) in two 16-byte loads. Held in registers
//     from the start, a four-vector thread would carry 64 registers of
//     them, so that form reads them in the epilogue (through L1) instead;
//     the one-vector form still loads them with x.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

constexpr int kBlockThreads = 128;
constexpr int kMaxThreads = 512;      // the widest team: fp32 at C = 8192
constexpr int kWave = 4 * 132;        // blocks of one wave, four an SM

// elements of T in a 16-byte vector
template <typename T>
__host__ __device__ constexpr int vec_elems() { return 16 / sizeof(T); }

// a 16-byte vector as loaded -> its elements as floats
template <typename T>
__device__ __forceinline__ void to_float(float (&v)[vec_elems<T>()],
                                         const uint4& r) {
  const T* e = reinterpret_cast<const T*>(&r);
#pragma unroll
  for (int i = 0; i < vec_elems<T>(); ++i) {
    if constexpr (sizeof(T) == 2) v[i] = __bfloat162float(e[i]);
    else v[i] = e[i];
  }
}

// v rounded to T, packed as loaded
template <typename T>
__device__ __forceinline__ uint4 pack_vec(const float (&v)[vec_elems<T>()]) {
  uint4 r;
  T* e = reinterpret_cast<T*>(&r);
#pragma unroll
  for (int i = 0; i < vec_elems<T>(); ++i) {
    if constexpr (sizeof(T) == 2) e[i] = __float2bfloat16(v[i]);
    else e[i] = v[i];
  }
  return r;
}

// 16-byte vectors of P that hold the parameters of one vector of T
template <typename T, typename P>
__host__ __device__ constexpr int param_vecs() {
  return vec_elems<T>() / vec_elems<P>();
}

// the vec_elems<T>() parameters at p + off, as loaded
template <typename T, typename P>
__device__ __forceinline__ void load_params(uint4 (&r)[param_vecs<T, P>()],
                                            const P* p, int off) {
#pragma unroll
  for (int w = 0; w < param_vecs<T, P>(); ++w)
    r[w] = *reinterpret_cast<const uint4*>(p + off + w * vec_elems<P>());
}

// loaded parameters -> floats
template <typename T, typename P>
__device__ __forceinline__ void params_float(
    float (&v)[vec_elems<T>()], const uint4 (&r)[param_vecs<T, P>()]) {
#pragma unroll
  for (int w = 0; w < param_vecs<T, P>(); ++w) {
    float t[vec_elems<P>()];
    to_float<P>(t, r[w]);
#pragma unroll
    for (int i = 0; i < vec_elems<P>(); ++i) v[w * vec_elems<P>() + i] = t[i];
  }
}

template <typename T>
__device__ __forceinline__ float to_f(T v) {
  if constexpr (sizeof(T) == 2) return __bfloat162float(v);
  else return v;
}

template <typename T>
__device__ __forceinline__ T from_f(float v) {
  if constexpr (sizeof(T) == 2) return __float2bfloat16(v);
  else return v;
}

// v[0] + ... + v[E - 1] as a tree
template <int E>
__device__ __forceinline__ float tree_sum(float (&v)[E]) {
#pragma unroll
  for (int w = E / 2; w > 0; w /= 2)
#pragma unroll
    for (int i = 0; i < w; ++i) v[i] += v[i + w];
  return v[0];
}

// The sum of v over the tpr threads of this thread's row. Every thread of
// the block calls it (rows past the end too): it synchronises the block
// when a team spans warps. `red` holds one float a warp.
__device__ __forceinline__ float team_sum(float v, int tpr, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    if (o < tpr) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (tpr <= 32) return v;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  const int per = tpr >> 5, first = warp & ~(per - 1);
  float t = 0.f;
  for (int w = 0; w < per; ++w) t += red[first + w];
  return t;
}

template <typename T, typename P, int NV, bool RMS, bool ADD, bool PRE>
__global__ void __launch_bounds__(kMaxThreads)
    norm_kernel(const T* __restrict__ x, const T* __restrict__ y,
                const P* __restrict__ scale, const P* __restrict__ bias,
                T* __restrict__ s_out, T* __restrict__ n_out, int n, int c,
                float eps, float inv_c, int tpr_log2) {
  constexpr int E = vec_elems<T>(), PW = param_vecs<T, P>();
  __shared__ float red[2][32];
  const int tpr = 1 << tpr_log2;
  const int li = threadIdx.x & (tpr - 1);
  const long long row = (long long)blockIdx.x * (blockDim.x >> tpr_log2) +
                        (threadIdx.x >> tpr_log2);
  const bool live = row < n;
  const int nvec = c / E;
  const long long base = row * c;

  uint4 xr[NV], sr[NV][PW], br[NV][PW];
  bool ok[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int idx = j * tpr + li;
    ok[j] = live && idx < nvec;
    if (ok[j]) xr[j] = *reinterpret_cast<const uint4*>(x + base + idx * E);
  }
  uint4 yr[ADD ? NV : 1];
  if constexpr (ADD) {
#pragma unroll
    for (int j = 0; j < NV; ++j)
      if (ok[j])
        yr[j] = *reinterpret_cast<const uint4*>(y + base + (j * tpr + li) * E);
  }
  if constexpr (PRE) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (!ok[j]) continue;
      const int off = (j * tpr + li) * E;
      load_params<T, P>(sr[j], scale, off);
      if (!RMS && bias) load_params<T, P>(br[j], bias, off);
    }
  }
  if constexpr (ADD) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (!ok[j]) continue;
      // s = x + y in fp32, rounded to T and stored; the norm reads the
      // rounded value
      float u[E], w[E];
      to_float<T>(u, xr[j]);
      to_float<T>(w, yr[j]);
#pragma unroll
      for (int e = 0; e < E; ++e) u[e] += w[e];
      xr[j] = pack_vec<T>(u);
      *reinterpret_cast<uint4*>(s_out + base + (j * tpr + li) * E) = xr[j];
    }
  }

  // the lane's sums in E partial sums (short dependency chains), a tree
  float part[E] = {};
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    if (!ok[j]) continue;
    float u[E];
    to_float<T>(u, xr[j]);
#pragma unroll
    for (int e = 0; e < E; ++e) part[e] += RMS ? u[e] * u[e] : u[e];
  }
  const float a = team_sum(tree_sum<E>(part), tpr, red[0]);
  float mean = 0.f, rstd;
  if constexpr (RMS) {
    rstd = rsqrtf(a * inv_c + eps);
  } else {
    mean = a * inv_c;
    float qp[E] = {};
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (!ok[j]) continue;
      float u[E];
      to_float<T>(u, xr[j]);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float d = u[e] - mean;
        qp[e] += d * d;
      }
    }
    rstd = rsqrtf(team_sum(tree_sum<E>(qp), tpr, red[1]) * inv_c + eps);
  }

#pragma unroll
  for (int j = 0; j < NV; ++j) {
    if (!ok[j]) continue;
    const int off = (j * tpr + li) * E;
    if constexpr (!PRE) {
      load_params<T, P>(sr[j], scale, off);
      if (!RMS && bias) load_params<T, P>(br[j], bias, off);
    }
    float u[E], sc[E], b[E] = {}, o[E];
    to_float<T>(u, xr[j]);
    params_float<T, P>(sc, sr[j]);
    if (!RMS && bias) params_float<T, P>(b, br[j]);
#pragma unroll
    for (int e = 0; e < E; ++e)
      o[e] = RMS ? u[e] * rstd * sc[e] : (u[e] - mean) * rstd * sc[e] + b[e];
    *reinterpret_cast<uint4*>(n_out + base + off) = pack_vec<T>(o);
  }
}

// The same function one element at a time, for widths that are not whole
// 16-byte vectors (or pointers off 16 bytes): each pass reads the row
// again (the add form: s, which this thread wrote).
template <typename T, typename P, bool RMS, bool ADD>
__global__ void __launch_bounds__(kMaxThreads)
    norm_elem_kernel(const T* __restrict__ x, const T* __restrict__ y,
                     const P* __restrict__ scale, const P* __restrict__ bias,
                     T* s_out, T* __restrict__ n_out, int n, int c, float eps,
                     float inv_c, int tpr_log2) {
  __shared__ float red[2][32];
  const int tpr = 1 << tpr_log2;
  const int li = threadIdx.x & (tpr - 1);
  const long long row = (long long)blockIdx.x * (blockDim.x >> tpr_log2) +
                        (threadIdx.x >> tpr_log2);
  const bool live = row < n;
  const long long base = row * c;
  const T* src = ADD ? s_out : x;
  float a = 0.f;
  for (int i = li; live && i < c; i += tpr) {
    float v = to_f(x[base + i]);
    if constexpr (ADD) {
      const T s = from_f<T>(v + to_f(y[base + i]));
      s_out[base + i] = s;
      v = to_f(s);
    }
    a += RMS ? v * v : v;
  }
  a = team_sum(a, tpr, red[0]);
  float mean = 0.f, rstd;
  if constexpr (RMS) {
    rstd = rsqrtf(a * inv_c + eps);
  } else {
    mean = a * inv_c;
    float q = 0.f;
    for (int i = li; live && i < c; i += tpr) {
      const float d = to_f(src[base + i]) - mean;
      q += d * d;
    }
    rstd = rsqrtf(team_sum(q, tpr, red[1]) * inv_c + eps);
  }
  for (int i = li; live && i < c; i += tpr) {
    const float v = to_f(src[base + i]), sc = to_f(scale[i]);
    n_out[base + i] = from_f<T>(
        RMS ? v * rstd * sc
            : (v - mean) * rstd * sc + (bias ? to_f(bias[i]) : 0.f));
  }
}

// the fewest threads (a power of two, at least 8) that hold `items` at
// most `per` a thread
static int team(int items, int per) {
  int tpr = 8;
  while (tpr * per < items) tpr *= 2;
  return tpr;
}

// rows a block for teams of tpr threads: 128 threads' worth (small blocks
// spread a short call evenly over the SMs), fewer when the call has fewer
// rows (keeping a whole warp)
static int rows_a_block(int n, int tpr) {
  int rpb = tpr >= kBlockThreads ? 1 : kBlockThreads / tpr;
  while (rpb > 1 && rpb / 2 >= n && (rpb / 2) * tpr >= 32) rpb /= 2;
  return rpb;
}

static int blocks_for(int n, int tpr) {
  const int rpb = rows_a_block(n, tpr);
  return (n + rpb - 1) / rpb;
}

template <typename T, typename P>
static int launch(void (*kernel)(const T*, const T*, const P*, const P*, T*,
                                 T*, int, int, float, float, int),
                  int tpr, const void* x, const void* y, const void* scale,
                  const void* bias, void* s_out, void* n_out, int n, int c,
                  float eps, cudaStream_t st) {
  if (tpr > kMaxThreads) return (int)cudaErrorInvalidValue;
  const int rpb = rows_a_block(n, tpr);
  kernel<<<(n + rpb - 1) / rpb, rpb * tpr, 0, st>>>(
      (const T*)x, (const T*)y, (const P*)scale, (const P*)bias, (T*)s_out,
      (T*)n_out, n, c, eps, (float)(1.0 / c), __builtin_ctz(tpr));
  return (int)cudaGetLastError();
}

template <typename T, typename P, bool RMS, bool ADD>
static int dispatch(bool vec, const void* x, const void* y, const void* scale,
                    const void* bias, void* s_out, void* n_out, int n, int c,
                    float eps, cudaStream_t st) {
#define LVV_LAUNCH(K, TPR) \
  launch<T, P>(K, TPR, x, y, scale, bias, s_out, n_out, n, c, eps, st)
  if (!vec) return LVV_LAUNCH((norm_elem_kernel<T, P, RMS, ADD>), team(c, 16));
  // a call of a wave or less at one vector a thread: one vector; of a wave
  // or less at four: four, the scale loaded with x (parameters of x's
  // type; fp32 ones beside bf16 x through L1, as the last form); else
  // four, the scale through L1
  constexpr bool pre4 = param_vecs<T, P>() == 1;
  const int nvec = c / vec_elems<T>();
  const int t1 = team(nvec, 1), t4 = team(nvec, 4);
  if (t1 <= kMaxThreads && blocks_for(n, t1) <= kWave)
    return LVV_LAUNCH((norm_kernel<T, P, 1, RMS, ADD, true>), t1);
  if (pre4 && blocks_for(n, t4) <= kWave)
    return LVV_LAUNCH((norm_kernel<T, P, 4, RMS, ADD, pre4>), t4);
  return LVV_LAUNCH((norm_kernel<T, P, 4, RMS, ADD, false>), t4);
#undef LVV_LAUNCH
}

static bool aligned16(const void* p) {
  return p == nullptr || ((uintptr_t)p & 15) == 0;
}

// x, n_out [n, c] contiguous, bf16 (fp32 = 0) or fp32 (fp32 = 1); scale
// (and bias, LayerNorm) [c] of x's type (pfp32 = 0, bf16 x only) or fp32
// (pfp32 = 1); c <= 8192. With y (and s_out) [n, c] of x's type: the add
// form, s_out = x + y and n_out = norm(s_out). bias may be null (a
// LayerNorm without bias); RMSNorm ignores it. Returns a cudaError_t (0 on
// success).
extern "C" int lvv_norm(const void* x, const void* y, const void* scale,
                        const void* bias, void* s_out, void* n_out, int n,
                        int c, float eps, int rms, int fp32, int pfp32,
                        void* stream) {
  if (!x || !scale || !n_out || n < 0 || c <= 0 || c > 8192 ||
      (!y) != (!s_out) || (fp32 && !pfp32))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int esize = fp32 ? 4 : 2;
  const bool vec = (c * esize) % 16 == 0 && aligned16(x) && aligned16(y) &&
                   aligned16(scale) && aligned16(rms ? nullptr : bias) &&
                   aligned16(s_out) && aligned16(n_out);
  cudaStream_t st = (cudaStream_t)stream;
#define LVV_NORM(T, P, R, A) \
  dispatch<T, P, R, A>(vec, x, y, scale, bias, s_out, n_out, n, c, eps, st)
#define LVV_NORM_RA(T, P)                                          \
  (rms ? (add ? LVV_NORM(T, P, true, true) : LVV_NORM(T, P, true, false)) \
       : (add ? LVV_NORM(T, P, false, true) : LVV_NORM(T, P, false, false)))
  const bool add = y != nullptr;
  if (fp32) return LVV_NORM_RA(float, float);
  return pfp32 ? LVV_NORM_RA(bf16, float) : LVV_NORM_RA(bf16, bf16);
#undef LVV_NORM_RA
#undef LVV_NORM
}
