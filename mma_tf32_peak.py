"""The rate of mma.sync m16n8k8 with TF32 operands and fp32 accumulators on
one card: the instruction that K-e's fp32 form (kernels/csrc/
flash_attention_f32.cu) runs three times a product in 3xTF32.

    python3 mma_tf32_peak.py

Builds a small CUDA kernel with nvcc under build/mma_tf32_peak/ (plain C
interface, loaded with ctypes): each warp issues `chains` independent
accumulations of m16n8k8 products in turn, 4,096 times, on register
operands (no memory traffic), four blocks of `warps` warps an SM. Prints
the card (nvidia-smi name and power limit) and one JSON line a
configuration: TFLOP/s (2,048 operations an instruction, timed with CUDA
events on the second of two launches) and clocks an instruction an SM at
the card's maximum SM clock. Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent
OUT = REPO / "build" / "mma_tf32_peak"
SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
template <int CHAINS>
__global__ void peak(float* out, int iters, uint32_t seed) {
  float c[CHAINS][4];
  for (int i = 0; i < CHAINS; ++i)
    for (int j = 0; j < 4; ++j) c[i][j] = 0.f;
  const uint32_t a[4] = {seed, seed * 3, seed * 5, seed * 7};
  const uint32_t b0 = seed * 11, b1 = seed * 13;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < CHAINS; ++i)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(c[i][0]), "+f"(c[i][1]), "+f"(c[i][2]), "+f"(c[i][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  float s = 0.f;
  for (int i = 0; i < CHAINS; ++i)
    for (int j = 0; j < 4; ++j) s += c[i][j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <int CHAINS>
static float timed(float* out, int blocks, int threads, int iters) {
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  peak<CHAINS><<<blocks, threads>>>(out, iters, 1);
  cudaEventRecord(a);
  peak<CHAINS><<<blocks, threads>>>(out, iters, 1);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, a, b);
  cudaEventDestroy(a);
  cudaEventDestroy(b);
  return cudaGetLastError() == cudaSuccess ? ms : -1.f;
}

// ms of one launch of `blocks` blocks of `warps` warps, `chains`
// accumulations a warp (1, 2, 4 or 8), `iters` steps; -1 on an error
extern "C" float lvv_mma_tf32_peak(int chains, int warps, int blocks,
                                   int iters) {
  float* out = nullptr;
  if (cudaMalloc(&out, (size_t)blocks * warps * 32 * 4) != cudaSuccess)
    return -1.f;
  const int t = warps * 32;
  const float ms = chains == 1   ? timed<1>(out, blocks, t, iters)
                   : chains == 2 ? timed<2>(out, blocks, t, iters)
                   : chains == 4 ? timed<4>(out, blocks, t, iters)
                                 : timed<8>(out, blocks, t, iters);
  cudaFree(out);
  return ms;
}
"""


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("mma_tf32_peak: no CUDA device", file=sys.stderr)
        return 1
    from lvv_tpu_torch.kernels import _nvcc
    OUT.mkdir(parents=True, exist_ok=True)
    src, lib = OUT / "mma_tf32_peak.cu", OUT / "libmma_tf32_peak.so"
    src.write_text(SOURCE)
    subprocess.run([_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", str(lib),
                    str(src)], check=True)
    fn = ctypes.CDLL(str(lib)).lvv_mma_tf32_peak
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_float
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    props = torch.cuda.get_device_properties(0)
    sms = props.multi_processor_count
    clock_hz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True,
        text=True).stdout.split()[0]) * 1e6
    iters, blocks = 4096, 4 * sms
    for chains in (1, 2, 4, 8):
        for warps in (4, 8, 16):
            ms = fn(chains, warps, blocks, iters)
            if ms <= 0:
                print(f"mma_tf32_peak: launch failed at {chains} chains, "
                      f"{warps} warps", file=sys.stderr)
                return 1
            n = blocks * warps * chains * iters
            print("mma-tf32-peak", json.dumps(dict(
                chains=chains, warps_an_sm=4 * warps,
                tflops=n * 2048 / (ms * 1e-3) / 1e12,
                clocks_an_mma_an_sm=sms * clock_hz * ms * 1e-3 / n,
                max_sm_clock_mhz=clock_hz / 1e6)), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    sys.exit(main())
