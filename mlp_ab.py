"""Time the port's two MLP kernels, SAM's W8A8 projection and the decode's
int8 products in several checkouts of this repository on one H100,
alternating the checkouts: K-b (`ln_mlp_residual`, the float path) and
K-f (`ln_mlp_residual_q8`, the serving path, with its wrapper's per-call
weight quantization) at every shape that chip_smoke.py's paths give them,
K-i (`w8a8_matmul`, its per-call weight quantization included) at SAM's
four projection shapes at 1024² and 1280², and K-j (`quantized_matmul`,
the packed int8 decode's four products a layer) and K-k
(`quantized_matmul_nk`, the tied unembed) at batch 1 and 8, the weights
rotated through copies that exceed the 50 MB L2 as in chip_smoke.py:

    python3 mlp_ab.py PATH [PATH ...] [--rounds 2]

PATH is the root of a checkout (e.g. a commit unpacked with `git archive`).
The checkouts' libraries are built first, all at once; then, for each
round, each checkout in turn runs in a process of its own
(`python3 mlp_ab.py --one PATH`), which prints one JSON line:

- `ms`: per-call ms of each wrapper (its glue included) at SAM's and
  CLIP's shapes at 1024² and 1280² (K-b and K-f), at serving-batch[8]
  (K-f), at SAM's projections (K-i) and at the decode's products (K-j,
  K-k);
- `out_abs_sum`: the sum of |output| at each shape, so that the checkouts
  can be seen to compute the same thing.

Inputs are drawn once per shape from torch's generator on the card (seed
0), the same in every checkout, as chip_smoke.py draws them: x N(0, 1),
the LN scale 1 + 0.1·N(0, 1), the biases 0.1·N(0, 1), W1 N(0, 1/C), W2
N(0, 1/H); K-i's x N(0, 1), weight N(0, 1/K), bias 0.1·N(0, 1); K-j's
weights N(0, 1/K) quantized per column, K-k's table 0.02·N(0, 1) per row.
Times are CUDA-event means over 20 calls after a warm-up, the stream first
held busy so that the host has queued every call (the
`alternate` and `timed_ms` of attention_ab.py). After the last round the
first process prints one `mlp-ab-summary` line: per shape, each checkout's
mean over the rounds and its ratio to the first checkout. Exits non-zero
without a CUDA device or when a wrapper did not launch its kernel.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

from attention_ab import alternate, timed_ms

# (label, quant8, (tokens, C, H, activation))
SAM, CLIP = (768, 3072, "gelu"), (1024, 4096, "quick_gelu")
SHAPES = [(f"{res} {kind} [{n},{dims[0]}]x[{dims[0]},{dims[1]}]", q8,
           (n,) + dims)
          for q8, kind in ((False, "K-b"), (True, "K-f"))
          for res, n, dims in (("1024 SAM", 24576, SAM),
                               ("1024 CLIP", 1542, CLIP),
                               ("1280 SAM", 38400, SAM),
                               ("1280 CLIP", 2406, CLIP))] + [
    (f"batch8 {name} K-f [{n},{dims[0]}]x[{dims[0]},{dims[1]}]", True,
     (n,) + dims)
    for name, n, dims in (("SAM", 8 * 24576, SAM), ("CLIP", 8 * 1542, CLIP))]
# K-j: (label, "qmv", (rows, K, N))
SHAPES += [(f"decode K-j {name} [{m},{k}]x[{k},{n}]", "qmv", (m, k, n))
           for m in (1, 8)
           for name, k, n in (("qkv", 896, 1152), ("o", 896, 896),
                              ("gate|up", 896, 9728), ("down", 4864, 896))]
# K-i: (label, "w8a8", (rows, K, N)); K-k: (label, "qmv_nk", (rows, K, N))
SHAPES += [(f"{res} K-i {name} [{m},768]x[768,{n}]", "w8a8", (m, 768, n))
           for res, win, glob in (("1024", 29400, 24576),
                                  ("1280", 42336, 38400))
           for name, m, n in (("windowed qkv", win, 2304),
                              ("windowed proj", win, 768),
                              ("global qkv", glob, 2304),
                              ("global proj", glob, 768))]
SHAPES += [(f"decode K-k unembed [{m},896]x[151940,896]^T", "qmv_nk",
            (m, 896, 151940)) for m in (1, 8)]
_NAMES = {"qmv": "int8_matmul", "w8a8": "w8a8_matmul",
          "qmv_nk": "int8_matmul_nk", True: "ln_mlp_residual_q8",
          False: "ln_mlp_residual"}


def case(torch, M, q8, shape):
    """The wrapper call on seeded inputs."""
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*s, std=1.0):
        return (torch.randn(s, generator=gen, device="cuda") * std).to(
            torch.bfloat16)
    if q8 in ("qmv", "qmv_nk", "w8a8"):
        from lvv_tpu_torch.ops import quant as Q
        m, k, n = shape
        x = rnd(m, k)
        if q8 == "w8a8":
            w, b = rnd(k, n, std=k ** -0.5), rnd(n, std=0.1)
            return lambda: Q.w8a8_matmul(x, w, b)
        copies = range(max(1, -(-128 * 2 ** 20 // (k * n))))
        if q8 == "qmv_nk":
            ws = [tuple(Q.quantize_rows_table(rnd(n, k, std=0.02)).values())
                  for _ in copies]
            fn = Q.quantized_matmul_nk
        else:
            ws = [Q.quantize_weight(rnd(k, n, std=k ** -0.5))
                  for _ in copies]
            fn = Q.quantized_matmul
        turn = iter(range(10 ** 9))
        return lambda: fn(x, *ws[next(turn) % len(ws)])
    n, c, h, act = shape
    x = rnd(n, c)
    p = (1 + rnd(c, std=0.1), rnd(c, std=0.1), rnd(c, h, std=c ** -0.5),
         rnd(h, std=0.1), rnd(h, c, std=h ** -0.5), rnd(c, std=0.1))
    return lambda: M.ln_mlp_residual(x, *p, eps=1e-6, act=act, quant8=q8)


def one(root: pathlib.Path, build_only: bool) -> int:
    import torch
    if not torch.cuda.is_available():
        print("mlp_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(root))
    from lvv_tpu_torch import kernels
    from lvv_tpu_torch.ops import fused_mlp as M
    if build_only:
        kernels.build_all(("ln_mlp_residual", "ln_mlp_residual_q8",
                           "int8_matmul", "int8_matmul_nk", "w8a8_matmul"))
        return 0
    ms, sums = {}, {}
    for label, q8, shape in SHAPES:
        fn = case(torch, M, q8, shape)
        name = _NAMES[q8]
        before = kernels.launches[name]
        sums[label] = float(fn().float().abs().sum())
        if kernels.launches[name] == before:
            raise AssertionError(f"{label}: the wrapper did not launch {name}")
        ms[label] = timed_ms(torch, fn, 20)
        del fn
        torch.cuda.empty_cache()
    print("mlp-ab", json.dumps(dict(tree=str(root), ms=ms,
                                    out_abs_sum=sums)), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="+", type=pathlib.Path)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--one", action="store_true",
                    help="time the one checkout PATH in this process")
    ap.add_argument("--build", action="store_true",
                    help="with --one: only build its libraries")
    args = ap.parse_args()
    roots = [p.resolve() for p in args.paths]
    if args.one:
        return one(roots[0], args.build)
    return alternate(__file__, roots, args.rounds, "mlp-ab",
                     [label for label, _, _ in SHAPES])


if __name__ == "__main__":
    sys.exit(main())
