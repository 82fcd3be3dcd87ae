"""Time the K-l modes of window_attention_rows.cu in several checkouts of
this repository on one H100, alternating the checkouts:

    python3 window_rows_ab.py PATH [PATH ...] [--rounds 2]

PATH is the root of a checkout (e.g. a commit unpacked with `git archive`).
The checkouts' libraries are built first, all at once; then, for each round,
each checkout in turn runs in a process of its own
(`python3 window_rows_ab.py --one PATH`), which prints one JSON line:

- `ms`: per-call ms of each K-l wrapper (window_attention_fused, _fused2,
  _v3, _v4 with its prep launch, _phased; their glue included) on the A/B
  benchmarks' inputs, 150 windows of 14x14, 12 heads, head dim 64, drawn
  as chip_smoke.py draws them (numpy default_rng(0): qkv N(0, 1), rel_h and
  rel_w 0.3·N(0, 1));
- `kernel_ms`: the kernel alone, `_window_rows_launch` on given bias rows
  [150, 12, 196, 16] (torch seed 0), q scaled before (`pre`) and after
  (`post`) the product;
- `out_abs_sum`: the sum of |output| of each wrapper, so that the
  checkouts can be seen to compute the same thing.

Times are CUDA-event means over 50 calls (100 for the kernel alone) after a
warm-up, the stream first held busy so that the host has queued every call.
Exits non-zero without a CUDA device or when a wrapper did not launch its
kernel.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys


def timed_ms(torch, fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(400_000 * iters)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def one(root: pathlib.Path, build_only: bool) -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("window_rows_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(root))
    from lvv_tpu_torch import kernels
    from lvv_tpu_torch.ops import attention as A
    if build_only:
        kernels.build_all(("window_attention_rows", "qr_prep"))
        return 0
    b, g, heads, d = 150, 14, 12, 64
    rng = np.random.default_rng(0)
    qkv, rh, rw = (torch.from_numpy(a).to(torch.bfloat16).cuda() for a in (
        rng.normal(size=(b, g * g, 3 * heads * d)),
        rng.normal(size=(g, g, d)) * 0.3, rng.normal(size=(g, g, d)) * 0.3))
    ms, sums = {}, {}
    for kind in ("fused", "fused2", "v3", "v4", "phased"):
        def fn(kind=kind):
            return getattr(A, f"window_attention_{kind}")(
                qkv, rh, rw, scale=d ** -0.5, heads=heads, win=g)
        name = f"window_attention_rows[{kind}]"
        before = kernels.launches[name]
        sums[kind] = float(fn().float().abs().sum())
        if kernels.launches[name] == before:
            raise AssertionError(f"{kind}: the wrapper did not launch {name}")
        ms[kind] = timed_ms(torch, fn, 50)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = [(torch.randn(b, heads, g * g, 16, generator=gen, device="cuda")
             * 0.3).to(torch.bfloat16) for _ in range(2)]
    kernel_ms = {}
    for pre in (True, False):
        kernel_ms["pre" if pre else "post"] = timed_ms(
            torch, lambda pre=pre: A._window_rows_launch(
                "fused", qkv, *rows, heads=heads, win=g, scale=d ** -0.5,
                prescale=pre), 100)
    print("window-rows-ab", json.dumps(dict(tree=str(root), ms=ms,
                                            kernel_ms=kernel_ms,
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
    me = [sys.executable, str(pathlib.Path(__file__).resolve())]
    builds = [subprocess.Popen(me + ["--one", "--build", str(r)])
              for r in roots]
    if any(p.wait() for p in builds):
        return 1
    for i in range(args.rounds):
        # alternate the order: A B .. then .. B A
        for r in (roots if i % 2 == 0 else roots[::-1]):
            if subprocess.run(me + ["--one", str(r)]).returncode:
                return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
