"""Time kernel K-a (the row norm and its add form) and the q·R preps of K-l
and K-m in several checkouts of this repository on one H100, alternating
the checkouts:

    python3 norm_prep_ab.py PATH [PATH ...] [--rounds 2]

PATH is the root of a checkout (e.g. a commit unpacked with `git archive`).
The checkouts' libraries are built first, all at once; then, for each
round, each checkout in turn runs in a process of its own
(`python3 norm_prep_ab.py --one PATH`), which prints one JSON line:

- `ms`: per-call device ms of `norm` at every row-norm shape of
  chip_smoke.py's 1024² paths and of the decode at batch 1 and 8; of the
  residual add and the RMS norm after it at the decode's and the
  prefill's shapes ("add"), as the checkout runs it: `add_norm` where it
  has one, else PyTorch's x + y then `norm`; of the q·R preps at their
  benchmarks' shapes (`window_bias_prep`, `hpacked_prep` per mode) and of
  the two wrappers that run them (`window_attention_v4`,
  `flash_attention_relpos_hpacked_prepped`);
- under the same `ms` key, "host_us ..." labels: the host's time a call in
  us (host clock, 2,000 calls, synchronised every 50 so that the queue
  stays short) at [1, 896] bf16 of `norm`, of the add ("add", as above)
  and of the pair x + y then `norm`;
- `out_abs_sum`: the sum of |output| at each device shape, so that the
  checkouts can be seen to compute the same thing.

Inputs are drawn once per shape from torch's generator on the card (seed
0), as chip_smoke.py draws them (x, y N(0, 1), the scale 1 + 0.1·N(0, 1),
the bias 0.1·N(0, 1)); the preps take the A/B benchmarks' inputs
(chip_smoke.benchmark_inputs). Device times are CUDA-event means over 20
calls after a warm-up, the stream first held busy so that the host has
queued every call (attention_ab.py's `timed_ms`). After the last round the
first process prints one `norm-prep-ab-summary` line: per label, each
checkout's mean over the rounds and its ratio to the first checkout. Exits
non-zero without a CUDA device or when a wrapper did not launch its
kernel.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

from attention_ab import alternate, timed_ms
from chip_smoke import GLOBAL, WINDOWS, benchmark_inputs, host_us

# (label, rows, C, rms) of `norm`: chip_smoke.py's 1024² row norms, then
# the decode at batch 1 and 8
NORMS = [("LN SAM", 24576, 768, False), ("LN SAM neck", 24576, 256, False),
         ("LN CLIP", 1542, 1024, False), ("LN adapter", 1536, 2048, False),
         ("LN VATVision", 768, 2048, False), ("LN VAT out", 768, 896, False),
         ("LN VATLiDAR in", 32400, 896, False),
         ("RMS prefill", 1564, 896, True), ("RMS decode", 1, 896, True),
         ("RMS decode b8", 8, 896, True)]
ADDS = [1, 8, 1564, 1996]            # rows of the add + RMS norm, C = 896
PREPS = ["qr_prep[rows]", "qr_prep[qk]", "qr_prep[v]",
         "window_attention_v4", "hpacked_prepped"]
HOST = ["norm", "add", "pair"]
LABELS = ([f"norm {n} [{r},{c}]" for n, r, c, _ in NORMS]
          + [f"add [{r},896]" for r in ADDS] + PREPS
          + [f"host_us {k} [1,896]" for k in HOST])


def cases(torch):
    """(label, wrapper call, launch-count names) on seeded inputs; for a
    host time, (label, us, None)."""
    from lvv_tpu_torch.ops import attention as A
    from lvv_tpu_torch.ops import fused_mlp as M
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*s, std=1.0):
        return (torch.randn(s, generator=gen, device="cuda") * std).to(
            torch.bfloat16)

    def add_fn(x, y, s):
        if hasattr(M, "add_norm"):
            return (lambda: M.add_norm(x, y, s, eps=1e-6, rms=True)[1],
                    ("norm[add]",))
        return (lambda: M.norm(x + y, s, eps=1e-6, rms=True), ("norm",))

    for name, r, c, rms in NORMS:
        x, s, b = rnd(r, c), 1 + rnd(c, std=0.1), rnd(c, std=0.1)
        yield (f"norm {name} [{r},{c}]",
               lambda x=x, s=s, b=None if rms else b, rms=rms: M.norm(
                   x, s, b, eps=1e-6, rms=rms), ("norm",))
    for r in ADDS:
        x, y, s = rnd(r, 896), rnd(r, 896), 1 + rnd(896, std=0.1)
        fn, names = add_fn(x, y, s)
        yield f"add [{r},896]", fn, names
    b, g, heads, d = WINDOWS
    qkv, rh, rw = benchmark_inputs(torch, *WINDOWS)
    yield ("qr_prep[rows]", lambda: A.window_bias_prep(
        qkv, rh, rw, heads=heads, win=g), ("qr_prep[rows]",))
    yield ("window_attention_v4", lambda: A.window_attention_v4(
        qkv, rh, rw, scale=d ** -0.5, heads=heads, win=g),
        ("qr_prep[rows]", "window_attention_rows[v4]"))
    b, g, heads, d = GLOBAL
    qkv, rh, rw = benchmark_inputs(torch, *GLOBAL)
    for mode in ("qk", "v"):
        yield (f"qr_prep[{mode}]", lambda mode=mode: A.hpacked_prep(
            qkv, rh, rw, heads=heads, grid_w=g, scale=d ** -0.5,
            modes=(mode,)), (f"qr_prep[{mode}]",))
    yield ("hpacked_prepped",
           lambda: A.flash_attention_relpos_hpacked_prepped(
               qkv, rh, rw, scale=d ** -0.5, grid_w=g, heads=heads),
           ("qr_prep[qk]", "qr_prep[v]"))
    x, y = rnd(1, 896), rnd(1, 896)
    s = torch.ones(896, dtype=torch.bfloat16, device="cuda")
    fns = {"norm": lambda: M.norm(x, s, eps=1e-6, rms=True),
           "add": add_fn(x, y, s)[0],
           "pair": lambda: M.norm(x + y, s, eps=1e-6, rms=True)}
    for key in HOST:
        yield f"host_us {key} [1,896]", host_us(torch, fns[key]), None


def one(root: pathlib.Path, build_only: bool) -> int:
    import torch
    if not torch.cuda.is_available():
        print("norm_prep_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(root))
    from lvv_tpu_torch import kernels
    if build_only:
        kernels.build_all(tuple(n for n in ("norm", "qr_prep",
                                            "window_attention_rows",
                                            "flash_attention_relpos")
                                if n in kernels.SOURCES))
        return 0
    ms, sums = {}, {}
    for label, fn, names in cases(torch):
        if names is None:           # a host time, measured in `cases`
            ms[label] = fn
            continue
        before = [kernels.launches[n] for n in names]
        out = fn()
        out = out if isinstance(out, (tuple, list)) else (out,)
        sums[label] = sum(float(t.float().abs().sum()) for t in out)
        if any(kernels.launches[n] == b for n, b in zip(names, before)):
            raise AssertionError(f"{label}: a wrapper did not launch "
                                 f"{names}")
        ms[label] = timed_ms(torch, fn, 20)
    print("norm-prep-ab", json.dumps(dict(tree=str(root), ms=ms,
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
    return alternate(__file__, roots, args.rounds, "norm-prep-ab", LABELS)


if __name__ == "__main__":
    sys.exit(main())
