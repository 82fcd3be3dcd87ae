"""Time the port's attention kernels in several checkouts of this
repository on one H100, alternating the checkouts: the flash attention
kernel (K-e, `flash_attention`) and the rel-pos attention kernel (K-c /
K-d, the float arm of `relpos_attention`) at every main-path shape, the
three int8 p@v launches (K-d8, `relpos_attention(..., pv_int8=True)`, at
1024²; K-h's int8 arm at 1280² and its fused form at its benchmark's
shape), the int8 scores of K-g (`relpos_attention_qk8`, its prep kernel
included) at 1024², and the window kernel (K-l's five bodies, B-1's four variants,
B-2) and the float forms of K-h (`flash_attention_relpos`: streaming,
fused, small; K-m on the fused form) at their benchmarks' shapes:

    python3 attention_ab.py PATH [PATH ...] [--rounds 2]

PATH is the root of a checkout (e.g. a commit unpacked with `git archive`).
The checkouts' libraries are built first, all at once; then, for each round,
each checkout in turn runs in a process of its own
(`python3 attention_ab.py --one PATH`), which prints one JSON line:

- `ms`: per-call ms of each wrapper (its glue included) at every shape that
  chip_smoke.py's main paths give it: SAM at 1024² and 1280², and the
  serving model at batch 8 (the prompt of row 5 cut to 17 of 24 tokens);
  and at the shapes of the benchmarks that time the window and K-h forms
  (labels "bench ...", K-h's 80x80 streaming form "1280 ...");
- `out_abs_sum`: the sum of |output| at each shape, so that the checkouts
  can be seen to compute the same thing.

Inputs are drawn once per shape from torch's generator on the card (seed
0), the same in every checkout: q, k, v N(0, 1) as views of [B, S, H·d]
projections (K-h's too, its tables 0.5·N(0, 1)); the window bodies' and
bisect variants' qkv N(0, 1), rel_h and rel_w 0.3·N(0, 1), bias2's rows
0.5·N(0, 1) and expanders 0.1·N(0, 1); K-c / K-d's and K-m's qkv
0.5·N(0, 1) (K-d8's and K-g's N(0, 1), as chip_smoke.py draws them),
rel_h and rel_w 0.1·N(0, 1). Times are
CUDA-event means over 20 calls after a warm-up, the stream first held busy
so that the host has queued every call. After the last round the first
process prints one `attention-ab-summary` line: per shape, each
checkout's mean over the rounds and its ratio to the first checkout.
Exits non-zero without a CUDA device or when a wrapper did not launch its
kernel.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

# (label, kind, shape): flash (b, sq, sk, hq, hkv, d, causal, short row
# (row, kv_len) or None); relpos, relpos8 (b, g, heads, d); kh (b, g,
# heads, d, block_q, block_k, launch name[, quant8])
PRE = 1564                           # the 1024² prefill's tokens
SHORT_8 = (5, PRE - 24 + 17)         # (row, kv_len) cut short at batch 8
SHAPES = [
    ("1024 VATVision cross q768 kv1536 8h d256", "flash",
     (1, 768, 1536, 8, 8, 256, False, None)),
    ("1024 VATLiDAR cross q768 kv32400 8h d112", "flash",
     (1, 768, 32400, 8, 8, 112, False, None)),
    ("1024 Qwen prefill causal 1564 14/2h d64", "flash",
     (1, PRE, PRE, 14, 2, 64, True, None)),
    ("1024 windows [150,196,2304]", "relpos", (150, 14, 12, 64)),
    ("1024 global [6,4096,2304]", "relpos", (6, 64, 12, 64)),
    ("1024 K-d8 int8 global [6,4096,2304] groups 1024", "relpos8",
     (6, 64, 12, 64)),
    ("1024 K-g int8 scores global [6,4096,2304]", "qk8", (6, 64, 12, 64)),
    ("1280 VATVision self q1200 kv1200 8h d256", "flash",
     (1, 1200, 1200, 8, 8, 256, False, None)),
    ("1280 VATVision cross q1200 kv2400 8h d256", "flash",
     (1, 1200, 2400, 8, 8, 256, False, None)),
    ("1280 Qwen prefill causal 1996 14/2h d64", "flash",
     (1, 1996, 1996, 14, 2, 64, True, None)),
    ("1280 windows [216,196,2304]", "relpos", (216, 14, 12, 64)),
    ("batch8 VATVision cross 8x q768 kv1536 8h d256", "flash",
     (8, 768, 1536, 8, 8, 256, False, None)),
    ("batch8 VATLiDAR cross 8x q768 kv32400 8h d112", "flash",
     (8, 768, 32400, 8, 8, 112, False, None)),
    ("batch8 Qwen prefill causal 8x 1564 14/2h d64, row 5 short", "flash",
     (8, PRE, PRE, 14, 2, 64, True, SHORT_8)),
    ("batch8 windows [1200,196,2304]", "relpos", (1200, 14, 12, 64)),
    ("batch8 global [48,4096,2304]", "relpos", (48, 64, 12, 64)),
] + [(f"bench window {k} [150,196,2304]", "window", (k, 150, 14, 12, 64))
     for k in ("fused", "fused2", "v3", "v4", "phased")] + [
    (f"bench bisect {v} [150,196,2304]", "bisect", (v, 150, 14, 12, 64))
    for v in ("dots_qk", "dots_qk_pv", "softmax", "bias2")] + [
    ("bench hmaj [150,12,196,64]", "hmaj", (150, 14, 12, 64)),
    # K-h (b, grid side, heads, d, block_q, block_k, launch name)
    ("1280 K-h streaming [6,12,6400,64]", "kh",
     (6, 80, 12, 64, 4096, 1024, "flash_attention_relpos[80x80]")),
    ("1280 K-h int8 [6,12,6400,64] groups 1024", "kh",
     (6, 80, 12, 64, 4096, 1024, "flash_attention_relpos_pv8[80x80]", True)),
    ("bench K-h fused [6,12,4096,64]", "kh",
     (6, 64, 12, 64, 4096, 1024, "flash_attention_relpos_fused[64x64]")),
    ("bench K-h fused int8 [6,12,4096,64] groups 1024", "kh",
     (6, 64, 12, 64, 4096, 1024, "flash_attention_relpos_fused_pv8[64x64]",
      True)),
    ("bench K-h small [150,12,196,64]", "kh",
     (150, 14, 12, 64, 256, 256, "flash_attention_relpos_mh[14x14]")),
    ("bench K-m prepped [6,4096,2304]", "prepped", (6, 64, 12, 64)),
]


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


def case(torch, A, kind, shape):
    """(wrapper call, launch-count name) on seeded inputs."""
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*s, std=1.0):
        return (torch.randn(s, generator=gen, device="cuda") * std).to(
            torch.bfloat16)
    if kind == "flash":
        b, sq, sk, hq, hkv, d, causal, short = shape
        q = rnd(b, sq, hq * d).view(b, sq, hq, d).transpose(1, 2)
        k = rnd(b, sk, hkv * d).view(b, sk, hkv, d).transpose(1, 2)
        v = rnd(b, sk, hkv * d).view(b, sk, hkv, d).transpose(1, 2)
        kv_len = None
        if causal:
            kv_len = torch.full((b,), sk, dtype=torch.int32, device="cuda")
            if short:
                kv_len[short[0]] = short[1]
        return (lambda: A.flash_attention(q, k, v, causal=causal,
                                          kv_len=kv_len)), "flash_attention"
    if kind == "kh":
        b, g, heads, d, bq, bk, name, *quant8 = shape
        s = g * g
        q, k, v = rnd(b, s, 3 * heads * d).view(b, s, 3, heads, d).permute(
            2, 0, 3, 1, 4)
        ops = (q, k, v, rnd(b, heads, s, g, std=0.5),
               rnd(b, heads, s, g, std=0.5))
        return (lambda: A.flash_attention_relpos(
            *ops, scale=d ** -0.5, grid_w=g, block_q=bq, block_k=bk,
            quant8=bool(quant8))), name
    if kind == "hmaj":
        b, g, heads, d = shape
        q, k, v = (rnd(b, heads, g * g, d) for _ in range(3))
        return (lambda: A.window_attention_hmaj(q, k, v, scale=d ** -0.5)), \
            "window_attention_rows[hmaj]"
    if kind in ("window", "bisect"):
        variant, b, g, heads, d = shape
        s = g * g
        qkv = rnd(b, s, 3 * heads * d)
        if kind == "window":
            rh, rw = rnd(g, g, d, std=0.3), rnd(g, g, d, std=0.3)
            fn = getattr(A, f"window_attention_{variant}")
            return (lambda: fn(qkv, rh, rw, scale=d ** -0.5, heads=heads,
                               win=g)), f"window_attention_rows[{variant}]"
        qrh, qrw = (rnd(b, heads, s, 16, std=0.5) for _ in range(2))
        eh, ew = (rnd(16, s, std=0.1) for _ in range(2))
        return (lambda: A.window_attention_bisect(
            qkv, variant=variant, heads=heads, scale=d ** -0.5, qrh=qrh,
            qrw=qrw, eh=eh, ew=ew)), f"window_attention_rows[{variant}]"
    b, g, heads, d = shape
    qkv = rnd(b, g * g, 3 * heads * d,
              std=1.0 if kind in ("relpos8", "qk8") else 0.5)
    rh, rw = rnd(g, g, d, std=0.1), rnd(g, g, d, std=0.1)
    if kind == "qk8":
        return (lambda: A.relpos_attention_qk8(
            qkv, rh, rw, heads=heads, scale=d ** -0.5)), \
            f"relpos_attention_qk8[{g}x{g}]"
    if kind == "relpos8":
        return (lambda: A.relpos_attention(
            qkv, rh, rw, heads=heads, scale=d ** -0.5, pv_int8=True,
            pv_group=1024)), f"relpos_attention_pv8[{g}x{g}]"
    if kind == "prepped":
        return (lambda: A.flash_attention_relpos_hpacked_prepped(
            qkv, rh, rw, scale=d ** -0.5, grid_w=g, heads=heads)), \
            f"flash_attention_relpos_hpacked_prepped[{g}x{g}]"
    return (lambda: A.relpos_attention(qkv, rh, rw, heads=heads,
                                       scale=d ** -0.5)), \
        f"relpos_attention[{g}x{g}]"


def one(root: pathlib.Path, build_only: bool) -> int:
    import torch
    if not torch.cuda.is_available():
        print("attention_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(root))
    from lvv_tpu_torch import kernels
    from lvv_tpu_torch.ops import attention as A
    if build_only:
        kernels.build_all(("flash_attention", "relpos_attention",
                           "flash_attention_relpos", "window_attention_rows",
                           "qr_prep", "relpos_attention_qk8"))
        return 0
    ms, sums = {}, {}
    for label, kind, shape in SHAPES:
        fn, name = case(torch, A, kind, shape)
        before = kernels.launches[name]
        sums[label] = float(fn().float().abs().sum())
        if kernels.launches[name] == before:
            raise AssertionError(f"{label}: the wrapper did not launch {name}")
        ms[label] = timed_ms(torch, fn, 20)
        del fn
        torch.cuda.empty_cache()
    print("attention-ab", json.dumps(dict(tree=str(root), ms=ms,
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
    return alternate(__file__, roots, args.rounds, "attention-ab",
                     [label for label, _, _ in SHAPES])


def alternate(script, roots, rounds: int, tag: str, labels) -> int:
    """Build every checkout (`script --one --build PATH`, all at once), then
    run `script --one PATH` for each checkout in turn, `rounds` times in
    alternating order; each prints a line `tag {..., "ms": {label: ms}}`.
    Prints `tag-summary`: per label, each checkout's mean ms over the
    rounds and its ratio to the first checkout's."""
    me = [sys.executable, str(pathlib.Path(script).resolve())]
    builds = [subprocess.Popen(me + ["--one", "--build", str(r)])
              for r in roots]
    if any(p.wait() for p in builds):
        return 1
    runs = {str(r): [] for r in roots}
    for i in range(rounds):
        # alternate the order: A B .. then .. B A
        for r in (roots if i % 2 == 0 else roots[::-1]):
            proc = subprocess.run(me + ["--one", str(r)], capture_output=True,
                                  text=True)
            sys.stdout.write(proc.stdout)
            sys.stderr.write(proc.stderr)
            if proc.returncode:
                return 1
            line = next(ln for ln in proc.stdout.splitlines()
                        if ln.startswith(f"{tag} "))
            runs[str(r)].append(json.loads(line.split(" ", 1)[1])["ms"])
    first = str(roots[0])
    summary = {}
    for label in labels:
        mean = {t: sum(m[label] for m in ms) / len(ms)
                for t, ms in runs.items()}
        summary[label] = {t: dict(ms=v, vs_first=v / mean[first])
                          for t, v in mean.items()}
    print(f"{tag}-summary", json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
