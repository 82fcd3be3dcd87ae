"""Time the port's end-to-end paths in several checkouts of this repository
on one H100, alternating the checkouts, so that their batch-1 latencies are
compared on one host:

    python3 path_ab.py PATH [PATH ...] [--rounds 2] [--runs 5]
                       [--sizes 1024,1280]

PATH is the root of a checkout (e.g. a commit unpacked with `git archive`).
The checkouts' kernels are built first, all at once; then, for each round,
each checkout in turn runs in a process of its own
(`python3 path_ab.py --one PATH`) that drives the paths of chip_smoke.py
through `greedy_generate`, with the checkout's own chip_smoke.py for the
models and inputs (random weights from seed 0, bench.py's inputs, 32 new
tokens):

- "float 1024": default_config() with SAM at 1024², float decode
  ("main-path");
- "serving 1024": the serving model (int8 SAM / CLIP, packed int8 decode)
  under LVV_Q8_SCOPE=mlp ("serving-path");
- "serving-batch 8": the same at batch 8 with row 5's prompt cut to 17
  tokens ("serving-batch[8]");
- "serving 1024 mlp,dense,attn": the serving model at 1024² under that
  scope, where SAM's 4 global layers run the int8 p@v arm K-d8
  ("serving-path[mlp,dense,attn]");
- "serving 1024 mlp,dense,qk": the same under that scope, where they run
  the int8 scores K-g ("serving-path[mlp,dense,qk]");
- "float 1280": SAM at 1280², float ("main-path[sam1280]");
- "serving 1280 mlp,dense,attn": the serving model at 1280² under that
  scope ("serving-path[sam1280,mlp,dense,attn]").

`--sizes 1024` drives the first five only. Each path is warmed up once,
then timed `--runs` times on the host's clock (synchronised), and so is its
encode alone (`encode_prefix` of the views and BEV grid, as chip_smoke.py
times it: device-bound at batch 8, less at the host's mercy than the p50);
the process prints one JSON line with every time, the p50s and the first
row's tokens. After the last round the first process prints one
`path-ab-summary` line: per path, each checkout's p50 over all its runs,
its per-round p50s, its ratio to the first checkout's, the same three for
the encode, and whether every run of every checkout gave the same tokens.
Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

QK_SCOPE = "mlp,dense,qk"
PATHS = ("float 1024", "serving 1024", "serving-batch 8",
         "serving 1024 mlp,dense,attn", f"serving 1024 {QK_SCOPE}",
         "float 1280", "serving 1280 mlp,dense,attn")


def drive(torch, cs, model, args, packed, runs: int) -> dict:
    from lvv_tpu_torch import greedy_generate

    def generate():
        toks, _ = greedy_generate(model, *args, max_new_tokens=cs.NEW_TOKENS,
                                  eos_id=cs.EOS_ID, params_decode=packed)
        torch.cuda.synchronize()
        return toks

    def encode():
        with torch.inference_mode():
            model.encode_prefix(*args[:3]).float().sum().item()
        torch.cuda.synchronize()

    toks = generate()                            # warm-up
    encode()
    times, enc = [], []
    for fn, out in ((generate, times), (encode, enc)):
        for _ in range(runs):
            t0 = time.perf_counter()
            fn()
            out.append(time.perf_counter() - t0)
    return dict(times_s=times, p50_s=statistics.median(times),
                encode_s=enc, encode_p50_s=statistics.median(enc),
                tokens=toks[0].tolist())


def one(root: pathlib.Path, build_only: bool, runs: int, sizes) -> int:
    import torch
    if not torch.cuda.is_available():
        print("path_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(root))
    from lvv_tpu_torch import VQAModel, kernels
    if build_only:
        kernels.build_all()
        return 0
    import chip_smoke as cs            # the checkout's own
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def on_card(arrays):
        return [torch.as_tensor(a, device="cuda") for a in arrays]

    out = {}
    for size in sizes:
        cfg = cs.config(size, quant8=False)
        model = VQAModel(cfg, dtype=torch.bfloat16, device="cuda", seed=0)
        out[f"float {size}"] = drive(torch, cs, model,
                                     on_card(cs.bench_inputs(cfg)), None, runs)
        del model
        torch.cuda.empty_cache()
        cfg, model, args, packed = cs.serving_model(torch, size)
        scope = "mlp" if size == 1024 else cs.LARGE_SCOPE
        with cs.q8_scope_env(scope):
            key = f"serving {size}" + ("" if size == 1024 else f" {scope}")
            out[key] = drive(torch, cs, model, args, packed, runs)
            if size == 1024:
                out[f"serving-batch {cs.SERVING_BATCH}"] = drive(
                    torch, cs, model, on_card(cs.serving_batch_inputs(
                        cfg, cs.SERVING_BATCH)), packed, runs)
        if size == 1024:
            for scope in (cs.LARGE_SCOPE, QK_SCOPE):
                with cs.q8_scope_env(scope):
                    out[f"serving {size} {scope}"] = drive(
                        torch, cs, model, args, packed, runs)
        del model, packed
        torch.cuda.empty_cache()
    print("path-ab", json.dumps(dict(tree=str(root), card=cs.card_line(),
                                     paths=out)), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="+", type=pathlib.Path)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--sizes", default="1024,1280",
                    help="SAM resolutions whose paths to drive")
    ap.add_argument("--one", action="store_true",
                    help="time the one checkout PATH in this process")
    ap.add_argument("--build", action="store_true",
                    help="with --one: only build its kernels")
    args = ap.parse_args()
    roots = [p.resolve() for p in args.paths]
    sizes = [int(v) for v in args.sizes.split(",")]
    if args.one:
        return one(roots[0], args.build, args.runs, sizes)
    me = [sys.executable, str(pathlib.Path(__file__).resolve())]
    builds = [subprocess.Popen(me + ["--one", "--build", str(r)])
              for r in roots]
    if any(p.wait() for p in builds):
        return 1
    runs = {str(r): [] for r in roots}
    for i in range(args.rounds):
        # alternate the order: A B .. then .. B A
        for r in (roots if i % 2 == 0 else roots[::-1]):
            proc = subprocess.run(me + ["--one", "--runs", str(args.runs),
                                        "--sizes", args.sizes, str(r)],
                                  capture_output=True, text=True)
            sys.stdout.write(proc.stdout)
            sys.stderr.write(proc.stderr)
            if proc.returncode:
                return 1
            line = next(ln for ln in proc.stdout.splitlines()
                        if ln.startswith("path-ab "))
            runs[str(r)].append(json.loads(line.split(" ", 1)[1])["paths"])
    first = str(roots[0])
    summary = {}
    for name in (n for n in PATHS if n in runs[first][0]):
        summary[name] = {t: {} for t in runs}
        for key, samples in (("", "times_s"), ("encode_", "encode_s")):
            p50 = {t: statistics.median([x for p in rs
                                         for x in p[name][samples]])
                   for t, rs in runs.items()}
            for t, v in p50.items():
                summary[name][t].update({
                    f"{key}p50_s": v, f"{key}vs_first": v / p50[first],
                    f"{key}round_p50s": [p[name][f"{key}p50_s"]
                                         for p in runs[t]]})
        summary[name]["tokens_equal"] = len({
            json.dumps(p[name]["tokens"]) for rs in runs.values()
            for p in rs}) == 1
    print("path-ab-summary", json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
