"""VQA inference CLI of the port, batch and interactive (counterpart of
tools/infer_vqa.py).

    python -m lvv_tpu_torch.tools.infer_vqa --checkpoint DIR \\
        --questions rows.json [--out answers.json] [--device cpu]
    python -m lvv_tpu_torch.tools.infer_vqa --checkpoint DIR \\
        --interactive --bev token.npy

Batch rows: {"question": str, "bev_path": str[, "cam_paths": [6 paths]]}.
Each answer prints as one JSON line {"question", "answer"}; a row that
fails answers "<error: ...>" and the others go on. Runs on the card unless
`--device` says otherwise.
"""
from __future__ import annotations

import argparse
import json
import pathlib

import numpy as np


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--tokenizer", default=None)
    p.add_argument("--questions", default=None, help="batch questions JSON")
    p.add_argument("--interactive", action="store_true")
    p.add_argument("--bev", default=None, help="BEV .npy for interactive")
    p.add_argument("--max-new-tokens", type=int, default=96)
    p.add_argument("--no-vision", action="store_true")
    p.add_argument("--no-lidar", action="store_true")
    p.add_argument("--out", default=None, help="output JSON path")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)
    if not args.interactive and not args.questions:
        p.error("give --questions or --interactive")
    if args.interactive and not args.bev:
        p.error("--bev is required for interactive mode")

    from lvv_tpu_torch.inference import InferenceEngine, ModelLoader

    loader = ModelLoader(args.checkpoint, args.tokenizer)
    model, _ = loader.load_all(args.device)
    engine = InferenceEngine(model, loader.tokenizer,
                             max_new_tokens=args.max_new_tokens)
    kw = dict(use_vision=not args.no_vision, use_lidar=not args.no_lidar)

    if args.interactive:
        bev = np.load(args.bev).astype(np.float32)
        print("interactive mode — empty line to exit")
        while True:
            try:
                q = input("Q> ").strip()
            except EOFError:
                break
            if not q:
                break
            print("A>", engine.generate(q, bev, **kw))
        return

    rows = json.loads(pathlib.Path(args.questions).read_text())
    answers = []
    for row in rows:
        try:
            bev = np.load(row["bev_path"]).astype(np.float32)
            cams = row.get("cam_paths")
            a = engine.generate_batch([row["question"]], [bev],
                                      [cams] if cams else None, **kw)[0]
        except Exception as e:   # a bad row answers with its error
            a = f"<error: {e}>"
        answers.append({"question": row.get("question"), "answer": a})
        print(json.dumps(answers[-1]), flush=True)
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(answers, indent=2))


if __name__ == "__main__":
    main()
