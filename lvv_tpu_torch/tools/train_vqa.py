"""VQA training CLI of the port (counterpart of tools/train_vqa.py).

    python -m lvv_tpu_torch.tools.train_vqa --config cfg.json \\
        --set train.epochs=5 --set model.llm_lora.r=32 [--device cpu]

The typed config and dotted overrides as in the JAX CLI; resume is
automatic from the newest loadable checkpoint under train.output_dir (set
train.resume=false to start fresh). Trains on the card unless `--device`
says otherwise; one card only.
"""
from __future__ import annotations

import argparse
import json


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--config", default=None, help="JSON config file")
    p.add_argument("--set", action="append", default=[], dest="overrides",
                   metavar="KEY.PATH=VALUE")
    p.add_argument("--tokenizer", default=None,
                   help="local HF tokenizer path (falls back to byte-level)")
    p.add_argument("--print-config", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)

    from lvv_tpu_torch import config as C
    from lvv_tpu_torch.data import load_tokenizer

    if args.config:
        cfg = C.load(C.VQAConfig, args.config, args.overrides)
    else:
        cfg = C.apply_overrides(C.default_config(), args.overrides)
    if args.print_config:
        print(json.dumps(C.to_dict(cfg), indent=2))
        return

    tokenizer = load_tokenizer(args.tokenizer, cfg.model.llm.special_tokens)
    from lvv_tpu_torch.train import Trainer
    result = Trainer(cfg, tokenizer=tokenizer, device=args.device).train()
    print(json.dumps({"steps": result["steps"]}))


if __name__ == "__main__":
    main()
