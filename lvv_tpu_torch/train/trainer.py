"""Trainer: VQA training on one card (counterpart of
lvv_tpu/train/trainer.py).

    setup: Tee logging + seed -> model / optimizer -> resume (the newest
    loadable checkpoint, the whole train state with its generator) ->
    epoch loop { train step, step checkpoints with pruning,
    teacher-forced validation, inference sampling + task metrics,
    best checkpoint, `latest`, history.json }

As in the JAX loop: a resumed run skips the batches of its epoch that it
already took; the step metrics stay on the card and are read at the log
points only (a read waits for the card); gradient accumulation lives in
the optimizer (MultiSteps). Host batches are collated and copied to the
card two ahead on a worker thread (`Prefetcher`). One card only: a mesh of
more than one device raises NotImplementedError.
"""
from __future__ import annotations

import json
import pathlib
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import VQAConfig
from ..data import (Collator, DeterministicSampler, MixedNuDataset,
                    Prefetcher, load_tokenizer, make_nusc_handle, split_rows)
from ..models.layers import resolve_device
from ..models.vqa import VQAModel, greedy_generate
from ..utils import AverageMeter, SummaryWriter, Tee, is_host_zero, log0, \
    seed_all
from .checkpoints import CheckpointManager
from .metrics import metrics_by_template
from .optim import count_by_group, make_optimizer
from .train_step import (create_state, load_masters, make_eval_step,
                         make_train_step)


def check_mesh(cfg: VQAConfig) -> None:
    """The port trains on one card: a mesh of more than one device (JAX's
    data / model axes) is not ported."""
    if cfg.mesh.model != 1 or cfg.mesh.data not in (-1, 1):
        raise NotImplementedError(
            f"mesh data={cfg.mesh.data} model={cfg.mesh.model}: the port "
            "trains on one card (DDP / TP are not ported)")


def build_model(cfg: VQAConfig, device) -> VQAModel:
    """The VQAModel that `cfg` describes (its dtype, LoRA ranks and alphas;
    a LoRA config that is not enabled gives rank 0), its weights drawn from
    train.seed, on `device`."""
    m = cfg.model
    return VQAModel(
        m, dtype=torch.bfloat16 if m.dtype == "bfloat16" else torch.float32,
        device=device,
        llm_lora_rank=m.llm_lora.r if m.llm_lora.enabled else 0,
        llm_lora_alpha=m.llm_lora.alpha,
        clip_lora_rank=m.clip_lora.r if m.clip_lora.enabled else 0,
        clip_lora_alpha=m.clip_lora.alpha, seed=cfg.train.seed)


class Trainer:
    def __init__(self, cfg: VQAConfig,
                 dataset: Optional[MixedNuDataset] = None, tokenizer=None,
                 device=None):
        check_mesh(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.out_dir = pathlib.Path(cfg.train.output_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.generator = seed_all(cfg.train.seed, self.device)

        self.tokenizer = tokenizer or load_tokenizer(
            None, cfg.model.llm.special_tokens)
        if dataset is None:
            dataset = MixedNuDataset(
                cfg.data.bev_features_dir, cfg.data.caption_json,
                cfg.data.grounding_json,
                grounding_template_filter=cfg.data.grounding_template_filter,
                nusc=make_nusc_handle(cfg.data.nuscenes_root),
                dataroot=cfg.data.nuscenes_root)
        self.dataset = dataset
        n = len(self.dataset)
        if n == 0:
            raise ValueError("dataset is empty — check data paths")
        self.train_idx, self.val_idx = split_rows(
            n, cfg.data.val_fraction, cfg.train.seed)
        log0(f"[trainer] dataset: {n} rows "
             f"({len(self.train_idx)} train / {len(self.val_idx)} val)")

        m = cfg.model
        self.model = build_model(cfg, self.device)
        self.collator = Collator(
            self.tokenizer, cfg.train.max_prompt_tokens,
            cfg.train.max_answer_tokens, m.sam.img_size,
            (m.bev_channels,) + tuple(m.bev_hw))

        self.batch_size = cfg.train.batch_size
        self.steps_per_epoch = max(len(self.train_idx) // self.batch_size, 1)
        total = self.steps_per_epoch * cfg.train.epochs
        self.ckpt = CheckpointManager(self.out_dir / "checkpoints",
                                      keep_last=cfg.train.keep_last_ckpts)
        self._init_state(total)
        self.history: List[Dict] = []
        self.best_val = float("inf")

    # ------------------------------------------------------------- setup

    def _init_state(self, total_steps: int) -> None:
        log0("[trainer] params by group:",
             json.dumps(count_by_group(self.model)))
        self.tx, _ = make_optimizer(self.cfg.train.optim, self.model,
                                    total_steps)
        self.state = create_state(self.model, self.tx, self.generator)
        restored, step = (self.ckpt.try_restore_newest(self.state)
                          if self.cfg.train.resume else (None, 0))
        if restored is not None:
            load_masters(self.model, self.state)
            log0(f"[trainer] resumed from step {step}")
        self.start_step = int(step)
        self.train_step = make_train_step(self.model, self.tx)
        self.eval_step = make_eval_step(self.model)

    # ------------------------------------------------------------- loops

    def _batches(self, indices, epoch: int, shuffle: bool = True):
        sampler = DeterministicSampler(indices, seed=self.cfg.train.seed,
                                       shuffle=shuffle)
        sampler.set_epoch(epoch)
        buf = []
        for i in sampler:
            buf.append(self.dataset[int(i)])
            if len(buf) == self.batch_size:
                yield self.collator(buf, self.cfg.train.use_vision,
                                    self.cfg.train.use_lidar)
                buf = []

    def train(self) -> Dict:
        cfg = self.cfg
        tb = (SummaryWriter(self.out_dir / "tensorboard") if is_host_zero()
              else None)
        with Tee(str(self.out_dir / "train.log")):
            global_step = self.start_step
            start_epoch = global_step // self.steps_per_epoch
            for epoch in range(start_epoch, cfg.train.epochs):
                meter = AverageMeter()
                t_epoch = time.perf_counter()
                skip = (global_step % self.steps_per_epoch
                        if epoch == start_epoch else 0)
                batches = Prefetcher(
                    self._batches(self.train_idx, epoch),
                    prepare=lambda b: b.to(self.device, non_blocking=True),
                    depth=2)
                # the metrics are read at log points only: a read per step
                # would wait for the card every step
                pending = []
                with batches:
                    for bi, batch in enumerate(batches):
                        if bi < skip:            # mid-epoch resume
                            continue
                        self.state, metrics = self.train_step(self.state,
                                                              batch)
                        global_step += 1
                        pending.append(metrics)
                        if global_step % cfg.train.log_every == 0:
                            for m in pending:
                                meter.update(float(m["loss"]))
                            pending.clear()
                            gn = float(metrics["grad_norm"])
                            log0(f"[e{epoch} s{global_step}] "
                                 f"loss {meter.val:.4f} "
                                 f"(avg {meter.avg:.4f}) gnorm {gn:.3f}")
                            if tb is not None:
                                tb.add_scalar("train/loss", meter.val,
                                              global_step)
                                tb.add_scalar("train/grad_norm", gn,
                                              global_step)
                        if global_step % cfg.train.save_every_steps == 0:
                            self.ckpt.save(self.state, step=global_step,
                                           cfg=cfg)
                for m in pending:   # the epoch's tail, for its average
                    meter.update(float(m["loss"]))
                record = {"epoch": epoch, "step": global_step,
                          "train_loss": meter.avg,
                          "epoch_seconds": time.perf_counter() - t_epoch}

                if (epoch + 1) % cfg.train.val_every_epochs == 0:
                    record["val_loss"] = self.validate()
                    if tb is not None:
                        tb.add_scalar("val/loss", record["val_loss"],
                                      global_step)
                    if record["val_loss"] < self.best_val:
                        self.best_val = record["val_loss"]
                        self.ckpt.save(self.state, step=global_step,
                                       tag=f"best_e{epoch}", cfg=cfg,
                                       is_best=True)
                if (epoch + 1) % cfg.train.inference_sampling_every == 0:
                    record["inference"] = self.inference_sample(
                        cfg.train.inference_samples)
                self.ckpt.save(self.state, step=global_step, tag="latest",
                               cfg=cfg)
                self.history.append(record)
                self._write_history()
                if tb is not None:
                    tb.flush()
                log0(f"[epoch {epoch}] {json.dumps(record, default=str)}")
        if tb is not None:
            tb.close()
        return {"steps": global_step, "history": self.history}

    def validate(self) -> float:
        total, count = 0.0, 0
        for batch in self._batches(self.val_idx, 0, shuffle=False):
            loss, n = self.eval_step(batch)
            total += float(loss) * int(n)
            count += int(n)
        return total / max(count, 1)

    def inference_sample(self, n: int) -> Dict:
        """Greedy answers for n held-out rows, scored by template (captions
        and det_area grounding); the rows go to inference_samples.json."""
        rows = [self.dataset[int(i)] for i in self.val_idx[:n]]
        if not rows:
            return {}
        preds, refs, templates, dump = [], [], [], []
        for r in rows:
            batch = self.collator([{**r, "answer": None}])
            prompt_len = int(batch.text_len[0])
            toks, lens = greedy_generate(
                self.model, batch.bev, batch.images, batch.view_valid,
                batch.text_ids[:, :prompt_len], batch.text_len,
                max_new_tokens=self.cfg.train.max_answer_tokens,
                eos_id=self.tokenizer.eos_id)
            text = self.tokenizer.decode(
                np.asarray(toks[0][:int(lens[0])].cpu()).tolist())
            preds.append(text)
            refs.append(r["answer"])
            templates.append(r["template_type"])
            dump.append({"token": r["token"], "question": r["question"],
                         "reference": r["answer"], "generated": text,
                         "template_type": r["template_type"]})
        (self.out_dir / "inference_samples.json").write_text(
            json.dumps(dump, indent=2))
        return metrics_by_template(preds, refs, templates)

    def _write_history(self) -> None:
        (self.out_dir / "history.json").write_text(
            json.dumps(self.history, indent=2, default=str))
        try:
            from .plotting import plot_history
        except ImportError:
            return
        try:
            plot_history(self.history, self.out_dir / "curves.png")
        except ImportError:          # matplotlib absent: no curves
            pass
