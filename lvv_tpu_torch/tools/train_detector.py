"""Detector training CLI of the port (counterpart of tools/train_detector.py).

    python -m lvv_tpu_torch.tools.train_detector --synthetic \\
        [--config cfg.json] [--set section.key=value ...] [--steps 20] \\
        [--batch 1] [--lr 1e-3] [--log-every 1] [--save-every 0] \\
        [--out runs/detector] [--device cpu]

Trains a detector with the JAX CLI's flags, defaults and chain: clip by
global norm 10, then AdamW (weight decay 1e-4) at a warmup-cosine schedule
from lr / 10 (`train.optim.detector_optimizer`). The family is --detector,
else the config file's `_detector` key (configs/nuscenes_*.json), else
VoxelNeXt; the port trains VoxelNeXt, PointPillars, CenterPoint, SECOND,
TransFusion, PillarNet and DSVT (configs/waymo_pillarnet.json,
waymo_dsvt_*.json) and the two-stage families (PVRCNN, PVRCNNPlusPlus, PartA2,
VoxelRCNN, SECONDNetIoU, PointRCNN: configs/kitti_*.json) through their
own `.loss`. BEVFusion and CaDDN build (`build_detector`) but do not
train: the JAX package has no train step that takes camera tensors, and
the CLI exits saying so. A focal Voxel R-CNN config
(configs/kitti_voxel_rcnn_car_focal_multimodal.json) trains its
LiDAR-only focal trunk, as JAX's step passes no image. `--synthetic`
takes tiny_config() (or --config) and one fixed generated batch (uniform
points, 8 boxes), as the JAX CLI's smoke mode does. MPPNet (--detector
MPPNet, configs/waymo_mppnet_*.json) trains on JAX's synthetic
multi-frame batch instead (`synthetic_mppnet_batch`: 4 frames of
max_points // 4 uniform points, 8 boxes, 32 proposals: the boxes plus
N(0, 0.3) noise, then random ones), each sample's RoI sampling drawing
from a torch.Generator seeded 11 (`make_mppnet_train_step`). MPPNetE2E
exits: the JAX CLI cannot train it (it steps every MPPNet-like family
with MPPNet's call, which MPPNetE2E's signature refuses with a
TypeError), and its preset is the reference's inference config. Each step prints `[i] loss L` and the family's loss terms
(e.g. `hm_loss H reg_loss R`) and `T ms`; checkpoints go to
OUT/checkpoints/step_N (the detector's parameters and running
statistics, without the optimizer state) every --save-every steps and at
the end; the last line is {"steps", "final_loss"}. Runs on the card
unless `--device` says otherwise, in fp32 with TF32 off. Real datasets
(--dataset without --synthetic) wait for the port's datasets
(ROADMAP.md, queue 1, item 2): they exit with a message saying so. The JAX CLI's real-data options (--tiny, --dataroot,
--info-path, --max-gt, --augment, --gt-db, --gt-quota, --cbgs,
--proposals, --seq-offsets) come with that mode.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np


def synthetic_batch(rng, b, n_pts, n_gt, point_range) -> dict:
    """The JAX CLI's synthetic batch: b clouds of n_pts uniform points,
    n_gt boxes each (labels 0-2, z -1, sizes 1-4 m)."""
    pts = rng.uniform(point_range[0], point_range[3],
                      (b, n_pts, 4)).astype(np.float32)
    pts[..., 2] = rng.uniform(point_range[2], point_range[5], (b, n_pts))
    boxes = np.zeros((b, n_gt, 9), np.float32)
    boxes[..., :2] = rng.uniform(point_range[0] * 0.8, point_range[3] * 0.8,
                                 (b, n_gt, 2))
    boxes[..., 2] = -1.0
    boxes[..., 3:6] = rng.uniform(1.0, 4.0, (b, n_gt, 3))
    boxes[..., 6] = rng.uniform(-np.pi, np.pi, (b, n_gt))
    labels = rng.integers(0, 3, (b, n_gt)).astype(np.int32)
    return {"points": pts, "num_points": np.full((b,), n_pts, np.int32),
            "gt_boxes": boxes, "gt_labels": labels,
            "gt_mask": np.ones((b, n_gt), bool)}


def synthetic_mppnet_batch(rng, b, n_frames, n_pts, n_gt, n_rois,
                           point_range) -> dict:
    """The JAX CLI's synthetic MPPNet batch: `synthetic_batch`'s gts, then
    b stacks of n_frames uniform clouds of n_pts points, and n_rois
    proposals: the gts plus N(0, 0.3) noise on every column, the rest at
    random centres with sizes 1-4 m (scores 0.5, labels 0)."""
    base = synthetic_batch(rng, b, n_pts, n_gt, point_range)
    fp = rng.uniform(point_range[0], point_range[3],
                     (b, n_frames, n_pts, 4)).astype(np.float32)
    fp[..., 2] = rng.uniform(point_range[2], point_range[5],
                             (b, n_frames, n_pts))
    pb = np.zeros((b, n_rois, 9), np.float32)
    pb[:, :n_gt] = base["gt_boxes"] + rng.normal(
        0, 0.3, (b, n_gt, 9)).astype(np.float32)
    pb[:, n_gt:, :2] = rng.uniform(point_range[0] * 0.8,
                                   point_range[3] * 0.8,
                                   (b, n_rois - n_gt, 2))
    pb[:, n_gt:, 3:6] = rng.uniform(1.0, 4.0, (b, n_rois - n_gt, 3))
    return {"frame_points": fp,
            "frame_counts": np.full((b, n_frames), n_pts, np.int32),
            "prop_boxes": pb,
            "prop_scores": np.full((b, n_rois), 0.5, np.float32),
            "prop_labels": np.zeros((b, n_rois), np.int32),
            "prop_count": np.full((b,), n_rois, np.int32),
            "gt_boxes": base["gt_boxes"], "gt_mask": base["gt_mask"]}


MPPNET_ROIS = 32
MPPNET_DRAW_SEED = 11
E2E_REFUSAL = (
    "MPPNetE2E does not train: the JAX CLI steps every MPPNet-like family "
    "with MPPNet's call (frame_points, frame_counts, proposals), which "
    "MPPNetE2E (bank, points, num_points, proposals) refuses with a "
    "TypeError, and its preset is the reference's inference-only "
    "memory-bank config; train MPPNet and load its head")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--detector", default=None,
                   help="registry family; defaults to the config file's "
                        "_detector key, else VoxelNeXt")
    p.add_argument("--config", default=None)
    p.add_argument("--set", action="append", default=[], dest="overrides")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--dataset", default="NuScenes",
                   help="registry dataset name (real-data mode, which "
                        "exits: see the module's docstring)")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--log-every", type=int, default=1)
    p.add_argument("--save-every", type=int, default=0,
                   help="intra-run checkpoint interval (0 = end only)")
    p.add_argument("--out", default="runs/detector")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    return p.parse_args(argv)


def main(argv=None):
    """Runs the CLI; returns (detector, last metrics as floats) to an
    in-process caller."""
    args = parse_args(argv)
    import torch

    from lvv_tpu_torch import config as C
    from lvv_tpu_torch.models.registry import build_detector
    from lvv_tpu_torch.train.checkpoints import CheckpointManager
    from lvv_tpu_torch.train.detector import (make_detector_train_step,
                                              make_mppnet_train_step)
    from lvv_tpu_torch.train.optim import detector_optimizer

    cfg = (C.load(C.VQAConfig, args.config, args.overrides) if args.config
           else C.apply_overrides(C.tiny_config(), args.overrides))
    detector = args.detector or (
        C.load_file(args.config).get("_detector") if args.config else None
    ) or "VoxelNeXt"
    if detector == "MPPNetE2E":
        raise SystemExit(E2E_REFUSAL)
    if not args.synthetic:
        raise SystemExit(f"real-data training (--dataset {args.dataset}) "
                         "waits for the port's detection datasets "
                         "(ROADMAP.md queue 1, item 2); use --synthetic")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        det = build_detector(detector, cfg.model.voxelnext, cfg.voxelize,
                             device=args.device)
    except NotImplementedError as e:
        raise SystemExit(str(e)) from None

    rng = np.random.default_rng(0)
    tx = detector_optimizer(args.lr, args.steps)
    if detector == "MPPNet":
        batch = synthetic_mppnet_batch(
            rng, args.batch, det.num_frames,
            cfg.voxelize.max_points // det.num_frames, 8, MPPNET_ROIS,
            cfg.voxelize.point_range)
        step = make_mppnet_train_step(
            det, tx, torch.Generator().manual_seed(MPPNET_DRAW_SEED))
    else:
        batch = synthetic_batch(rng, args.batch,
                                cfg.voxelize.max_points // 4, 8,
                                cfg.voxelize.point_range)
        try:
            step = make_detector_train_step(det, tx, cfg.model.voxelnext,
                                            cfg.voxelize)
        except NotImplementedError as e:        # the camera-input families
            raise SystemExit(str(e)) from None
    state = (det, tx.init(dict(det.named_parameters())))
    ckpt = CheckpointManager(args.out + "/checkpoints")
    metrics = {}
    for i in range(args.steps):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        metrics = {k: float(v) for k, v in metrics.items()}
        dt = time.perf_counter() - t0
        if i % args.log_every == 0 or i == args.steps - 1:
            extras = " ".join(
                f"{k} {v:.4f}" for k, v in sorted(metrics.items())
                if k not in ("loss", "grad_norm"))
            print(f"[{i}] loss {metrics['loss']:.4f} {extras} "
                  f"{dt * 1e3:.0f} ms", flush=True)
        if args.save_every and (i + 1) % args.save_every == 0:
            ckpt.save(state[0], step=i + 1, cfg=cfg)
    ckpt.save(state[0], step=args.steps, cfg=cfg)
    print(json.dumps({"steps": args.steps,
                      "final_loss": metrics.get("loss")}), flush=True)
    return det, metrics


if __name__ == "__main__":
    main()
