"""Detector training and evaluation utilities (counterpart of
lvv_tpu/train/detector.py).

- `make_detector_train_step`: JAX's jit'd step, which vmaps one sample's
  loss over the batch, as a loop of one sample's forward and backward at a
  time, each loss divided by the batch size. Every sample gets its own
  batch moments (the vmap's), the gradients add up to the gradient of the
  mean, and only one sample's graph is alive at a time. The "bn" running
  statistics become the batch mean of the per-sample updates,
  (1 - m)·ra + m·mean_b(moment_b), as JAX averages the vmap's.
- `make_bucketed_detector_train_step`: one step per capacity bucket, all
  on one set of parameters, and the host planner's pick of the smallest
  bucket that drops no voxel.
- `make_mppnet_train_step`: MPPNet's step (JAX's
  `make_mppnet_train_step`): each sample's trajectories refined, its RoIs
  sampled with its own pair of uniform draws, the RoI loss; the mean over
  the batch, one sample's graph at a time.
- `recall_stats`: recall of gt boxes at 3D IoU thresholds.

The step trains VoxelNeXt, PointPillars, CenterPoint, SECOND,
TransFusion, PillarNet, DSVT and the two-stage families (PV-RCNN, PV-RCNN++, Part-A²,
Voxel R-CNN with or without its focal trunk, SECOND-IoU, PointRCNN, each
through its own `.loss`; MPPNet trains through `make_mppnet_train_step`.
The camera-input families (BEVFusion, CaDDN) raise: the JAX
package's step feeds a detector points alone and has none that takes
camera tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from ..config.schema import VoxelizeConfig, VoxelNeXtConfig
from ..models.transfusion import transfusion_loss
from ..models.voxelnext_loss import dense_center_loss, voxelnext_loss
from ..ops.boxes import iou_3d

RECALL_THRESHOLDS = (0.3, 0.5, 0.7)
BATCH_KEYS = ("points", "num_points", "gt_boxes", "gt_labels", "gt_mask")
_ZOO = "ROADMAP.md queue 1, item 2 (the detector zoo)"


def detector_loss(det, out: Dict, boxes, labels, mask,
                  det_cfg: VoxelNeXtConfig, vox_cfg: VoxelizeConfig,
                  stride: int = 8):
    """JAX's family dispatch: a detector with its own `.loss(out, gt,
    labels, mask)` (SECOND, CaDDN, the two-stage families) -> that; `bev_sparse` in out -> the sparse
    VoxelNeXt loss; query-head preds (`cls` and `box`: TransFusion) ->
    transfusion_loss; dense centre-head preds (a 3-D `hm`: PointPillars,
    CenterPoint, PillarNet, DSVT) -> dense_center_loss."""
    if callable(getattr(type(det), "loss", None)):
        return det.loss(out, boxes, labels, mask)
    if not isinstance(out, dict):
        raise NotImplementedError(
            f"{type(det).__name__} returns {type(out).__name__}, not a "
            "preds dict")
    if "bev_sparse" in out:
        return voxelnext_loss(out["preds"], out["bev_sparse"], boxes,
                              labels, mask, det_cfg, vox_cfg, stride)
    preds = out.get("preds")
    if isinstance(preds, dict) and "cls" in preds and "box" in preds:
        return transfusion_loss(preds, boxes, labels, mask, det_cfg,
                                vox_cfg, stride)
    if isinstance(preds, dict) and "hm" in preds and preds["hm"].dim() == 3:
        return dense_center_loss(preds, boxes, labels, mask, det_cfg,
                                 vox_cfg)
    raise NotImplementedError(
        f"{type(det).__name__} needs a family-specific train step "
        f"({_ZOO})")


def make_detector_train_step(det, tx, det_cfg: VoxelNeXtConfig,
                             vox_cfg: VoxelizeConfig,
                             stride: int | None = None):
    """-> step(state, batch) -> (state, metrics), state = (det, opt_state)
    with opt_state = tx.init(dict(det.named_parameters())), updated in
    place, for any family `detector_loss` takes. batch: points [B, N, 4],
    num_points [B], gt_boxes [B, G, 9], gt_labels [B, G], gt_mask [B, G]
    (numpy or tensors; moved to the detector's device). metrics: the batch
    means of `loss` and of the family's loss terms (VoxelNeXt and the
    dense centre head: `hm_loss`, `reg_loss`; SECOND: `cls_loss`,
    `box_loss`, `dir_loss`; TransFusion: `tf_cls_loss`, `tf_reg_loss`),
    and `grad_norm` before the clip, as 0-d tensors on the device. The
    step leaves the detector in train mode; the detector is also
    `step.det`."""
    if getattr(det, "camera_input", False):
        raise NotImplementedError(
            f"{type(det).__name__} builds in the port but does not train: "
            "the JAX package has no train step that takes camera tensors "
            "(its step feeds a detector points alone)")
    if stride is None:
        stride = det_cfg.spatial_stride
    params = dict(det.named_parameters())
    stats = [b for _, b in det.named_buffers()]      # "bn" running mean / var

    def step(state, batch):
        _, opt_state = state
        det.train()
        dev = det.device
        pts, num, boxes, labels, mask = (torch.as_tensor(batch[k]).to(dev)
                                         for k in BATCH_KEYS)
        b = pts.shape[0]
        for p in params.values():
            p.grad = None
        start = [t.clone() for t in stats]
        moved = [torch.zeros_like(t) for t in stats]
        sums: Dict[str, torch.Tensor] = {}
        for i in range(b):
            with torch.no_grad():
                for t, s in zip(stats, start):
                    t.copy_(s)
            out = det(pts[i], num[i], return_dense_bev=False)
            loss, aux = detector_loss(det, out, boxes[i], labels[i],
                                      mask[i], det_cfg, vox_cfg, stride)
            (loss / b).backward()
            del out
            aux = dict(aux)
            aux.setdefault("loss", loss)
            for k, v in aux.items():
                sums[k] = sums[k] + v.detach() if k in sums else v.detach()
            with torch.no_grad():
                for m, t in zip(moved, stats):
                    m.add_(t)
        with torch.no_grad():
            for t, m in zip(stats, moved):
                t.copy_(m / b)
        norm = tx.update({n: p.grad for n, p in params.items()}, opt_state,
                         params)
        metrics = {k: v / b for k, v in sums.items()}
        metrics["grad_norm"] = norm
        return state, metrics

    step.det = det
    return step


MPPNET_BATCH_KEYS = ("frame_points", "frame_counts", "prop_boxes",
                     "prop_scores", "prop_labels", "prop_count", "gt_boxes",
                     "gt_mask")


def make_mppnet_train_step(det, tx, generator: torch.Generator | None = None):
    """-> step(state, batch) -> (state, metrics) for MPPNetDetector, state =
    (det, opt_state) updated in place. batch: frame_points [B, T, P, F],
    frame_counts [B, T], prop_boxes [B, R, 9], prop_scores [B, R],
    prop_labels [B, R], prop_count [B], gt_boxes [B, G, 9], gt_mask [B, G],
    and optionally draws [B, 2, R]: each sample's foreground and background
    priorities for `subsample_rois` (uniform in [0, 1)); without them each
    sample draws its own from `generator` (on the host, then moved).
    metrics: the batch means of `loss`, `roi_cls_loss` and
    `roi_reg_loss`, and `grad_norm` before the clip."""
    from ..models.mppnet import mppnet_loss
    from ..models.voxelnext import Detections
    params = dict(det.named_parameters())
    gen = generator if generator is not None else torch.Generator()

    def step(state, batch):
        _, opt_state = state
        det.train()
        dev = det.device
        fp, fc, pb, ps, pl, pc, boxes, mask = (
            torch.as_tensor(batch[k]).to(dev) for k in MPPNET_BATCH_KEYS)
        b, r = pb.shape[:2]
        draws = batch.get("draws")
        draws = (torch.rand((b, 2, r), generator=gen) if draws is None
                 else torch.as_tensor(draws)).to(dev, torch.float32)
        for p in params.values():
            p.grad = None
        sums: Dict[str, torch.Tensor] = {}
        for i in range(b):
            out = det(fp[i], fc[i], Detections(pb[i], ps[i], pl[i], pc[i]),
                      return_preds=True)
            loss, aux = mppnet_loss(out["preds"], out["rois"], boxes[i],
                                    mask[i], draws=(draws[i, 0],
                                                    draws[i, 1]),
                                    trajectory_rois=out["trajectory_rois"])
            (loss / b).backward()
            aux = dict(aux)
            aux.setdefault("loss", loss)
            for k, v in aux.items():
                sums[k] = sums[k] + v.detach() if k in sums else v.detach()
        norm = tx.update({n: p.grad for n, p in params.items()}, opt_state,
                         params)
        metrics = {k: v / b for k, v in sums.items()}
        metrics["grad_norm"] = norm
        return state, metrics

    step.det = det
    return step


def make_bucketed_detector_train_step(detector_name: str, det_cfg, vox_cfg,
                                      tx, buckets,
                                      stride: int | None = None, *,
                                      device=None, seed: int = 0):
    """Capacity-bucketed training: one detector and step per bucket
    (ascending (max_voxels, capacity_schedule)), every detector on the
    parameters and buffers of the first (shapes do not depend on the
    capacities), and `pick(points, num_points)`, the index of the
    smallest bucket that drops no voxel of any cloud of a host batch
    (`ops.sparse.plan_capacity_demand`). Returns (steps, pick); `steps[i]`
    takes state (steps[0].det, tx.init(...)) and runs bucket i's
    capacities."""
    from ..models.registry import build_detector
    from ..ops.sparse import pick_capacity_bucket, plan_capacity_demand
    from ..ops.voxelize import VoxelGrid

    steps, shared = [], None
    for max_vox, sched in buckets:
        vcfg = dataclasses.replace(vox_cfg, max_voxels=int(max_vox))
        dcfg = dataclasses.replace(det_cfg, capacity_schedule=tuple(sched))
        if shared is None:
            det_b = build_detector(detector_name, dcfg, vcfg, device=device,
                                   seed=seed)
            shared = det_b.state_dict(keep_vars=True)
        else:
            det_b = build_detector(detector_name, dcfg, vcfg, device="meta")
            det_b.load_state_dict(shared, assign=True)
        steps.append(make_detector_train_step(det_b, tx, dcfg, vcfg, stride))
    grid = VoxelGrid.create(vox_cfg.point_range, vox_cfg.voxel_size)
    n_stages = len(buckets[0][1])

    def pick(points, num_points) -> int:
        best = 0
        for b in range(len(points)):
            pts = np.asarray(points[b][: int(num_points[b])])
            demands = plan_capacity_demand(pts, grid, n_stages=n_stages)
            best = max(best, pick_capacity_bucket(demands, buckets))
        return best

    return steps, pick


def recall_stats(pred_boxes: np.ndarray, pred_count: int,
                 gt_boxes: np.ndarray,
                 thresholds=RECALL_THRESHOLDS) -> Dict[str, float]:
    """Fraction of gt boxes matched by any prediction at 3D IoU >= t."""
    out = {f"recall_{t}": 0.0 for t in thresholds}
    out["gt"] = float(len(gt_boxes))
    if len(gt_boxes) == 0 or pred_count == 0:
        return out
    iou = iou_3d(torch.as_tensor(np.asarray(pred_boxes)[:pred_count, :7]),
                 torch.as_tensor(np.asarray(gt_boxes)[:, :7])).numpy()
    best = iou.max(axis=0)
    for t in thresholds:
        out[f"recall_{t}"] = float((best >= t).mean())
    return out
