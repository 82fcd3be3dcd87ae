"""The anchor head of SECOND-style detectors (counterpart of
lvv_tpu/models/anchor_head.py).

- `ResidualBoxCoder`: box targets relative to anchors (offsets over the
  anchor's diagonal, log-ratio sizes, angle residual).
- `generate_anchors`: the anchor table, [H·W·C·R, 7], cells in row-major
  order, then class, then rotation.
- `AnchorHead`: 1x1 convs cls / box / dir over the dense BEV map;
  `AnchorHeadMulti`: one AnchorHead per class group, the group's logits
  lifted into the global classes (-1e9 elsewhere) and the groups
  concatenated, with `multi_anchor_table` its anchors.
- `assign_anchor_targets`: axis-aligned IoU assignment per class, each gt's
  best anchor forced positive where it overlaps any.
- `sigmoid_focal_loss`, `smooth_l1`, `anchor_head_loss`: focal cls,
  smooth-L1 box (sin of the angle difference), direction cross-entropy.
- `decode_anchor_preds`: scores, decoded boxes with the direction bin,
  top-K and class-agnostic rotated NMS.

Fixed shapes: gts are padded to a fixed count with a mask. Argmax and
top-K pick the lowest index among equal values, as JAX does.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config.schema import VoxelNeXtConfig
from ..ops.boxes import iou_aabb_bev, limit_period
from ..ops.nms import nms, top_k
from .pointpillars import HM_BIAS, Conv2d
from .voxelnext import Detections


class ResidualBoxCoder:
    """pcdet's ResidualCoder (code size 7)."""

    code_size = 7

    @staticmethod
    def encode(boxes: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
        xa, ya, za, dxa, dya, dza, ra = anchors.unbind(-1)
        xg, yg, zg, dxg, dyg, dzg, rg = boxes[..., :7].unbind(-1)
        diag = torch.sqrt(dxa ** 2 + dya ** 2)
        return torch.stack([
            (xg - xa) / diag, (yg - ya) / diag, (zg - za) / dza,
            torch.log((dxg / dxa).clamp_min(1e-3)),
            torch.log((dyg / dya).clamp_min(1e-3)),
            torch.log((dzg / dza).clamp_min(1e-3)),
            rg - ra], -1)

    @staticmethod
    def decode(deltas: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
        xa, ya, za, dxa, dya, dza, ra = anchors.unbind(-1)
        diag = torch.sqrt(dxa ** 2 + dya ** 2)
        return torch.stack([
            deltas[..., 0] * diag + xa, deltas[..., 1] * diag + ya,
            deltas[..., 2] * dza + za,
            torch.exp(deltas[..., 3].clamp(-5, 5)) * dxa,
            torch.exp(deltas[..., 4].clamp(-5, 5)) * dya,
            torch.exp(deltas[..., 5].clamp(-5, 5)) * dza,
            deltas[..., 6] + ra], -1)


def generate_anchors(grid_hw: Tuple[int, int], class_sizes: Sequence,
                     point_range, stride_m: Tuple[float, float],
                     rotations=(0.0, np.pi / 2),
                     z_centers: float = -1.0) -> Tuple[np.ndarray,
                                                       np.ndarray]:
    """-> (anchors [H·W·C·R, 7] float32, class ids [H·W·C·R] int32), one
    (dx, dy, dz) per class in `class_sizes`, cell centres in float64
    before the cast, as the JAX package's loop makes them."""
    h, w = grid_hw
    ys = point_range[1] + (np.arange(h) + 0.5) * stride_m[1]
    xs = point_range[0] + (np.arange(w) + 0.5) * stride_m[0]
    c, r = len(class_sizes), len(rotations)
    shape = (h, w, c, r)
    sizes = np.asarray(class_sizes, np.float64)
    cols = [np.broadcast_to(ys[:, None, None, None], shape),
            np.broadcast_to(xs[None, :, None, None], shape),
            np.full(shape, z_centers, np.float64)]
    cols += [np.broadcast_to(sizes[None, None, :, i, None], shape)
             for i in range(3)]
    cols.append(np.broadcast_to(np.asarray(rotations, np.float64), shape))
    anchors = np.stack([cols[1], cols[0], *cols[2:]], -1).reshape(-1, 7)
    cls = np.broadcast_to(np.arange(c)[None, None, :, None], shape)
    return (anchors.astype(np.float32),
            np.ascontiguousarray(cls.reshape(-1)).astype(np.int32))


class AnchorHead(nn.Module):
    """1x1 convs over a dense [C, H, W] map -> {"cls" [H·W·A, classes],
    "box" [H·W·A, 7], "dir" [H·W·A, 2]}, A anchors a cell."""

    def __init__(self, cin: int, num_classes: int, anchors_per_cell: int,
                 code_size: int = 7, *, device):
        super().__init__()
        self.num_classes, self.a, self.code_size = (num_classes,
                                                    anchors_per_cell,
                                                    code_size)
        kw = dict(k=1, device=device)
        self.cls = Conv2d(cin, anchors_per_cell * num_classes,
                          bias_init=HM_BIAS, **kw)
        self.box = Conv2d(cin, anchors_per_cell * code_size, **kw)
        self.dir = Conv2d(cin, anchors_per_cell * 2, **kw)

    def forward(self, bev_chw: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = bev_chw[None]
        h, w = x.shape[2:]
        n = h * w * self.a

        def head(conv, ch):
            return conv(x)[0].permute(1, 2, 0).reshape(n, ch)
        return {"cls": head(self.cls, self.num_classes),
                "box": head(self.box, self.code_size),
                "dir": head(self.dir, 2)}


class AnchorHeadMulti(nn.Module):
    """One AnchorHead per class group (`head_{i}`, `rotations` anchors per
    class a cell) over the shared map; each group's class logits lifted
    into the global class space (-1e9 at the other classes) and the
    groups' outputs concatenated in group order."""

    def __init__(self, cin: int, num_classes: int,
                 class_groups: Sequence[Sequence[int]], rotations: int = 2,
                 code_size: int = 7, *, device):
        super().__init__()
        self.num_classes = num_classes
        self.class_groups = tuple(tuple(g) for g in class_groups)
        for gi, group in enumerate(self.class_groups):
            setattr(self, f"head_{gi}", AnchorHead(
                cin, len(group), len(group) * rotations, code_size,
                device=device))

    def forward(self, bev_chw: torch.Tensor) -> Dict[str, torch.Tensor]:
        outs = []
        for gi, group in enumerate(self.class_groups):
            preds = getattr(self, f"head_{gi}")(bev_chw)
            cls = preds["cls"]
            idx = torch.tensor(group, device=cls.device)
            full = cls.new_full((cls.shape[0], self.num_classes), -1e9)
            outs.append(dict(preds, cls=full.index_copy(1, idx, cls)))
        return {k: torch.cat([o[k] for o in outs]) for k in
                ("cls", "box", "dir")}


def multi_anchor_table(grid_hw, class_groups, class_sizes, point_range,
                       stride_m, rotations=(0.0, np.pi / 2)
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """AnchorHeadMulti's anchors: one `generate_anchors` block per group in
    group order, class ids global."""
    anchors, cls = [], []
    for group in class_groups:
        a, local = generate_anchors(grid_hw, [class_sizes[g] for g in group],
                                    point_range, stride_m,
                                    rotations=rotations)
        anchors.append(a)
        cls.append(np.asarray([group[i] for i in local], np.int32))
    return np.concatenate(anchors), np.concatenate(cls)


def assign_anchor_targets(anchors: torch.Tensor, anchor_cls: torch.Tensor,
                          gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                          gt_mask: torch.Tensor, pos_thresh: float = 0.6,
                          neg_thresh: float = 0.45) -> Dict:
    """Axis-aligned BEV IoU against same-class gts -> {"cls" [N] int32 (-1
    ignore, 0 negative, c + 1 positive of class c), "box" [N, 7], "dir"
    [N] (the gt heading's bin over [0, 2π)), "matched_gt" [N]}. Each gt's
    best anchor is positive where the gt overlaps any anchor of its
    class."""
    n = anchors.shape[0]
    gt_mask = gt_mask.bool()
    iou = iou_aabb_bev(anchors, gt_boxes[:, :7])            # [N, G]
    iou = torch.where(gt_mask[None, :], iou, 0.0)
    same = anchor_cls[:, None] == gt_labels[None, :]
    iou = torch.where(same, iou, 0.0)
    best_iou = iou.amax(1)
    best_gt = iou.argmax(1)
    best_anchor = iou.argmax(0)                             # [G]
    overlap = iou.amax(0) > 0
    forced = torch.zeros(n, dtype=torch.int32, device=anchors.device)
    forced = forced.scatter_reduce(0, best_anchor,
                                   (gt_mask & overlap).to(torch.int32),
                                   "amax") > 0
    pos = (best_iou >= pos_thresh) | forced
    neg = best_iou < neg_thresh
    matched = gt_boxes[best_gt]
    cls_tgt = torch.where(pos, gt_labels[best_gt].to(torch.int32) + 1,
                          torch.where(neg, 0, -1)).to(torch.int32)
    box_tgt = ResidualBoxCoder.encode(matched[:, :7], anchors)
    dir_tgt = (limit_period(matched[:, 6], 0.0, 2 * math.pi)
               >= math.pi).to(torch.int32)
    return {"cls": cls_tgt, "box": box_tgt, "dir": dir_tgt,
            "matched_gt": best_gt}


def optax_sigmoid_ce(logits, labels):
    """optax's sigmoid binary cross-entropy."""
    return (logits.clamp_min(0) - logits * labels
            + torch.log1p(torch.exp(-logits.abs())))


def sigmoid_focal_loss(logits, targets_onehot, alpha: float = 0.25,
                       gamma: float = 2.0):
    logits = logits.float()
    p = torch.sigmoid(logits)
    ce = optax_sigmoid_ce(logits, targets_onehot)
    p_t = p * targets_onehot + (1 - p) * (1 - targets_onehot)
    a_t = alpha * targets_onehot + (1 - alpha) * (1 - targets_onehot)
    return a_t * (1 - p_t) ** gamma * ce


def smooth_l1(x, beta: float = 1.0 / 9.0):
    ax = x.abs()
    return torch.where(ax < beta, 0.5 * ax * ax / beta, ax - 0.5 * beta)


def anchor_head_loss(preds: Dict, targets: Dict, num_classes: int,
                     box_weight: float = 2.0, dir_weight: float = 0.2):
    """-> (cls + box_weight·box + dir_weight·dir, {"cls_loss", "box_loss",
    "dir_loss"}), each over the number of positives (at least 1)."""
    cls_tgt = targets["cls"]
    valid = cls_tgt >= 0
    pos = cls_tgt > 0
    onehot = F.one_hot((cls_tgt - 1).clamp(0, num_classes - 1).long(),
                       num_classes).float() * pos[:, None]
    n_pos = pos.sum().clamp_min(1).float()
    cls_loss = (sigmoid_focal_loss(preds["cls"], onehot)
                * valid[:, None]).sum() / n_pos
    box_pred, box_tgt = preds["box"], targets["box"]
    ang = torch.sin(box_pred[:, 6:7] - box_tgt[:, 6:7])
    diff = torch.cat([box_pred[:, :6] - box_tgt[:, :6], ang], 1)
    box_loss = (smooth_l1(diff) * pos[:, None]).sum() / n_pos
    dir_onehot = F.one_hot(targets["dir"].long(), 2).float()
    dir_loss = (optax_sigmoid_ce(preds["dir"], dir_onehot)
                * pos[:, None]).sum() / n_pos
    total = cls_loss + box_weight * box_loss + dir_weight * dir_loss
    return total, {"cls_loss": cls_loss, "box_loss": box_loss,
                   "dir_loss": dir_loss}


def decode_anchor_preds(preds: Dict, anchors: torch.Tensor,
                        anchor_cls: torch.Tensor, det_cfg: VoxelNeXtConfig
                        ) -> Detections:
    """Each anchor's best class score and decoded box, its heading put in
    [0, π) plus π times the direction bin, the top `nms_pre_max`, then
    class-agnostic rotated NMS; boxes padded to 9 values."""
    scores_all = torch.sigmoid(preds["cls"].float())
    score = scores_all.amax(1)
    label = scores_all.argmax(1).to(torch.int32)
    boxes = ResidualBoxCoder.decode(preds["box"].float(), anchors)
    dir_cls = preds["dir"].argmax(1)
    rot = limit_period(boxes[:, 6], 0.0, math.pi)
    boxes = torch.cat([boxes[:, :6], (rot + math.pi * dir_cls)[:, None]], 1)
    k = min(det_cfg.nms_pre_max, boxes.shape[0])
    top_scores, top_idx = top_k(score, k)
    top_boxes = boxes[top_idx]
    keep, count, kscores = nms(
        top_boxes, top_scores, iou_thresh=det_cfg.nms_iou_thresh,
        pre_max=k, post_max=det_cfg.nms_post_max,
        valid=top_scores > det_cfg.score_thresh)
    kept = keep >= 0
    safe = keep.clamp_min(0).long()
    full = torch.cat([top_boxes[safe], top_boxes.new_zeros((len(safe), 2))],
                     1)
    return Detections(boxes=full,
                      scores=torch.where(kept, kscores, 0.0),
                      labels=torch.where(kept, label[top_idx][safe], -1),
                      count=count)
