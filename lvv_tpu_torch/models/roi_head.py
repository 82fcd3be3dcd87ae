"""The two-stage detectors' RoI refinement head (counterpart of
lvv_tpu/models/roi_head.py).

- `canonical_encode` / `canonical_decode`: a box relative to its RoI in
  the RoI's yaw frame (the ResidualBoxCoder on a RoI moved to the origin
  with heading 0).
- `proposal_targets`: each RoI matched to its best gt by axis-aligned BEV
  IoU; a soft class target from the IoU between the background and
  foreground thresholds; canonical box targets.
- `RoIHead`: RoI-aware max pooling of point features on a grid³ lattice
  per RoI (`pool`), then Dense + LayerNorm + ReLU layers and the cls / reg
  outputs (`head`).
- `roi_head_loss`: BCE on the soft labels, smooth-L1 on the foreground
  RoIs' box targets; `refine_boxes`: the decoded boxes and sigmoid
  confidences.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Sequence

import torch
from torch import nn

from ..ops.boxes import iou_aabb_bev
from ..ops.pool import roiaware_pool3d
from .anchor_head import ResidualBoxCoder, smooth_l1
from .pointpillars import Dense, FlaxLayerNorm


def _at_origin(roi: torch.Tensor) -> torch.Tensor:
    """The RoI with x, y and heading set to 0."""
    z = torch.zeros_like(roi[..., 0])
    return torch.stack([z, z, *roi[..., 2:6].unbind(-1), z], -1)


def canonical_encode(gt: torch.Tensor, roi: torch.Tensor) -> torch.Tensor:
    """gt [..., 7] relative to roi [..., 7] in the RoI's yaw frame."""
    c, s = torch.cos(-roi[..., 6]), torch.sin(-roi[..., 6])
    dx = gt[..., 0] - roi[..., 0]
    dy = gt[..., 1] - roi[..., 1]
    gt_local = torch.stack([dx * c - dy * s, dx * s + dy * c,
                            *gt[..., 2:6].unbind(-1),
                            gt[..., 6] + (-roi[..., 6])], -1)
    return ResidualBoxCoder.encode(gt_local, _at_origin(roi))


def canonical_decode(deltas: torch.Tensor, roi: torch.Tensor
                     ) -> torch.Tensor:
    local = ResidualBoxCoder.decode(deltas, _at_origin(roi))
    c, s = torch.cos(roi[..., 6]), torch.sin(roi[..., 6])
    x = local[..., 0] * c - local[..., 1] * s + roi[..., 0]
    y = local[..., 0] * s + local[..., 1] * c + roi[..., 1]
    return torch.stack([x, y, *local[..., 2:6].unbind(-1),
                        local[..., 6] + roi[..., 6]], -1)


class RoITargets(NamedTuple):
    rois: torch.Tensor        # [R, 7]
    cls_tgt: torch.Tensor     # [R] in [0, 1] (IoU-aware soft labels)
    reg_tgt: torch.Tensor     # [R, 7]
    fg_mask: torch.Tensor     # [R]
    valid: torch.Tensor       # [R]


def proposal_targets(rois: torch.Tensor, gt_boxes: torch.Tensor,
                     gt_mask: torch.Tensor, *, fg_thresh: float = 0.55,
                     bg_thresh: float = 0.45) -> RoITargets:
    """Each RoI's best gt (first among equal IoUs) and its targets; a RoI
    is valid where some gt is and its sizes sum above 0."""
    gt_mask = gt_mask.bool()
    gt_boxes = gt_boxes.float()
    iou = iou_aabb_bev(rois[:, :7], gt_boxes[:, :7])
    iou = torch.where(gt_mask[None, :], iou, 0.0)
    best_gt = iou.argmax(1)
    best_iou = iou.amax(1)
    fg = best_iou >= fg_thresh
    soft = ((best_iou - bg_thresh) / (fg_thresh - bg_thresh)).clamp(0, 1)
    reg_tgt = canonical_encode(gt_boxes[best_gt][:, :7], rois[:, :7])
    valid = gt_mask.any() & (rois[:, 3:6].sum(1) > 0)
    return RoITargets(rois=rois, cls_tgt=soft, reg_tgt=reg_tgt,
                      fg_mask=fg & valid, valid=valid)


class RoIHead(nn.Module):
    """RoI-aware pooled refinement: `pool` (grid³ max pooling of point
    features per RoI), then `head` (Dense + LayerNorm + ReLU per
    `fc_channels`, cls [R] and reg [R, 7])."""

    def __init__(self, cin: int, grid: int = 6,
                 fc_channels: Sequence[int] = (256, 256), *, device):
        super().__init__()
        self.grid = grid
        self.n_fc = len(fc_channels)
        c = cin * grid ** 3
        for i, ch in enumerate(fc_channels):
            setattr(self, f"fc{i}", Dense(c, ch, device=device))
            setattr(self, f"ln{i}", FlaxLayerNorm(ch, device=device))
            c = ch
        self.cls = Dense(c, 1, device=device)
        self.reg = Dense(c, 7, device=device)

    def pool(self, points, point_feats, rois, valid_points=None):
        """points [N, 3+], point_feats [N, C], rois [R, 7] -> [R, grid³·C]."""
        pooled = roiaware_pool3d(points[:, :3], point_feats, rois[:, :7],
                                 self.grid, mode="max",
                                 valid_points=valid_points)
        return pooled.reshape(rois.shape[0], -1)

    def head(self, x) -> Dict[str, torch.Tensor]:
        for i in range(self.n_fc):
            x = torch.relu(getattr(self, f"ln{i}")(getattr(self, f"fc{i}")(x)))
        return {"cls": self.cls(x)[:, 0], "reg": self.reg(x)}

    def forward(self, points, point_feats, rois, valid_points=None):
        return self.head(self.pool(points, point_feats, rois, valid_points))


def roi_head_loss(preds: Dict, targets: RoITargets,
                  reg_weight: float = 1.0):
    """(BCE on the soft labels over the valid RoIs + reg_weight · smooth-L1
    over the foreground ones, {"roi_cls_loss", "roi_reg_loss"}). The BCE is
    log(1 + e^l) - l·t (logaddexp), whose gradient is sigmoid(l) - t at
    l = 0 too."""
    logits = preds["cls"].float()
    bce = torch.logaddexp(torch.zeros_like(logits), logits) \
        - logits * targets.cls_tgt
    n_valid = targets.valid.sum().clamp_min(1)
    cls_loss = (bce * targets.valid).sum() / n_valid
    diff = preds["reg"].float() - targets.reg_tgt
    n_fg = targets.fg_mask.sum().clamp_min(1)
    reg_loss = (smooth_l1(diff).sum(1) * targets.fg_mask).sum() / n_fg
    total = cls_loss + reg_weight * reg_loss
    return total, {"roi_cls_loss": cls_loss, "roi_reg_loss": reg_loss}


def refine_boxes(preds: Dict, rois: torch.Tensor):
    """-> (refined boxes [R, 7], confidence [R])."""
    boxes = canonical_decode(preds["reg"].float(), rois[:, :7])
    return boxes, torch.sigmoid(preds["cls"].float())


def boxes9(boxes7: torch.Tensor) -> torch.Tensor:
    """[R, 7] -> [R, 9], the velocity columns 0."""
    return torch.cat([boxes7, boxes7.new_zeros((boxes7.shape[0], 2))], 1)

