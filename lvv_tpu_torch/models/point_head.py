"""Point heads: per-point foreground classification and box regression
(counterpart of lvv_tpu/models/point_head.py).

- `PointHead`: Dense + LayerNorm + ReLU layers, a class branch (bias
  -4.6) and, with `predict_boxes`, an 8-value box branch (offsets to the
  box centre, log sizes, sin / cos of the heading).
- `point_targets`: the points inside a gt box (the first that holds them)
  are foreground of its class, with that box encoded relative to them.
- `point_head_loss`: focal classification over the valid points, smooth-L1
  on the foreground points' boxes, each over the foreground count.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.pool import assign_points_to_boxes
from .anchor_head import optax_sigmoid_ce, smooth_l1
from .pointpillars import HM_BIAS, Dense, FlaxLayerNorm


class PointHead(nn.Module):
    """Shared Dense trunk, then cls [N, classes] and, with
    `predict_boxes`, box [N, box_code]."""

    def __init__(self, cin: int, num_classes: int = 1, box_code: int = 8,
                 predict_boxes: bool = False,
                 fc_channels: Sequence[int] = (128, 128), *, device):
        super().__init__()
        self.n_fc = len(fc_channels)
        c = cin
        for i, ch in enumerate(fc_channels):
            setattr(self, f"fc{i}", Dense(c, ch, device=device))
            setattr(self, f"ln{i}", FlaxLayerNorm(ch, device=device))
            c = ch
        self.cls = Dense(c, num_classes, bias_init=HM_BIAS, device=device)
        self.box = Dense(c, box_code, device=device) if predict_boxes \
            else None

    def forward(self, point_feats: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = point_feats
        for i in range(self.n_fc):
            x = torch.relu(getattr(self, f"ln{i}")(getattr(self, f"fc{i}")(x)))
        out = {"cls": self.cls(x)}
        if self.box is not None:
            out["box"] = self.box(x)
        return out


def point_targets(points: torch.Tensor, gt_boxes: torch.Tensor,
                  gt_labels: torch.Tensor, gt_mask: torch.Tensor,
                  valid_points: torch.Tensor | None = None) -> Dict:
    """-> {"cls" [N] int32 (-1 background, else the class), "box" [N, 8],
    "fg" [N]}: offsets to the owning box's centre, log sizes (at least
    1e-3), sin and cos of its heading."""
    boxes = gt_boxes[:, :7].float()
    owner = assign_points_to_boxes(points[:, :3], boxes, valid_points)
    safe = owner.clamp_min(0)
    owner_ok = (owner >= 0) & gt_mask.bool()[safe]
    ob = boxes[safe]
    tgt = torch.cat([ob[:, :3] - points[:, :3],
                     torch.log(ob[:, 3:6].clamp_min(1e-3)),
                     torch.sin(ob[:, 6:7]), torch.cos(ob[:, 6:7])], 1)
    cls = torch.where(owner_ok, gt_labels[safe].to(torch.int32), -1)
    return {"cls": cls.to(torch.int32), "box": tgt, "fg": owner_ok}


def point_head_loss(preds: Dict, targets: Dict, num_classes: int,
                    reg_weight: float = 1.0,
                    valid_points: torch.Tensor | None = None):
    """(focal cls + reg_weight · smooth-L1 box, {"point_cls_loss",
    "point_reg_loss" where the head predicts boxes})."""
    logits = preds["cls"].float()
    fg = targets["fg"]
    valid = torch.ones_like(fg) if valid_points is None else valid_points
    onehot = F.one_hot(targets["cls"].clamp(0, num_classes - 1).long(),
                       num_classes).float() * fg[:, None]
    p = torch.sigmoid(logits)
    ce = optax_sigmoid_ce(logits, onehot)
    p_t = p * onehot + (1 - p) * (1 - onehot)
    focal = 0.25 * ((1 - p_t) ** 2) * ce
    n_fg = (fg & valid).sum().clamp_min(1)
    cls_loss = (focal * valid[:, None]).sum() / n_fg
    total, aux = cls_loss, {"point_cls_loss": cls_loss}
    if "box" in preds:
        diff = preds["box"].float() - targets["box"]
        reg = (smooth_l1(diff).sum(1) * (fg & valid)).sum() / n_fg
        aux["point_reg_loss"] = reg
        total = total + reg_weight * reg
    return total, aux
