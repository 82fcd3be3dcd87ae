"""SECOND-IoU: SECOND's anchor RPN and a BEV-grid IoU head (counterpart of
lvv_tpu/models/second_iou.py).

The proposals (SECOND's anchor decode + NMS) each sample the dense BEV on a
rotated 7 x 7 lattice over their footprint (`roi_grid_points`,
`bev_bilinear`); Dense layers predict each one's IoU with its gt. A
detection's score blends the class score and the IoU confidence by the
number of points in the box (`cal_scores_by_npoints`). The loss is
SECOND's anchor loss plus the IoU head's BCE against each proposal's best
3D IoU, averaged over every proposal slot, the empty ones too (ROADMAP.md
queue 3). The proposals keep their gradient, as in JAX.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from ..config.schema import VoxelizeConfig, VoxelNeXtConfig
from ..ops.boxes import iou_3d
from ..ops.pool import points_in_rotated_boxes
from .anchor_head import optax_sigmoid_ce
from .pointpillars import Dense
from .pv_rcnn import bev_bilinear, bev_stride_m
from .second import SECONDDetector
from .two_stage import TwoStageDetector, point_mask
from .voxelnext import Detections


def roi_grid_points(rois: torch.Tensor, grid: int) -> torch.Tensor:
    """[M, 7] -> [M, grid², 2] metric BEV points of a rotated lattice over
    each box's footprint (cell centres of a grid x grid split)."""
    gs = (torch.arange(grid, dtype=torch.float32, device=rois.device)
          + 0.5) / grid - 0.5
    gu, gv = torch.meshgrid(gs, gs, indexing="ij")
    lu, lv = gu.reshape(-1), gv.reshape(-1)
    lx = lu[None, :] * rois[:, None, 3]
    ly = lv[None, :] * rois[:, None, 4]
    c = torch.cos(rois[:, 6])[:, None]
    s = torch.sin(rois[:, 6])[:, None]
    x = lx * c - ly * s + rois[:, None, 0]
    y = lx * s + ly * c + rois[:, None, 1]
    return torch.stack([x, y], -1)


class SECONDIoUHead(nn.Module):
    """Bilinear BEV samples on each RoI's lattice -> Dense + ReLU layers ->
    an IoU logit a RoI; `pool` and `head` split the two."""

    def __init__(self, cin: int, grid: int = 7,
                 hidden: Tuple[int, ...] = (256, 256), *, device):
        super().__init__()
        self.grid, self.n_fc = grid, len(hidden)
        c = cin * grid * grid
        for i, ch in enumerate(hidden):
            setattr(self, f"fc{i}", Dense(c, ch, device=device))
            c = ch
        self.iou = Dense(c, 1, device=device)

    def pool(self, bev_chw, rois, point_range, stride_m) -> torch.Tensor:
        pts = roi_grid_points(rois, self.grid).reshape(-1, 2)
        feats = bev_bilinear(bev_chw, pts, point_range, stride_m)
        return feats.reshape(rois.shape[0], -1)

    def head(self, h) -> torch.Tensor:
        for i in range(self.n_fc):
            h = torch.relu(getattr(self, f"fc{i}")(h))
        return self.iou(h)[:, 0]

    def forward(self, bev_chw, rois, point_range, stride_m):
        return self.head(self.pool(bev_chw, rois, point_range, stride_m))


def cal_scores_by_npoints(cls_scores, iou_scores, npoints,
                          cls_thresh: float = 10.0,
                          iou_thresh: float = 100.0):
    """(1 - α)·cls + α·iou, α the point count's ramp from cls_thresh to
    iou_thresh, clipped to [0, 1]."""
    alpha = ((npoints - cls_thresh) / (iou_thresh - cls_thresh)).clamp(0, 1)
    return (1 - alpha) * cls_scores + alpha * iou_scores


class SECONDNetIoUDetector(TwoStageDetector):
    """`second` (the port's SECONDDetector, named as JAX's submodule) and
    `iou_head`."""

    def __init__(self, det_cfg: VoxelNeXtConfig, vox_cfg: VoxelizeConfig, *,
                 device=None, seed: int = 0, roi_grid: int = 7):
        super().__init__(det_cfg, vox_cfg, device)
        self.second = SECONDDetector(det_cfg, vox_cfg, device=self._device,
                                     seed=seed)
        self.iou_head = SECONDIoUHead(self.second.backbone2d.out_channels,
                                      grid=roi_grid, device=self._device)
        self._finish(seed)

    def stages(self, trace: Optional[List] = None):
        base = dict(self.second.stages(trace))
        grid = self.voxel_grid()
        stride_m = bev_stride_m(grid, self.det_cfg.spatial_stride)

        def voxelize(points, n):
            return {"points": points, "valid_points": point_mask(points, n),
                    "st": base["voxelize"](points, n)}

        def trunk3d(s):
            s["bev3d"] = base["trunk3d"](s.pop("st"))
            return s

        def trunk2d_rpn(s):
            s.update(base["head"](base["trunk2d"](s.pop("bev3d"))))
            return s

        def pool(s):
            p = s["proposals"]
            s["pooled"] = self.iou_head.pool(
                s["bev_dense"], p.boxes[:, :7], self.vox_cfg.point_range,
                stride_m)
            return s

        def roi_head(s):
            s["iou_logits"] = self.iou_head.head(s["pooled"])
            inside = points_in_rotated_boxes(
                s["points"], s["proposals"].boxes[:, :7]) \
                & s["valid_points"][:, None]
            s["npoints"] = inside.sum(0, dtype=torch.int32)
            return s

        def refine(s):
            p = s["proposals"]
            iou_conf = torch.sigmoid(s["iou_logits"].float())
            fused = cal_scores_by_npoints(p.scores, iou_conf,
                                          s["npoints"].float())
            s["detections"] = Detections(
                boxes=p.boxes, scores=torch.where(p.labels >= 0, fused, 0.0),
                labels=p.labels, count=p.count)
            return s
        return [("voxelize", voxelize), ("trunk3d", trunk3d),
                ("trunk2d_rpn", trunk2d_rpn),
                self.proposals_stage("preds"), ("pool", pool),
                ("roi_head", roi_head), ("refine", refine)]

    def loss(self, out, gt_boxes, gt_labels, gt_mask):
        rpn_loss, stats = self.second.loss(out, gt_boxes, gt_labels, gt_mask)
        rois = out["proposals"].boxes[:, :7]
        iou = iou_3d(rois, gt_boxes[:, :7].float())
        best = torch.where(gt_mask.bool()[None, :], iou, 0.0).amax(1)
        # every decoded slot, as JAX supervises them
        iou_loss = optax_sigmoid_ce(out["iou_logits"].float(), best).mean()
        return rpn_loss + iou_loss, {**stats, "iou_loss": iou_loss}
