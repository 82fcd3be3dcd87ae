"""PointRCNN: point-based proposals and RoI refinement (counterpart of
lvv_tpu/models/point_rcnn.py).

points -> `PointNet2Backbone` (SA levels of 512 / 128 / 32 / 16 samples,
FP back to every point, 64 channels) -> `PointHead` (class scores and an
8-value box a point) -> each point's box (`decode_point_proposals`) ->
class-agnostic rotated NMS over the top `nms_pre_max` scores to 64 RoIs
(constants to the second stage) -> `RoIHead` over every point's features
(4³ cells, 128) -> the RoIs refined; an unused slot scores 0 and is
labelled -1.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from ..config.schema import VoxelizeConfig, VoxelNeXtConfig
from ..ops.nms import nms
from .point_head import PointHead, point_head_loss, point_targets
from .pointnet2 import PointNet2Backbone
from .roi_head import (RoIHead, boxes9, proposal_targets, refine_boxes,
                       roi_head_loss)
from .two_stage import TwoStageDetector, point_mask
from .voxelnext import Detections


def decode_point_proposals(points: torch.Tensor, preds: Dict
                           ) -> torch.Tensor:
    """Each point's box [N, 7]: centre = point + offset, sizes = e^clip(·,
    -4, 4), heading = atan2(sin, cos)."""
    b = preds["box"].float()
    center = points[:, :3] + b[:, :3]
    dims = torch.exp(b[:, 3:6].clamp(-4, 4))
    heading = torch.atan2(b[:, 6], b[:, 7])
    return torch.cat([center, dims, heading[:, None]], 1)


class PointRCNNDetector(TwoStageDetector):
    """`backbone` (PointNet++), `point_head`, `roi_head`; `loss`: the point
    head's focal + box loss and the RoI head's."""

    def __init__(self, det_cfg: VoxelNeXtConfig, vox_cfg: VoxelizeConfig, *,
                 device=None, seed: int = 0, num_rois: int = 64):
        super().__init__(det_cfg, vox_cfg, device)
        kw = dict(device=self._device)
        self.num_rois = num_rois
        self.backbone = PointNet2Backbone(
            vox_cfg.num_point_features - 3, npoints=(512, 128, 32, 16),
            radii=(0.5, 1.0, 2.0, 4.0), nsamples=(16, 16, 16, 16),
            channels=(16, 32, 64, 128), out_channels=64, **kw)
        self.point_head = PointHead(64, det_cfg.num_classes,
                                    predict_boxes=True, fc_channels=(64,),
                                    **kw)
        self.roi_head = RoIHead(64, grid=4, fc_channels=(128,), **kw)
        self._finish(seed)

    def stages(self, trace: Optional[List] = None):
        cfg = self.det_cfg

        def backbone(points, n):
            valid = point_mask(points, n)
            return {"points": points, "valid_points": valid,
                    "point_features": self.backbone(points, valid)}

        def point_head(s):
            s["point_preds"] = self.point_head(s["point_features"])
            return s

        def proposals(s):
            scores_all = torch.sigmoid(s["point_preds"]["cls"].float())
            score = scores_all.amax(1)
            s["point_labels"] = scores_all.argmax(1).to(torch.int32)
            boxes = decode_point_proposals(s["points"], s["point_preds"])
            n = boxes.shape[0]
            keep, count, kscores = nms(
                boxes, torch.where(s["valid_points"], score, -torch.inf),
                iou_thresh=cfg.nms_iou_thresh,
                pre_max=min(cfg.nms_pre_max, n), post_max=self.num_rois)
            # the proposals are constants to the second stage
            s["rois"] = boxes[keep.clamp_min(0).long()].detach()
            s.update(keep=keep, count=count, keep_scores=kscores)
            return s

        def pool(s):
            s["pooled"] = self.roi_head.pool(s["points"], s["point_features"],
                                             s["rois"], s["valid_points"])
            return s

        def roi_head(s):
            s["roi_preds"] = self.roi_head.head(s["pooled"])
            return s

        def refine(s):
            keep = s["keep"]
            kept = keep >= 0
            refined, conf = refine_boxes(s["roi_preds"], s["rois"])
            s["detections"] = Detections(
                boxes=boxes9(refined),
                scores=torch.where(kept, conf * s["keep_scores"], 0.0),
                labels=torch.where(
                    kept, s["point_labels"][keep.clamp_min(0).long()], -1),
                count=s["count"])
            return s
        return [("backbone", backbone), ("point_head", point_head),
                ("proposals", proposals), ("pool", pool),
                ("roi_head", roi_head), ("refine", refine)]

    def loss(self, out, gt_boxes, gt_labels, gt_mask):
        gt_mask = gt_mask.bool()
        gt = torch.where(gt_mask[:, None], gt_boxes.float(), 0.0)
        valid = out["valid_points"]
        pt = point_targets(out["points"], gt, gt_labels, gt_mask,
                           valid_points=valid)
        p_loss, aux = point_head_loss(out["point_preds"], pt,
                                      self.det_cfg.num_classes,
                                      valid_points=valid)
        rt = proposal_targets(out["rois"], gt_boxes, gt_mask)
        r_loss, r_aux = roi_head_loss(out["roi_preds"], rt)
        return p_loss + r_loss, {**aux, **r_aux}
