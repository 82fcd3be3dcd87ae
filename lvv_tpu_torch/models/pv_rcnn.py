"""PV-RCNN: voxel set abstraction and two-stage refinement (counterpart of
lvv_tpu/models/pv_rcnn.py).

points -> `voxelize_mean` -> `CenterPointBackbone3D` (to stride 8) ->
`height_compression` -> the anchor RPN on that map (no 2D trunk) ->
anchor decode + NMS (the proposals) | farthest-point keypoints of the raw
cloud -> `VoxelSetAbstraction` (a ball-query mean of the raw points'
features, a ball-query max over the stride-8 voxel centres, a bilinear
sample of the BEV; each projected to 32, fused by Dense + LayerNorm +
ReLU) -> `RoIHead` over the keypoints (4³ cells, 128, 128) -> the
proposals refined in their canonical frames, scored by the RoI's
confidence times the proposal's score.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..config.schema import VoxelizeConfig, VoxelNeXtConfig
from ..ops.sampling import ball_query, farthest_point_sample
from ..ops.sparse import SparseTensor, delinearize
from ..ops.voxelize import VoxelGrid
from .anchor_head import anchor_head_loss, assign_anchor_targets
from .centerpoint import CenterPointBackbone3D, height_compression
from .pointpillars import Dense, FlaxLayerNorm
from .roi_head import (RoIHead, boxes9, proposal_targets, refine_boxes,
                       roi_head_loss)
from .two_stage import TwoStageDetector
from .voxelnext import Detections


def voxel_centers(st: SparseTensor, grid: VoxelGrid, stride: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(centres [V, 3] in metres, valid [V]) of a SparseTensor at `stride`
    of the base grid: (coord + 0.5) · voxel · stride + origin per axis."""
    coords = delinearize(st.ids, st.grid)
    vx, vy, vz = grid.voxel_size
    x0, y0, z0 = grid.point_range[:3]
    cx = (coords[:, 2].float() + 0.5) * vx * stride + x0
    cy = (coords[:, 1].float() + 0.5) * vy * stride + y0
    cz = (coords[:, 0].float() + 0.5) * vz * stride + z0
    return torch.stack([cx, cy, cz], 1), st.valid


def bev_bilinear(bev_chw: torch.Tensor, xy: torch.Tensor, point_range,
                 stride_m: Tuple[float, float]) -> torch.Tensor:
    """Bilinear samples of a [C, H, W] map at metric xy [K, 2] -> [K, C];
    the lower corner clipped to [0, W - 2] x [0, H - 2]."""
    _, h, w = bev_chw.shape
    u = (xy[:, 0] - point_range[0]) / stride_m[0] - 0.5
    v = (xy[:, 1] - point_range[1]) / stride_m[1] - 0.5
    u0 = torch.floor(u).to(torch.int32).clamp(0, w - 2)
    v0 = torch.floor(v).to(torch.int32).clamp(0, h - 2)
    du = (u - u0).clamp(0, 1)[:, None]
    dv = (v - v0).clamp(0, 1)[:, None]
    u0, v0 = u0.long(), v0.long()

    def g(vv, uu):
        return bev_chw[:, vv, uu].t()                          # [K, C]
    return (g(v0, u0) * (1 - du) * (1 - dv) + g(v0, u0 + 1) * du * (1 - dv)
            + g(v0 + 1, u0) * (1 - du) * dv + g(v0 + 1, u0 + 1) * du * dv)


def raw_point_mean(points, kp, gi, cnt, nsample: int) -> torch.Tensor:
    """The mean over each keypoint's filled slots of its neighbours'
    features (points[:, 3:]; their offsets where the cloud has xyz
    alone)."""
    grouped = points[gi]
    raw = grouped[..., 3:] if points.shape[1] > 3 \
        else grouped[..., :3] - kp[:, None, :]
    mask = (torch.arange(nsample, device=points.device)[None, :]
            < cnt.clamp_min(1)[:, None])[..., None]
    return torch.where(mask, raw, 0.0).sum(1) / cnt.clamp_min(1)[:, None]


def bev_stride_m(grid: VoxelGrid, stride: int):
    return (grid.voxel_size[0] * stride, grid.voxel_size[1] * stride)


class VoxelSetAbstraction(nn.Module):
    """Keypoint features: `keypoints` (FPS over the valid points) and
    `aggregate` (the raw, voxel and BEV branches, fused)."""

    def __init__(self, point_features: int, voxel_channels: Sequence[int],
                 bev_channels: int, num_keypoints: int = 2048,
                 out_channels: int = 128, raw_radius: float = 0.8,
                 raw_nsample: int = 16,
                 voxel_radii: Sequence[float] = (1.2, 2.4),
                 voxel_nsample: int = 16, *, device):
        super().__init__()
        self.num_keypoints, self.raw_radius = num_keypoints, raw_radius
        self.raw_nsample, self.voxel_radii = raw_nsample, tuple(voxel_radii)
        self.voxel_nsample = voxel_nsample
        kw = dict(device=device)
        self.raw_proj = Dense(point_features or 3, 32, **kw)
        for si, c in enumerate(voxel_channels):
            setattr(self, f"vox_proj{si}", Dense(c, 32, **kw))
        self.bev_proj = Dense(bev_channels, 32, **kw)
        self.fuse = Dense(32 * (len(voxel_channels) + 2), out_channels, **kw)
        self.ln = FlaxLayerNorm(out_channels, **kw)

    def keypoints(self, points, valid) -> torch.Tensor:
        return farthest_point_sample(points[:, :3], self.num_keypoints,
                                     valid)

    def aggregate(self, points, valid, kp, voxel_tensors, voxel_strides,
                  bev_chw, grid: VoxelGrid, bev_stride: int):
        gi, cnt = ball_query(kp, points[:, :3], self.raw_radius,
                             self.raw_nsample, valid)
        branches = [self.raw_proj(raw_point_mean(points, kp, gi, cnt,
                                                 self.raw_nsample))]
        for si, (st, stride) in enumerate(zip(voxel_tensors, voxel_strides)):
            centers, vvalid = voxel_centers(st, grid, stride)
            radius = self.voxel_radii[min(si, len(self.voxel_radii) - 1)]
            gi, cnt = ball_query(kp, centers, radius, self.voxel_nsample,
                                 vvalid)
            mask = (torch.arange(self.voxel_nsample, device=kp.device)[None]
                    < cnt.clamp_min(1)[:, None])[..., None]
            pooled = torch.where(mask, st.features[gi], -1e9).amax(1)
            pooled = torch.where(cnt[:, None] > 0, pooled, 0.0)
            branches.append(getattr(self, f"vox_proj{si}")(pooled))
        bev = bev_bilinear(bev_chw, kp[:, :2], grid.point_range,
                           bev_stride_m(grid, bev_stride))
        branches.append(self.bev_proj(bev))
        return torch.relu(self.ln(self.fuse(torch.cat(branches, -1))))


class PVRCNNDetector(TwoStageDetector):
    """The sparse trunk, the anchor RPN on the height-compressed map, VSA
    keypoints (512) and the RoI head; `loss` is `two_stage_loss`."""

    def __init__(self, det_cfg: VoxelNeXtConfig, vox_cfg: VoxelizeConfig, *,
                 device=None, seed: int = 0, num_keypoints: int = 512):
        super().__init__(det_cfg, vox_cfg, device)
        kw = dict(device=self._device)
        self.backbone3d = CenterPointBackbone3D(
            det_cfg, vox_cfg.num_point_features, vox_cfg.max_voxels, **kw)
        nz = CenterPointBackbone3D.out_depth(self.voxel_grid().grid_size[2],
                                             self.backbone3d.n_stages)
        bev_ch = self.backbone3d.out_channels * nz
        self._anchor_rpn(bev_ch)
        self.vsa = self._make_vsa(bev_ch, num_keypoints)
        self.roi_head = RoIHead(self.vsa.fuse.kernel.shape[1], grid=4,
                                fc_channels=(128, 128), **kw)
        self._finish(seed)

    def _make_vsa(self, bev_ch: int, num_keypoints: int) -> nn.Module:
        return VoxelSetAbstraction(
            self.vox_cfg.num_point_features - 3,
            [self.backbone3d.out_channels], bev_ch,
            num_keypoints=num_keypoints, device=self._device)

    def keypoint_mask(self, s) -> torch.Tensor:
        return s["valid_points"]

    def stages(self, trace: Optional[List] = None):
        grid, stride = self.voxel_grid(), self.det_cfg.spatial_stride

        def trunk3d(s):
            s["st8"] = self.backbone3d(s["st0"], trace)
            s["bev_dense"] = height_compression(s["st8"])
            return s

        def trunk2d_rpn(s):
            s["rpn_preds"] = self.rpn(s["bev_dense"])
            s.update(self.anchor_entries(s["bev_dense"].device))
            return s

        def keypoints(s):
            s["kp_mask"] = self.keypoint_mask(s)
            s["keypoints"] = s["points"][
                self.vsa.keypoints(s["points"], s["kp_mask"]), :3]
            return s

        def pool(s):
            s["keypoint_features"] = self.vsa.aggregate(
                s["points"], s["kp_mask"], s["keypoints"], [s["st8"]],
                [stride], s["bev_dense"], grid, stride)
            # the proposals are constants to the second stage
            s["rois"] = s["proposals"].boxes[:, :7].detach()
            s["pooled"] = self.roi_head.pool(
                s["keypoints"], s["keypoint_features"], s["rois"])
            return s

        def roi_head(s):
            s["roi_preds"] = self.roi_head.head(s["pooled"])
            return s
        return [self.voxelize_stage(), ("trunk3d", trunk3d),
                ("trunk2d_rpn", trunk2d_rpn), self.proposals_stage(),
                ("keypoints", keypoints), ("pool", pool),
                ("roi_head", roi_head), ("refine", refine)]

    def loss(self, out, gt_boxes, gt_labels, gt_mask):
        return two_stage_loss(out, gt_boxes, gt_labels, gt_mask,
                              self.det_cfg.num_classes)


def refine(s):
    """The RoIs refined, scored by confidence times the proposal score."""
    p = s["proposals"]
    refined, conf = refine_boxes(s["roi_preds"], s["rois"])
    s["detections"] = Detections(boxes=boxes9(refined),
                                 scores=conf * p.scores, labels=p.labels,
                                 count=p.count)
    return s


def two_stage_loss(out, gt_boxes, gt_labels, gt_mask, num_classes: int):
    """The anchor RPN's loss + the RoI head's over `proposal_targets` of
    out["rois"] -> (total, {the anchor terms, "roi_cls_loss",
    "roi_reg_loss", "rpn_loss"})."""
    targets = assign_anchor_targets(out["anchors"], out["anchor_cls"],
                                    gt_boxes.float(), gt_labels, gt_mask)
    rpn_loss, aux = anchor_head_loss(out["rpn_preds"], targets, num_classes)
    rt = proposal_targets(out["rois"], gt_boxes, gt_mask)
    roi_loss, roi_aux = roi_head_loss(out["roi_preds"], rt)
    aux = dict(aux)
    aux.update(roi_aux)
    aux["rpn_loss"] = rpn_loss
    return rpn_loss + roi_loss, aux

