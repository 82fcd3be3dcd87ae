"""Voxel R-CNN: SECOND-style stage one and voxel-query RoI pooling
(counterpart of lvv_tpu/models/voxel_rcnn.py, its LiDAR trunk).

points -> `voxelize_mean` -> `MultiScaleBackbone3D` (every stage kept,
strides 1 to 8) -> `height_compression` -> `BaseBEVBackbone` -> the anchor
RPN -> anchor decode + NMS -> `VoxelRCNNHead`: a 4³ lattice inside each
proposal; each lattice point gathers the active voxels of its 3³
neighbourhood at strides 2, 4 and 8 (`gather_neighborhood`, within the
voxel diagonal), their offsets and features through Dense + ReLU, max
over the neighbours; the scales concatenated, Dense + ReLU layers, cls
and residual box. The proposals keep their gradient, as in JAX.

With `focal` (configs/kitti_voxel_rcnn_car_focal_multimodal.json) the
sparse trunk is `focal_conv.FocalMultiScaleBackbone3D`, and `loss` adds
its importance losses as "loss_box_of_pts". With `focal_use_img` too the
detector also builds the image branch (`semseg`: PyramidFeat2D's layer1,
reduced to channels[0], trunk norm `focal_trunk_norm`) and the multimodal
focal conv; a call that passes `image` [H, W, 3] and `proj` [3, 4] runs
them, the projection's pixel rows scaled by 0.25 to layer1's stride.
Reference trait kept: `detect(points, num_points)` and the train step
pass no image, as JAX's do, so they run the LiDAR-only focal trunk and
leave the image modules without a gradient.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..config.schema import VoxelizeConfig, VoxelNeXtConfig
from ..ops.sparse import SparseTensor, build_subm_rulebook
from ..ops.voxel_query import gather_neighborhood
from ..ops.voxelize import VoxelGrid
from .anchor_head import anchor_head_loss, assign_anchor_targets
from .centerpoint import TRUNK2D, CenterPointBackbone3D, height_compression
from .focal_conv import FocalMultiScaleBackbone3D, focal_aux_loss
from .pointpillars import BaseBEVBackbone, Dense
from .roi_head import (boxes9, canonical_decode, proposal_targets,
                       roi_head_loss)
from .semseg import PyramidFeat2D, image_feature_map, scale_pixels
from .two_stage import TwoStageDetector
from .voxelnext import Detections, SparseBasicBlock, SparseConvLayer

IMAGE_STRIDE = 4      # layer1's stride: the image features' pixel scale


class MultiScaleBackbone3D(nn.Module):
    """conv_input and res1 at full resolution, then three strided convs
    each followed by a residual block (capacity 3/4 of the previous, at
    least 1024) -> every stage's SparseTensor."""

    def __init__(self, cfg: VoxelNeXtConfig, cin: int, capacity: int, *,
                 device):
        super().__init__()
        chs = tuple(cfg.channels[:4])
        kw = dict(device=device)
        self.conv_input = SparseConvLayer(cin, chs[0], **kw)
        self.res1 = SparseBasicBlock(chs[0], **kw)
        cap = capacity
        for i, ch in enumerate(chs[1:], start=1):
            cap = max(cap * 3 // 4, 1024)
            setattr(self, f"down{i}", SparseConvLayer(
                chs[i - 1], ch, subm=False, stride=2, out_capacity=cap,
                **kw))
            setattr(self, f"res{i + 1}", SparseBasicBlock(ch, **kw))
        self.channels = chs

    def forward(self, st: SparseTensor,
                trace: Optional[List] = None) -> List[SparseTensor]:
        rb = build_subm_rulebook(st)
        st = self.res1(self.conv_input(st, rb), rb)
        stages = [st]
        for i in range(1, len(self.channels)):
            st = getattr(self, f"down{i}")(st)
            st = getattr(self, f"res{i + 1}")(st, build_subm_rulebook(st))
            stages.append(st)
        if trace is not None:
            trace.extend((f"stage{i + 1}", t) for i, t in enumerate(stages))
        return stages


def roi_grid_points_3d(rois: torch.Tensor, grid: int) -> torch.Tensor:
    """[M, 7] -> [M, grid³, 3] metric lattice points (cell centres) inside
    each rotated box."""
    gs = (torch.arange(grid, dtype=torch.float32, device=rois.device)
          + 0.5) / grid - 0.5
    gx, gy, gz = torch.meshgrid(gs, gs, gs, indexing="ij")
    lx = gx.reshape(-1)[None, :] * rois[:, None, 3]
    ly = gy.reshape(-1)[None, :] * rois[:, None, 4]
    lz = gz.reshape(-1)[None, :] * rois[:, None, 5]
    c = torch.cos(rois[:, 6])[:, None]
    s = torch.sin(rois[:, 6])[:, None]
    x = lx * c - ly * s + rois[:, None, 0]
    y = lx * s + ly * c + rois[:, None, 1]
    z = lz + rois[:, None, 2]
    return torch.stack([x, y, z], -1)


def neighbour_max(h: torch.Tensor) -> torch.Tensor:
    """[N, K, C] -> [N, C], the max over the K neighbours (-inf where every
    one is masked); its gradient goes to the winning entry, split evenly
    between exact ties, as jnp.max's."""
    return h.amax(1)


class VoxelRCNNHead(nn.Module):
    """Grid-point voxel aggregation (`pool`) and the Dense refinement
    (`head`)."""

    def __init__(self, stage_channels: Sequence[int], grid: int = 4,
                 mlp_ch: int = 32, fc_channels: Tuple[int, ...] = (128, 128),
                 ranges: Tuple[int, int, int] = (1, 1, 1), *, device):
        super().__init__()
        self.grid, self.ranges = grid, tuple(ranges)
        self.n_fc = len(fc_channels)
        for si, c in enumerate(stage_channels):
            setattr(self, f"mlp{si}", Dense(3 + c, mlp_ch, device=device))
        c = mlp_ch * len(stage_channels) * grid ** 3
        for i, ch in enumerate(fc_channels):
            setattr(self, f"fc{i}", Dense(c, ch, device=device))
            c = ch
        self.cls = Dense(c, 1, device=device)
        self.reg = Dense(c, 7, device=device)

    def pool(self, stages: List[SparseTensor], strides: List[int],
             rois: torch.Tensor, base_grid: VoxelGrid, point_range
             ) -> torch.Tensor:
        m = rois.shape[0]
        flat = roi_grid_points_3d(rois, self.grid).reshape(-1, 3)
        origin = torch.as_tensor(point_range[:3], dtype=torch.float32,
                                 device=rois.device)
        pooled = []
        for si, (st, stride) in enumerate(zip(stages, strides)):
            vs = torch.as_tensor(base_grid.voxel_size, dtype=torch.float32,
                                 device=rois.device) * stride
            qc = torch.floor((flat - origin) / vs).to(torch.int32).flip(1)
            radius = float(np.linalg.norm(
                np.asarray(base_grid.voxel_size) * stride))
            rel, feats, mask = gather_neighborhood(
                st, flat, qc, vs, origin, ranges=self.ranges, radius=radius)
            h = torch.relu(getattr(self, f"mlp{si}")(
                torch.cat([rel, feats], -1)))
            h = neighbour_max(torch.where(mask[..., None], h, -torch.inf))
            pooled.append(torch.where(torch.isfinite(h), h, 0.0))
        return torch.cat(pooled, -1).reshape(m, -1)

    def head(self, h) -> Dict[str, torch.Tensor]:
        for i in range(self.n_fc):
            h = torch.relu(getattr(self, f"fc{i}")(h))
        return {"cls": self.cls(h)[:, 0], "reg": self.reg(h)}


class VoxelRCNNDetector(TwoStageDetector):
    """`backbone3d` (focal with `det_cfg.focal`), `semseg` (with
    `focal_use_img`), `backbone2d`, `rpn`, `roi_head` (pooling from
    strides 2, 4 and 8); `loss`: the anchor loss, the RoI head's over
    `proposal_targets` of the proposals, and the focal convs' importance
    losses where the forward has them."""

    STRIDES = (2, 4, 8)

    def __init__(self, det_cfg: VoxelNeXtConfig, vox_cfg: VoxelizeConfig, *,
                 device=None, seed: int = 0, roi_grid: int = 4):
        super().__init__(det_cfg, vox_cfg, device)
        kw = dict(device=self._device)
        self.focal = getattr(det_cfg, "focal", False)
        if self.focal:
            use_img = getattr(det_cfg, "focal_use_img", False)
            if use_img:
                self.semseg = PyramidFeat2D(
                    ("layer1",), reduce_out=(det_cfg.channels[0],),
                    trunk_norm=getattr(det_cfg, "focal_trunk_norm", "gn"),
                    **kw)
            self.backbone3d = FocalMultiScaleBackbone3D(
                det_cfg, vox_cfg.num_point_features, vox_cfg.max_voxels,
                use_img=use_img, spawn=getattr(det_cfg, "focal_spawn", 128),
                **kw)
        else:
            self.backbone3d = MultiScaleBackbone3D(
                det_cfg, vox_cfg.num_point_features, vox_cfg.max_voxels,
                **kw)
        chs = self.backbone3d.channels
        nz = CenterPointBackbone3D.out_depth(self.voxel_grid().grid_size[2],
                                             len(chs) - 1)
        self.backbone2d = BaseBEVBackbone(chs[-1] * nz, **TRUNK2D, **kw)
        self._anchor_rpn(self.backbone2d.out_channels)
        self.roi_head = VoxelRCNNHead(chs[1:], grid=roi_grid, **kw)
        self._finish(seed)

    def forward(self, points: torch.Tensor, num_points, image=None,
                proj=None, return_dense_bev: bool = True,
                trace: Optional[List] = None,
                spawned: Optional[List] = None) -> Dict:
        """As DenseDetector's; `image` [H, W, 3] and `proj` [3, 4] run the
        image branch of a focal multimodal config (its multimodal focal
        conv included); `spawned` receives each focal conv's spawned
        ids."""
        (_, first), *rest = self.stages(trace, image, proj, spawned)
        x = first(points.to(self.device, torch.float32), num_points)
        for _, fn in rest:
            x = fn(x)
        return x

    def stages(self, trace: Optional[List] = None, image=None, proj=None,
               spawned: Optional[List] = None):
        """The forward's steps; a focal config with `image` and `proj`
        adds "image" (the image branch) after "voxelize"."""
        grid = self.voxel_grid()
        use_img = (self.focal and image is not None
                   and hasattr(self, "semseg"))

        def image_branch(s):
            s["image_feat"] = image_feature_map(self.semseg,
                                                image.to(self.device))
            s["proj"] = scale_pixels(proj.to(self.device).float(),
                                     1.0 / IMAGE_STRIDE)
            return s

        def trunk3d(s):
            if self.focal:
                s["stages"], s["focal_aux"] = self.backbone3d(
                    s.pop("st0"), s.pop("image_feat", None),
                    s.pop("proj", None), self.vox_cfg.voxel_size,
                    self.vox_cfg.point_range, trace, spawned)
            else:
                s["stages"] = self.backbone3d(s.pop("st0"), trace)
            s["bev3d"] = height_compression(s["stages"][-1])
            return s

        def trunk2d_rpn(s):
            bev = self.backbone2d(s.pop("bev3d"))
            s.update(bev_dense=bev, preds=self.rpn(bev),
                     **self.anchor_entries(bev.device))
            return s

        def pool(s):
            s["pooled"] = self.roi_head.pool(
                s["stages"][1:], list(self.STRIDES),
                s["proposals"].boxes[:, :7], grid, self.vox_cfg.point_range)
            return s

        def roi_head(s):
            s["roi_preds"] = self.roi_head.head(s["pooled"])
            return s

        def refine(s):
            p, rp = s["proposals"], s["roi_preds"]
            refined = canonical_decode(rp["reg"].float(), p.boxes[:, :7])
            s["detections"] = Detections(
                boxes=boxes9(refined),
                scores=torch.sigmoid(rp["cls"].float()) * p.scores,
                labels=p.labels, count=p.count)
            return s
        return [self.voxelize_stage(),
                *([("image", image_branch)] if use_img else []),
                ("trunk3d", trunk3d),
                ("trunk2d_rpn", trunk2d_rpn), self.proposals_stage("preds"),
                ("pool", pool), ("roi_head", roi_head), ("refine", refine)]

    def loss(self, out, gt_boxes, gt_labels, gt_mask):
        rpn_loss, stats = anchor_head_loss(
            out["preds"],
            assign_anchor_targets(out["anchors"], out["anchor_cls"],
                                  gt_boxes.float(), gt_labels, gt_mask),
            self.det_cfg.num_classes)
        tgt = proposal_targets(out["proposals"].boxes[:, :7], gt_boxes,
                               gt_mask)
        rcnn_loss, rstats = roi_head_loss(out["roi_preds"], tgt)
        total = rpn_loss + rcnn_loss
        if out.get("focal_aux"):
            fl = focal_aux_loss(out["focal_aux"], gt_boxes, gt_labels,
                                gt_mask)
            total = total + fl
            rstats = {**rstats, "loss_box_of_pts": fl}
        return total, {**stats, **rstats}

