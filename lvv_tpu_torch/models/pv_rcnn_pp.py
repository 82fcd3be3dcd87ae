"""PV-RCNN++: proposal-centric keypoints and vector-pool aggregation
(counterpart of lvv_tpu/models/pv_rcnn_pp.py).

PV-RCNN's trunk, RPN, RoI head and loss, with two changes:
1. the keypoints are farthest-point samples of the points near a live
   proposal (`proposal_centric_mask`: within the box's half-diagonal plus
   1.6 m of its centre, in BEV; all valid points where no proposal is
   live);
2. the voxel branch is `vector_pool` over each keypoint's 3³ stride-8
   voxel neighbourhood (within twice the largest voxel side), 2³ bins of
   the local box concatenated (`VectorPoolVSA`).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from ..ops.sampling import ball_query, farthest_point_sample
from ..ops.voxel_query import gather_neighborhood, vector_pool
from ..ops.voxelize import VoxelGrid
from .pointpillars import Dense, FlaxLayerNorm
from .pv_rcnn import (PVRCNNDetector, bev_bilinear, bev_stride_m,
                      raw_point_mean)


def proposal_centric_mask(points: torch.Tensor, valid: torch.Tensor,
                          proposals: torch.Tensor, prop_scores: torch.Tensor,
                          radius_extra: float = 1.6) -> torch.Tensor:
    """[N] bool: valid points within (half-diagonal + radius_extra) of a
    proposal's centre in BEV; proposals of score 0 (NMS padding) are
    ignored."""
    c2 = proposals[None, :, :2] - points[:, None, :2]
    d2 = (c2 * c2).sum(-1)
    half_diag = 0.5 * torch.sqrt(proposals[:, 3] ** 2 + proposals[:, 4] ** 2)
    thr = (half_diag + radius_extra) ** 2
    near = ((d2 <= thr[None, :]) & (prop_scores > 0)[None, :]).any(1)
    return near & valid


class VectorPoolVSA(nn.Module):
    """Keypoint features with vector-pool voxel neighbourhoods: the raw
    branch (ball-query mean), one vector pool a voxel scale, the BEV
    sample; each projected to 32 and fused."""

    def __init__(self, point_features: int, voxel_channels: Sequence[int],
                 bev_channels: int, num_keypoints: int = 512,
                 out_channels: int = 128, raw_radius: float = 0.8,
                 raw_nsample: int = 16,
                 divisions: Sequence[int] = (2, 2, 2),
                 ranges: Sequence[int] = (1, 1, 1), *, device):
        super().__init__()
        self.num_keypoints, self.raw_radius = num_keypoints, raw_radius
        self.raw_nsample = raw_nsample
        self.divisions, self.ranges = tuple(divisions), tuple(ranges)
        nbin = int(np.prod(self.divisions))
        kw = dict(device=device)
        self.raw_proj = Dense(point_features or 3, 32, **kw)
        for si, c in enumerate(voxel_channels):
            setattr(self, f"vp_proj{si}", Dense(nbin * c, 32, **kw))
        self.bev_proj = Dense(bev_channels, 32, **kw)
        self.fuse = Dense(32 * (len(voxel_channels) + 2), out_channels, **kw)
        self.ln = FlaxLayerNorm(out_channels, **kw)

    def keypoints(self, points, kp_mask) -> torch.Tensor:
        return farthest_point_sample(points[:, :3], self.num_keypoints,
                                     kp_mask)

    def aggregate(self, points, kp_mask, kp, voxel_tensors, voxel_strides,
                  bev_chw, grid: VoxelGrid, bev_stride: int):
        gi, cnt = ball_query(kp, points[:, :3], self.raw_radius,
                             self.raw_nsample, kp_mask)
        branches = [self.raw_proj(raw_point_mean(points, kp, gi, cnt,
                                                 self.raw_nsample))]
        origin = torch.as_tensor(grid.point_range[:3], dtype=torch.float32,
                                 device=kp.device)
        for si, (st, stride) in enumerate(zip(voxel_tensors, voxel_strides)):
            vs = torch.as_tensor(grid.voxel_size, dtype=torch.float32,
                                 device=kp.device) * stride
            qc = torch.floor((kp - origin) / vs).to(torch.int32).flip(1)
            rel, feats, mask = gather_neighborhood(
                st, kp, qc, vs, origin, ranges=self.ranges,
                radius=float(2.0 * np.max(np.asarray(grid.voxel_size))
                             * stride))
            ext = tuple(float(v) * (self.ranges[i] + 0.5) for i, v in
                        enumerate(np.asarray(grid.voxel_size) * stride))
            vp = vector_pool(rel, feats, mask, extent=ext,
                             divisions=self.divisions)
            branches.append(getattr(self, f"vp_proj{si}")(vp))
        bev = bev_bilinear(bev_chw, kp[:, :2], grid.point_range,
                           bev_stride_m(grid, bev_stride))
        branches.append(self.bev_proj(bev))
        return torch.relu(self.ln(self.fuse(torch.cat(branches, -1))))


class PVRCNNPlusPlusDetector(PVRCNNDetector):
    """PV-RCNN with proposal-centric keypoints and `VectorPoolVSA`."""

    def _make_vsa(self, bev_ch: int, num_keypoints: int) -> nn.Module:
        return VectorPoolVSA(
            self.vox_cfg.num_point_features - 3,
            [self.backbone3d.out_channels], bev_ch,
            num_keypoints=num_keypoints, device=self._device)

    def keypoint_mask(self, s) -> torch.Tensor:
        p, valid = s["proposals"], s["valid_points"]
        mask = proposal_centric_mask(s["points"], valid, p.boxes[:, :7],
                                     p.scores)
        # all valid points where no proposal survives NMS
        return torch.where(mask.any(), mask, valid)
