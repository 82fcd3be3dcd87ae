"""SECOND: the sparse trunk, height compression, the dense 2D trunk and
an anchor head (counterpart of lvv_tpu/models/second.py).

The anchor table is a function of the configs alone (`default_anchor_table`:
the stride-8 BEV cells, `DEFAULT_ANCHOR_SIZES` trimmed to the class count,
two rotations); it is made once when the detector is built and kept on its
device beside the parameters, outside the state_dict.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..config.schema import VoxelizeConfig, VoxelNeXtConfig
from ..ops.voxelize import VoxelGrid
from .anchor_head import (AnchorHead, anchor_head_loss,
                          assign_anchor_targets, decode_anchor_preds,
                          generate_anchors)
from .centerpoint import SparseTrunkDetector
from .voxelnext import Detections

# nuScenes-like per-class anchor sizes (dx, dy, dz); trimmed to num_classes
DEFAULT_ANCHOR_SIZES = ((4.6, 1.95, 1.72), (6.9, 2.5, 2.8), (0.7, 0.7, 1.7))


def default_anchor_table(det_cfg: VoxelNeXtConfig, vox_cfg: VoxelizeConfig
                         ) -> Tuple[np.ndarray, np.ndarray, int]:
    """(anchors [N, 7], class ids [N], sizes used) for the stride-8 BEV
    grid of the configs."""
    grid = VoxelGrid.create(vox_cfg.point_range, vox_cfg.voxel_size)
    stride = det_cfg.spatial_stride
    h = -(-grid.grid_size[1] // stride)
    w = -(-grid.grid_size[0] // stride)
    sizes = DEFAULT_ANCHOR_SIZES[: min(det_cfg.num_classes,
                                       len(DEFAULT_ANCHOR_SIZES))]
    anchors, acls = generate_anchors(
        (h, w), sizes, vox_cfg.point_range,
        (grid.voxel_size[0] * stride, grid.voxel_size[1] * stride))
    return anchors, acls, len(sizes)


class SECONDDetector(SparseTrunkDetector):
    """points -> the sparse trunk -> dense BEV -> AnchorHead (two
    rotations of each size a cell) -> {"preds", "anchors", "anchor_cls",
    "bev_dense"}; `loss` assigns the anchors' targets and takes the anchor
    loss, `decode` the anchor decode with NMS."""

    def __init__(self, det_cfg: VoxelNeXtConfig, vox_cfg: VoxelizeConfig, *,
                 device=None, seed: int = 0):
        super().__init__(det_cfg, vox_cfg, device)
        anchors, acls, n_sizes = default_anchor_table(det_cfg, vox_cfg)
        self.head = AnchorHead(self.backbone2d.out_channels,
                               det_cfg.num_classes, n_sizes * 2,
                               device=self._device)
        # constants, not state: plain tensors, moved to the map's device
        self.anchors = torch.from_numpy(anchors)
        self.anchor_cls = torch.from_numpy(acls)
        if self._device.type != "meta":
            self.anchors = self.anchors.to(self._device)
            self.anchor_cls = self.anchor_cls.to(self._device)
        self._finish(seed)

    def head_out(self, bev):
        return {"preds": self.head(bev),
                "anchors": self.anchors.to(bev.device),
                "anchor_cls": self.anchor_cls.to(bev.device),
                "bev_dense": bev}

    def decode(self, out) -> Detections:
        return decode_anchor_preds(out["preds"], out["anchors"],
                                   out["anchor_cls"], self.det_cfg)

    def loss(self, out, gt_boxes, gt_labels, gt_mask):
        targets = assign_anchor_targets(out["anchors"], out["anchor_cls"],
                                        gt_boxes.float(), gt_labels,
                                        gt_mask)
        return anchor_head_loss(out["preds"], targets,
                                self.det_cfg.num_classes)
