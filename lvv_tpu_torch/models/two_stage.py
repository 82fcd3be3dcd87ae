"""What the two-stage detectors share (PV-RCNN, PV-RCNN++, Part-A²,
Voxel R-CNN, SECOND-IoU, PointRCNN; the JAX package writes each as one
flax module).

A family's forward is a list of stages (`stages(trace)`), each a (name,
fn): the first takes (points, num_points) and returns a dict, every later
one takes that dict and returns it with its own entries added. The last,
"refine", adds "detections"; `decode(out)` reads them, so `detect` (the
eval forward without a graph, then `decode`) and chip_smoke's stage timer
run the forward as the zoo's dense families do. The stage names are the
ones the family has of: "voxelize", "trunk3d" (the sparse trunk, its
height compression), "trunk2d_rpn" (the 2D trunk, the anchor RPN and any
first-stage point head), "proposals" (anchor decode + NMS), "keypoints"
(farthest-point sampling), "pool" (the second stage's gathers and
pooling), "roi_head" (its dense layers) and "refine"; PointRCNN has
"backbone" (PointNet++), "point_head" and "proposals" (point decode + NMS)
before "pool".

Proposals are constants to the second stage where JAX stops their
gradient (PV-RCNN, PV-RCNN++, PointRCNN: `.detach()`); Part-A², Voxel
R-CNN and SECOND-IoU pass them on with their gradient, as JAX does.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from ..ops.sparse import delinearize, from_voxels
from ..ops.voxelize import voxelize_mean
from .anchor_head import AnchorHead, decode_anchor_preds
from .pointpillars import DenseDetector
from .second import default_anchor_table
from .voxelnext import Detections


def point_mask(points: torch.Tensor, num_points) -> torch.Tensor:
    """[N] bool: the first num_points rows."""
    return torch.arange(points.shape[0], device=points.device) < num_points


def metric_centers(st, voxel_size, origin) -> torch.Tensor:
    """[V, 3] xyz centres of a SparseTensor's sites, as JAX's heads take
    them: (coords + 0.5) · voxel_size + origin, both float32."""
    coords = delinearize(st.ids, st.grid)
    dev = st.ids.device
    vs = torch.as_tensor(voxel_size, dtype=torch.float32, device=dev)
    og = torch.as_tensor(origin, dtype=torch.float32, device=dev)
    return (coords.flip(1).float() + 0.5) * vs + og


class TwoStageDetector(DenseDetector):
    """DenseDetector's forward and `detect` over the family's stages; the
    anchor table (for the voxel families) as SECOND keeps it."""

    def _anchor_rpn(self, cin: int, name: str = "rpn") -> None:
        anchors, acls, n_sizes = default_anchor_table(self.det_cfg,
                                                      self.vox_cfg)
        setattr(self, name, AnchorHead(cin, self.det_cfg.num_classes,
                                       n_sizes * 2, device=self._device))
        self.anchors = torch.from_numpy(anchors)
        self.anchor_cls = torch.from_numpy(acls)
        if self._device.type != "meta":
            self.anchors = self.anchors.to(self._device)
            self.anchor_cls = self.anchor_cls.to(self._device)

    def anchor_entries(self, device) -> Dict:
        return {"anchors": self.anchors.to(device),
                "anchor_cls": self.anchor_cls.to(device)}

    def voxelize_stage(self):
        grid = self.voxel_grid()

        def voxelize(points, n):
            vox = voxelize_mean(points, n, grid,
                                max_voxels=self.vox_cfg.max_voxels)
            return {"points": points, "num_points": n,
                    "valid_points": point_mask(points, n),
                    "st0": from_voxels(vox.coords, vox.features,
                                       grid.grid_size)}
        return ("voxelize", voxelize)

    def proposals_stage(self, preds_key: str = "rpn_preds"):
        def proposals(s):
            s["proposals"] = decode_anchor_preds(
                s[preds_key], s["anchors"], s["anchor_cls"], self.det_cfg)
            return s
        return ("proposals", proposals)

    def decode(self, out) -> Detections:
        return out["detections"]

    def stages(self, trace: Optional[List] = None):
        raise NotImplementedError
