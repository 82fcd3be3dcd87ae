"""CenterPoint: a sparse 3D trunk, its height compression and the dense BEV
head (counterpart of lvv_tpu/models/centerpoint.py).

points -> `voxelize_mean` -> `CenterPointBackbone3D` (the sparse stages of
VoxelNeXt's trunk to stride 8) -> `height_compression` (z folded into the
channels of a dense map) -> `BaseBEVBackbone` (levels 64 and 128 at
strides 1 and 2, both brought back to stride 8) -> `DenseCenterHead` ->
`decode_dense` at the config's stride.

JAX's `CenterPointBackbone3D` builds its layers with their default norm,
LayerNorm, whatever the config's `norm` says; the port keeps that (its
`norm` argument is "ln" in every detector that the JAX package builds),
so a "bn" config trains and loads the same tree as an "ln" one
(ROADMAP.md queue 3).
"""
from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from ..config.schema import VoxelizeConfig, VoxelNeXtConfig
from ..ops.sparse import (SparseTensor, build_subm_rulebook, from_voxels,
                          to_dense)
from ..ops.voxelize import voxelize_mean
from .pointpillars import (BaseBEVBackbone, DenseCenterHead, DenseDetector,
                           decode_dense)
from .voxelnext import Detections, SparseBasicBlock, SparseConvLayer

# the 2D trunk of CenterPoint, SECOND and TransFusion (transfusion_lidar.
# yaml BACKBONE_2D): levels of 64 and 128 channels at strides 1 and 2, each
# brought back with 64 channels
TRUNK2D = dict(layer_channels=(64, 128), layer_strides=(1, 2),
               upsample_channels=(64, 64))


def height_compression(st: SparseTensor) -> torch.Tensor:
    """The dense [C·nz, ny, nx] map, z folded into the channels (channel
    c·nz + z)."""
    dense = to_dense(st)                              # [C, nz, ny, nx]
    c, nz, ny, nx = dense.shape
    return dense.reshape(c * nz, ny, nx)


class CenterPointBackbone3D(nn.Module):
    """Sparse stages to stride 8 (VoxelResBackBone8x's shape): conv_input
    and res1 at full resolution, then three strided convs, each followed by
    a residual block on its own active set. Stage capacities:
    `capacity_schedule` where the config gives one, else 3/4 of the
    previous (at least 1024) from the voxelizer's."""

    def __init__(self, cfg: VoxelNeXtConfig, cin: int, capacity: int, *,
                 norm: str = "ln", device=None):
        super().__init__()
        chs = tuple(cfg.channels[:4])
        kw = dict(norm=norm, device=device)
        self.conv_input = SparseConvLayer(cin, chs[0], **kw)
        self.res1 = SparseBasicBlock(chs[0], **kw)
        sched, cap = cfg.capacity_schedule, capacity
        self.capacities = []
        for i, ch in enumerate(chs[1:], start=1):
            cap = (sched[i - 1] if sched and i - 1 < len(sched)
                   else max(cap * 3 // 4, 1024))
            self.capacities.append(cap)
            setattr(self, f"down{i}", SparseConvLayer(
                chs[i - 1], ch, subm=False, stride=2, out_capacity=cap, **kw))
            setattr(self, f"res{i + 1}", SparseBasicBlock(ch, **kw))
        self.n_stages = len(chs) - 1
        self.out_channels = chs[-1]

    @staticmethod
    def out_depth(nz: int, n_stages: int = 3) -> int:
        """z cells after the strided stages (each ceil(nz / 2))."""
        for _ in range(n_stages):
            nz = -(-nz // 2)
        return nz

    def forward(self, st: SparseTensor,
                trace: Optional[List] = None) -> SparseTensor:
        """st -> the stride-8 sparse tensor; `trace`, when given, receives
        (name, SparseTensor) of every stage."""
        rb = build_subm_rulebook(st)
        st = self.res1(self.conv_input(st, rb), rb)
        if trace is not None:
            trace.append(("stage1", st))
        for i in range(1, self.n_stages + 1):
            st = getattr(self, f"down{i}")(st)
            st = getattr(self, f"res{i + 1}")(st, build_subm_rulebook(st))
            if trace is not None:
                trace.append((f"stage{i + 1}", st))
        return st


class SparseTrunkDetector(DenseDetector):
    """What CenterPoint, SECOND and TransFusion share: `voxelize_mean`,
    `CenterPointBackbone3D`, `height_compression` and the 2D trunk
    `TRUNK2D`; the subclass adds `head_out(bev)` and `decode(out)`."""

    def __init__(self, det_cfg: VoxelNeXtConfig, vox_cfg: VoxelizeConfig,
                 device):
        super().__init__(det_cfg, vox_cfg, device)
        self.backbone3d = CenterPointBackbone3D(
            det_cfg, vox_cfg.num_point_features, vox_cfg.max_voxels,
            device=self._device)
        nz = self.voxel_grid().grid_size[2]
        self.backbone2d = BaseBEVBackbone(
            self.backbone3d.out_channels * CenterPointBackbone3D.out_depth(
                nz, self.backbone3d.n_stages), **TRUNK2D,
            device=self._device)

    def stages(self, trace=None):
        grid = self.voxel_grid()

        def voxels(points, n):
            vox = voxelize_mean(points, n, grid,
                                max_voxels=self.vox_cfg.max_voxels)
            return from_voxels(vox.coords, vox.features, grid.grid_size)

        def trunk3d(st):
            return height_compression(self.backbone3d(st, trace))
        return (("voxelize", voxels), ("trunk3d", trunk3d),
                ("trunk2d", self.backbone2d), ("head", self.head_out))


class CenterPointDetector(SparseTrunkDetector):
    """points -> the sparse trunk -> dense BEV -> DenseCenterHead; decoded
    at the config's `spatial_stride`."""

    def __init__(self, det_cfg: VoxelNeXtConfig, vox_cfg: VoxelizeConfig, *,
                 device=None, seed: int = 0):
        super().__init__(det_cfg, vox_cfg, device)
        self.head = DenseCenterHead(self.backbone2d.out_channels,
                                    det_cfg.num_classes, device=self._device)
        self._finish(seed)

    def head_out(self, bev):
        return {"bev_dense": bev, "preds": self.head(bev)}

    def decode(self, out) -> Detections:
        return decode_dense(out["preds"], self.det_cfg, self.vox_cfg,
                            stride=self.det_cfg.spatial_stride)
