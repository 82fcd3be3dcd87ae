"""PillarNet: a sparse 2D pillar trunk and the dense centre head
(counterpart of lvv_tpu/models/pillarnet.py).

points -> `voxelize_mean` on a pillar grid (the whole z range one voxel)
-> `PillarResBackbone` (sparse 2D residual stages to stride 8; the pillars
stay sparse until then) -> the dense stride-8 map -> `BaseBEVBackbone`
(levels 64 and 128 at strides 1 and 2, both back at stride 8) ->
`DenseCenterHead` -> `decode_dense` at the config's `spatial_stride`.

Each strided stage keeps 3/4 of the previous stage's capacity (at least
1024) from the voxelizer's, as JAX's trunk does.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

from torch import nn

from ..config.schema import VoxelizeConfig, VoxelNeXtConfig
from ..ops.sparse import (SparseTensor, build_subm_rulebook, from_voxels,
                          to_dense)
from ..ops.voxelize import VoxelGrid, voxelize_mean
from .pointpillars import (BaseBEVBackbone, DenseCenterHead, DenseDetector,
                           decode_dense)
from .voxelnext import Detections, SparseBasicBlock, SparseConvLayer


def stage_capacities(capacity: int, n: int) -> list:
    """The strided stages' capacities: each 3/4 of the previous, at least
    1024."""
    caps = []
    for _ in range(n):
        capacity = max(capacity * 3 // 4, 1024)
        caps.append(capacity)
    return caps


class PillarResBackbone(nn.Module):
    """Sparse 2D residual trunk to stride 8 (PillarRes18BackBone8x): a
    submanifold conv and two residual blocks, then per stage a strided
    sparse conv and two residual blocks on its own active set."""

    def __init__(self, cin: int, capacity: int,
                 channels: Sequence[int] = (32, 64, 128, 256), *, device):
        super().__init__()
        chs = tuple(channels)
        kw = dict(ndim2d=True, device=device)
        self.conv_input = SparseConvLayer(cin, chs[0], **kw)
        self.res1a = SparseBasicBlock(chs[0], **kw)
        self.res1b = SparseBasicBlock(chs[0], **kw)
        self.capacities = stage_capacities(capacity, len(chs) - 1)
        for i, (ch, cap) in enumerate(zip(chs[1:], self.capacities),
                                      start=1):
            setattr(self, f"down{i}", SparseConvLayer(
                chs[i - 1], ch, subm=False, stride=2, out_capacity=cap,
                **kw))
            setattr(self, f"res{i + 1}a", SparseBasicBlock(ch, **kw))
            setattr(self, f"res{i + 1}b", SparseBasicBlock(ch, **kw))
        self.out_channels = chs[-1]

    def forward(self, st: SparseTensor,
                trace: Optional[List] = None) -> SparseTensor:
        """st -> the stride-8 sparse tensor; `trace`, when given, receives
        (name, SparseTensor) of every stage."""
        rb = build_subm_rulebook(st, ndim2d=True)
        st = self.conv_input(st, rb)
        st = self.res1b(self.res1a(st, rb), rb)
        if trace is not None:
            trace.append(("stage1", st))
        for i in range(1, len(self.capacities) + 1):
            st = getattr(self, f"down{i}")(st)
            rb = build_subm_rulebook(st, ndim2d=True)
            st = getattr(self, f"res{i + 1}a")(st, rb)
            st = getattr(self, f"res{i + 1}b")(st, rb)
            if trace is not None:
                trace.append((f"stage{i + 1}", st))
        return st


class PillarNetDetector(DenseDetector):
    """points -> pillars -> the sparse 2D trunk -> dense stride-8 BEV ->
    BaseBEVBackbone -> DenseCenterHead; decoded at `spatial_stride`."""

    def __init__(self, det_cfg: VoxelNeXtConfig, vox_cfg: VoxelizeConfig, *,
                 device=None, seed: int = 0):
        super().__init__(det_cfg, vox_cfg, device)
        kw = dict(device=self._device)
        self.backbone2d_sparse = PillarResBackbone(
            vox_cfg.num_point_features, vox_cfg.max_voxels, **kw)
        self.backbone2d = BaseBEVBackbone(
            self.backbone2d_sparse.out_channels, layer_channels=(64, 128),
            layer_strides=(1, 2), upsample_channels=(64, 64), **kw)
        self.head = DenseCenterHead(self.backbone2d.out_channels,
                                    det_cfg.num_classes, **kw)
        self._finish(seed)

    def voxel_grid(self) -> VoxelGrid:
        """The pillar grid: the whole z range as one voxel."""
        pr, vs = self.vox_cfg.point_range, self.vox_cfg.voxel_size
        return VoxelGrid.create(pr, (vs[0], vs[1], pr[5] - pr[2]))

    def stages(self, trace=None):
        grid = self.voxel_grid()

        def pillars(points, n):
            vox = voxelize_mean(points, n, grid,
                                max_voxels=self.vox_cfg.max_voxels)
            return from_voxels(vox.coords, vox.features, grid.grid_size)

        def trunk(st):
            return self.backbone2d_sparse(st, trace)

        def bev(st):
            return self.backbone2d(to_dense(st)[:, 0])
        return (("voxelize", pillars), ("trunk3d", trunk),
                ("trunk2d", bev), ("head", self.head_out))

    def head_out(self, bev):
        return {"bev_dense": bev, "preds": self.head(bev)}

    def decode(self, out) -> Detections:
        return decode_dense(out["preds"], self.det_cfg, self.vox_cfg,
                            stride=self.det_cfg.spatial_stride)
