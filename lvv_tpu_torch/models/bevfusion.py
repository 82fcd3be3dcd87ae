"""BEVFusion: the camera + LiDAR fusion detector (counterpart of
lvv_tpu/models/bevfusion.py).

- LiDAR branch: `voxelize_mean` -> `CenterPointBackbone3D` (stride 8) ->
  `height_compression`, CenterPoint's.
- Camera branch: `SwinBackbone` (Swin-T, `out_indices` (1, 2, 3)) over
  the views at `image_hw` -> `GeneralizedLSSFPN` (top-down: each level
  upsampled bilinearly to the next finer one, concatenated, a 1x1 and a
  3x3 block) -> `project_points_to_depth` (each view's sparse LiDAR depth
  image) -> `DepthLSSTransform` (the lift and `bev_pool`'s splat onto the
  LiDAR BEV's grid).
- `ConvFuser`, then `BaseBEVBackbone` (levels 128 / 256 at strides 1 / 2,
  each brought back with 128 channels) and `TransFusionHead` (200
  queries), decoded NMS-free by `decode_queries` at the config's stride.

The defaults are the JAX class's: 256 x 704 views, Swin-T (embed 96,
depths 2 / 2 / 6 / 2, heads 3 / 6 / 12 / 24, window 7), FPN 256, camera
BEV 80, fuser 128. At 256 x 704 the Swin stages' grids (64 x 176 down to
8 x 22) are not whole windows of 7: the port pads them as transformers
does (`models/swin.py`), where the JAX package cannot run. The FPN's
bilinear upsampling is `jax.image.resize`'s (`layers.resize_1d` on each
axis). Everything runs in fp32 (TF32 off, as the caller sets it); kernel
K-a takes Swin's LayerNorms of width 384, 768 and 1536 and the head's of
128, K-e's fp32 form the head's cross-attention over the BEV tokens.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..config.schema import VoxelizeConfig, VoxelNeXtConfig
from ..ops.sparse import from_voxels
from ..ops.voxelize import voxelize_mean
from .centerpoint import CenterPointBackbone3D, height_compression
from .depth_lss import ConvFuser, DepthLSSTransform, project_points_to_depth
from .layers import resize_1d
from .pointpillars import BaseBEVBackbone, Conv2d, DenseDetector, FlaxLayerNorm
from .swin import SwinBackbone
from .transfusion import TransFusionHead, decode_queries
from .voxelnext import Detections


class BasicBlock2D(nn.Module):
    """A bias-free conv (flax SAME), LayerNorm, ReLU; NCHW."""

    def __init__(self, cin: int, channels: int, kernel: int = 3, *, device):
        super().__init__()
        self.conv = Conv2d(cin, channels, kernel, bias=False, device=device)
        self.ln = FlaxLayerNorm(channels, 1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.ln(self.conv(x)))


class GeneralizedLSSFPN(nn.Module):
    """Top-down FPN with concatenation: for i from the second-coarsest level
    to the finest, the level above upsampled to level i's size, concatenated
    after level i, a 1x1 block (`lateral{i}`) and a 3x3 block (`fpn{i}`);
    -> every level but the coarsest, [V, out, Hi, Wi]."""

    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 *, device):
        super().__init__()
        self.used = len(in_channels) - 1
        for i in range(self.used):
            above = (in_channels[i + 1] if i == self.used - 1
                     else out_channels)
            setattr(self, f"lateral{i}", BasicBlock2D(
                in_channels[i] + above, out_channels, 1, device=device))
            setattr(self, f"fpn{i}", BasicBlock2D(out_channels, out_channels,
                                                  3, device=device))

    def forward(self, inputs: Sequence[torch.Tensor]) -> Tuple:
        levels = list(inputs)
        for i in range(self.used - 1, -1, -1):
            h, w = levels[i].shape[2:]
            up = resize_1d(resize_1d(levels[i + 1], 2, h, "linear"), 3, w,
                           "linear")
            y = getattr(self, f"lateral{i}")(torch.cat([levels[i], up], 1))
            levels[i] = getattr(self, f"fpn{i}")(y)
        return tuple(levels[:self.used])


def _halved(n: int, times: int) -> int:
    for _ in range(times):
        n = -(-n // 2)
    return n


class BEVFusionDetector(DenseDetector):
    """points, views, intrinsics and camera-to-LiDAR transforms ->
    {"bev_dense", "cam_bev", "lidar_bev", "preds"}; `detect` adds the query
    decode. `stages(trace)` lists the forward's steps for chip_smoke's
    split, each (name, fn(state)) on a dict that starts with the inputs
    (`inputs`) and keeps every step's result (the depth maps among
    them)."""

    camera_input = True           # views in; no train step (registry)

    def __init__(self, det_cfg: VoxelNeXtConfig, vox_cfg: VoxelizeConfig, *,
                 device=None, seed: int = 0,
                 image_hw: Tuple[int, int] = (256, 704),
                 swin_embed: int = 96,
                 swin_depths: Tuple[int, ...] = (2, 2, 6, 2),
                 swin_heads: Tuple[int, ...] = (3, 6, 12, 24),
                 swin_window: int = 7,
                 out_indices: Tuple[int, ...] = (1, 2, 3),
                 fpn_channels: int = 256, cam_bev_channels: int = 80,
                 fuse_channels: int = 128, num_queries: int = 200):
        super().__init__(det_cfg, vox_cfg, device)
        kw = dict(device=self._device)
        self.image_hw = tuple(image_hw)
        self.backbone3d = CenterPointBackbone3D(
            det_cfg, vox_cfg.num_point_features, vox_cfg.max_voxels, **kw)
        nx, ny, nz = self.voxel_grid().grid_size
        n_st = self.backbone3d.n_stages
        lidar_ch = (self.backbone3d.out_channels
                    * CenterPointBackbone3D.out_depth(nz, n_st))
        self.image_backbone = SwinBackbone(
            swin_embed, swin_depths, swin_heads, swin_window,
            image_hw=self.image_hw, out_indices=out_indices, **kw)
        self.neck = GeneralizedLSSFPN(
            [swin_embed * 2 ** i for i in out_indices], fpn_channels, **kw)
        feat_h = _halved(self.image_hw[0] // 4, out_indices[0])
        self.vtransform = DepthLSSTransform(
            fpn_channels, cam_bev_channels,
            img_stride=self.image_hw[0] // feat_h,
            bev_hw=(_halved(ny, n_st), _halved(nx, n_st)),
            point_range=tuple(vox_cfg.point_range), **kw)
        self.fuser = ConvFuser(cam_bev_channels + lidar_ch, fuse_channels,
                               **kw)
        self.backbone2d = BaseBEVBackbone(
            fuse_channels, layer_channels=(128, 256), layer_strides=(1, 2),
            upsample_channels=(128, 128), **kw)
        self.head = TransFusionHead(self.backbone2d.out_channels,
                                    det_cfg.num_classes, num_queries, **kw)
        self._finish(seed)

    def stages(self, trace: Optional[List] = None):
        grid = self.voxel_grid()

        def voxelize(s):
            vox = voxelize_mean(s["points"], s["num_points"], grid,
                                max_voxels=self.vox_cfg.max_voxels)
            s["st"] = from_voxels(vox.coords, vox.features, grid.grid_size)

        def trunk3d(s):
            s["lidar_bev"] = height_compression(self.backbone3d(s["st"],
                                                                trace))

        def swin(s):
            s["pyramid"] = self.image_backbone(s["images"])

        def fpn(s):
            s["feats"] = self.neck(s["pyramid"])[0]

        def depth(s):
            s["depth_maps"] = project_points_to_depth(
                s["points"], s["num_points"], s["intrinsics"],
                s["cam2lidar"], self.image_hw)

        def lift_splat(s):
            s["cam_bev"] = self.vtransform(s["feats"], s["intrinsics"],
                                           s["cam2lidar"],
                                           s["depth_maps"])

        def fuse_trunk2d(s):
            s["bev_dense"] = self.backbone2d(self.fuser(s["cam_bev"],
                                                        s["lidar_bev"]))

        def head(s):
            s["preds"] = self.head(s["bev_dense"])
        return (("voxelize", voxelize), ("trunk3d", trunk3d), ("swin", swin),
                ("fpn", fpn), ("depth", depth), ("lift_splat", lift_splat),
                ("fuser_trunk2d", fuse_trunk2d), ("head", head))

    def inputs(self, points, num_points, images, intrinsics,
               cam2lidar) -> Dict:
        """The stages' starting state, on the detector's device."""
        if tuple(images.shape[-2:]) != self.image_hw:
            raise ValueError(f"images {tuple(images.shape[-2:])} != the "
                             f"configured image_hw {self.image_hw}: the "
                             "depth projection would misalign")
        dev = self.device
        return {"points": points.to(dev, torch.float32),
                "num_points": num_points,
                "images": images.to(dev, torch.float32),
                "intrinsics": intrinsics.to(dev, torch.float32),
                "cam2lidar": cam2lidar.to(dev, torch.float32)}

    @staticmethod
    def outputs(state: Dict) -> Dict:
        return {k: state[k] for k in ("bev_dense", "cam_bev", "lidar_bev",
                                      "preds")}

    def forward(self, points, num_points, images, intrinsics, cam2lidar,
                trace: Optional[List] = None) -> Dict:
        """points [P, >=4]; images [V, 3, H, W]; intrinsics [V, 3, 3];
        cam2lidar [V, 4, 4] (camera -> LiDAR / ego); `trace` receives the
        sparse trunk's stages."""
        s = self.inputs(points, num_points, images, intrinsics, cam2lidar)
        for _, fn in self.stages(trace):
            fn(s)
        return self.outputs(s)

    @torch.no_grad()
    def detect(self, points, num_points, images, intrinsics,
               cam2lidar) -> Detections:
        training = self.training
        self.eval()
        try:
            out = self(points, num_points, images, intrinsics, cam2lidar)
        finally:
            self.train(training)
        return self.decode(out)

    def decode(self, out) -> Detections:
        return decode_queries(out["preds"], self.det_cfg, self.vox_cfg,
                              stride=self.det_cfg.spatial_stride)
