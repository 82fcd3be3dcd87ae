"""Depth-LSS camera-to-BEV view transform and the conv fuser (counterpart
of lvv_tpu/models/depth_lss.py; BEVFusion's camera branch).

Per camera, image features predict a distribution over depth bins and a
context vector; their outer product lifts the features into the camera's
frustum; each frustum point goes to its ego-frame BEV bin, and `bev_pool`
sums everything into the BEV canvas; `ConvFuser` merges the camera BEV
with the LiDAR BEV.

- `ConvImageBackbone`: a compact strided conv pyramid, [3, H, W] ->
  [C, H/8, W/8] (the JAX package's stand-in image backbone).
- `frustum_grid`, `frustum_to_ego`: (u, v, d) at pixel centres of the
  feature map, and their ego-frame xyz.
- `project_points_to_depth`: each camera's sparse depth image from the
  LiDAR points, the nearest return a pixel (a scatter-min; pixels with no
  return 0).
- `DepthLSSTransform`: the depth-prior conv stack (`dt*`, `mix`), the
  depth and context heads, the lift and the splat.
- `ConvFuser`: concatenation, a 3x3 conv, LayerNorm, ReLU.

Maps are NCHW here where the JAX package runs NHWC; its flax LayerNorms
(one-pass variance, eps 1e-6) are `FlaxLayerNorm` over the channels. The
geometry (points into pixels, frustum points into bins) is written as
elementwise fp32 products and sums in a fixed order, constants as device
tensors (a true division, as `ops.voxelize` bins), so the card computes
the same pixel and bin of every point as the CPU; the splat's sums then
differ only by the card's atomic order.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..ops.pool import bev_pool
from .pointpillars import Conv2d, FlaxLayerNorm


def _f32(v, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=device)


class ConvImageBackbone(nn.Module):
    """Strided 3x3 convs (flax SAME), each LayerNorm + ReLU: [3, H, W] ->
    [C, H/8, W/8]."""

    def __init__(self, channels: Sequence[int] = (32, 64, 128), *, device):
        super().__init__()
        self.n = len(channels)
        cin = 3
        for i, ch in enumerate(channels):
            setattr(self, f"conv{i}", Conv2d(cin, ch, 3, 2, device=device))
            setattr(self, f"ln{i}", FlaxLayerNorm(ch, 1, device=device))
            cin = ch

    def forward(self, img_chw: torch.Tensor) -> torch.Tensor:
        x = img_chw[None]
        for i in range(self.n):
            x = torch.relu(getattr(self, f"ln{i}")(
                getattr(self, f"conv{i}")(x)))
        return x[0]


def frustum_grid(hf: int, wf: int, depth_bins: torch.Tensor,
                 img_stride: int) -> torch.Tensor:
    """[D, Hf, Wf, 3] of (u, v, d): pixel centres of the stride-`img_stride`
    feature map at each depth."""
    dev = depth_bins.device
    us = (torch.arange(wf, dtype=torch.float32, device=dev) + 0.5) \
        * img_stride
    vs = (torch.arange(hf, dtype=torch.float32, device=dev) + 0.5) \
        * img_stride
    d, v, u = torch.meshgrid(depth_bins, vs, us, indexing="ij")
    return torch.stack([u, v, d], -1)


def _affine(cam, m: torch.Tensor) -> tuple:
    """Rows 0-2 of m [4, 4] (or [V, 4, 4], broadcast over cam's leading
    axes after V) applied to homogeneous cam = (x, y, z, 1): each output a
    sum of products in column order."""
    lead = (slice(None),) * (m.dim() - 2)
    shape = m.shape[:-2] + (1,) * (cam[0].dim() - (m.dim() - 2))

    def e(j, k):
        return m[lead + (j, k)].reshape(shape)
    return tuple(cam[0] * e(j, 0) + cam[1] * e(j, 1) + cam[2] * e(j, 2)
                 + e(j, 3) for j in range(3))


def frustum_to_ego(frustum_uvd: torch.Tensor, intrinsics: torch.Tensor,
                   cam2ego: torch.Tensor) -> torch.Tensor:
    """(u, v, d) -> ego-frame xyz. intrinsics [3, 3], cam2ego [4, 4] (or a
    leading view axis on both, the frustum broadcast over it)."""
    u, v, d = frustum_uvd.unbind(-1)
    lead = (slice(None),) * (intrinsics.dim() - 2)
    shape = intrinsics.shape[:-2] + (1,) * u.dim()

    def k(i, j):
        return intrinsics[lead + (i, j)].reshape(shape)
    x = (u - k(0, 2)) * d / k(0, 0)
    y = (v - k(1, 2)) * d / k(1, 1)
    return torch.stack(_affine((x, y, d.expand_as(x)), cam2ego), -1)


def project_points_to_depth(points: torch.Tensor, num_points,
                            intrinsics: torch.Tensor,
                            cam2lidar: torch.Tensor,
                            img_hw: Tuple[int, int]) -> torch.Tensor:
    """LiDAR points -> each camera's sparse depth image [V, 1, H, W]: a
    point's camera-frame depth in the pixel it lands on, the smallest where
    several land on one; 0 where none. Points past `num_points`, behind
    the camera (depth <= 1e-3) or outside the frame write nothing."""
    h, w = img_hw
    dev = points.device
    p = points[:, :3].float()
    valid = torch.arange(p.shape[0], device=dev) < torch.as_tensor(
        num_points, device=dev)
    eps = _f32(1e-3, dev)
    maps = []
    for vi in range(cam2lidar.shape[0]):
        rot, t = cam2lidar[vi, :3, :3], cam2lidar[vi, :3, 3]
        q = p - t                                       # R^T (p - t)
        cam = [q[:, 0] * rot[0, j] + q[:, 1] * rot[1, j] + q[:, 2] * rot[2, j]
               for j in range(3)]
        d = cam[2]
        dm = torch.maximum(d, eps)
        u = intrinsics[vi, 0, 0] * cam[0] / dm + intrinsics[vi, 0, 2]
        v = intrinsics[vi, 1, 1] * cam[1] / dm + intrinsics[vi, 1, 2]
        ui = torch.floor(u).to(torch.int32)
        vj = torch.floor(v).to(torch.int32)
        ok = (valid & (d > eps) & (ui >= 0) & (ui < w) & (vj >= 0)
              & (vj < h))
        lin = torch.where(ok, vj.long() * w + ui.long(), h * w)
        canvas = torch.full((h * w + 1,), torch.inf, dtype=torch.float32,
                            device=dev)
        canvas = canvas.scatter_reduce(0, lin, torch.where(ok, d, torch.inf),
                                       "amin")[:h * w]
        maps.append(torch.where(torch.isfinite(canvas), canvas,
                                0.0).view(h, w))
    return torch.stack(maps)[:, None]


class DepthLSSTransform(nn.Module):
    """Lift-splat of each camera's features onto the BEV canvas [C, H, W].
    The sparse LiDAR depth images run through a strided conv stack (a 1x1
    conv, then 5x5 convs of stride 4 and 2 down to `img_stride`, each
    LayerNorm + ReLU) and are concatenated before the image features, then
    mixed back to their width (`mix`): the form BEVFusion builds, whose
    JAX module makes these layers where it is given depth maps."""

    def __init__(self, cin: int, out_channels: int = 64,
                 depth_bins: Tuple[float, float, float] = (1.0, 45.0, 0.5),
                 img_stride: int = 8, bev_hw: Tuple[int, int] = (180, 180),
                 point_range: Tuple[float, ...] = (-54.0, -54.0, -5.0, 54.0,
                                                   54.0, 3.0), *, device):
        super().__init__()
        kw = dict(device=device)
        self.out_channels, self.img_stride = out_channels, img_stride
        self.depth_bins, self.bev_hw = depth_bins, tuple(bev_hw)
        self.point_range = tuple(point_range)
        self.dt0 = Conv2d(1, 8, 1, **kw)
        remaining, di, ch, dcin = img_stride, 1, 32, 8
        self.dt_strides = []
        while remaining > 1:
            s = min(4, remaining)
            setattr(self, f"dt{di}", Conv2d(dcin, ch, 5, s, padding=2, **kw))
            setattr(self, f"dtln{di}", FlaxLayerNorm(ch, 1, **kw))
            self.dt_strides.append(s)
            remaining //= s
            di, dcin, ch = di + 1, ch, min(ch * 2, 64)
        self.mix = Conv2d(dcin + cin, cin, 3, **kw)
        self.mixln = FlaxLayerNorm(cin, 1, **kw)
        d_num = len(self.depth_values())
        self.depth_head = Conv2d(cin, d_num, 1, **kw)
        self.context = Conv2d(cin, out_channels, 1, **kw)

    def depth_values(self, device=None) -> torch.Tensor:
        lo, hi, step = self.depth_bins
        return torch.from_numpy(np.arange(lo, hi, step,
                                          dtype=np.float32)).to(device)

    def dtransform(self, depth_maps: torch.Tensor) -> torch.Tensor:
        d = torch.relu(self.dt0(depth_maps))
        for di in range(1, len(self.dt_strides) + 1):
            d = torch.relu(getattr(self, f"dtln{di}")(
                getattr(self, f"dt{di}")(d)))
        return d

    def lift(self, img_feats: torch.Tensor,
             depth_maps: torch.Tensor) -> tuple:
        """-> (depth probabilities [V, D, Hf, Wf], context [V, C, Hf, Wf])."""
        x = torch.cat([self.dtransform(depth_maps), img_feats], 1)
        x = torch.relu(self.mixln(self.mix(x)))
        prob = torch.softmax(self.depth_head(x), 1)
        return prob, self.context(x)

    def bev_ids(self, hf: int, wf: int, intrinsics: torch.Tensor,
                cam2ego: torch.Tensor) -> tuple:
        """Every view's frustum points' BEV bins -> (ids [V·D·Hf·Wf],
        valid), views, then depths, rows and columns in order."""
        dev = intrinsics.device
        fr = frustum_grid(hf, wf, self.depth_values(dev), self.img_stride)
        ego = frustum_to_ego(fr, intrinsics.float(), cam2ego.float())
        h, w = self.bev_hw
        pr = self.point_range
        xi = torch.floor((ego[..., 0] - _f32(pr[0], dev))
                         / _f32((pr[3] - pr[0]) / w, dev)).to(torch.int32)
        yi = torch.floor((ego[..., 1] - _f32(pr[1], dev))
                         / _f32((pr[4] - pr[1]) / h, dev)).to(torch.int32)
        ok = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        return (yi * w + xi).reshape(-1), ok.reshape(-1)

    def splat(self, prob, context, intrinsics, cam2ego) -> torch.Tensor:
        """The outer product [V, D, Hf, Wf, C] summed into its BEV bins ->
        [C, H, W]."""
        hf, wf = prob.shape[2:]
        lifted = prob[..., None] * context.permute(0, 2, 3, 1)[:, None]
        ids, ok = self.bev_ids(hf, wf, intrinsics, cam2ego)
        h, w = self.bev_hw
        canvas = bev_pool(lifted.reshape(-1, self.out_channels), ids, ok,
                          h * w)
        return canvas.reshape(h, w, self.out_channels).permute(2, 0, 1)

    def forward(self, img_feats: torch.Tensor, intrinsics: torch.Tensor,
                cam2ego: torch.Tensor,
                depth_maps: torch.Tensor) -> torch.Tensor:
        """img_feats [V, Cf, Hf, Wf]; intrinsics [V, 3, 3]; cam2ego
        [V, 4, 4]; depth_maps [V, 1, Hf·stride, Wf·stride] -> BEV
        [out_channels, H, W]."""
        prob, context = self.lift(img_feats, depth_maps)
        return self.splat(prob, context, intrinsics, cam2ego)


class ConvFuser(nn.Module):
    """Camera BEV and LiDAR BEV concatenated (camera first), a 3x3 conv,
    LayerNorm, ReLU."""

    def __init__(self, cin: int, out_channels: int = 128, *, device):
        super().__init__()
        self.fuse = Conv2d(cin, out_channels, 3, device=device)
        self.ln = FlaxLayerNorm(out_channels, 1, device=device)

    def forward(self, cam_bev: torch.Tensor,
                lidar_bev: torch.Tensor) -> torch.Tensor:
        x = torch.cat([cam_bev, lidar_bev], 0)[None]
        return torch.relu(self.ln(self.fuse(x)))[0]
