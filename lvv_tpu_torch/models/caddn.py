"""CaDDN: the monocular detector through categorical depth distributions
(counterpart of lvv_tpu/models/caddn.py).

image -> `DepthFFN` (a strided conv pyramid to stride `img_downsample`:
depth-bin logits over D + 1 bins, the last "background", and features)
-> `frustum_features` (softmax over the bins, background dropped, times
the features: a [D, Hf, Wf, C] volume) -> every voxel centre of a
coarse-z lattice projected into the image and its LID depth bin,
`sample_frustum` trilinear there -> `conv2d_collapse` (z into channels)
-> a strided conv stem to the anchor stride -> `BaseBEVBackbone` ->
`AnchorHead`; `loss` is the anchor loss plus the depth cross-entropy
against LID-binned LiDAR depth (pixels without a return ignored).

The lattice is `jnp.linspace(lo, hi, n, endpoint=False)` plus half a
voxel, per axis, built once on the host (`linspace_f32`) and kept on the
detector's device beside the anchors, outside the state_dict. XLA
rewrites linspace's arithmetic and contracts it into FMAs in ways that
depend on the compile (JAX's eager and jit'd calls differ in 5 of 500
values at the KITTI preset's y axis), so the port computes the rewritten
form and holds the lattice within 1 ulp of JAX's. The projection is
elementwise fp32 in a fixed order, so the card samples at the CPU's
coordinates.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..config.schema import VoxelizeConfig, VoxelNeXtConfig
from .anchor_head import (AnchorHead, anchor_head_loss,
                          assign_anchor_targets, decode_anchor_preds)
from .pointpillars import BaseBEVBackbone, Conv2d, DenseDetector, FlaxLayerNorm
from .second import default_anchor_table
from .voxelnext import Detections


def _f32(v, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=device)


def bin_depths(depth: torch.Tensor, mode: str = "LID",
               depth_min: float = 2.0, depth_max: float = 46.8,
               num_bins: int = 80, clamp: bool = True) -> torch.Tensor:
    """Depth -> bin index, int32. LID: linearly increasing bins; UD:
    uniform. Depths outside the bins (and non-finite ones) map to
    `num_bins`, the background bin, with `clamp`; else to 0."""
    dev = depth.device
    dmin = _f32(depth_min, dev)
    if mode == "UD":
        idx_f = (depth - dmin) / _f32((depth_max - depth_min) / num_bins,
                                      dev)
    else:
        bin_size = 2 * (depth_max - depth_min) / (num_bins * (1 + num_bins))
        arg = 1 + 8 * (depth - dmin) / _f32(bin_size, dev)
        idx_f = torch.where(arg >= 0, -0.5 + 0.5 * torch.sqrt(
            arg.clamp_min(0.0)), -1.0)
    idx_f = torch.floor(idx_f)
    bad = ((idx_f < 0) | (idx_f >= num_bins) | ~torch.isfinite(idx_f)
           | ~torch.isfinite(depth))
    return torch.where(bad, num_bins if clamp else 0, idx_f).to(torch.int32)


def bin_centers(mode: str = "LID", depth_min: float = 2.0,
                depth_max: float = 46.8, num_bins: int = 80) -> np.ndarray:
    """Continuous depth of each bin's centre."""
    i = np.arange(num_bins, dtype=np.float32) + 0.5
    if mode == "UD":
        return depth_min + (depth_max - depth_min) / num_bins * i
    bin_size = 2 * (depth_max - depth_min) / (num_bins * (1 + num_bins))
    return depth_min + bin_size / 2 * i * (i + 1)


def linspace_f32(start: float, stop: float, num: int) -> np.ndarray:
    """jnp.linspace(start, stop, num, endpoint=False) as XLA compiles it on
    the CPU: start·(1 - i·r) + i·(stop·r), r = 1 / num rounded to float32
    (the division by a constant turned into a product with its reciprocal,
    stop's product reassociated), 1 - i·r and the final sum each rounded
    once (contracted into FMAs); every other step float32."""
    f, d = np.float32, np.float64
    i = np.arange(num, dtype=f)
    r = f(1) / f(num)
    head = f(start) * (d(1) - d(i) * d(r)).astype(f)
    return (d(head) + d(i) * d(f(f(stop) * r))).astype(f)


class DepthFFN(nn.Module):
    """[3, H, W] -> (depth logits [D + 1, Hf, Wf], features [C, Hf, Wf]) at
    stride `downsample`: 3x3 stride-2 convs (32 channels, doubling to at
    most 128), a 3x3 trunk of 128, each LayerNorm + ReLU, then 1x1 depth
    and feature heads."""

    def __init__(self, num_bins: int = 80, channels: int = 64,
                 downsample: int = 4, *, device):
        super().__init__()
        kw = dict(device=device)
        cin, ch, s, i = 3, 32, 1, 0
        while s < downsample:
            setattr(self, f"conv{i}", Conv2d(cin, ch, 3, 2, **kw))
            setattr(self, f"ln{i}", FlaxLayerNorm(ch, 1, **kw))
            cin, s, ch, i = ch, s * 2, min(ch * 2, 128), i + 1
        self.n = i
        self.trunk = Conv2d(cin, 128, 3, **kw)
        self.lnt = FlaxLayerNorm(128, 1, **kw)
        self.depth = Conv2d(128, num_bins + 1, 1, **kw)
        self.feat = Conv2d(128, channels, 1, **kw)

    def forward(self, img_chw: torch.Tensor) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
        x = img_chw[None]
        for i in range(self.n):
            x = torch.relu(getattr(self, f"ln{i}")(
                getattr(self, f"conv{i}")(x)))
        x = torch.relu(self.lnt(self.trunk(x)))
        return self.depth(x)[0], self.feat(x)[0]


def frustum_features(depth_logits: torch.Tensor,
                     feats: torch.Tensor) -> torch.Tensor:
    """[D + 1, Hf, Wf] logits and [C, Hf, Wf] features -> the [D, Hf, Wf, C]
    volume (softmax over the bins, the background bin dropped, times the
    features)."""
    prob = torch.softmax(depth_logits.float(), 0)[:-1]
    return prob[..., None] * feats.permute(1, 2, 0)[None]


def sample_frustum(volume: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                   dbin: torch.Tensor) -> torch.Tensor:
    """Trilinear samples of [D, Hf, Wf, C] at fractional (dbin, v, u) ->
    [N, C]; corners outside the volume add zero."""
    d_n, h_n, w_n, c = volume.shape
    flat = volume.reshape(-1, c)

    def corner(di, vi, ui, wgt):
        ok = ((di >= 0) & (di < d_n) & (vi >= 0) & (vi < h_n) & (ui >= 0)
              & (ui < w_n))
        idx = ((di.clamp(0, d_n - 1).long() * h_n
                + vi.clamp(0, h_n - 1).long()) * w_n
               + ui.clamp(0, w_n - 1).long())
        return torch.where(ok[:, None], flat[idx], 0.0) * wgt[:, None]

    d0 = torch.floor(dbin).to(torch.int32)
    v0 = torch.floor(v).to(torch.int32)
    u0 = torch.floor(u).to(torch.int32)
    fd, fv, fu = dbin - d0, v - v0, u - u0
    out = 0.0
    for dd in (0, 1):
        for dv in (0, 1):
            for du in (0, 1):
                w = ((1 - dd - fd).abs() * (1 - dv - fv).abs()
                     * (1 - du - fu).abs())
                out = out + corner(d0 + dd, v0 + dv, u0 + du, w)
    return out


def conv2d_collapse(vox: torch.Tensor) -> torch.Tensor:
    """[C, Z, Y, X] -> [C·Z, Y, X] (z folded into the channels)."""
    c, z, y, x = vox.shape
    return vox.reshape(c * z, y, x)


class CaDDNDetector(DenseDetector):
    """image [3, H, W], intrinsics [3, 3], lidar2cam [4, 4] -> {"preds",
    "anchors", "anchor_cls", "bev_dense", "depth_logits"}; `detect` adds
    the anchor decode with NMS; `stages()` lists the forward's steps for
    chip_smoke's split, each (name, fn(state)) on a dict that starts with
    the inputs."""

    camera_input = True           # views in; no train step (registry)

    def __init__(self, det_cfg: VoxelNeXtConfig, vox_cfg: VoxelizeConfig, *,
                 device=None, seed: int = 0, num_depth_bins: int = 40,
                 depth_min: float = 2.0, depth_max: float = 46.8,
                 cam_channels: int = 32, z_bins: int = 4,
                 img_downsample: int = 4):
        super().__init__(det_cfg, vox_cfg, device)
        kw = dict(device=self._device)
        self.num_depth_bins, self.depth_min = num_depth_bins, depth_min
        self.depth_max, self.cam_channels = depth_max, cam_channels
        self.z_bins, self.img_downsample = z_bins, img_downsample
        self.ffn = DepthFFN(num_depth_bins, cam_channels, img_downsample,
                            **kw)
        cin, s, i = cam_channels * z_bins, 1, 0
        while s < det_cfg.spatial_stride:
            setattr(self, f"stem{i}", Conv2d(cin, 64, 3, 2, **kw))
            setattr(self, f"stem_ln{i}", FlaxLayerNorm(64, 1, **kw))
            cin, s, i = 64, s * 2, i + 1
        self.n_stem = i
        self.backbone2d = BaseBEVBackbone(
            cin, layer_channels=(64, 128), layer_strides=(1, 2),
            upsample_channels=(64, 64), **kw)
        anchors, acls, n_sizes = default_anchor_table(det_cfg, vox_cfg)
        self.head = AnchorHead(self.backbone2d.out_channels,
                               det_cfg.num_classes, n_sizes * 2, **kw)
        # constants, not state, as SECOND's anchors
        self.anchors = torch.from_numpy(anchors)
        self.anchor_cls = torch.from_numpy(acls)
        self.lattice = torch.from_numpy(self.lattice_np())
        if self._device.type != "meta":
            self.anchors = self.anchors.to(self._device)
            self.anchor_cls = self.anchor_cls.to(self._device)
            self.lattice = self.lattice.to(self._device)
        self._finish(seed)

    def lattice_np(self) -> np.ndarray:
        """The voxel centres [Z, Y, X, 3] (x, y, z), float32 as the JAX
        package makes them."""
        grid = self.voxel_grid()
        pr, (nx, ny, _) = self.vox_cfg.point_range, grid.grid_size
        f = np.float32
        xs = linspace_f32(pr[0], pr[3], nx) + f(grid.voxel_size[0] / 2)
        ys = linspace_f32(pr[1], pr[4], ny) + f(grid.voxel_size[1] / 2)
        zs = linspace_f32(pr[2], pr[5], self.z_bins) + f(
            (pr[5] - pr[2]) / self.z_bins / 2)
        zz, yy, xx = np.meshgrid(zs, ys, xs, indexing="ij")
        return np.stack([xx, yy, zz], -1)

    def sample_coords(self, intrinsics: torch.Tensor,
                      lidar2cam: torch.Tensor) -> tuple:
        """Each lattice point's (u, v) on the feature map and its
        fractional LID bin (-10 behind the camera) -> three [N]."""
        dev = intrinsics.device
        p = self.lattice.reshape(-1, 3).to(dev)
        m = lidar2cam
        cam = [p[:, 0] * m[j, 0] + p[:, 1] * m[j, 1] + p[:, 2] * m[j, 2]
               + m[j, 3] for j in range(3)]
        depth = cam[2]
        eps = _f32(1e-3, dev)
        dm = torch.maximum(depth, eps)
        ds = _f32(self.img_downsample, dev)
        u = (intrinsics[0, 0] * cam[0] / dm + intrinsics[0, 2]) / ds - 0.5
        v = (intrinsics[1, 1] * cam[1] / dm + intrinsics[1, 2]) / ds - 0.5
        bin_size = 2 * (self.depth_max - self.depth_min) / (
            self.num_depth_bins * (1 + self.num_depth_bins))
        dbin = -0.5 + 0.5 * torch.sqrt(
            1 + 8 * (depth - _f32(self.depth_min, dev)).clamp_min(0.0)
            / _f32(bin_size, dev))
        return u, v, torch.where(depth > eps, dbin, -10.0)

    def stages(self, trace: Optional[List] = None):
        nx, ny, _ = self.voxel_grid().grid_size

        def ffn(s):
            s["depth_logits"], s["feats"] = self.ffn(s["image"])

        def frustum(s):
            s["volume"] = frustum_features(s["depth_logits"], s["feats"])

        def sample(s):
            u, v, dbin = self.sample_coords(s["intrinsics"], s["lidar2cam"])
            vox = sample_frustum(s["volume"], u, v, dbin).reshape(
                self.z_bins, ny, nx, self.cam_channels).permute(3, 0, 1, 2)
            s["bev"] = conv2d_collapse(vox)

        def trunk2d(s):
            x = s["bev"][None]
            for i in range(self.n_stem):
                x = torch.relu(getattr(self, f"stem_ln{i}")(
                    getattr(self, f"stem{i}")(x)))
            s["bev_dense"] = self.backbone2d(x[0])

        def head(s):
            s["preds"] = self.head(s["bev_dense"])
        return (("ffn", ffn), ("frustum", frustum), ("sample", sample),
                ("trunk2d", trunk2d), ("head", head))

    def inputs(self, image, intrinsics, lidar2cam) -> Dict:
        dev = self.device
        return {"image": image.to(dev, torch.float32),
                "intrinsics": intrinsics.to(dev, torch.float32),
                "lidar2cam": lidar2cam.to(dev, torch.float32)}

    def outputs(self, state: Dict) -> Dict:
        dev = state["bev_dense"].device
        return {"preds": state["preds"], "anchors": self.anchors.to(dev),
                "anchor_cls": self.anchor_cls.to(dev),
                "bev_dense": state["bev_dense"],
                "depth_logits": state["depth_logits"]}

    def forward(self, image, intrinsics, lidar2cam,
                trace: Optional[List] = None) -> Dict:
        s = self.inputs(image, intrinsics, lidar2cam)
        for _, fn in self.stages(trace):
            fn(s)
        return self.outputs(s)

    @torch.no_grad()
    def detect(self, image, intrinsics, lidar2cam) -> Detections:
        training = self.training
        self.eval()
        try:
            out = self(image, intrinsics, lidar2cam)
        finally:
            self.train(training)
        return self.decode(out)

    def decode(self, out) -> Detections:
        return decode_anchor_preds(out["preds"], out["anchors"],
                                   out["anchor_cls"], self.det_cfg)

    def loss(self, out, gt_boxes, gt_labels, gt_mask,
             lidar_depth_map: Optional[torch.Tensor] = None):
        """The anchor loss, plus (given a LiDAR depth map [Hf, Wf], 0 where
        no return) the cross-entropy of the depth logits against its LID
        bins over the pixels with a return -> (total, terms)."""
        targets = assign_anchor_targets(out["anchors"], out["anchor_cls"],
                                        gt_boxes.float(), gt_labels, gt_mask)
        total, stats = anchor_head_loss(out["preds"], targets,
                                        self.det_cfg.num_classes)
        if lidar_depth_map is not None:
            tgt = bin_depths(lidar_depth_map, depth_min=self.depth_min,
                             depth_max=self.depth_max,
                             num_bins=self.num_depth_bins)
            logp = torch.log_softmax(
                out["depth_logits"].permute(1, 2, 0).float(), -1)
            has = lidar_depth_map > 0
            ce = -torch.gather(logp, -1, tgt.long()[..., None])[..., 0]
            depth_loss = (ce * has).sum() / has.sum().clamp_min(1)
            total = total + depth_loss
            stats = {**stats, "depth_loss": depth_loss}
        return total, stats
