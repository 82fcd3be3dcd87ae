"""PointPillars and the dense BEV core of the detector zoo (counterpart of
lvv_tpu/models/pointpillars.py).

- `PillarVFE`: each pillar's points decorated with their offsets from the
  pillar's mean and centre ([x, y, z, i, xc, yc, zc, xp, yp]), Dense +
  LayerNorm + ReLU, max-pooled over the pillar's points.
- `pillar_scatter`: the pillars' features onto the dense [C, H, W] canvas.
- `BaseBEVBackbone`: the dense multi-scale trunk (strided 3x3 convs, each
  level upsampled back by a transposed conv and concatenated), which
  CenterPoint, SECOND, TransFusion and PillarNet share;
  `BaseBEVResBackbone`, its residual form (`ResBlock2D`s), DSVT's 2D
  trunk; `BaseBEVBackboneV1`, the two-level neck JAX's tests pin.
- `DenseCenterHead` and `decode_dense`: the dense centre head and its top-K
  decode with class-agnostic rotated NMS.
- `PointPillarsDetector`: points -> pillars -> canvas -> trunk -> head.

The JAX package writes these in flax, whose layers differ from PyTorch's
defaults in three ways; each has one helper here:
- `same_conv`: flax's padding "SAME" pads a strided conv by (0, 1) on an
  even side (total (out - 1)·s + k - n, the smaller half first), not (1, 1);
- `ConvTranspose2d`: flax's nn.ConvTranspose does not flip its kernel
  (transpose_kernel=False), so the port stores the kernel flipped, in
  PyTorch's [in, out, kh, kw] (`ConvTranspose2d.from_jax_leaf`, which the
  converter calls), for F.conv_transpose2d;
- `flax_layer_norm`: nn.LayerNorm takes eps 1e-6 and the one-pass variance
  E[x²] - E[x]², clamped at 0 (use_fast_variance), not the port's
  `layers.LayerNorm`.

The maps are [C, H, W] (the JAX package's layout at its module
boundaries) and run as [1, C, H, W] through PyTorch's fp32 convolutions
(cuDNN on the card; TF32 off, as the caller sets it): the JAX package
leaves them to XLA and no Pallas kernel reaches them. Parameters are fp32,
named as in the JAX tree (`convert.from_jax_detector_params`), drawn as
flax draws them (lecun normal kernels, zero biases, the heatmap bias
-4.6). A detector is built on `device` (the card unless told otherwise)
in eval mode; `forward` builds an autograd graph unless the caller turns
it off, and `detect` runs without one.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config.schema import VoxelizeConfig, VoxelNeXtConfig
from ..ops.boxes import limit_period
from ..ops.nms import nms, top_k
from ..ops.voxelize import VoxelGrid, Voxels, voxelize
from .layers import PARAM_FP32, init_parameters, new_param, resolve_device
from .voxelnext import Detections

FLAX_LN_EPS = 1e-6
HM_BIAS = -4.6              # the heatmap / class logits' initial bias


def flax_layer_norm(x: torch.Tensor, scale: torch.Tensor,
                    bias: torch.Tensor, dim: int = -1,
                    eps: float = FLAX_LN_EPS) -> torch.Tensor:
    """flax nn.LayerNorm over axis `dim`: mean and E[x²] in one pass, var =
    max(E[x²] - E[x]², 0), y = (x - mean)·(rsqrt(var + eps)·scale) +
    bias."""
    mean = x.mean(dim, keepdim=True)
    var = ((x * x).mean(dim, keepdim=True) - mean * mean).clamp_min(0.0)
    shape = [1] * x.dim()
    shape[dim] = -1
    return ((x - mean) * (torch.rsqrt(var + eps) * scale.view(shape))
            + bias.view(shape))


def same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """flax / XLA "SAME" padding of one side: out = ceil(n / s), total
    max((out - 1)·s + k - n, 0), the smaller half before."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def same_conv(x: torch.Tensor, kernel: torch.Tensor, bias, stride: int = 1
              ) -> torch.Tensor:
    """x [N, C, H, W], kernel [O, C, k, k]: flax's nn.Conv with padding
    "SAME" at `stride`."""
    k = kernel.shape[-1]
    ph = same_pads(x.shape[2], k, stride)
    pw = same_pads(x.shape[3], k, stride)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return F.conv2d(x, kernel, bias, stride, (ph[0], pw[0]))
    return F.conv2d(F.pad(x, (*pw, *ph)), kernel, bias, stride)


class FlaxLayerNorm(nn.Module):
    """flax nn.LayerNorm's parameters ("scale", "bias") over the channels
    of `dim`."""

    def __init__(self, ch: int, dim: int = -1, *, device):
        super().__init__()
        kw = dict(dtype=PARAM_FP32, device=device)
        self.dim = dim
        self.scale = new_param((ch,), "ones", **kw)
        self.bias = new_param((ch,), "zeros", **kw)

    def forward(self, x):
        return flax_layer_norm(x, self.scale, self.bias, self.dim)


class Conv2d(nn.Module):
    """flax nn.Conv with padding "SAME", or `padding` p on every side (its
    ((p, p), (p, p))): kernel [O, C, k, k] (the HWIO leaf transposed by
    the converter), bias [O]."""

    def __init__(self, cin: int, cout: int, k: int = 3, stride: int = 1,
                 bias: bool = True, bias_init=0.0,
                 padding: Optional[int] = None, *, device):
        super().__init__()
        kw = dict(dtype=PARAM_FP32, device=device)
        self.stride, self.padding = stride, padding
        self.kernel = new_param((cout, cin, k, k), ("lecun", cin * k * k),
                                **kw)
        self.bias = (new_param((cout,), ("constant", bias_init) if bias_init
                               else "zeros", **kw) if bias else None)

    def forward(self, x):
        if self.padding is not None:
            return F.conv2d(x, self.kernel, self.bias, self.stride,
                            self.padding)
        return same_conv(x, self.kernel, self.bias, self.stride)


class ConvTranspose2d(nn.Module):
    """flax nn.ConvTranspose with kernel = strides = `stride` (each input
    cell to a stride x stride block): kernel [in, out, k, k], flipped
    (`from_jax_leaf`), bias [out]."""

    def __init__(self, cin: int, cout: int, stride: int, bias: bool = True,
                 *, device):
        super().__init__()
        kw = dict(dtype=PARAM_FP32, device=device)
        self.stride = stride
        self.kernel = new_param((cin, cout, stride, stride),
                                ("lecun", cin * stride * stride), **kw)
        self.bias = new_param((cout,), "zeros", **kw) if bias else None

    @staticmethod
    def from_jax_leaf(name: str, arr: np.ndarray) -> np.ndarray:
        """flax's (kh, kw, in, out) kernel -> [in, out, kh, kw], spatially
        flipped: flax applies it unflipped, PyTorch's transposed conv
        flipped."""
        if name == "kernel":
            return arr.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
        return arr

    def forward(self, x):
        return F.conv_transpose2d(x, self.kernel, self.bias, self.stride)


class Dense(nn.Module):
    """flax nn.Dense: y = x @ kernel + bias, kernel [in, out]."""

    def __init__(self, cin: int, cout: int, bias_init=0.0, *, device):
        super().__init__()
        kw = dict(dtype=PARAM_FP32, device=device)
        self.kernel = new_param((cin, cout), ("lecun", cin), **kw)
        self.bias = new_param((cout,), ("constant", bias_init) if bias_init
                              else "zeros", **kw)

    def forward(self, x):
        return x @ self.kernel + self.bias


class PillarVFE(nn.Module):
    """Pillar feature encoder: decorated points -> Dense + LayerNorm +
    ReLU -> max over each pillar's points."""

    def __init__(self, cin: int = 4, out_ch: int = 64, *, device):
        super().__init__()
        self.fc = Dense(cin + 5, out_ch, device=device)
        self.ln = FlaxLayerNorm(out_ch, device=device)

    def forward(self, vox: Voxels, grid: VoxelGrid) -> torch.Tensor:
        feats = vox.features                          # [P, N, F]
        p, n, _ = feats.shape
        mask = (torch.arange(n, device=feats.device)[None, :]
                < vox.num_points[:, None])[..., None]
        counts = vox.num_points.clamp_min(1)[:, None, None].to(feats.dtype)
        mean_xyz = (feats[..., :3] * mask).sum(1, keepdim=True) / counts
        cluster = feats[..., :3] - mean_xyz
        vx, vy = grid.voxel_size[0], grid.voxel_size[1]
        x0, y0 = grid.point_range[0], grid.point_range[1]
        cx = (vox.coords[:, 2:3].float() + 0.5) * vx + x0
        cy = (vox.coords[:, 1:2].float() + 0.5) * vy + y0
        center = torch.stack([feats[..., 0] - cx, feats[..., 1] - cy], -1)
        dec = torch.cat([feats, cluster, center], -1)          # [P, N, 9]
        dec = torch.where(mask, dec, 0.0)
        h = torch.relu(self.ln(self.fc(dec)))
        h = torch.where(mask, h, -1e9)
        pooled = h.amax(1)                                     # [P, C]
        return torch.where(vox.num_points[:, None] > 0, pooled, 0.0)


def pillar_scatter(pillar_feats: torch.Tensor, coords: torch.Tensor,
                   grid_hw: Tuple[int, int]) -> torch.Tensor:
    """[P, C] + (z, y, x) coords -> the dense [C, H, W] canvas (an add at
    each valid pillar's cell; invalid ones to a spare row)."""
    h, w = grid_hw
    c = pillar_feats.shape[1]
    valid = (coords >= 0).all(1)
    lin = torch.where(valid, coords[:, 1].long() * w + coords[:, 2].long(),
                      h * w)
    canvas = pillar_feats.new_zeros((h * w + 1, c))
    canvas = canvas.index_add(0, lin, torch.where(valid[:, None],
                                                  pillar_feats, 0.0))
    return canvas[:-1].reshape(h, w, c).permute(2, 0, 1)


class BaseBEVBackbone(nn.Module):
    """Dense multi-scale trunk: per level a strided 3x3 conv and a 3x3
    conv (each LayerNorm + ReLU), upsampled back by the level's total
    stride with a transposed conv (LayerNorm + ReLU), cropped to the first
    level's size (odd grids round up through the strided convs) and
    concatenated."""

    def __init__(self, cin: int, layer_channels: Sequence[int] = (64, 128,
                                                                   256),
                 layer_strides: Sequence[int] = (2, 2, 2),
                 upsample_channels: Sequence[int] = (128, 128, 128), *,
                 device):
        super().__init__()
        kw = dict(device=device)
        self.strides = tuple(layer_strides)
        total = 1
        for i, (ch, st) in enumerate(zip(layer_channels, layer_strides)):
            total *= st
            setattr(self, f"down{i}", Conv2d(cin, ch, 3, st, **kw))
            setattr(self, f"ln{i}", FlaxLayerNorm(ch, 1, **kw))
            setattr(self, f"conv{i}", Conv2d(ch, ch, 3, **kw))
            setattr(self, f"ln{i}b", FlaxLayerNorm(ch, 1, **kw))
            setattr(self, f"up{i}", ConvTranspose2d(
                ch, upsample_channels[i], total, **kw))
            setattr(self, f"uln{i}", FlaxLayerNorm(upsample_channels[i], 1,
                                                   **kw))
            cin = ch
        self.out_channels = sum(upsample_channels)

    def forward(self, x_chw: torch.Tensor) -> torch.Tensor:
        x = x_chw[None]
        ups = []
        for i in range(len(self.strides)):
            x = torch.relu(getattr(self, f"ln{i}")(
                getattr(self, f"down{i}")(x)))
            x = torch.relu(getattr(self, f"ln{i}b")(
                getattr(self, f"conv{i}")(x)))
            up = torch.relu(getattr(self, f"uln{i}")(
                getattr(self, f"up{i}")(x)))
            if ups:
                up = up[:, :, :ups[0].shape[2], :ups[0].shape[3]]
            ups.append(up)
        return torch.cat(ups, 1)[0]                  # [C, H, W]


class ResBlock2D(nn.Module):
    """JAX's `_ResBlock2D` (BasicBlock): two 3x3 convs without bias, each
    LayerNorm'd (ReLU after the first), plus the identity, projected by a
    1x1 conv and LayerNorm where the block strides or changes width; ReLU
    of the sum. On [1, C, H, W]."""

    def __init__(self, cin: int, ch: int, stride: int = 1, *, device):
        super().__init__()
        kw = dict(bias=False, device=device)
        self.conv1 = Conv2d(cin, ch, 3, stride, **kw)
        self.n1 = FlaxLayerNorm(ch, 1, device=device)
        self.conv2 = Conv2d(ch, ch, 3, **kw)
        self.n2 = FlaxLayerNorm(ch, 1, device=device)
        if stride != 1 or cin != ch:
            self.down = Conv2d(cin, ch, 1, stride, **kw)
            self.dn = FlaxLayerNorm(ch, 1, device=device)

    def forward(self, x):
        y = torch.relu(self.n1(self.conv1(x)))
        y = self.n2(self.conv2(y))
        idn = self.dn(self.down(x)) if hasattr(self, "down") else x
        return torch.relu(y + idn)


class BaseBEVResBackbone(nn.Module):
    """Residual multi-scale trunk (DSVT's 2D trunk): per level a strided
    ResBlock2D and `layer_nums[i]` unit-stride ones, upsampled back by the
    level's total stride (a transposed conv without bias, LayerNorm +
    ReLU), cropped to the first level's size and concatenated."""

    def __init__(self, cin: int, layer_channels: Sequence[int] = (64, 128,
                                                                   256),
                 layer_strides: Sequence[int] = (2, 2, 2),
                 layer_nums: Sequence[int] = (1, 1, 1),
                 upsample_channels: Sequence[int] = (128, 128, 128), *,
                 device):
        super().__init__()
        kw = dict(device=device)
        self.layer_nums = tuple(layer_nums)
        total = 1
        for i, (ch, st, n) in enumerate(zip(layer_channels, layer_strides,
                                            layer_nums)):
            total *= st
            setattr(self, f"res{i}_0", ResBlock2D(cin, ch, st, **kw))
            for k in range(n):
                setattr(self, f"res{i}_{k + 1}", ResBlock2D(ch, ch, **kw))
            setattr(self, f"up{i}", ConvTranspose2d(
                ch, upsample_channels[i], total, bias=False, **kw))
            setattr(self, f"uln{i}", FlaxLayerNorm(upsample_channels[i], 1,
                                                   **kw))
            cin = ch
        self.out_channels = sum(upsample_channels)

    def forward(self, x_chw: torch.Tensor) -> torch.Tensor:
        x = x_chw[None]
        ups = []
        for i, n in enumerate(self.layer_nums):
            for k in range(n + 1):
                x = getattr(self, f"res{i}_{k}")(x)
            up = torch.relu(getattr(self, f"uln{i}")(
                getattr(self, f"up{i}")(x)))
            if ups:
                up = up[:, :, :ups[0].shape[2], :ups[0].shape[3]]
            ups.append(up)
        return torch.cat(ups, 1)[0]                  # [C, H, W]


class BaseBEVBackboneV1(nn.Module):
    """Two-level neck over a sparse trunk's x_conv4 / x_conv5 dense maps:
    x_conv4 upsampled by `upsample_strides[0]` (a transposed conv,
    LayerNorm + ReLU), x_conv5 through `layer_nums[1] + 1` 3x3 convs of
    `num_filters[1]` (each LayerNorm + ReLU) and upsampled by
    `upsample_strides[1]`, cropped to the first's size, concatenated and
    refined by `layer_nums[0] + 1` 3x3 convs at the concatenation's width
    (JAX's `num_filters[0]` is not read)."""

    def __init__(self, cin4: int, cin5: int,
                 num_filters: Tuple[int, int] = (128, 256),
                 layer_nums: Tuple[int, int] = (5, 5),
                 upsample_channels: Tuple[int, int] = (256, 256),
                 upsample_strides: Tuple[int, int] = (1, 2), *, device):
        super().__init__()
        kw = dict(device=device)
        self.layer_nums = tuple(layer_nums)
        s0, s1 = upsample_strides
        self.de0 = ConvTranspose2d(cin4, upsample_channels[0], s0,
                                   bias=False, **kw)
        self.de0_ln = FlaxLayerNorm(upsample_channels[0], 1, **kw)
        self._make_stack("b1", cin5, num_filters[1], layer_nums[1], kw)
        self.de1 = ConvTranspose2d(num_filters[1], upsample_channels[1], s1,
                                   bias=False, **kw)
        self.de1_ln = FlaxLayerNorm(upsample_channels[1], 1, **kw)
        width = sum(upsample_channels)
        self._make_stack("b0", width, width, layer_nums[0], kw)
        self.out_channels = width

    def _make_stack(self, tag: str, cin: int, ch: int, n: int, kw) -> None:
        for k in range(n + 1):
            setattr(self, f"{tag}_conv{k}", Conv2d(cin, ch, 3, bias=False,
                                                   **kw))
            setattr(self, f"{tag}_ln{k}", FlaxLayerNorm(ch, 1, **kw))
            cin = ch

    def _stack(self, x, tag: str, n: int):
        for k in range(n + 1):
            x = torch.relu(getattr(self, f"{tag}_ln{k}")(
                getattr(self, f"{tag}_conv{k}")(x)))
        return x

    def forward(self, x_conv4_chw: torch.Tensor,
                x_conv5_chw: torch.Tensor) -> torch.Tensor:
        up0 = torch.relu(self.de0_ln(self.de0(x_conv4_chw[None])))
        x5 = self._stack(x_conv5_chw[None], "b1", self.layer_nums[1])
        up1 = torch.relu(self.de1_ln(self.de1(x5)))
        up1 = up1[:, :, :up0.shape[2], :up0.shape[3]]
        x = self._stack(torch.cat([up0, up1], 1), "b0", self.layer_nums[0])
        return x[0]


BRANCHES = (("center", 2), ("center_z", 1), ("dim", 3), ("rot", 2))


class DenseCenterHead(nn.Module):
    """Shared 3x3 conv (LayerNorm + ReLU), then a 3x3 conv per branch: hm
    (num_classes), center, center_z, dim, rot -> {name: [ch, H, W]}."""

    def __init__(self, cin: int, num_classes: int, shared_ch: int = 64, *,
                 device):
        super().__init__()
        self.shared = Conv2d(cin, shared_ch, device=device)
        self.shared_ln = FlaxLayerNorm(shared_ch, 1, device=device)
        self.hm = Conv2d(shared_ch, num_classes, bias_init=HM_BIAS,
                         device=device)
        for name, ch in BRANCHES:
            setattr(self, name, Conv2d(shared_ch, ch, device=device))

    def forward(self, bev_chw: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = torch.relu(self.shared_ln(self.shared(bev_chw[None])))
        out = {"hm": self.hm(x)[0]}
        for name, _ in BRANCHES:
            out[name] = getattr(self, name)(x)[0]
        return out


def decode_dense(preds: Dict[str, torch.Tensor], det_cfg: VoxelNeXtConfig,
                 vox_cfg: VoxelizeConfig, stride: int) -> Detections:
    """Top `nms_pre_max` (class, cell) scores of the dense heatmap (ties to
    the lower index, as jax.lax.top_k), their boxes, then class-agnostic
    rotated NMS; fixed shapes."""
    hm = torch.sigmoid(preds["hm"].float())          # [C, H, W]
    c, h, w = hm.shape
    flat = hm.reshape(-1)
    k = min(det_cfg.nms_pre_max, flat.shape[0])
    scores, idx = top_k(flat, k)
    label = (idx // (h * w)).to(torch.int32)
    yx = idx % (h * w)
    ys = (yx // w).float()
    xs = (yx % w).float()

    def g(name):
        m = preds[name]
        return m.reshape(m.shape[0], -1)[:, yx].t().float()
    center, center_z = g("center"), g("center_z")
    dim = torch.exp(g("dim").clamp(-5, 5))
    rot = g("rot")
    vx, vy = vox_cfg.voxel_size[0], vox_cfg.voxel_size[1]
    x0, y0 = vox_cfg.point_range[0], vox_cfg.point_range[1]
    x = (xs + center[:, 0]) * stride * vx + x0
    y = (ys + center[:, 1]) * stride * vy + y0
    heading = limit_period(torch.atan2(rot[:, 0], rot[:, 1]), 0.5,
                           2 * math.pi)
    zeros = torch.zeros_like(x)
    boxes = torch.stack([x, y, center_z[:, 0], dim[:, 0], dim[:, 1],
                         dim[:, 2], heading, zeros, zeros], 1)
    keep, count, kscores = nms(boxes, scores,
                               iou_thresh=det_cfg.nms_iou_thresh, pre_max=k,
                               post_max=det_cfg.nms_post_max,
                               valid=scores > det_cfg.score_thresh)
    kept = keep >= 0
    safe = keep.clamp_min(0).long()
    return Detections(boxes=boxes[safe],
                      scores=torch.where(kept, kscores, 0.0),
                      labels=torch.where(kept, label[safe], -1),
                      count=count)


class DenseDetector(nn.Module):
    """What the dense-BEV families share: configs, device, seeded weights
    (`_finish`, after the subclass made its modules), eval mode,
    `voxel_grid`, and `detect` (the eval forward without a graph, then the
    family's decode). A subclass defines `stages(trace)`, the forward's
    steps in order as (name, fn): "voxelize" (points, num_points) ->
    voxels, "trunk3d" (the sparse trunk and its height compression, or the
    pillars' encoder and scatter) -> the dense map, "trunk2d" -> the BEV,
    "head" -> the output dict (chip_smoke times each), and `decode(out)`."""

    def __init__(self, det_cfg: VoxelNeXtConfig, vox_cfg: VoxelizeConfig,
                 device):
        super().__init__()
        self.det_cfg, self.vox_cfg = det_cfg, vox_cfg
        self._device = resolve_device(device)

    def _finish(self, seed: int) -> None:
        if self._device.type != "meta":
            init_parameters(self, seed)
        self.requires_grad_(True)     # every parameter trains, as in JAX
        self.eval()

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def voxel_grid(self) -> VoxelGrid:
        return VoxelGrid.create(self.vox_cfg.point_range,
                                self.vox_cfg.voxel_size)

    def forward(self, points: torch.Tensor, num_points,
                return_dense_bev: bool = True,
                trace: Optional[List] = None) -> Dict:
        """-> {"bev_dense" [C, H, W], "preds", ...}. The dense BEV is the
        trunk's output and is always returned (`return_dense_bev` is taken
        for the train step's common call); `trace`, where the family has a
        sparse trunk, receives its stages as (name, SparseTensor)."""
        (_, first), *rest = self.stages(trace)
        x = first(points.to(self.device, torch.float32), num_points)
        for _, fn in rest:
            x = fn(x)
        return x

    @torch.no_grad()
    def detect(self, points: torch.Tensor, num_points) -> Detections:
        """The eval form's detections, whatever mode the module is in; the
        mode is left as it was."""
        training = self.training
        self.eval()
        try:
            out = self(points, num_points)
        finally:
            self.train(training)
        return self.decode(out)


class PointPillarsDetector(DenseDetector):
    """points -> pillars (a single z bin over the whole height) -> PillarVFE
    -> canvas -> BaseBEVBackbone -> DenseCenterHead; the trunk's transposed
    convs bring every level back to the pillar grid, so the decode's stride
    is 1."""

    def __init__(self, det_cfg: VoxelNeXtConfig, vox_cfg: VoxelizeConfig, *,
                 device=None, seed: int = 0, pillar_ch: int = 64):
        super().__init__(det_cfg, vox_cfg, device)
        kw = dict(device=self._device)
        self.vfe = PillarVFE(vox_cfg.num_point_features, pillar_ch, **kw)
        self.backbone = BaseBEVBackbone(pillar_ch, **kw)
        self.head = DenseCenterHead(self.backbone.out_channels,
                                    det_cfg.num_classes, **kw)
        self._finish(seed)

    def voxel_grid(self) -> VoxelGrid:
        pr = self.vox_cfg.point_range
        vs = (self.vox_cfg.voxel_size[0], self.vox_cfg.voxel_size[1],
              pr[5] - pr[2])
        return VoxelGrid.create(pr, vs)

    def stages(self, trace=None):
        grid = self.voxel_grid()
        nx, ny, _ = grid.grid_size

        def pillars(points, n):
            return voxelize(points, n, grid,
                            max_voxels=self.vox_cfg.max_voxels,
                            max_points_per_voxel=(
                                self.vox_cfg.max_points_per_voxel))

        def canvas(vox):
            return pillar_scatter(self.vfe(vox, grid), vox.coords, (ny, nx))
        return (("voxelize", pillars), ("trunk3d", canvas),
                ("trunk2d", self.backbone), ("head", self.head_out))

    def head_out(self, bev):
        return {"bev_dense": bev, "preds": self.head(bev)}

    def decode(self, out) -> Detections:
        return decode_dense(out["preds"], self.det_cfg, self.vox_cfg,
                            stride=1)
