"""Part-A²: the sparse UNet, part-aware point head and part-aggregation RoI
head (counterpart of lvv_tpu/models/part_a2.py).

points -> `voxelize_mean` -> `SparseUNet` (UNetV2: four encoder stages to
stride 8, UR blocks back onto the encoder's own active sets through
inverse convs) -> `height_compression` of the encoder's last stage ->
`BaseBEVBackbone` -> the anchor head (`head`) and, on the decoder's
full-resolution voxels, `PointIntraPartOffsetHead` (segmentation and
intra-box part locations) -> anchor decode + NMS -> `PartA2RoIHead`: the
voxels' [seg prob, part, features] max-pooled on a 6³ lattice per
proposal, Dense layers, cls and residual box.

The loss is the anchor loss plus the point-part loss only, as in JAX: the
RoI head gets no gradient in training (ROADMAP.md queue 3).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config.schema import VoxelizeConfig, VoxelNeXtConfig
from ..ops.pool import roiaware_pool3d
from ..ops.sparse import SparseTensor, build_subm_rulebook, inverse_conv
from ..ops.voxelize import VoxelGrid
from .anchor_head import (anchor_head_loss, assign_anchor_targets,
                          optax_sigmoid_ce)
from .centerpoint import TRUNK2D, CenterPointBackbone3D, height_compression
from .layers import PARAM_FP32, new_param
from .pointpillars import HM_BIAS, BaseBEVBackbone, Dense
from .roi_head import boxes9, canonical_decode
from .two_stage import TwoStageDetector, metric_centers
from .voxelnext import Detections, SparseBasicBlock, SparseConvLayer


class InverseConvLayer(nn.Module):
    """Inverse conv onto a target active set, then LayerNorm + ReLU (the
    norm's variance two-pass, eps 1e-5, as JAX writes it)."""

    def __init__(self, cin: int, out_ch: int, kernel: int = 3,
                 stride: int = 2, *, device):
        super().__init__()
        k = kernel ** 3
        kw = dict(dtype=PARAM_FP32, device=device)
        self.kernel_size, self.stride = kernel, stride
        self.kernel = new_param((k, cin, out_ch), ("he", k * cin), **kw)
        self.bias = new_param((out_ch,), "zeros", **kw)
        self.ln_scale = new_param((out_ch,), "ones", **kw)
        self.ln_bias = new_param((out_ch,), "zeros", **kw)

    def forward(self, st: SparseTensor, target: SparseTensor
                ) -> SparseTensor:
        out = inverse_conv(st, target.ids, target.grid, self.kernel,
                           self.bias, kernel=self.kernel_size,
                           stride=self.stride)
        f = out.features.float()
        mean = f.mean(-1, keepdim=True)
        var = f.var(-1, unbiased=False, keepdim=True)
        f = torch.relu((f - mean) * torch.rsqrt(var + 1e-5) * self.ln_scale
                       + self.ln_bias)
        f = torch.where(out.valid[:, None], f, 0.0)
        return SparseTensor(out.ids, f.to(out.features.dtype), out.grid)


def channel_reduction(st: SparseTensor, out_ch: int) -> SparseTensor:
    """[V, C] -> [V, out_ch]: each group of C / out_ch channels summed."""
    v, c = st.features.shape
    assert c % out_ch == 0
    f = st.features.reshape(v, out_ch, c // out_ch).sum(2)
    return SparseTensor(st.ids, f, st.grid)


class SparseUNet(nn.Module):
    """UNetV2: conv_input and conv1 at full resolution, three strided
    stages (each a strided conv and two subm convs; capacity 3/4 of the
    previous, at least 1024, from the input's `capacity`), then UR blocks
    back down to the input's active set -> {"encoded": stride-8 stage,
    "point_feats": full resolution}."""

    def __init__(self, cin: int, channels: Tuple[int, ...], capacity: int,
                 *, device):
        super().__init__()
        chs = tuple(channels)
        kw = dict(device=device)
        self.conv_input = SparseConvLayer(cin, chs[0], **kw)
        self.conv1 = SparseConvLayer(chs[0], chs[0], **kw)
        cap = capacity
        for i, ch in enumerate(chs[1:], start=1):
            cap = max(cap * 3 // 4, 1024)
            setattr(self, f"down{i}", SparseConvLayer(
                chs[i - 1], ch, subm=False, stride=2, out_capacity=cap,
                **kw))
            setattr(self, f"subm{i}a", SparseConvLayer(ch, ch, **kw))
            setattr(self, f"subm{i}b", SparseConvLayer(ch, ch, **kw))
        # UR blocks: (idx, lateral width, bottom width, out width)
        for idx, lat, bot, out in ((4, chs[3], chs[3], chs[2]),
                                   (3, chs[2], chs[2], chs[1]),
                                   (2, chs[1], chs[1], chs[0]),
                                   (1, chs[0], chs[0], chs[0])):
            setattr(self, f"up_t{idx}", SparseBasicBlock(lat, **kw))
            setattr(self, f"up_m{idx}", SparseConvLayer(bot + lat, lat, **kw))
            if idx == 1:
                self.up_out1 = SparseConvLayer(lat, out, **kw)
            else:
                setattr(self, f"inv{idx}", InverseConvLayer(lat, out, **kw))

    def forward(self, st: SparseTensor,
                trace: Optional[List] = None) -> Dict[str, SparseTensor]:
        rb = build_subm_rulebook(st)
        x = self.conv_input(st, rb)
        x = self.conv1(x, rb)
        laterals = [x]
        for i in range(1, 4):
            x = getattr(self, f"down{i}")(x)
            rb = build_subm_rulebook(x)
            x = getattr(self, f"subm{i}b")(getattr(self, f"subm{i}a")(x, rb),
                                           rb)
            laterals.append(x)
        if trace is not None:
            trace.extend((f"stage{i + 1}", t) for i, t in enumerate(laterals))
        x1, x2, x3, x4 = laterals

        def ur_block(lateral, bottom, target, idx):
            t = getattr(self, f"up_t{idx}")(lateral)
            cat = SparseTensor(t.ids, torch.cat([bottom.features,
                                                 t.features], -1), t.grid)
            m = getattr(self, f"up_m{idx}")(cat)
            red = channel_reduction(cat, m.features.shape[-1])
            merged = SparseTensor(m.ids, m.features + red.features, m.grid)
            if target is None:
                return self.up_out1(merged)
            return getattr(self, f"inv{idx}")(merged, target)

        up4 = ur_block(x4, x4, x3, 4)
        up3 = ur_block(x3, up4, x2, 3)
        up2 = ur_block(x2, up3, x1, 2)
        up1 = ur_block(x1, up2, None, 1)
        return {"encoded": x4, "point_feats": up1}


def part_targets(centers: torch.Tensor, valid: torch.Tensor,
                 gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                 gt_mask: torch.Tensor):
    """Per-voxel segmentation and part targets: {"seg" [V] int32 (-1 pad,
    0 background, 1 + class inside the first box that holds the centre),
    "part" [V, 3] (the centre's place in that box, each axis in [0, 1])}."""
    gt_boxes = gt_boxes.float()
    d = centers[:, None, :] - gt_boxes[None, :, :3]            # [V, G, 3]
    c = torch.cos(-gt_boxes[:, 6])[None, :]
    s = torch.sin(-gt_boxes[:, 6])[None, :]
    u = c * d[..., 0] - s * d[..., 1]
    v = s * d[..., 0] + c * d[..., 1]
    inside = (gt_mask.bool()[None, :]
              & (u.abs() <= gt_boxes[None, :, 3] / 2)
              & (v.abs() <= gt_boxes[None, :, 4] / 2)
              & (d[..., 2].abs() <= gt_boxes[None, :, 5] / 2))
    has = inside.any(1)
    first = torch.argmax(inside.to(torch.int8), 1)             # [V]
    seg = torch.where(has, gt_labels[first].long() + 1, 0)

    def pick(t):
        return torch.gather(t, 1, first[:, None])[:, 0]
    dims = gt_boxes[first, 3:6].clamp_min(1e-3)
    part = torch.stack([(pick(u) / dims[:, 0] + 0.5).clamp(0, 1),
                        (pick(v) / dims[:, 1] + 0.5).clamp(0, 1),
                        (pick(d[..., 2]) / dims[:, 2] + 0.5).clamp(0, 1)], 1)
    part = torch.where(has[:, None], part, 0.0)
    seg = torch.where(valid, seg, -1).to(torch.int32)
    return {"seg": seg, "part": part}


class PointIntraPartOffsetHead(nn.Module):
    """Per-voxel seg logits (bias -4.6) and part logits from one hidden
    Dense + ReLU."""

    def __init__(self, cin: int, num_classes: int, hidden: int = 32, *,
                 device):
        super().__init__()
        self.fc1 = Dense(cin, hidden, device=device)
        self.seg = Dense(hidden, num_classes, bias_init=HM_BIAS,
                         device=device)
        self.part = Dense(hidden, 3, device=device)

    def forward(self, feats: torch.Tensor) -> Dict[str, torch.Tensor]:
        h = torch.relu(self.fc1(feats))
        return {"seg": self.seg(h), "part": self.part(h)}


def point_part_loss(preds: Dict, targets: Dict):
    """(seg BCE over the valid voxels + part BCE over the foreground ones,
    each over the foreground count, {"seg_loss", "part_loss"})."""
    seg_t, part_t = targets["seg"], targets["part"]
    valid = seg_t >= 0
    fg = seg_t > 0
    onehot = F.one_hot((seg_t - 1).clamp_min(0).long(),
                       preds["seg"].shape[-1]).float() * fg[:, None]
    ce = optax_sigmoid_ce(preds["seg"].float(), onehot)
    n_fg = fg.sum().clamp_min(1)
    seg_loss = (ce * valid[:, None]).sum() / n_fg
    pce = optax_sigmoid_ce(preds["part"].float(), part_t)
    part_loss = (pce * fg[:, None]).sum() / n_fg
    return seg_loss + part_loss, {"seg_loss": seg_loss,
                                  "part_loss": part_loss}


class PartA2RoIHead(nn.Module):
    """The aggregated per-voxel vectors max-pooled on a grid³ lattice per
    RoI (`pool`), two Dense + ReLU, cls [R] and reg [R, 7] (`head`)."""

    def __init__(self, cin: int, grid: int = 6, hidden: int = 128, *,
                 device):
        super().__init__()
        self.grid = grid
        self.fc1 = Dense(cin * grid ** 3, hidden, device=device)
        self.fc2 = Dense(hidden, hidden, device=device)
        self.cls = Dense(hidden, 1, device=device)
        self.reg = Dense(hidden, 7, device=device)

    def pool(self, centers, feats, rois, valid) -> torch.Tensor:
        pooled = roiaware_pool3d(centers, feats, rois[:, :7], self.grid,
                                 mode="max", valid_points=valid)
        return pooled.reshape(pooled.shape[0], -1)

    def head(self, h) -> Dict[str, torch.Tensor]:
        h = torch.relu(self.fc2(torch.relu(self.fc1(h))))
        return {"cls": self.cls(h)[:, 0], "reg": self.reg(h)}

    def forward(self, centers, feats, rois, valid):
        return self.head(self.pool(centers, feats, rois, valid))


class PartA2Detector(TwoStageDetector):
    """`unet`, `backbone2d`, `head` (anchors), `point_head`, `roi_head`."""

    def __init__(self, det_cfg: VoxelNeXtConfig, vox_cfg: VoxelizeConfig, *,
                 device=None, seed: int = 0, roi_grid: int = 6):
        super().__init__(det_cfg, vox_cfg, device)
        kw = dict(device=self._device)
        chs = tuple(det_cfg.channels[:4])
        self.unet = SparseUNet(vox_cfg.num_point_features, chs,
                               capacity=vox_cfg.max_voxels, **kw)
        nz = CenterPointBackbone3D.out_depth(self.voxel_grid().grid_size[2])
        self.backbone2d = BaseBEVBackbone(chs[3] * nz, **TRUNK2D, **kw)
        self._anchor_rpn(self.backbone2d.out_channels, name="head")
        nc = det_cfg.num_classes
        self.point_head = PointIntraPartOffsetHead(chs[0], nc, **kw)
        self.roi_head = PartA2RoIHead(nc + 3 + chs[0], grid=roi_grid, **kw)
        self._finish(seed)

    def stages(self, trace: Optional[List] = None):
        grid: VoxelGrid = self.voxel_grid()

        def trunk3d(s):
            unet = self.unet(s["st0"], trace)
            s["unet"] = unet
            s["bev3d"] = height_compression(unet["encoded"])
            return s

        def trunk2d_rpn(s):
            bev = self.backbone2d(s.pop("bev3d"))
            pf = s["unet"]["point_feats"]
            s.update(bev_dense=bev, preds=self.head(bev),
                     point_preds=self.point_head(pf.features),
                     centers=metric_centers(pf, grid.voxel_size,
                                            self.vox_cfg.point_range[:3]),
                     centers_valid=pf.valid, point_feats=pf.features,
                     **self.anchor_entries(bev.device))
            return s

        def pool(s):
            pp = s["point_preds"]
            agg = torch.cat([torch.sigmoid(pp["seg"].float()),
                             torch.sigmoid(pp["part"].float()),
                             s["point_feats"].float()], 1)
            s["pooled"] = self.roi_head.pool(
                s["centers"], agg, s["proposals"].boxes[:, :7],
                s["centers_valid"])
            return s

        def roi_head(s):
            s["roi_preds"] = self.roi_head.head(s["pooled"])
            return s

        def refine(s):
            p, rp = s["proposals"], s["roi_preds"]
            refined = canonical_decode(rp["reg"], p.boxes[:, :7])
            s["detections"] = Detections(
                boxes=boxes9(refined),
                scores=torch.sigmoid(rp["cls"]) * p.scores,
                labels=p.labels, count=p.count)
            return s
        return [self.voxelize_stage(), ("trunk3d", trunk3d),
                ("trunk2d_rpn", trunk2d_rpn), self.proposals_stage("preds"),
                ("pool", pool), ("roi_head", roi_head), ("refine", refine)]

    def loss(self, out, gt_boxes, gt_labels, gt_mask):
        rpn_loss, rpn_stats = anchor_head_loss(
            out["preds"],
            assign_anchor_targets(out["anchors"], out["anchor_cls"],
                                  gt_boxes.float(), gt_labels, gt_mask),
            self.det_cfg.num_classes)
        tgt = part_targets(out["centers"], out["centers_valid"], gt_boxes,
                           gt_labels, gt_mask)
        pt_loss, pt_stats = point_part_loss(out["point_preds"], tgt)
        return rpn_loss + pt_loss, {**rpn_stats, **pt_stats}
