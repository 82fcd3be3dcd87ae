"""VoxelNeXt, the fully sparse LiDAR BEV producer (counterpart of
lvv_tpu/models/voxelnext.py).

points -> `voxelize_mean` (voxelization and MeanVFE in one) -> a 6-stage
sparse backbone (strides to 32x; stage 5 and 6 re-indexed onto the
stride-8 grid and added in; z collapsed to BEV; two 2D convs) -> the
stride-8 sparse BEV tensor, whose dense form [128, 180, 180] is the VQA
model's LiDAR input; then a sparse centre head (7 branches) and the
decode with class-agnostic rotated NMS (`detect`).

Every stage has a fixed capacity: `capacity_schedule` when the config
gives one (`NUSCENES_CAPACITY_SCHEDULE` is the product's), else 3/4 of the
previous stage's (at least 1024) from the voxelizer's. The model runs in
fp32 (TF32 off on the card, as the caller sets it); a float64 copy
(`.double()`) runs its layers in float64 from the same fp32 voxelization
(the reference chip_smoke holds the fp32 gradients to). Norm "ln" is a
LayerNorm over channels; "bn" a BatchNorm1d with running `mean` / `var`
buffers (from a converted `batch_stats` tree), so that an spconv-trained
checkpoint loads. The detector is built in eval mode, JAX's plain apply:
"bn" reads the running buffers. Under `.train()`, JAX's apply with a
mutable "batch_stats", "bn" takes the biased moments of the valid rows
(`masked_moments`, differentiated) and moves the buffers by
BN_MOMENTUM; `forward` builds an autograd graph unless the caller turns
it off, and `detect` always runs the eval form without one. Parameters
are named as in the JAX tree, so a flattened
`{"params", "batch_stats"}` tree and the state_dict share their keys
(`convert.from_jax_detector_params`); conv kernels keep the [K, Cin, Cout]
layout, drawn as flax draws them (he_normal over (K, Cin); head kernels
N(0, 0.01), the heatmap bias -4.6).
"""
from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional

import torch
from torch import nn

from ..config.schema import VoxelizeConfig, VoxelNeXtConfig
from ..ops.boxes import limit_period
from ..ops.nms import nms, top_k
from ..ops.sparse import (SparseTensor, bev_collapse, build_subm_rulebook,
                          delinearize, from_voxels, merge_add,
                          reindex_upscale, sparse_conv, submanifold_conv,
                          to_dense, wide)
from ..ops.voxelize import VoxelGrid, voxelize_mean
from .layers import PARAM_FP32, init_parameters, new_param, resolve_device

# Measured per-stage active-voxel capacities for nuScenes at 0.075 m with
# a 160k-voxel voxelizer (the JAX package's audit, benchmarks/
# capacity_stress.py): the surface profile plus headroom.
NUSCENES_CAPACITY_SCHEDULE = (440000, 240000, 96000, 32000, 12000)
BRANCHES = ("hm", "center", "center_z", "dim", "rot", "vel", "iou")
# the reference's norm_fn: BatchNorm1d(eps=1e-3, momentum=0.01), torch's
# convention ra = (1 - m)·ra + m·batch
BN_EPS, BN_MOMENTUM = 1e-3, 0.01


def masked_moments(f: torch.Tensor, valid: torch.Tensor):
    """Per-channel mean and biased variance of f [V, C] over the rows where
    `valid` holds (at least one row counted), as JAX's train form takes
    them; F.batch_norm would count the padded rows and keep an unbiased
    running variance."""
    vmask = valid[:, None].to(f.dtype)
    cnt = vmask.sum().clamp_min(1.0)
    mean = (f * vmask).sum(0) / cnt
    var = (((f - mean) ** 2) * vmask).sum(0) / cnt
    return mean, var


class SparseConvLayer(nn.Module):
    """conv + norm + ReLU on a SparseTensor (subm, or strided with its own
    output capacity)."""

    def __init__(self, cin: int, out_ch: int, *, kernel: int = 3,
                 stride: int = 1, subm: bool = True, ndim2d: bool = False,
                 out_capacity: Optional[int] = None, norm: str = "ln",
                 device=None):
        super().__init__()
        if norm not in ("ln", "bn"):
            raise ValueError(f"unknown norm {norm!r}")
        k = kernel ** (2 if ndim2d else 3)
        kw = dict(dtype=PARAM_FP32, device=device)
        self.kernel_size, self.stride, self.subm = kernel, stride, subm
        self.ndim2d, self.out_capacity, self.norm = ndim2d, out_capacity, norm
        self.kernel = new_param((k, cin, out_ch), ("he", k * cin), **kw)
        self.bias = new_param((out_ch,), "zeros", **kw)
        self.ln_scale = new_param((out_ch,), "ones", **kw)
        self.ln_bias = new_param((out_ch,), "zeros", **kw)
        if norm == "bn":
            self.register_buffer("mean", torch.zeros(out_ch, **kw))
            self.register_buffer("var", torch.ones(out_ch, **kw))

    def forward(self, st: SparseTensor, rulebook=None) -> SparseTensor:
        if self.subm:
            out = submanifold_conv(st, self.kernel, self.bias,
                                   kernel=self.kernel_size,
                                   ndim2d=self.ndim2d, rulebook=rulebook)
        else:
            out = sparse_conv(st, self.kernel, self.bias,
                              kernel=self.kernel_size, stride=self.stride,
                              padding=1, out_capacity=self.out_capacity,
                              ndim2d=self.ndim2d)
        f = wide(out.features)
        if self.norm == "bn":
            eps = BN_EPS
            if not self.training:
                mean, var = self.mean, self.var
            else:
                mean, var = masked_moments(f, out.valid)
                with torch.no_grad():
                    m = BN_MOMENTUM
                    self.mean.copy_((1 - m) * self.mean + m * mean)
                    self.var.copy_((1 - m) * self.var + m * var)
        else:
            mean = f.mean(-1, keepdim=True)
            var = f.var(-1, unbiased=False, keepdim=True)
            eps = 1e-5
        f = (f - mean) * torch.rsqrt(var + eps) * self.ln_scale + self.ln_bias
        f = torch.where(out.valid[:, None], torch.relu(f), 0.0)
        return SparseTensor(out.ids, f.to(out.features.dtype), out.grid)


class SparseBasicBlock(nn.Module):
    """Residual pair of submanifold convs."""

    def __init__(self, ch: int, *, ndim2d: bool = False, norm: str = "ln",
                 device=None):
        super().__init__()
        kw = dict(ndim2d=ndim2d, norm=norm, device=device)
        self.conv1 = SparseConvLayer(ch, ch, **kw)
        self.conv2 = SparseConvLayer(ch, ch, **kw)

    def forward(self, st: SparseTensor, rulebook=None) -> SparseTensor:
        y = self.conv2(self.conv1(st, rulebook), rulebook)
        return SparseTensor(st.ids, st.features + y.features, st.grid)


class VoxelNeXtBackbone(nn.Module):
    """6-stage sparse backbone -> the stride-8 sparse BEV tensor."""

    def __init__(self, cfg: VoxelNeXtConfig, cin: int, capacity: int, *,
                 device=None):
        super().__init__()
        chs, norm = tuple(cfg.channels), cfg.norm
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
        self.conv_out = SparseConvLayer(chs[3], cfg.out_channels,
                                        ndim2d=True, **kw)
        self.shared_conv = SparseConvLayer(cfg.out_channels, cfg.out_channels,
                                           ndim2d=True, **kw)
        self.n_stages = len(chs) - 1

    def forward(self, st: SparseTensor,
                trace: Optional[List] = None) -> SparseTensor:
        """st -> the BEV tensor; `trace`, when given, receives (name,
        SparseTensor) of every stage (each stage's active set)."""
        def keep(name, t):
            if trace is not None:
                trace.append((name, t))
            return t
        # one rulebook per active set, shared by every subm conv on it
        rb = build_subm_rulebook(st)
        st = self.res1(self.conv_input(st, rb), rb)
        keep("stage1", st)
        stages = []
        for i in range(1, self.n_stages + 1):
            st = getattr(self, f"down{i}")(st)
            st = getattr(self, f"res{i + 1}")(st, build_subm_rulebook(st))
            stages.append(keep(f"stage{i + 1}", st))
        # stage 5 (stride 16) and stage 6 (stride 32) onto the stride-8 grid
        s4, s5, s6 = stages[2], stages[3], stages[4]
        cap = s4.ids.shape[0]
        merged = merge_add(merge_add(s4, reindex_upscale(s5, 2, s4.grid),
                                     capacity=cap),
                           reindex_upscale(s6, 4, s4.grid), capacity=cap)
        bev = keep("bev_collapse", bev_collapse(merged, bev_capacity=cap))
        rb2d = build_subm_rulebook(bev, ndim2d=True)
        bev = self.shared_conv(self.conv_out(bev, rb2d), rb2d)
        return keep("bev", bev)


class VoxelNeXtHead(nn.Module):
    """Sparse centre head: per branch a 2D subm conv layer and a 2D subm
    conv to the branch's outputs, all on the BEV active set."""

    def __init__(self, cfg: VoxelNeXtConfig, *, device=None):
        super().__init__()
        c = cfg.out_channels
        outs = dict(hm=cfg.num_classes, center=2, center_z=1, dim=3, rot=2,
                    vel=2, iou=1)
        kw = dict(dtype=PARAM_FP32, device=device)
        for name in BRANCHES:
            setattr(self, f"{name}_conv", SparseConvLayer(
                c, c, ndim2d=True, norm=cfg.norm, device=device))
            setattr(self, f"{name}_head_kernel", new_param(
                (9, c, outs[name]), ("normal", 0.01), **kw))
            setattr(self, f"{name}_head_bias", new_param(
                (outs[name],), ("constant", -4.6) if name == "hm" else "zeros",
                **kw))

    def forward(self, bev: SparseTensor) -> Dict[str, SparseTensor]:
        rb2d = build_subm_rulebook(bev, ndim2d=True)
        out = {}
        for name in BRANCHES:
            st = getattr(self, f"{name}_conv")(bev, rb2d)
            out[name] = submanifold_conv(
                st, getattr(self, f"{name}_head_kernel"),
                getattr(self, f"{name}_head_bias"), ndim2d=True,
                rulebook=rb2d)
        return out


class Detections(NamedTuple):
    boxes: torch.Tensor     # [K, 9] x, y, z, dx, dy, dz, heading, vx, vy
    scores: torch.Tensor    # [K]
    labels: torch.Tensor    # [K] int32, -1 in unused slots
    count: torch.Tensor     # [] int32


def decode_detections(preds: Dict[str, SparseTensor],
                      det_cfg: VoxelNeXtConfig, vox_cfg: VoxelizeConfig,
                      stride: int) -> Detections:
    """Sparse decode of the top `nms_pre_max` (site, class) scores, the
    IoU-rectified score, then class-agnostic NMS; fixed shapes."""
    hm = preds["hm"]
    scores_all = torch.where(hm.valid[:, None],
                             torch.sigmoid(hm.features.float()), 0.0)
    v, c = scores_all.shape
    flat = scores_all.reshape(-1)
    k = min(det_cfg.nms_pre_max, flat.shape[0])
    top_scores, top_idx = top_k(flat, k)
    site = top_idx // c
    label = (top_idx % c).to(torch.int32)
    coords = delinearize(hm.ids, hm.grid)
    ys, xs = coords[site, 1].float(), coords[site, 2].float()

    def g(name):
        return preds[name].features[site].float()
    center, center_z = g("center"), g("center_z")
    dim = torch.exp(g("dim").clamp(-5, 5))
    rot, vel = g("rot"), g("vel")
    iou_pred = g("iou")[:, 0].clamp(-1, 1)
    vx, vy = vox_cfg.voxel_size[0], vox_cfg.voxel_size[1]
    x0, y0 = vox_cfg.point_range[0], vox_cfg.point_range[1]
    x = (xs + center[:, 0]) * stride * vx + x0
    y = (ys + center[:, 1]) * stride * vy + y0
    heading = limit_period(torch.atan2(rot[:, 0], rot[:, 1]), 0.5,
                           2 * math.pi)
    boxes = torch.stack([x, y, center_z[:, 0], dim[:, 0], dim[:, 1],
                         dim[:, 2], heading, vel[:, 0], vel[:, 1]], 1)
    # IoU-rectified score: score^(1 - a) * iou^a
    alpha = 0.68
    score = top_scores ** (1 - alpha) * ((iou_pred + 1) * 0.5) ** alpha
    keep_idx, count, keep_scores = nms(
        boxes, score, iou_thresh=det_cfg.nms_iou_thresh, pre_max=k,
        post_max=det_cfg.nms_post_max,
        valid=top_scores > det_cfg.score_thresh)
    kept = keep_idx >= 0
    safe = keep_idx.clamp_min(0).long()
    return Detections(boxes=boxes[safe],
                      scores=torch.where(kept, keep_scores, 0.0),
                      labels=torch.where(kept, label[safe], -1),
                      count=count)


class VoxelNeXtDetector(nn.Module):
    """points -> (BEV features for the VQA model, detections): MeanVFE
    (fused into the voxelizer), backbone, head. Built on `device` (the
    card unless told otherwise) with seeded random weights, in eval
    mode."""

    def __init__(self, det_cfg: VoxelNeXtConfig, vox_cfg: VoxelizeConfig, *,
                 device=None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.det_cfg, self.vox_cfg = det_cfg, vox_cfg
        self.backbone = VoxelNeXtBackbone(
            det_cfg, vox_cfg.num_point_features, vox_cfg.max_voxels,
            device=device)
        self.head = VoxelNeXtHead(det_cfg, device=device)
        if device.type != "meta":
            init_parameters(self, seed)
        # every parameter trains (JAX's step optimizes the whole "params")
        self.requires_grad_(True)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.backbone.conv_input.kernel.device

    def voxel_grid(self) -> VoxelGrid:
        return VoxelGrid.create(self.vox_cfg.point_range,
                                self.vox_cfg.voxel_size)

    def voxelize(self, points: torch.Tensor, num_points) -> SparseTensor:
        """points [N, F] (zero-padded rows), num_points [] -> the sparse
        voxel tensor (per-voxel means)."""
        grid = self.voxel_grid()
        vox = voxelize_mean(points.to(self.device, torch.float32),
                            num_points, grid,
                            max_voxels=self.vox_cfg.max_voxels)
        return from_voxels(vox.coords, vox.features.to(
            self.backbone.conv_input.kernel.dtype), grid.grid_size)

    def forward(self, points: torch.Tensor, num_points,
                return_dense_bev: bool = True,
                trace: Optional[List] = None) -> Dict:
        """-> {"bev_sparse", "preds", and "bev_dense" [C, H, W] fp32}; a
        graph is built unless the caller runs it under torch.no_grad()."""
        bev = self.backbone(self.voxelize(points, num_points), trace)
        out = {"bev_sparse": bev, "preds": self.head(bev)}
        if return_dense_bev:
            out["bev_dense"] = to_dense(bev)[:, 0].contiguous()
        return out

    @torch.no_grad()
    def detect(self, points: torch.Tensor, num_points) -> Detections:
        """The eval form's detections (JAX's plain apply), whatever mode
        the module is in; the mode is left as it was."""
        training = self.training
        self.eval()
        try:
            out = self(points, num_points, return_dense_bev=False)
        finally:
            self.train(training)
        return decode_detections(out["preds"], self.det_cfg, self.vox_cfg,
                                 self.det_cfg.spatial_stride)
