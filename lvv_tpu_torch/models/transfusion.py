"""TransFusion-L: heatmap-initialised object queries that cross-attend to
the BEV (counterpart of lvv_tpu/models/transfusion.py).

- `TransFusionHead`: BEV [C, H, W] -> tokens (Dense to d_model); a 3x3
  conv heatmap whose per-cell peak picks the queries (top-K, ties to the
  lower index as jax.lax.top_k); each query its token plus a Dense
  embedding of its cell; `num_layers` decoder layers (pre-norm self
  attention, cross attention to every BEV token, MLP with tanh GELU, as
  flax's nn.gelu); then Dense class logits and an 8-value box.
- `decode_queries`: NMS-free, each query at most one box, the top
  `nms_post_max` by score.
- `greedy_one_to_one` and `hungarian_one_to_one` (scipy's
  linear_sum_assignment on the host, the cost's inf and NaN sanitised as
  JAX sanitises them): the matchers of `transfusion_loss`.
- `TransFusionDetector`: the sparse trunk, height compression and 2D trunk
  of CenterPoint, then the head.

The cross attention goes through `ops.attention.attention`, whose rule
sends it (kv of 32,400 tokens at the preset) to K-e's fp32 kernel on the
card; the norms are `layers.LayerNorm` (K-a on the card at width 128).

`transfusion_loss` keeps two traits of the JAX package (ROADMAP.md queue
3): the cost rows are `decode_queries`' score order while the class loss
takes the logits in query order; and where `nms_post_max` < the query
count (every preset: 83 < 200) JAX's shapes do not broadcast and it
raises, so the port's loss decodes every query (the same function
wherever JAX runs).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config.schema import VoxelizeConfig, VoxelNeXtConfig
from ..ops.boxes import iou_aabb_bev
from ..ops.nms import top_k
from .anchor_head import smooth_l1
from .centerpoint import SparseTrunkDetector
from .layers import MLP, LayerNorm, MultiHeadAttention
from .pointpillars import HM_BIAS, Conv2d, Dense
from .voxelnext import Detections

BIG = 1e9               # the matchers' cost of a padded gt


def gelu_tanh(x):
    """flax's nn.gelu (approximate=True)."""
    return F.gelu(x, approximate="tanh")


class TransFusionDecoderLayer(nn.Module):
    def __init__(self, d_model: int, num_heads: int = 4, *, device):
        super().__init__()
        kw = dict(dtype=torch.float32, device=device)
        self.self_attn = MultiHeadAttention(d_model, num_heads, **kw)
        self.ln1 = LayerNorm(d_model, **kw)
        self.cross_attn = MultiHeadAttention(d_model, num_heads, **kw)
        self.ln2 = LayerNorm(d_model, **kw)
        self.mlp = MLP(d_model, 4 * d_model, act=gelu_tanh, **kw)
        self.ln3 = LayerNorm(d_model, **kw)

    def forward(self, queries, bev_tokens):
        q = queries + self.self_attn(self.ln1(queries))
        q = q + self.cross_attn(self.ln2(q), bev_tokens)
        return q + self.mlp(self.ln3(q))


class TransFusionHead(nn.Module):
    """BEV [C, H, W] -> {"cls" [Q, classes], "box" [Q, 8], "query_yx"
    [Q, 2], "hm" [H, W, classes], "top_idx" [Q]}, Q = min(num_queries,
    H·W)."""

    def __init__(self, cin: int, num_classes: int, num_queries: int = 200,
                 d_model: int = 128, num_layers: int = 2,
                 num_heads: int = 4, *, device):
        super().__init__()
        self.num_queries, self.num_layers = num_queries, num_layers
        self.in_proj = Dense(cin, d_model, device=device)
        self.hm = Conv2d(cin, num_classes, bias_init=HM_BIAS, device=device)
        self.pos_emb = Dense(2, d_model, device=device)
        for i in range(num_layers):
            setattr(self, f"layer_{i}", TransFusionDecoderLayer(
                d_model, num_heads, device=device))
        self.cls = Dense(d_model, num_classes, bias_init=HM_BIAS,
                         device=device)
        self.box = Dense(d_model, 8, device=device)

    def forward(self, bev_chw: torch.Tensor,
                top_idx: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        """`top_idx`, when given, replaces the heatmap's picks (a replay of
        another run's queries)."""
        c, h, w = bev_chw.shape
        tokens = self.in_proj(bev_chw.reshape(c, h * w).t()[None])
        hm = self.hm(bev_chw[None])[0].permute(1, 2, 0)     # [H, W, cls]
        if top_idx is None:
            peak = torch.sigmoid(hm.float()).amax(-1)
            _, top_idx = top_k(peak.reshape(-1),
                               min(self.num_queries, h * w))
        q_init = tokens[0, top_idx][None]                   # [1, Q, D]
        q_pos = torch.stack([(top_idx % w).float(),
                             (top_idx // w).float()], -1)
        scale = torch.tensor([w, h], dtype=torch.float32,
                             device=q_pos.device)
        q = q_init + self.pos_emb(q_pos / scale)[None]
        for i in range(self.num_layers):
            q = getattr(self, f"layer_{i}")(q, tokens)
        q = q[0]
        return {"cls": self.cls(q), "box": self.box(q),
                "query_yx": q_pos.flip(-1), "hm": hm, "top_idx": top_idx}


def decode_queries(preds: Dict, det_cfg: VoxelNeXtConfig,
                   vox_cfg: VoxelizeConfig, stride: int,
                   post_max: Optional[int] = None) -> Detections:
    """Each query's best class score and its box; the top `post_max`
    (default `nms_post_max`) by score, those above `score_thresh`
    valid."""
    scores_all = torch.sigmoid(preds["cls"].float())
    score = scores_all.amax(-1)
    label = scores_all.argmax(-1).to(torch.int32)
    b = preds["box"].float()
    yx = preds["query_yx"]
    vx, vy = vox_cfg.voxel_size[0], vox_cfg.voxel_size[1]
    x0, y0 = vox_cfg.point_range[0], vox_cfg.point_range[1]
    x = (yx[:, 1] + b[:, 0]) * stride * vx + x0
    y = (yx[:, 0] + b[:, 1]) * stride * vy + y0
    dims = torch.exp(b[:, 3:6].clamp(-5, 5))
    heading = torch.atan2(b[:, 6], b[:, 7])
    zeros = torch.zeros_like(x)
    boxes = torch.stack([x, y, b[:, 2], dims[:, 0], dims[:, 1], dims[:, 2],
                         heading, zeros, zeros], 1)
    post_max = det_cfg.nms_post_max if post_max is None else post_max
    k = min(post_max, boxes.shape[0])
    top, idx = top_k(score, k)
    valid = top > det_cfg.score_thresh
    return Detections(boxes=boxes[idx],
                      scores=torch.where(valid, top, 0.0),
                      labels=torch.where(valid, label[idx], -1),
                      count=valid.sum(dtype=torch.int32))


def _masked_cost(cost: torch.Tensor, gt_mask: torch.Tensor) -> torch.Tensor:
    return torch.where(gt_mask.bool()[None, :], cost.float(),
                       torch.tensor(BIG, device=cost.device))


def greedy_one_to_one(cost: torch.Tensor, gt_mask: torch.Tensor):
    """Greedy one-to-one matching on a [Q, G] cost: G steps, each taking the
    smallest remaining pair (the first on ties) while it is below the
    padding cost. -> (gt_of_query [Q] int32, matched [Q] bool)."""
    q_num, g_num = cost.shape
    c = _masked_cost(cost, gt_mask)
    gt_of_q = torch.full((q_num,), -1, dtype=torch.int32,
                         device=cost.device)
    rows = torch.arange(q_num, device=c.device)
    cols = torch.arange(g_num, device=c.device)
    for _ in range(g_num):
        flat = torch.argmin(c)
        qi, gi = flat // g_num, flat % g_num
        take = c[qi, gi] < BIG
        gt_of_q = torch.where(take & (rows == qi), gi.to(torch.int32),
                              gt_of_q)
        c = torch.where(take & ((rows[:, None] == qi) | (cols == gi)), BIG,
                        c)
    return gt_of_q, gt_of_q >= 0


def hungarian_one_to_one(cost: torch.Tensor, gt_mask: torch.Tensor):
    """The exact one-to-one assignment (scipy's linear_sum_assignment on the
    host, in float64) on the [Q, G] cost with padded gts at the padding
    cost and inf / NaN sanitised to it; pairs matched at the padding cost
    are dropped. -> (gt_of_query [Q] int32, matched [Q] bool)."""
    from scipy.optimize import linear_sum_assignment
    q_num, _ = cost.shape
    c = _masked_cost(cost, gt_mask)
    c = torch.where(torch.isfinite(c), c.clamp(-BIG, BIG), BIG)
    c = c.detach().cpu().numpy().astype(np.float64)
    rows, cols = linear_sum_assignment(c)
    out = np.full((q_num,), -1, np.int32)
    for r, g in zip(rows, cols):
        if c[r, g] < BIG / 2:
            out[r] = g
    gt_of_q = torch.from_numpy(out).to(cost.device)
    return gt_of_q, gt_of_q >= 0


def transfusion_loss(preds: Dict, gt_boxes, gt_labels, gt_mask,
                     det_cfg: VoxelNeXtConfig, vox_cfg: VoxelizeConfig,
                     stride: int, cls_weight: float = 1.0,
                     reg_weight: float = 0.5, matcher: str = "hungarian"):
    """Match, then supervise: cost = centre distance - 5·IoU (axis-aligned
    BEV) between the decoded queries and the gts, matched one to one
    (`matcher` "hungarian" or "greedy"); focal class loss (0.25, γ 2) over
    every query, smooth-L1 on the matched boxes in decoded space, each over
    the matches (at least 1). -> (total, {"tf_cls_loss",
    "tf_reg_loss"})."""
    dets = decode_queries(preds, det_cfg, vox_cfg, stride,
                          post_max=preds["cls"].shape[0])
    gt_boxes = gt_boxes.float()
    iou = iou_aabb_bev(dets.boxes[:, :7], gt_boxes[:, :7])
    dist = (dets.boxes[:, None, :2] - gt_boxes[None, :, :2]).norm(dim=-1)
    cost = dist - 5.0 * iou
    match = hungarian_one_to_one if matcher == "hungarian" \
        else greedy_one_to_one
    gt_of_q, matched = match(cost.detach(), gt_mask)
    safe = gt_of_q.clamp_min(0).long()

    logits = preds["cls"].float()
    nc = det_cfg.num_classes
    onehot = F.one_hot(gt_labels[safe].long().clamp(0, nc - 1), nc).float()
    onehot = onehot * matched[:, None]
    p = torch.sigmoid(logits)
    ce = (logits.clamp_min(0) - logits * onehot
          + torch.log1p(torch.exp(-logits.abs())))
    p_t = p * onehot + (1 - p) * (1 - onehot)
    focal = 0.25 * (1 - p_t) ** 2 * ce
    n_pos = matched.sum().clamp_min(1).float()
    cls_loss = focal.sum() / n_pos
    diff = dets.boxes[:, :7] - gt_boxes[safe][:, :7]
    reg_loss = (smooth_l1(diff).sum(1) * matched).sum() / n_pos
    total = cls_weight * cls_loss + reg_weight * reg_loss
    return total, {"tf_cls_loss": cls_loss, "tf_reg_loss": reg_loss}


class TransFusionDetector(SparseTrunkDetector):
    """LiDAR-only TransFusion: the sparse trunk of CenterPoint, then
    `TransFusionHead` (200 queries); NMS-free decode at the config's
    `spatial_stride`."""

    def __init__(self, det_cfg: VoxelNeXtConfig, vox_cfg: VoxelizeConfig, *,
                 device=None, seed: int = 0, num_queries: int = 200):
        super().__init__(det_cfg, vox_cfg, device)
        self.head = TransFusionHead(self.backbone2d.out_channels,
                                    det_cfg.num_classes, num_queries,
                                    device=self._device)
        self._finish(seed)

    def head_out(self, bev):
        return {"bev_dense": bev, "preds": self.head(bev)}

    def decode(self, out) -> Detections:
        return decode_queries(out["preds"], self.det_cfg, self.vox_cfg,
                              stride=self.det_cfg.spatial_stride)
