"""MPPNet: multi-frame proposal trajectory refinement, and its online form
with a memory bank (counterpart of lvv_tpu/models/mppnet.py).

First-stage proposals [R, 9] become trajectories: each box moved back
through the past frames by its velocity (`propagate_trajectories`). Per
(proposal, frame) `roipoint_pool3d` keeps the first `samples` points
inside the trajectory box (`MPPNetHead.pool`); `MPPNetHead.forward`
takes them into the box's frame (`canonicalize`), embeds them per frame
(`embed_{t}` plus a learned `time_embed_{t}`), and intertwines all the
frames' tokens of a proposal through `num_layers` pre-norm blocks of
self-attention and a ReLU MLP, then mean-pools the filled tokens into
cls [R] and reg [R, 7] (a box relative to the proposal,
`canonical_decode`).

Reference traits kept: the attention has no key mask, so the tokens of
an empty (proposal, frame) pair, zeroed and then normalised to the
LayerNorm's bias, still serve as keys to the filled ones; only the
residual adds and the final mean skip them. With a point width of 3 the
per-frame Dense reads a zero feature beside xyz, as JAX's does.

- `MPPNetDetector`: a fixed T-frame stack (frame 0 the current one) and
  the proposals -> refined Detections (`return_preds`: also the raw
  outputs and the trajectory RoIs that the loss samples from); `stages`
  splits it as chip_smoke times it.
- `MemoryBank` / `MPPNetE2E`: the last T - 1 frames as explicit state;
  a step takes (bank, frame, proposals) and returns (bank', detections).
- `subsample_rois`, `mppnet_proposal_targets`, `mppnet_loss`: the
  trajectory targets' fixed-shape foreground / background sampling. Its
  two uniform draws are tensors the caller passes (`draws`), so that a
  test can hand the port the draws a JAX key gives; the train step takes
  them from the batch or from its torch.Generator.

The path runs no hand-written kernel: its attention holds T·S keys (128
at the presets) and its LayerNorm is 64 wide, which the JAX package's
rules (`ops.attention.attention`, `fused_mlp.kernel_ok`) leave to the
plain path.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..config.schema import VoxelizeConfig, VoxelNeXtConfig
from ..ops.boxes import iou_aabb_bev
from ..ops.nms import top_k
from ..ops.pool import roipoint_pool3d
from .layers import (LayerNorm, MultiHeadAttention, init_parameters,
                     new_param, resolve_device)
from .pointpillars import Dense
from .roi_head import (RoITargets, canonical_decode, canonical_encode,
                       proposal_targets, roi_head_loss)
from .voxelnext import Detections


def propagate_trajectories(boxes: torch.Tensor, num_frames: int,
                           dt: float = 0.1) -> torch.Tensor:
    """[R, 9] current boxes (vx, vy in columns 7:9) -> [T, R, 7]: frame t
    is the box moved back t·dt by its velocity."""
    steps = torch.arange(num_frames, dtype=torch.float32,
                         device=boxes.device) * dt
    xy = boxes[None, :, :2] - steps[:, None, None] * boxes[None, :, 7:9]
    rest = boxes[None, :, 2:7].expand(num_frames, -1, -1)
    return torch.cat([xy, rest], -1)


def canonicalize(points_xyz: torch.Tensor, box: torch.Tensor) -> torch.Tensor:
    """[..., 3] points into the frame of box [..., 7] (broadcast)."""
    d = points_xyz - box[..., :3]
    c, s = torch.cos(-box[..., 6]), torch.sin(-box[..., 6])
    return torch.stack([d[..., 0] * c - d[..., 1] * s,
                        d[..., 0] * s + d[..., 1] * c, d[..., 2]], -1)


class MPPNetHead(nn.Module):
    """Trajectory point pooling (`pool`) and the intertwining head
    (`forward` on pooled points). `point_features` is the frames' point
    width F (JAX reads it from its input at init): the per-frame Dense
    takes 3 + max(F - 3, 1) features."""

    def __init__(self, num_frames: int = 4, samples: int = 32,
                 d_model: int = 64, num_layers: int = 2, num_heads: int = 4,
                 point_features: int = 4, *, device):
        super().__init__()
        self.num_frames, self.samples = num_frames, samples
        self.num_layers = num_layers
        cin = 3 + max(point_features - 3, 1)
        kw = dict(device=device)
        for t in range(num_frames):
            setattr(self, f"embed_{t}", Dense(cin, d_model, **kw))
            setattr(self, f"time_embed_{t}", new_param(
                (d_model,), ("normal", 0.02), dtype=torch.float32, **kw))
        akw = dict(dtype=torch.float32, **kw)
        for li in range(num_layers):
            setattr(self, f"ln{li}", LayerNorm(d_model, **akw))
            setattr(self, f"attn{li}", MultiHeadAttention(d_model, num_heads,
                                                          **akw))
            setattr(self, f"ln{li}b", LayerNorm(d_model, **akw))
            setattr(self, f"fc{li}a", Dense(d_model, 2 * d_model, **kw))
            setattr(self, f"fc{li}b", Dense(2 * d_model, d_model, **kw))
        self.shared = Dense(d_model, d_model, **kw)
        self.cls = Dense(d_model, 1, **kw)
        self.reg = Dense(d_model, 7, **kw)

    def pool(self, frame_points: torch.Tensor, frame_counts: torch.Tensor,
             trajectories: torch.Tensor):
        """frame_points [T, P, F], frame_counts [T], trajectories [T, R, 7]
        -> (pooled [T, R, S, 3 + max(F - 3, 1)] (xyz and features, the
        first S points inside each box; 0 in unfilled slots), empty
        [T, R] bool)."""
        pooled, empty = [], []
        p = frame_points.shape[1]
        rows = torch.arange(p, device=frame_points.device)
        for t in range(trajectories.shape[0]):
            pts = frame_points[t]
            extra = pts[:, 3:] if pts.shape[-1] > 3 else pts[:, :1] * 0.0
            got, e = roipoint_pool3d(pts[:, :3], extra, trajectories[t],
                                     self.samples,
                                     valid_points=rows < frame_counts[t])
            pooled.append(got)
            empty.append(e)
        return torch.stack(pooled), torch.stack(empty)

    def forward(self, pooled: torch.Tensor, empty: torch.Tensor,
                trajectories: torch.Tensor) -> Dict[str, torch.Tensor]:
        """(`pool`'s outputs, trajectories [T, R, 7]) -> {cls [R],
        reg [R, 7]}."""
        t_num, r_num = trajectories.shape[:2]
        toks = []
        for t in range(t_num):
            xyz = canonicalize(pooled[t, ..., :3], trajectories[t][:, None])
            tok = torch.cat([xyz, pooled[t, ..., 3:]], -1)
            toks.append(getattr(self, f"embed_{t}")(tok)
                        + getattr(self, f"time_embed_{t}"))
        tokens = torch.cat(toks, 1)                       # [R, T·S, D]
        mask = (~empty).t()[:, :, None].expand(
            r_num, t_num, self.samples).reshape(r_num, -1)
        m = mask[..., None]
        tokens = torch.where(m, tokens, 0.0)
        for li in range(self.num_layers):
            y = getattr(self, f"ln{li}")(tokens)
            a = getattr(self, f"attn{li}")(y, y)
            tokens = tokens + torch.where(m, a, 0.0)
            y = getattr(self, f"ln{li}b")(tokens)
            h = getattr(self, f"fc{li}a")(y)
            tokens = tokens + getattr(self, f"fc{li}b")(torch.relu(h))
        denom = mask.sum(1, keepdim=True).clamp_min(1)
        pooled_tok = torch.where(m, tokens, 0.0).sum(1) / denom
        h = torch.relu(self.shared(pooled_tok))
        return {"cls": self.cls(h)[:, 0], "reg": self.reg(h)}


def refine(preds: Dict, proposals: Detections) -> Detections:
    """The proposals' boxes refined by the head, scores times its
    confidence; velocities, labels and count kept."""
    conf = torch.sigmoid(preds["cls"].float())
    refined = canonical_decode(preds["reg"].float(), proposals.boxes[:, :7])
    return Detections(boxes=torch.cat([refined, proposals.boxes[:, 7:9]], 1),
                      scores=conf * proposals.scores, labels=proposals.labels,
                      count=proposals.count)


class _MPPNetBase(nn.Module):
    """Configs, device, the head and its seeded weights; every parameter
    trains, and the module starts in eval mode."""

    def __init__(self, det_cfg: VoxelNeXtConfig, vox_cfg: VoxelizeConfig, *,
                 device=None, seed: int = 0, num_frames: int = 4,
                 samples: int = 32, point_features: int = 4):
        super().__init__()
        self.det_cfg, self.vox_cfg = det_cfg, vox_cfg
        self.num_frames, self.samples = num_frames, samples
        self.point_features = point_features
        dev = resolve_device(device)
        self.head = MPPNetHead(num_frames, samples,
                               point_features=point_features, device=dev)
        if dev.type != "meta":
            init_parameters(self, seed)
        self.requires_grad_(True)
        self.eval()

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def _proposals(self, proposals: Detections) -> Detections:
        return Detections(*(torch.as_tensor(t).to(self.device)
                            for t in proposals))


class MPPNetDetector(_MPPNetBase):
    """Offline refinement of a fixed T-frame stack: forward(frame_points
    [T, P, F] (frame 0 the current one), frame_counts [T], proposals) ->
    Detections, or with `return_preds` {detections, preds,
    trajectory_rois, rois} for the loss."""

    def stages(self):
        """The forward as (name, fn) steps: "trajectories" (frame_points,
        frame_counts, proposals) -> dict, then "pool", "head", "refine",
        each dict -> dict."""
        def trajectories(fp, fc, proposals):
            proposals = self._proposals(proposals)
            return {"frame_points": fp.to(self.device, torch.float32),
                    "frame_counts": torch.as_tensor(fc).to(self.device),
                    "proposals": proposals,
                    "trajectory_rois": propagate_trajectories(
                        proposals.boxes.float(), self.num_frames)}

        def pool(s):
            s["pooled"], s["empty"] = self.head.pool(
                s.pop("frame_points"), s.pop("frame_counts"),
                s["trajectory_rois"])
            return s

        def head(s):
            s["preds"] = self.head(s["pooled"], s["empty"],
                                   s["trajectory_rois"])
            return s

        def refine_(s):
            s["detections"] = refine(s["preds"], s["proposals"])
            return s
        return [("trajectories", trajectories), ("pool", pool),
                ("head", head), ("refine", refine_)]

    def forward(self, frame_points, frame_counts, proposals: Detections,
                return_preds: bool = False):
        (_, first), *rest = self.stages()
        s = first(frame_points, frame_counts, proposals)
        for _, fn in rest:
            s = fn(s)
        if return_preds:
            return {"detections": s["detections"], "preds": s["preds"],
                    "trajectory_rois": s["trajectory_rois"],
                    "rois": s["proposals"].boxes[:, :7]}
        return s["detections"]

    @torch.no_grad()
    def detect(self, frame_points, frame_counts, proposals) -> Detections:
        """The forward without a graph, in eval mode; the mode is left as
        it was."""
        training = self.training
        self.eval()
        try:
            return self(frame_points, frame_counts, proposals)
        finally:
            self.train(training)


class MemoryBank(NamedTuple):
    """The last T - 1 frames, newest first: points [T-1, P, F], counts
    [T-1]."""
    points: torch.Tensor
    counts: torch.Tensor

    @classmethod
    def create(cls, num_frames: int, max_points: int, feat_dim: int = 4, *,
               device=None):
        dev = resolve_device(device)
        return cls(points=torch.zeros((num_frames - 1, max_points, feat_dim),
                                      device=dev),
                   counts=torch.zeros((num_frames - 1,), dtype=torch.int32,
                                      device=dev))

    def push(self, points: torch.Tensor, count) -> "MemoryBank":
        count = torch.as_tensor(count, dtype=torch.int32,
                                device=self.counts.device)
        return MemoryBank(points=torch.cat([points[None].to(self.points),
                                            self.points[:-1]]),
                          counts=torch.cat([count[None], self.counts[:-1]]))


class MPPNetE2E(_MPPNetBase):
    """Online refinement step: forward(bank, points [P, F], num_points,
    proposals) -> (the bank with this frame pushed, refined
    Detections)."""

    def create_bank(self, max_points: int, feat_dim: Optional[int] = None
                    ) -> MemoryBank:
        return MemoryBank.create(self.num_frames, max_points,
                                 feat_dim or self.point_features,
                                 device=self.device)

    def forward(self, bank: MemoryBank, points, num_points,
                proposals: Detections) -> Tuple[MemoryBank, Detections]:
        points = points.to(self.device, torch.float32)
        n = torch.as_tensor(num_points, dtype=torch.int32,
                            device=self.device)
        frame_points = torch.cat([points[None], bank.points])
        frame_counts = torch.cat([n[None], bank.counts])
        proposals = self._proposals(proposals)
        traj = propagate_trajectories(proposals.boxes.float(),
                                      self.num_frames)
        preds = self.head(*self.head.pool(frame_points, frame_counts, traj),
                          traj)
        return bank.push(points, n), refine(preds, proposals)


def subsample_rois(max_overlaps: torch.Tensor,
                   draws: Tuple[torch.Tensor, torch.Tensor],
                   roi_per_image: int = 96, fg_ratio: float = 0.5,
                   fg_thresh: float = 0.55, bg_thresh_lo: float = 0.1,
                   hard_bg_ratio: float = 0.8):
    """Fixed-shape foreground / background RoI sampling: up to
    round(fg_ratio · m) random foregrounds (IoU >= fg_thresh), the rest of
    the m = min(roi_per_image, R) slots background, hard background (IoU
    >= bg_thresh_lo) first hard_bg_ratio of the time. draws: two [R]
    uniforms (the foreground and background priorities). -> (sampled
    index [m], fg_mask [m])."""
    u_fg, u_bg = draws
    r = max_overlaps.shape[0]
    m = min(roi_per_image, r)
    n_fg = max(1, int(np.round(fg_ratio * m)))
    fg = max_overlaps >= fg_thresh
    fg_val, fg_idx = top_k(torch.where(fg, u_fg, -torch.inf), n_fg)
    hard = ~fg & (max_overlaps >= bg_thresh_lo)
    bg_pri = torch.where(~fg, u_bg + torch.where(hard, hard_bg_ratio, 0.0),
                         -torch.inf)
    bg_val, bg_idx = top_k(bg_pri, m)
    # the valid foregrounds first, then the background in sampled order,
    # never an invalid candidate
    cand_idx = torch.cat([fg_idx, bg_idx])
    bg_order = 1.0 - torch.arange(m, dtype=torch.float32,
                                  device=u_fg.device) / (m + 1)
    cand_pri = torch.cat([torch.where(torch.isfinite(fg_val), 2.0, -2.0),
                          torch.where(torch.isfinite(bg_val), bg_order, -1.0)])
    _, sel = top_k(cand_pri, m)
    sampled = cand_idx[sel]
    return sampled, fg[sampled]


def mppnet_proposal_targets(draws, trajectory_rois: torch.Tensor,
                            roi_scores: torch.Tensor,
                            roi_labels: torch.Tensor,
                            valid_length: torch.Tensor,
                            gt_boxes: torch.Tensor, gt_mask: torch.Tensor,
                            roi_per_image: int = 96, fg_thresh: float = 0.55,
                            cls_fg_thresh: float = 0.75,
                            cls_bg_thresh: float = 0.25) -> Dict:
    """The current frame's trajectory RoIs matched to the gts (axis-aligned
    BEV IoU), sampled by `subsample_rois`, whole trajectories and
    valid_length carried along, soft class targets between the two
    thresholds. trajectory_rois [T, R, 7]; roi_scores / labels [R];
    valid_length [T, R] -> trajectory_rois [T, M, 7], rois [M, 7], reg_tgt,
    cls_tgt, fg_mask, valid, sampled_idx and the rest."""
    gt_boxes, gt_mask = gt_boxes.float(), gt_mask.bool()
    rois0 = trajectory_rois[0]
    iou = iou_aabb_bev(rois0[:, :7], gt_boxes[:, :7])
    iou = torch.where(gt_mask[None, :], iou, 0.0)
    best_gt = iou.argmax(1)
    best_iou = iou.amax(1)
    sampled, fg_mask = subsample_rois(best_iou, draws, roi_per_image,
                                      fg_thresh=fg_thresh)
    rois_s = rois0[sampled]
    gt_s = gt_boxes[best_gt[sampled]]
    iou_s = best_iou[sampled]
    soft = ((iou_s - cls_bg_thresh)
            / (cls_fg_thresh - cls_bg_thresh)).clamp(0.0, 1.0)
    valid = gt_mask.any() & (rois_s[:, 3:6].sum(1) > 0)
    return {"trajectory_rois": trajectory_rois[:, sampled],
            "valid_length": valid_length[:, sampled],
            "rois": rois_s, "roi_scores": roi_scores[sampled],
            "roi_labels": roi_labels[sampled], "gt_iou_of_rois": iou_s,
            "cls_tgt": soft,
            "reg_tgt": canonical_encode(gt_s[:, :7], rois_s[:, :7]),
            "fg_mask": fg_mask & valid, "valid": valid,
            "sampled_idx": sampled}


def mppnet_loss(preds: Dict, rois: torch.Tensor, gt_boxes, gt_mask,
                draws=None, trajectory_rois: torch.Tensor | None = None,
                valid_length: torch.Tensor | None = None):
    """The RoI loss (`roi_head_loss`): with `draws` and `trajectory_rois`
    on the RoIs that `mppnet_proposal_targets` samples (at most 96),
    otherwise on `proposal_targets` of the current frame's RoIs."""
    if draws is not None and trajectory_rois is not None:
        r = trajectory_rois.shape[1]
        dev = trajectory_rois.device
        if valid_length is None:
            valid_length = torch.ones(trajectory_rois.shape[:2], dtype=bool,
                                      device=dev)
        t = mppnet_proposal_targets(
            draws, trajectory_rois, roi_scores=torch.zeros(r, device=dev),
            roi_labels=torch.zeros(r, dtype=torch.int32, device=dev),
            valid_length=valid_length, gt_boxes=gt_boxes, gt_mask=gt_mask,
            roi_per_image=min(96, r))
        sel = t["sampled_idx"]
        preds = {"cls": preds["cls"][sel], "reg": preds["reg"][sel]}
        return roi_head_loss(preds, RoITargets(
            rois=t["rois"], cls_tgt=t["cls_tgt"], reg_tgt=t["reg_tgt"],
            fg_mask=t["fg_mask"], valid=t["valid"]))
    return roi_head_loss(preds, proposal_targets(rois, gt_boxes, gt_mask))
