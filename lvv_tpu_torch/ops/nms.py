"""Rotated NMS as masked greedy suppression over a fixed top-K
(counterpart of lvv_tpu/ops/nms.py).

The top-K pre-NMS candidates' IoU matrix is computed at once, then the
greedy suppression walks its rows in score order, K steps of O(K) vector
work: on the card K small launches a step from Python (a hand-written
kernel for it is later work). Top-k is a stable descending sort, so equal
scores keep the lower index first, as `jax.lax.top_k` does.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from .boxes import iou_aabb_bev, iou_bev


def top_k(values: torch.Tensor, k: int):
    """(values, indices) of the k largest, ties to the lower index."""
    vals, idx = torch.sort(values, descending=True, stable=True)
    return vals[:k], idx[:k]


def _greedy_suppress(iou: torch.Tensor, order_valid: torch.Tensor,
                     iou_thresh: float) -> torch.Tensor:
    """Boxes sorted by score, descending; iou [K, K] -> keep mask [K]:
    each box still alive kills every later box it overlaps."""
    k = iou.shape[0]
    later = torch.ones(k, k, dtype=torch.bool, device=iou.device).triu(1)
    kills = (iou > iou_thresh) & later
    alive = order_valid.clone()
    for i in range(k):
        alive &= ~(kills[i] & alive[i])
    return alive


def nms(boxes: torch.Tensor, scores: torch.Tensor, *, iou_thresh: float,
        pre_max: int, post_max: int, iou_fn: Callable = iou_bev,
        valid: Optional[torch.Tensor] = None):
    """Class-agnostic rotated NMS. boxes [N, 7+], scores [N]; invalid rows
    masked by `valid` or a score of -inf. Returns (keep_idx [post_max]
    int32, keep_count [] int32, keep_scores [post_max]); unused slots hold
    -1 / -inf."""
    n = boxes.shape[0]
    if valid is not None:
        scores = torch.where(valid, scores, -torch.inf)
    k = min(pre_max, n)
    top_scores, top_idx = top_k(scores, k)
    top_boxes = boxes[top_idx]
    iou = iou_fn(top_boxes[:, :7], top_boxes[:, :7])
    alive = _greedy_suppress(iou, torch.isfinite(top_scores), iou_thresh)
    # the survivors, already in score order, compacted to post_max slots
    alive_scores = torch.where(alive, top_scores, -torch.inf)
    kept_scores, kept_pos = top_k(alive_scores, min(post_max, k))
    kept = torch.isfinite(kept_scores)
    kept_idx = torch.where(kept, top_idx[kept_pos], -1).to(torch.int32)
    count = kept.sum(dtype=torch.int32)
    if post_max > k:
        pad = post_max - k
        kept_idx = torch.cat([kept_idx, kept_idx.new_full((pad,), -1)])
        kept_scores = torch.cat([kept_scores,
                                 kept_scores.new_full((pad,), -torch.inf)])
    return kept_idx, count, kept_scores


def nms_axis_aligned(boxes, scores, **kw):
    """NMS with axis-aligned BEV IoU."""
    return nms(boxes, scores, iou_fn=iou_aabb_bev, **kw)


def multi_class_nms(boxes, scores, labels, num_classes: int, *,
                    iou_thresh: float, pre_max: int, post_max: int):
    """Per-class NMS: each class's boxes shifted to a region of its own, so
    one class-agnostic pass suppresses within classes only."""
    span = (boxes[:, :2].abs().max() + boxes[:, 3:5].max() + 1.0) * 2
    shifted = boxes.clone()
    shifted[:, 0] += labels.to(boxes.dtype) * span
    return nms(shifted, scores, iou_thresh=iou_thresh, pre_max=pre_max,
               post_max=post_max)
