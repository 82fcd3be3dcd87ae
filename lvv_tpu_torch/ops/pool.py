"""Pooling ops: points in rotated boxes, RoI-aware 3D pooling, RoI point
pooling and the BEV pooling of lifted camera features (counterpart of
lvv_tpu/ops/pool.py).

- `points_in_rotated_boxes` / `assign_points_to_boxes`: each point in each
  box's frame (translated to the centre, rotated by -heading), inside
  where |u|, |v|, |z| are within half the box's sizes.
- `roiaware_pool3d`: a grid³ lattice per box; the features of the points
  in each cell pooled by max or mean, empty cells 0. JAX broadcasts every
  (point, box) pair with its feature row, [N, M, C], and sends the pairs
  outside every box to a spare segment that it drops. The port pools the
  pairs inside a box alone: the same segments get the same rows, so the
  values are JAX's, without the [N, M, C] array (4.9 GB at PointRCNN's
  300,000 points x 64 RoIs x 64 channels) and without every outside pair
  meeting in one segment's atomics on the card. Finding the inside pairs
  (`torch.nonzero`) synchronises with the host once a call.
- `roipoint_pool3d`: up to `num_sampled` points per box, the first in
  input order; unused slots 0.
- `bev_pool`: a masked segment sum; each frustum point's feature vector
  adds into its BEV bin, invalid points into a spare bin that is dropped.

On the card `index_add_` adds with float atomics in any order, so sums
agree with the CPU's to fp32 reduction order only; maxima are exact.
"""
from __future__ import annotations

import torch

from .segment import segment_max, segment_sum


def _box_frame(points: torch.Tensor, boxes: torch.Tensor):
    """(u, v, z) of every point in every box's frame, each [N, M], and the
    inside mask [N, M]."""
    px = points[:, 0][:, None] - boxes[:, 0][None, :]
    py = points[:, 1][:, None] - boxes[:, 1][None, :]
    pz = points[:, 2][:, None] - boxes[:, 2][None, :]
    c = torch.cos(-boxes[:, 6])[None, :]
    s = torch.sin(-boxes[:, 6])[None, :]
    u = px * c - py * s
    v = px * s + py * c
    inside = ((u.abs() <= boxes[:, 3][None, :] * 0.5)
              & (v.abs() <= boxes[:, 4][None, :] * 0.5)
              & (pz.abs() <= boxes[:, 5][None, :] * 0.5))
    return u, v, pz, inside


def points_in_rotated_boxes(points: torch.Tensor,
                            boxes: torch.Tensor) -> torch.Tensor:
    """[N, 3+] points x [M, 7] boxes -> bool [N, M] membership (z is the
    box's centre)."""
    return _box_frame(points, boxes)[3]


def assign_points_to_boxes(points: torch.Tensor, boxes: torch.Tensor,
                           valid_points: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """[N] int64: the first box that holds each point, else -1."""
    inside = points_in_rotated_boxes(points, boxes)
    if valid_points is not None:
        inside &= valid_points[:, None]
    first = torch.argmax(inside.to(torch.int8), 1)
    return torch.where(inside.any(1), first, -1)


def roiaware_pool3d(points: torch.Tensor, features: torch.Tensor,
                    boxes: torch.Tensor, grid: int, *, mode: str = "max",
                    valid_points: torch.Tensor | None = None
                    ) -> torch.Tensor:
    """[M, grid, grid, grid, C]: each box's cells pool the features of the
    points in them (max or mean); empty cells are 0. A point's cell along
    an axis is ((coord / size + 0.5)·grid) truncated toward zero, clipped
    to [0, grid)."""
    if mode not in ("max", "avg"):
        raise ValueError(f"mode {mode!r}")
    m, c_dim = boxes.shape[0], features.shape[1]
    u, v, pz, inside = _box_frame(points, boxes)
    if valid_points is not None:
        inside &= valid_points[:, None]

    def cell(coord, size):
        rel = (coord / size[None, :] + 0.5) * grid
        return rel.to(torch.int32).clamp(0, grid - 1)
    box_ids = torch.arange(m, device=boxes.device, dtype=torch.int32)
    seg = ((box_ids[None, :] * grid + cell(u, boxes[:, 3])) * grid
           + cell(v, boxes[:, 4])) * grid + cell(pz, boxes[:, 5])
    pair = torch.nonzero(inside)                       # [P, 2] (point, box)
    seg = seg[pair[:, 0], pair[:, 1]]
    rows = features[pair[:, 0]]
    num_seg = m * grid ** 3
    if mode == "max":
        pooled = segment_max(rows, seg, num_seg)
        counts = segment_sum(torch.ones_like(seg), seg, num_seg)
        pooled = torch.where(counts[:, None] > 0, pooled, 0.0)
    else:
        total = segment_sum(rows, seg, num_seg)
        counts = segment_sum(torch.ones(seg.shape, dtype=torch.float32,
                                        device=seg.device), seg, num_seg)
        pooled = total / counts.clamp_min(1e-12)[:, None]
    return pooled.reshape(m, grid, grid, grid, c_dim)


def roipoint_pool3d(points: torch.Tensor, features: torch.Tensor,
                    boxes: torch.Tensor, num_sampled: int,
                    valid_points: torch.Tensor | None = None):
    """Up to `num_sampled` points per box, the first in input order ->
    ([M, num_sampled, 3 + C] (xyz, features), empty [M] bool)."""
    inside = points_in_rotated_boxes(points, boxes)
    if valid_points is not None:
        inside &= valid_points[:, None]
    m = inside.shape[1]
    # each box's running count of points, scanned along the box's own row
    # of the transposed mask: a scan along dim 0 of [N, M] runs one thread
    # a box over all N points (PyTorch's outer-dim scan: 17.6 ms a call at
    # N = 75,000, M = 32 on an H100), the inner-dim scan in parallel
    rank = torch.cumsum(inside.t().to(torch.int32), 1).t() - 1
    keep = inside & (rank < num_sampled)
    pf = torch.cat([points[:, :3], features], 1)
    # the kept (box, rank) pairs are unique: one write each, every other
    # slot stays 0
    pair = torch.nonzero(keep)                         # [P, 2] (point, box)
    out = pf.new_zeros((m * num_sampled, pf.shape[1]))
    slot = pair[:, 1] * num_sampled + rank[pair[:, 0], pair[:, 1]]
    out = out.index_copy(0, slot, pf[pair[:, 0]])
    return out.reshape(m, num_sampled, -1), ~inside.any(0)


def bev_pool(features: torch.Tensor, bev_ids: torch.Tensor,
             valid: torch.Tensor, num_bins: int) -> torch.Tensor:
    """Sum the features sharing a BEV bin. features [N, C], bev_ids [N]
    (linear bin ids), valid [N] bool -> [num_bins, C]."""
    ids = torch.where(valid, bev_ids.long(), num_bins)
    feats = torch.where(valid[:, None], features, 0.0)
    return segment_sum(feats, ids, num_bins + 1)[:num_bins]
