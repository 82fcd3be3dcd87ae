"""Box geometry: rotated BEV / 3D IoU, corners, period limiting
(counterpart of lvv_tpu/ops/boxes.py).

Fixed-shape and batched over every pair at once: the intersection of two
rotated rectangles is Sutherland-Hodgman clipping with a static vertex
capacity (a 4-gon clipped by 4 half-planes has at most 8 vertices), each
clip emitting two candidates per edge and compacting them with a stable
sort, as the JAX package does per pair under vmap.

Boxes are pcdet's [x, y, z, dx, dy, dz, heading]: z the box centre,
heading in radians about +z (counter-clockwise).
"""
from __future__ import annotations

import math

import torch

_MAXV = 8  # most vertices of a rectangle-rectangle intersection


def limit_period(val, offset: float = 0.5, period: float = math.pi):
    return val - torch.floor(val / period + offset) * period


def corners_bev(boxes: torch.Tensor) -> torch.Tensor:
    """[N, 7] -> [N, 4, 2] BEV corners (counter-clockwise)."""
    x, y = boxes[:, 0], boxes[:, 1]
    dx, dy, ang = boxes[:, 3], boxes[:, 4], boxes[:, 6]
    c, s = torch.cos(ang), torch.sin(ang)
    lx = torch.stack([dx, -dx, -dx, dx], 1) * 0.5
    ly = torch.stack([dy, dy, -dy, -dy], 1) * 0.5
    gx = lx * c[:, None] - ly * s[:, None] + x[:, None]
    gy = lx * s[:, None] + ly * c[:, None] + y[:, None]
    return torch.stack([gx, gy], -1)


def _take(pts: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """pts [..., K, 2] rows idx [..., J] -> [..., J, 2]."""
    return torch.gather(pts, -2, idx[..., None].expand(*idx.shape, 2))


def _clip_halfplane(poly, n, p0, p1):
    """Clip polygons (poly [..., 8, 2], n [...] valid vertices) by the
    half-plane left of p0 -> p1 ([..., 2] each). Returns (poly', n')."""
    idx = torch.arange(_MAXV, device=poly.device)
    valid = idx < n[..., None]
    prev_idx = (idx - 1) % n.clamp_min(1)[..., None]
    cur, prv = poly, _take(poly, prev_idx)
    edge = p1 - p0

    def side(q):
        return (edge[..., None, 0] * (q[..., 1] - p0[..., None, 1])
                - edge[..., None, 1] * (q[..., 0] - p0[..., None, 0]))

    s_cur, s_prv = side(cur), side(prv)
    in_cur, in_prv = s_cur >= 0, s_prv >= 0
    denom = s_prv - s_cur
    t = s_prv / torch.where(denom.abs() < 1e-12,
                            torch.full_like(denom, 1e-12), denom)
    inter = prv + t[..., None] * (cur - prv)
    emit_inter = valid & (in_cur != in_prv)
    emit_cur = valid & in_cur
    # (inter_0, cur_0, inter_1, cur_1, ...), then the emitted ones to the
    # front in order
    pts = torch.stack([inter, cur], -2).flatten(-3, -2)      # [..., 16, 2]
    mask = torch.stack([emit_inter, emit_cur], -1).flatten(-2)
    order = torch.argsort((~mask).to(torch.int8), dim=-1, stable=True)
    n_new = mask.sum(-1)
    return _take(pts, order[..., :_MAXV]), n_new.clamp_max(_MAXV)


def _poly_area(poly, n):
    """Shoelace area of the first n counter-clockwise vertices."""
    idx = torch.arange(_MAXV, device=poly.device)
    valid = idx < n[..., None]
    nxt = _take(poly, (idx + 1) % n.clamp_min(1)[..., None])
    cross = poly[..., 0] * nxt[..., 1] - nxt[..., 0] * poly[..., 1]
    return 0.5 * torch.where(valid, cross, 0.0).sum(-1).abs()


def pairwise_overlap_bev(boxes_a: torch.Tensor,
                         boxes_b: torch.Tensor) -> torch.Tensor:
    """Exact rotated BEV overlap area, [N, M]."""
    ca, cb = corners_bev(boxes_a), corners_bev(boxes_b)
    na, nb = ca.shape[0], cb.shape[0]
    poly = ca.new_zeros((na, nb, _MAXV, 2))
    poly[:, :, :4] = ca[:, None]
    n = torch.full((na, nb), 4, dtype=torch.int64, device=ca.device)
    for i in range(4):
        p0 = cb[None, :, i].expand(na, nb, 2)
        p1 = cb[None, :, (i + 1) % 4].expand(na, nb, 2)
        poly, n = _clip_halfplane(poly, n, p0, p1)
    return torch.where(n >= 3, _poly_area(poly, n), 0.0)


def iou_bev(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Rotated BEV IoU [N, M]."""
    inter = pairwise_overlap_bev(boxes_a, boxes_b)
    area_a = (boxes_a[:, 3] * boxes_a[:, 4])[:, None]
    area_b = (boxes_b[:, 3] * boxes_b[:, 4])[None, :]
    return inter / (area_a + area_b - inter).clamp_min(1e-6)


def iou_3d(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Rotated 3D IoU [N, M]: BEV overlap times z overlap over the union
    of the volumes."""
    inter_bev = pairwise_overlap_bev(boxes_a, boxes_b)
    za1 = boxes_a[:, 2] - boxes_a[:, 5] * 0.5
    za2 = boxes_a[:, 2] + boxes_a[:, 5] * 0.5
    zb1 = boxes_b[:, 2] - boxes_b[:, 5] * 0.5
    zb2 = boxes_b[:, 2] + boxes_b[:, 5] * 0.5
    z_ov = (torch.minimum(za2[:, None], zb2[None, :])
            - torch.maximum(za1[:, None], zb1[None, :])).clamp_min(0.0)
    inter = inter_bev * z_ov
    vol_a = (boxes_a[:, 3] * boxes_a[:, 4] * boxes_a[:, 5])[:, None]
    vol_b = (boxes_b[:, 3] * boxes_b[:, 4] * boxes_b[:, 5])[None, :]
    return inter / (vol_a + vol_b - inter).clamp_min(1e-6)


def iou_aabb_bev(boxes_a: torch.Tensor, boxes_b: torch.Tensor
                 ) -> torch.Tensor:
    """Axis-aligned BEV IoU (heading ignored)."""
    def edges(b):
        return (b[:, 0] - b[:, 3] * 0.5, b[:, 0] + b[:, 3] * 0.5,
                b[:, 1] - b[:, 4] * 0.5, b[:, 1] + b[:, 4] * 0.5)
    ax1, ax2, ay1, ay2 = edges(boxes_a)
    bx1, bx2, by1, by2 = edges(boxes_b)
    ix = (torch.minimum(ax2[:, None], bx2[None, :])
          - torch.maximum(ax1[:, None], bx1[None, :])).clamp_min(0.0)
    iy = (torch.minimum(ay2[:, None], by2[None, :])
          - torch.maximum(ay1[:, None], by1[None, :])).clamp_min(0.0)
    inter = ix * iy
    area_a = ((ax2 - ax1) * (ay2 - ay1))[:, None]
    area_b = ((bx2 - bx1) * (by2 - by1))[None, :]
    return inter / (area_a + area_b - inter).clamp_min(1e-6)
