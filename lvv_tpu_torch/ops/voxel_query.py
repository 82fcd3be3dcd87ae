"""Voxel-neighbourhood query and vector-pool aggregation (counterpart of
lvv_tpu/ops/voxel_query.py).

`voxel_query` looks each query voxel's (2rz+1)(2ry+1)(2rx+1) neighbours up
among a SparseTensor's active sites, one vectorised lookup an offset: the
dense occupancy table where the grid has at most `_DENSE_LOOKUP_MAX_CELLS`
cells, else a binary search over the sorted ids, as JAX does. The result is
a fixed [M, K] set of slots with a hit mask; `gather_neighborhood` gathers
their features and offsets (with an optional radius cut) and `vector_pool`
pools them per sub-voxel bin of the query's local box, bins concatenated
by position.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .sparse import (_DENSE_LOOKUP_MAX_CELLS, SENTINEL, SparseTensor,
                     _GatherRows, _lookup, _occupancy_table, _table_lookup,
                     delinearize, linearize)


def neighborhood_offsets(ranges: Tuple[int, int, int]) -> np.ndarray:
    """[(dz, dy, dx)] of the (2rz+1)(2ry+1)(2rx+1) cube."""
    rz, ry, rx = ranges
    return np.array([(dz, dy, dx)
                     for dz in range(-rz, rz + 1)
                     for dy in range(-ry, ry + 1)
                     for dx in range(-rx, rx + 1)], np.int32)


def voxel_query(st: SparseTensor, query_coords: torch.Tensor,
                ranges: Tuple[int, int, int] = (1, 1, 1)):
    """For each query voxel [M, 3] (z, y, x), the active slots of its
    neighbourhood -> (slots [M, K] int64 into st.features, hit [M, K]
    bool). A query with a negative coordinate, and a neighbour outside the
    grid, hits nothing."""
    offs = torch.as_tensor(neighborhood_offsets(ranges),
                           device=query_coords.device)
    valid_q = (query_coords >= 0).all(1)
    nx, ny, nz = st.grid
    table = (_occupancy_table(st)
             if nx * ny * nz <= _DENSE_LOOKUP_MAX_CELLS else None)
    nb = query_coords[:, None, :] + offs[None]                 # [M, K, 3]
    nid = torch.where(valid_q[:, None], linearize(nb, st.grid), SENTINEL)
    if table is not None:
        slot, hit = _table_lookup(table, nid)
    else:
        slot, hit = _lookup(st.ids, nid.reshape(-1))
        slot, hit = slot.reshape(nid.shape), hit.reshape(nid.shape)
    return slot.long(), hit


def gather_neighborhood(st: SparseTensor, query_xyz: torch.Tensor,
                        query_coords: torch.Tensor, voxel_size, origin,
                        ranges: Tuple[int, int, int] = (1, 1, 1),
                        radius: float | None = None):
    """voxel_query and the gather of each neighbour's feature row and its
    centre's offset from the query. query_xyz [M, 3] metric; voxel_size /
    origin map coordinates to centres -> (rel_xyz [M, K, 3], feats
    [M, K, C], mask [M, K]), zeros where the mask is off."""
    slots, hit = voxel_query(st, query_coords, ranges)
    coords = delinearize(st.ids, st.grid)                      # [V, 3] zyx
    vs = torch.as_tensor(voxel_size, dtype=torch.float32,
                         device=query_xyz.device)
    og = torch.as_tensor(origin, dtype=torch.float32,
                         device=query_xyz.device)
    centers = (coords.flip(1).float() + 0.5) * vs + og
    rel = centers[slots] - query_xyz[:, None, :]
    mask = hit
    if radius is not None:
        mask = mask & ((rel * rel).sum(-1) <= radius * radius)
    # the masked entries gather sparse.py's zero row past the end (JAX's
    # where(mask, features[slots], 0)), so that the gradient's accumulation
    # does not walk every miss through one row
    rows = torch.where(mask, slots, st.features.shape[0])
    feats = _GatherRows.apply(st.features, rows)
    rel = torch.where(mask[..., None], rel, 0.0)
    return rel, feats, mask


def vector_pool(rel_xyz: torch.Tensor, feats: torch.Tensor,
                mask: torch.Tensor, extent: Tuple[float, float, float],
                divisions: Tuple[int, int, int] = (2, 2, 2),
                mode: str = "mean") -> torch.Tensor:
    """Each query's local box of half-size `extent` split into nx·ny·nz
    bins; the neighbours' features pooled per bin (mean or max), bins
    concatenated: [M, K, *] -> [M, nx·ny·nz·C]."""
    m, _, c = feats.shape
    nx, ny, nz = divisions
    ex = torch.as_tensor(extent, dtype=torch.float32, device=feats.device)
    u = rel_xyz / (2 * ex) + 0.5                               # [0, 1)
    inb = ((u >= 0) & (u < 1)).all(-1) & mask
    bx = (u[..., 0] * nx).to(torch.int32).clamp(0, nx - 1)
    by = (u[..., 1] * ny).to(torch.int32).clamp(0, ny - 1)
    bz = (u[..., 2] * nz).to(torch.int32).clamp(0, nz - 1)
    bin_id = (bz * ny + by) * nx + bx                          # [M, K]
    nbin = nx * ny * nz
    onehot = F.one_hot(torch.where(inb, bin_id, nbin).long(),
                       nbin + 1).to(feats.dtype)[..., :nbin]   # [M, K, nbin]
    if mode == "max":
        big = torch.where((onehot > 0).transpose(1, 2)[..., None],
                          feats[:, None], -torch.inf)          # [M, nbin, K, C]
        pooled = big.amax(2)
        pooled = torch.where(torch.isfinite(pooled), pooled, 0.0)
    else:
        sums = torch.einsum("mkc,mkb->mbc", feats, onehot)
        cnt = onehot.sum(1)[..., None]                         # [M, nbin, 1]
        pooled = sums / cnt.clamp_min(1.0)
    return pooled.reshape(m, nbin * c)
