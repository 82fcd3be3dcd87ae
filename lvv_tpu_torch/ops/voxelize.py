"""Fixed-capacity voxelization (counterpart of lvv_tpu/ops/voxelize.py).

Every shape is static (pad and mask), the unique-voxel computation is a
stable sort over linear voxel ids, and the per-voxel buckets are scatters
into fixed [max_voxels, max_points_per_voxel] buffers. Voxel coords are
(z, y, x) int32 (pcdet order); points outside `point_range` are dropped,
and voxels past `max_voxels` (the highest ids) and points past
`max_points_per_voxel` are dropped in sorted-id order.

Points are binned in fp32 exactly as `_point_voxel_ids` does: the range
origin and the voxel size rounded to fp32, a true division (the constants
are device tensors, never host scalars, which CUDA's division would turn
into a multiplication by the reciprocal), floor, int32; so the coords are
bit-equal to the JAX package's.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .segment import run_ranks_sorted, run_starts, segment_sum

INT32_MAX = torch.iinfo(torch.int32).max


class VoxelGrid(NamedTuple):
    """Static voxel-grid geometry derived from range + voxel size."""
    point_range: Tuple[float, ...]       # (x0, y0, z0, x1, y1, z1)
    voxel_size: Tuple[float, ...]        # (vx, vy, vz)
    grid_size: Tuple[int, int, int]      # (nx, ny, nz)

    @staticmethod
    def create(point_range, voxel_size) -> "VoxelGrid":
        nx = int(round((point_range[3] - point_range[0]) / voxel_size[0]))
        ny = int(round((point_range[4] - point_range[1]) / voxel_size[1]))
        nz = int(round((point_range[5] - point_range[2]) / voxel_size[2]))
        return VoxelGrid(tuple(point_range), tuple(voxel_size), (nx, ny, nz))


class Voxels(NamedTuple):
    """Fixed-capacity voxelization result (one sample).

    features:  [V, P, F] per-voxel point buckets (zero-padded), or [V, F]
               means (`voxelize_mean`)
    coords:    [V, 3] int32 (z, y, x); invalid slots are -1
    num_points:[V] int32 points captured per voxel
    num_voxels:[] int32 number of valid voxel slots
    point_voxel: [N] int32 voxel slot of each input point (-1 = dropped)
    """
    features: torch.Tensor
    coords: torch.Tensor
    num_points: torch.Tensor
    num_voxels: torch.Tensor
    point_voxel: torch.Tensor


def _point_voxel_ids(points: torch.Tensor, num_points, grid: VoxelGrid):
    """Linear voxel id per point (int32); invalid -> INT32_MAX."""
    n = points.shape[0]
    nx, ny, nz = grid.grid_size
    dev = points.device

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    axes = []
    for a in range(3):
        q = torch.floor((points[:, a].float() - f32(grid.point_range[a]))
                        / f32(grid.voxel_size[a]))
        axes.append(q.to(torch.int32))
    xi, yi, zi = axes
    in_range = ((xi >= 0) & (xi < nx) & (yi >= 0) & (yi < ny)
                & (zi >= 0) & (zi < nz))
    num_points = torch.as_tensor(num_points, device=dev)
    valid = in_range & (torch.arange(n, device=dev) < num_points)
    lin = (zi.long() * ny + yi.long()) * nx + xi.long()
    return torch.where(valid, lin, INT32_MAX).to(torch.int32)


def _sorted_runs(points, num_points, grid: VoxelGrid, max_voxels: int):
    """The shared front of both voxelizers: (order, sorted ids, sorted
    points, run starts, voxel rank of each sorted point, num_voxels)."""
    ids = _point_voxel_ids(points, num_points, grid)
    order = torch.argsort(ids, stable=True)
    s_ids, s_pts = ids[order], points[order]
    start = run_starts(s_ids) & (s_ids != INT32_MAX)
    voxel_rank = torch.cumsum(start.to(torch.int32), 0,
                              dtype=torch.int32) - 1
    from .sparse import report_overflow
    report_overflow("voxelize", voxel_rank[-1] + 1, max_voxels)
    num_voxels = (voxel_rank[-1] + 1).clamp(0, max_voxels)
    return order, s_ids, s_pts, start, voxel_rank, num_voxels


def _coords_and_point_voxel(order, s_ids, start, voxel_rank, keep,
                            grid: VoxelGrid, max_voxels: int):
    """coords [V, 3] of each voxel slot (from its run's first id) and the
    voxel slot of each input point."""
    start_keep = start & (voxel_rank < max_voxels)
    coord_ids = s_ids.new_full((max_voxels + 1,), INT32_MAX)
    coord_ids[torch.where(start_keep, voxel_rank, max_voxels).long()] = (
        torch.where(start_keep, s_ids, INT32_MAX))
    coord_ids = coord_ids[:max_voxels]
    nx, ny, _ = grid.grid_size
    zyx = torch.stack([coord_ids // (nx * ny), (coord_ids // nx) % ny,
                       coord_ids % nx], 1)
    coords = torch.where((coord_ids != INT32_MAX)[:, None], zyx, -1)
    point_voxel = torch.empty_like(voxel_rank)
    point_voxel[order] = torch.where(keep, voxel_rank, -1)
    return coords.to(torch.int32), point_voxel


def voxelize(points: torch.Tensor, num_points, grid: VoxelGrid,
             max_voxels: int, max_points_per_voxel: int) -> Voxels:
    """points [N, F] (x, y, z, ...; zero-padded rows), num_points [] int."""
    n, f = points.shape
    order, s_ids, s_pts, start, voxel_rank, num_voxels = _sorted_runs(
        points, num_points, grid, max_voxels)
    within = run_ranks_sorted(s_ids)
    keep = ((s_ids != INT32_MAX) & (voxel_rank < max_voxels)
            & (within < max_points_per_voxel))
    slot_v = torch.where(keep, voxel_rank, max_voxels).long()  # overflow row
    slot_p = torch.where(keep, within, 0).long()
    features = points.new_zeros((max_voxels + 1, max_points_per_voxel, f))
    features[slot_v, slot_p] = torch.where(keep[:, None], s_pts, 0.0)
    counts = segment_sum(keep.to(torch.int32), slot_v, max_voxels + 1)
    coords, point_voxel = _coords_and_point_voxel(
        order, s_ids, start, voxel_rank, keep, grid, max_voxels)
    return Voxels(features[:max_voxels], coords, counts[:max_voxels],
                  num_voxels, point_voxel)


def voxelize_mean(points: torch.Tensor, num_points, grid: VoxelGrid,
                  max_voxels: int) -> Voxels:
    """Voxelize and MeanVFE in one: the per-voxel mean of every in-range
    point's features (no max_points_per_voxel truncation), features [V, F],
    num_points the contributing counts."""
    order, s_ids, s_pts, start, voxel_rank, num_voxels = _sorted_runs(
        points, num_points, grid, max_voxels)
    keep = (s_ids != INT32_MAX) & (voxel_rank < max_voxels)
    slot = torch.where(keep, voxel_rank, max_voxels)
    sums = segment_sum(torch.where(keep[:, None], s_pts, 0.0), slot,
                       max_voxels + 1)[:max_voxels]
    counts = segment_sum(keep.to(torch.int32), slot,
                         max_voxels + 1)[:max_voxels]
    means = sums / counts.clamp_min(1)[:, None].to(points.dtype)
    coords, point_voxel = _coords_and_point_voxel(
        order, s_ids, start, voxel_rank, keep, grid, max_voxels)
    return Voxels(means, coords, counts, num_voxels, point_voxel)


def mean_vfe(voxels: Voxels) -> torch.Tensor:
    """MeanVFE over bucketed voxels: [V, P, F] -> [V, F] masked mean."""
    v, p, f = voxels.features.shape
    mask = (torch.arange(p, device=voxels.features.device)[None, :]
            < voxels.num_points[:, None])
    total = (voxels.features * mask[..., None]).sum(1)
    return total / voxels.num_points.clamp_min(1)[:, None].to(
        voxels.features.dtype)
