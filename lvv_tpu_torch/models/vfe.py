"""Dynamic pillar and voxel feature encoders (counterpart of
lvv_tpu/models/vfe.py).

"Dynamic": no cap on a pillar's or voxel's points; every in-range point
is decorated, goes through a pointwise Dense + LayerNorm + ReLU, and is
max-pooled into its slot by a segment max.

- `point_pillar_slots`: each point's pillar slot over the xy grid (one
  sort and a fixed-capacity unique; slot `max_pillars` is the dump of
  dropped and overflowing points), the pillars' (0, y, x) coords and point
  counts.
- `DynamicPillarVFE`: points decorated with their offset from the
  pillar's point mean (`use_cluster`) and from its centre;
  `DynamicPillarVFESimple2D` without the mean.
- `DynamicVoxelVFE`: the same over true 3D voxels (ids from
  `ops.voxelize._point_voxel_ids`); with `num_layers=2`, as the DSVT
  presets run it, the first layer's pooled feature is concatenated back
  onto each of its points before the second layer.

Every norm is flax's nn.LayerNorm (`flax_layer_norm`: eps 1e-6, one-pass
variance). Points that are not valid pool as -inf, and pooled rows that
are not finite (empty slots) become 0, as in JAX. The segment max is
`ops.segment.segment_max` (a scatter "amax"), whose gradient splits
evenly among tied winners, as JAX's scatter-max rule does. The grid's
origin and voxel size enter the binning as fp32 device tensors, so the
ids are bit-equal to JAX's.
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops.segment import segment_max, segment_mean, unique_with_inverse
from ..ops.sparse import gather_rows, report_overflow
from ..ops.voxelize import INT32_MAX, VoxelGrid, Voxels, _point_voxel_ids
from .pointpillars import Dense, FlaxLayerNorm


def _f32(v, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=device)


def point_pillar_slots(points: torch.Tensor, num_points, grid: VoxelGrid,
                       max_pillars: int):
    """-> (slot [N] int32 in [0, max_pillars], valid [N], coords
    [max_pillars, 3] (0, y, x) int32, -1 where empty, counts
    [max_pillars]). slot == max_pillars marks dropped and overflowing
    points."""
    dev = points.device
    nx, ny = grid.grid_size[0], grid.grid_size[1]
    pts = points.float()
    xi = torch.floor((pts[:, 0] - _f32(grid.point_range[0], dev))
                     / _f32(grid.voxel_size[0], dev)).to(torch.int32)
    yi = torch.floor((pts[:, 1] - _f32(grid.point_range[1], dev))
                     / _f32(grid.voxel_size[1], dev)).to(torch.int32)
    zok = ((pts[:, 2] >= _f32(grid.point_range[2], dev))
           & (pts[:, 2] <= _f32(grid.point_range[5], dev)))
    num_points = torch.as_tensor(num_points, device=dev)
    valid = ((torch.arange(points.shape[0], device=dev) < num_points)
             & (xi >= 0) & (xi < nx) & (yi >= 0) & (yi < ny) & zok)
    pid = torch.where(valid, yi * nx + xi, INT32_MAX).to(torch.int32)
    # max_pillars + 1 slots: the last is the dump, so that an overflowing
    # pillar is dropped instead of aliased into slot max_pillars - 1
    uids, inverse, counts, n_unique = unique_with_inverse(
        pid, INT32_MAX, max_pillars + 1)
    report_overflow("dynamic_pillar_vfe", n_unique, max_pillars)
    slot = torch.where(valid & (inverse < max_pillars), inverse, max_pillars)
    valid = valid & (slot < max_pillars)
    uids = uids[:max_pillars]
    coords = torch.stack([torch.zeros_like(uids), uids // nx, uids % nx], 1)
    coords = torch.where((uids != INT32_MAX)[:, None], coords, -1)
    return (slot.to(torch.int32), valid, coords.to(torch.int32),
            counts[:max_pillars])


def _pool(h: torch.Tensor, valid: torch.Tensor, slot: torch.Tensor,
          cap: int) -> torch.Tensor:
    """Segment max of each valid point's row into its slot (cap slots and
    the dump), empty slots 0."""
    h = torch.where(valid[:, None], h, -torch.inf)
    pooled = segment_max(h, torch.where(valid, slot, cap), cap + 1)[:cap]
    return torch.where(torch.isfinite(pooled), pooled, 0.0)


class DynamicPillarVFE(nn.Module):
    """Decorated points ([x, y, z, i, (x, y, z) - pillar mean, (x, y) -
    pillar centre]) -> Dense + LayerNorm + ReLU -> max per pillar."""

    use_cluster = True

    def __init__(self, cin: int = 4, out_ch: int = 64, *, device):
        super().__init__()
        extra = 5 if self.use_cluster else 2
        self.fc = Dense(cin + extra, out_ch, device=device)
        self.ln = FlaxLayerNorm(out_ch, device=device)

    def forward(self, points: torch.Tensor, num_points, grid: VoxelGrid,
                max_pillars: int) -> Voxels:
        slot, valid, coords, counts = point_pillar_slots(
            points, num_points, grid, max_pillars)
        parts = [points]
        safe = slot.clamp_max(max_pillars - 1).long()
        if self.use_cluster:
            mean_xyz = segment_mean(
                torch.where(valid[:, None], points[:, :3], 0.0), slot,
                max_pillars + 1)[:max_pillars]
            parts.append(points[:, :3] - mean_xyz[safe])
        cx = ((coords[:, 2].float() + 0.5) * grid.voxel_size[0]
              + grid.point_range[0])
        cy = ((coords[:, 1].float() + 0.5) * grid.voxel_size[1]
              + grid.point_range[1])
        parts.append(torch.stack([points[:, 0] - cx[safe],
                                  points[:, 1] - cy[safe]], 1))
        dec = torch.where(valid[:, None], torch.cat(parts, 1), 0.0)
        h = torch.relu(self.ln(self.fc(dec)))
        return Voxels(features=_pool(h, valid, slot, max_pillars),
                      coords=coords, num_points=counts,
                      num_voxels=(coords[:, 0] >= 0).sum(dtype=torch.int32),
                      point_voxel=torch.where(valid, slot, -1))


class DynamicPillarVFESimple2D(DynamicPillarVFE):
    """The centre offset only ([x, y, z, i, (x, y) - pillar centre])."""

    use_cluster = False


class DynamicVoxelVFE(nn.Module):
    """Decorated points ([x, y, z, i, (x, y, z) - voxel mean, (x, y, z) -
    voxel centre]) over 3D voxels -> `num_layers` pointwise Dense +
    LayerNorm + ReLU layers, each max-pooled per voxel; a layer before the
    last concatenates its pooled feature back onto each of its points."""

    def __init__(self, cin: int = 4, out_ch: int = 64, num_layers: int = 1,
                 *, device):
        super().__init__()
        self.num_layers = num_layers
        kw = dict(device=device)
        width = cin + 6
        for li in range(num_layers):
            sfx = str(li) if li else ""
            setattr(self, f"fc{sfx}", Dense(width, out_ch, **kw))
            setattr(self, f"ln{sfx}", FlaxLayerNorm(out_ch, **kw))
            width = 2 * out_ch

    def forward(self, points: torch.Tensor, num_points, grid: VoxelGrid,
                max_voxels: int) -> Voxels:
        ids = _point_voxel_ids(points, num_points, grid)
        valid = ids != INT32_MAX
        uids, inverse, counts, n_unique = unique_with_inverse(
            ids, INT32_MAX, max_voxels + 1)
        report_overflow("dynamic_voxel_vfe", n_unique, max_voxels)
        slot = torch.where(valid & (inverse < max_voxels), inverse,
                           max_voxels)
        valid = valid & (slot < max_voxels)
        uids = uids[:max_voxels]
        nx, ny, _ = grid.grid_size
        slot_ok = uids != INT32_MAX
        zyx = torch.stack([uids // (nx * ny), (uids // nx) % ny, uids % nx],
                          1)
        coords = torch.where(slot_ok[:, None], zyx, -1).to(torch.int32)

        dev = points.device
        mean_xyz = segment_mean(
            torch.where(valid[:, None], points[:, :3], 0.0), slot,
            max_voxels + 1)[:max_voxels]
        safe = slot.clamp_max(max_voxels - 1).long()
        vs = _f32(grid.voxel_size, dev)
        origin = _f32(grid.point_range[:3], dev)
        centers = (coords.flip(1).float() + 0.5) * vs + origin
        dec = torch.cat([points, points[:, :3] - mean_xyz[safe],
                         points[:, :3] - centers[safe]], 1)
        h = torch.where(valid[:, None], dec, 0.0)
        # each valid point's voxel row; the others read a zero row and take
        # no gradient (`gather_rows`), where pooled[safe] would sum all of
        # theirs into one voxel
        own = torch.where(valid, slot, max_voxels).long()
        for li in range(self.num_layers):
            sfx = str(li) if li else ""
            h = torch.relu(getattr(self, f"ln{sfx}")(
                getattr(self, f"fc{sfx}")(h)))
            pooled = _pool(h, valid, slot, max_voxels)
            if li < self.num_layers - 1:
                h = torch.where(valid[:, None],
                                torch.cat([h, gather_rows(pooled, own)], 1),
                                0.0)
        return Voxels(features=pooled, coords=coords,
                      num_points=counts[:max_voxels],
                      num_voxels=slot_ok.sum(dtype=torch.int32),
                      point_voxel=torch.where(valid, slot, -1))
