"""Sparse convolution as gather-GEMM over sorted voxel ids (counterpart of
lvv_tpu/ops/sparse.py).

A `SparseTensor` is (ids, features, grid): `ids` are linear voxel coords
sorted ascending, SENTINEL-padded to a fixed capacity; `features` the
matching [V, C] rows (zeros in padded slots). Every op keeps the JAX
package's fixed shapes and index algebra, so active sets (ids) are
bit-equal to its; features agree to fp32 reduction order.

- Neighbour lookups go through a dense occupancy table (cell -> slot, -1
  if empty) where the grid fits `_DENSE_LOOKUP_MAX_CELLS`, else a binary
  search (`torch.searchsorted`).
- Submanifold conv: one [V, K, Cin] gather (a zero row stands in for a
  missing neighbour) and one GEMM with the [K·Cin, Cout] weights.
- Strided conv: output-centric where both grids fit the table (an
  occupancy bitmap of the output grid, its cumsum, and a gather of each
  output site's K inputs), else the scatter form (unique over K·V output
  ids, segment sum).
- XLA drops scatter writes at out-of-range indices (`mode="drop"`); here
  each such write is sent to a spare row that is sliced off, so no index
  is ever out of bounds and nothing is read back to the host.

Telemetry: with `set_overflow_debug(True)` every capacity-bound op reads
its true demand on the host (a synchronisation), records it in
`overflow_log()` and prints a warning when it truncates; off (the
default), the ops issue no synchronisation at all.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from .segment import segment_sum, unique_with_inverse

SENTINEL = int(np.iinfo(np.int32).max)

# --------------------------------------------------------------- telemetry
_OVERFLOW_DEBUG = False
_OVERFLOW_LOG: dict = {}


def set_overflow_debug(enabled: bool) -> None:
    """Turn overflow reporting on or off for every fixed-capacity op
    (sparse_conv, bev_collapse, merge_add, the voxelizer)."""
    global _OVERFLOW_DEBUG
    _OVERFLOW_DEBUG = bool(enabled)


def overflow_debug_enabled() -> bool:
    return _OVERFLOW_DEBUG


def overflow_log() -> dict:
    """"tag@cap" -> {"demand": most true sites seen, "cap": capacity,
    "dropped": most sites dropped}, recorded while debugging was on."""
    return {k: dict(v) for k, v in _OVERFLOW_LOG.items()}


def reset_overflow_log() -> None:
    _OVERFLOW_LOG.clear()


def report_overflow(tag: str, num_true: torch.Tensor, capacity: int) -> None:
    """With debugging on: record the demand `num_true` against `capacity`
    and print `[capacity-overflow] ...` when it truncates."""
    if not _OVERFLOW_DEBUG:
        return
    n, cap = int(num_true), int(capacity)
    e = _OVERFLOW_LOG.setdefault(f"{tag}@{cap}",
                                 {"demand": 0, "cap": cap, "dropped": 0})
    e["demand"] = max(e["demand"], n)
    e["dropped"] = max(e["dropped"], max(n - cap, 0))
    if n > cap:
        print(f"[capacity-overflow] {tag}: true {n} > cap {cap} — sites "
              "dropped")


class SparseTensor(NamedTuple):
    """Fixed-capacity sparse voxel tensor over a static dense grid.

    ids: [V] int32 linear coords, sorted ascending, SENTINEL padding.
    features: [V, C] float; rows of padded slots are zeros.
    grid: static (nx, ny, nz); nz == 1 for 2D maps.
    """
    ids: torch.Tensor
    features: torch.Tensor
    grid: Tuple[int, int, int]

    @property
    def valid(self) -> torch.Tensor:
        return self.ids != SENTINEL

    def num_active(self) -> torch.Tensor:
        return self.valid.sum(dtype=torch.int32)


def linearize(coords_zyx: torch.Tensor, grid) -> torch.Tensor:
    """[..., 3] (z, y, x) -> int32 linear ids; outside the grid ->
    SENTINEL."""
    nx, ny, nz = grid
    c = coords_zyx.long()
    z, y, x = c[..., 0], c[..., 1], c[..., 2]
    ok = (z >= 0) & (z < nz) & (y >= 0) & (y < ny) & (x >= 0) & (x < nx)
    lin = (z * ny + y) * nx + x
    return torch.where(ok, lin, SENTINEL).to(torch.int32)


def delinearize(ids: torch.Tensor, grid) -> torch.Tensor:
    """int32 linear ids -> [..., 3] (z, y, x); SENTINEL -> -1."""
    nx, ny, _ = grid
    out = torch.stack([ids // (nx * ny), (ids // nx) % ny, ids % nx], -1)
    return torch.where((ids == SENTINEL)[..., None], -1, out).to(torch.int32)


def _sorted(ids: torch.Tensor, features: torch.Tensor, grid) -> SparseTensor:
    """ids (SENTINEL where invalid) and their rows, sorted by id, invalid
    rows zeroed."""
    order = torch.argsort(ids, stable=True)
    ids = ids[order]
    feats = torch.where((ids != SENTINEL)[:, None], features[order], 0.0)
    return SparseTensor(ids, feats, tuple(grid))


def from_voxels(coords_zyx: torch.Tensor, features: torch.Tensor,
                grid) -> SparseTensor:
    """From the voxelizer's output (coords may be -1-padded, any order)."""
    ids = linearize(coords_zyx.clamp_min(0), grid)
    ids = torch.where((coords_zyx >= 0).all(1), ids, SENTINEL)
    return _sorted(ids, features, grid)


def _offsets(kernel: int, ndim2d: bool) -> np.ndarray:
    """Kernel offsets [(dz, dy, dx)] centred at 0."""
    r = range(-(kernel // 2), kernel // 2 + 1)
    if ndim2d:
        return np.array([(0, dy, dx) for dy in r for dx in r], np.int32)
    return np.array([(dz, dy, dx) for dz in r for dy in r for dx in r],
                    np.int32)


def _lookup(sorted_ids: torch.Tensor, query: torch.Tensor):
    """(slot, hit) of `query` in `sorted_ids` by binary search (grids too
    large for an occupancy table)."""
    slot = torch.searchsorted(sorted_ids, query.contiguous())
    slot = slot.clamp_max(sorted_ids.shape[0] - 1)
    hit = (sorted_ids[slot] == query) & (query != SENTINEL)
    return slot.to(torch.int32), hit


# Dense occupancy tables above this cell count (int32 -> 512 MB) fall back
# to binary search. nuScenes at 0.075 m is 1440·1440·40 = 83M cells.
_DENSE_LOOKUP_MAX_CELLS = 128 * 1024 * 1024


def _fits(grid) -> bool:
    nx, ny, nz = grid
    return nx * ny * nz <= _DENSE_LOOKUP_MAX_CELLS


def _occupancy_table(st: SparseTensor) -> torch.Tensor:
    """[ncells + 1] int32: cell -> active slot, -1 if empty; the last cell
    (-1) answers SENTINEL and out-of-grid queries. Valid ids are unique;
    invalid rows write a spare cell past the end, sliced off."""
    nx, ny, nz = st.grid
    ncells = nx * ny * nz
    v = st.ids.shape[0]
    idx = torch.where(st.valid, st.ids, ncells + 1).long()
    table = torch.full((ncells + 2,), -1, dtype=torch.int32,
                       device=st.ids.device)
    table[idx] = torch.arange(v, dtype=torch.int32, device=st.ids.device)
    return table[:ncells + 1]


def _table_lookup(table: torch.Tensor, query: torch.Tensor):
    """(slot, hit) of linear-id queries against an occupancy table."""
    ncells = table.shape[0] - 1
    q = torch.where((query >= 0) & (query < ncells), query, ncells).long()
    slot = table[q]
    return slot.clamp_min(0), slot >= 0


def _find(st: SparseTensor, table, query: torch.Tensor):
    return (_table_lookup(table, query) if table is not None
            else _lookup(st.ids, query))


def _offsets_t(kernel: int, ndim2d: bool, device) -> torch.Tensor:
    return torch.as_tensor(_offsets(kernel, ndim2d), device=device)


def build_subm_rulebook(st: SparseTensor, kernel: int = 3,
                        ndim2d: bool = False):
    """Neighbour rulebook of a submanifold conv: (slot [K, V] int32, hit
    [K, V] bool), one build per active set (every subm conv on it shares
    it). The centre offset is (arange(V), valid)."""
    offs = _offsets(kernel, ndim2d)
    offs_t = torch.as_tensor(offs, device=st.ids.device)
    coords = delinearize(st.ids, st.grid)
    table = _occupancy_table(st) if _fits(st.grid) else None
    nid = linearize(coords[None] + offs_t[:, None], st.grid)
    nid = torch.where(st.valid[None], nid, SENTINEL)
    slot, hit = _find(st, table, nid)
    centre = int(np.flatnonzero((offs == 0).all(1))[0])
    slot[centre] = torch.arange(st.ids.shape[0], dtype=torch.int32,
                                device=st.ids.device)
    hit[centre] = st.valid
    return slot, hit


class _GatherRows(torch.autograd.Function):
    """features [V, C] -> [*rows.shape, C]: row `rows[i]` of features, or
    zeros where rows[i] == V (a zero row past the end). Its gradient adds
    each gathered row's gradient back into its row (a sorted
    `index_put_(accumulate=True)`), the zero row's left out: autograd's own
    transpose would send every miss, most of a sparse conv's K·Vout
    entries, to that one row, whose run of millions the sorted
    accumulation walks serially (a default_config() train step took 18 s
    on an H100 with it, 0.2 s without)."""

    @staticmethod
    def forward(ctx, features, rows):
        ctx.save_for_backward(rows)
        ctx.v = features.shape[0]
        return torch.cat([features, features.new_zeros((1,) + features.shape[
            1:])])[rows]

    @staticmethod
    def backward(ctx, grad):
        rows, = ctx.saved_tensors
        v = ctx.v
        rows = rows.reshape(-1)
        grad = grad.reshape(rows.shape[0], -1)
        hit = rows < v
        # misses add zeros, spread over the real rows (no long run)
        spread = torch.arange(rows.shape[0], device=rows.device) % v
        out = grad.new_zeros((v, grad.shape[1]))
        out.index_put_((torch.where(hit, rows, spread),),
                       torch.where(hit[:, None], grad, 0.0), accumulate=True)
        return out, None


def gather_rows(features: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """features [V, C] at `rows` (any shape, int64), a zero row where rows
    == V; the gradient skips those (`_GatherRows`): a masked gather whose
    masked entries would otherwise all accumulate into one row."""
    return _GatherRows.apply(features, rows)


def wide(t: torch.Tensor) -> torch.Tensor:
    """t in fp32, or as it is in float64 (a float64 model's reference
    run); the weights of a product follow their features."""
    return t if t.dtype == torch.float64 else t.float()


def _gather_gemm(features: torch.Tensor, slot: torch.Tensor,
                 hit: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """sum_k where(hit[k], features[slot[k]], 0) @ weights[k] in fp32 (or
    float64): features [V, Cin], slot / hit [K, Vout], weights [K, Cin,
    Cout] -> [Vout, Cout]. One [Vout, K, Cin] gather (a zero row past the
    end for the misses; `_GatherRows`) and one GEMM."""
    k, cin, cout = weights.shape
    miss = torch.full_like(slot, features.shape[0])
    rows = torch.where(hit, slot, miss).t().long()            # [Vout, K]
    features = wide(features)
    return _GatherRows.apply(features, rows).reshape(
        -1, k * cin) @ weights.to(features.dtype).reshape(k * cin, cout)


def _finish(out, bias, valid, dtype) -> torch.Tensor:
    if bias is not None:
        out = out + bias.to(out.dtype)
    return torch.where(valid[:, None], out, 0.0).to(dtype)


def submanifold_conv(st: SparseTensor, weights: torch.Tensor,
                     bias: torch.Tensor | None = None, kernel: int = 3,
                     ndim2d: bool = False, rulebook=None) -> SparseTensor:
    """SubMConv (spconv SubMConv3d / SubMConv2d): the active set is kept.
    weights [K^d, Cin, Cout] in `_offsets` order; pass a `rulebook` from
    `build_subm_rulebook` to share it across convs on one active set."""
    slot, hit = (rulebook if rulebook is not None
                 else build_subm_rulebook(st, kernel, ndim2d))
    out = _gather_gemm(st.features, slot, hit, weights)
    return SparseTensor(st.ids, _finish(out, bias, st.valid,
                                        st.features.dtype), st.grid)


def _strides_shift(kernel, stride, padding, ndim2d, device):
    """(strides [3], shift [3]) (z, y, x) of a strided conv: coarse =
    (fine + shift - k') / stride per axis, z unstrided for 2D maps."""
    strides = torch.tensor([1 if ndim2d else stride, stride, stride],
                           dtype=torch.int32, device=device)
    shift = (padding - kernel // 2) * torch.tensor(
        [0 if ndim2d else 1, 1, 1], dtype=torch.int32, device=device)
    return strides, shift


def _coarse_ids(coords, strides, shift, offs, grid):
    """[K, V] linear ids on `grid` of the coarse site each fine coord
    reaches through each offset, SENTINEL where not divisible."""
    shifted = coords[None] + shift - offs[:, None]             # [K, V, 3]
    divisible = (shifted % strides == 0).all(-1)
    ids = linearize(torch.div(shifted, strides, rounding_mode="floor"),
                    grid)
    return torch.where(divisible, ids, SENTINEL)


def sparse_conv(st: SparseTensor, weights: torch.Tensor,
                bias: torch.Tensor | None = None, kernel: int = 3,
                stride: int = 2, padding: int = 1,
                out_capacity: int | None = None,
                ndim2d: bool = False) -> SparseTensor:
    """Strided sparse conv (spconv SparseConv3d / 2d): a new active set of
    `out_capacity` sites (the lowest ids kept), over the grid
    ceil(grid / stride) (z unstrided for 2D maps)."""
    out_capacity = out_capacity or st.ids.shape[0]
    nx, ny, nz = st.grid
    sz = 1 if ndim2d else stride
    out_grid = (-(-nx // stride), -(-ny // stride), -(-nz // sz))
    strides, shift = _strides_shift(kernel, stride, padding, ndim2d,
                                    st.ids.device)
    offs = _offsets_t(kernel, ndim2d, st.ids.device)
    oid = _coarse_ids(delinearize(st.ids, st.grid), strides, shift, offs,
                      out_grid)
    oid = torch.where(st.valid[None], oid, SENTINEL)           # [K, V]
    if _fits(out_grid) and _fits(st.grid):
        return _sparse_conv_gather(st, weights, bias, out_capacity,
                                   out_grid, strides, shift, offs, oid)
    # scatter form: input c reaches output (c + shift - k') / stride where
    # divisible
    all_ids = oid.reshape(-1)                                  # [K·V]
    # out_capacity + 1 slots: the last is the overflow dump, so that sites
    # past the capacity are dropped, not summed into the last live row
    uids, inverse, _, n_unique = unique_with_inverse(
        all_ids, SENTINEL, out_capacity + 1)
    report_overflow("sparse_conv", n_unique, out_capacity)
    x = wide(st.features)
    feats = torch.einsum("vc,kcd->kvd", x, weights.to(x.dtype)).reshape(
        -1, weights.shape[-1])
    live = (all_ids != SENTINEL) & (inverse < out_capacity)
    seg = torch.where(live, inverse, out_capacity)
    out = segment_sum(torch.where(live[:, None], feats, 0.0), seg,
                      out_capacity + 1)[:out_capacity]
    uids = uids[:out_capacity]
    return SparseTensor(uids, _finish(out, bias, uids != SENTINEL,
                                      st.features.dtype), out_grid)


def _sparse_conv_gather(st, weights, bias, out_capacity, out_grid, strides,
                        shift, offs, oid) -> SparseTensor:
    """Output-centric strided conv: occupancy bitmap of the output grid
    (from `oid`, the output site of each input and offset), the first
    `out_capacity` occupied cells in id order, then each output site
    gathers its K inputs (in = out·stride - shift + k')."""
    dev = st.ids.device
    ncells_out = out_grid[0] * out_grid[1] * out_grid[2]
    idx = torch.where(oid != SENTINEL, oid, ncells_out)
    occ = torch.zeros(ncells_out + 1, dtype=torch.int32, device=dev)
    occ[idx.reshape(-1).long()] = 1
    occ[ncells_out] = 0
    # the j-th occupied cell is where the running count first reaches j + 1
    # (a search, not a scatter of every cell into a dump slot)
    count = torch.cumsum(occ, 0, dtype=torch.int32)
    report_overflow("sparse_conv", count[-1], out_capacity)
    want = torch.arange(1, out_capacity + 1, dtype=torch.int32, device=dev)
    cell = torch.searchsorted(count, want).to(torch.int32)
    uids = torch.where(cell < ncells_out, cell, SENTINEL)
    out_valid = uids != SENTINEL
    out_coords = delinearize(uids, out_grid)
    in_coord = out_coords[None] * strides - shift + offs[:, None]
    iid = linearize(torch.where(out_valid[None, :, None], in_coord, -1),
                    st.grid)
    slot, hit = _table_lookup(_occupancy_table(st), iid)
    out = _gather_gemm(st.features, slot, hit, weights)
    return SparseTensor(uids, _finish(out, bias, out_valid,
                                      st.features.dtype), out_grid)


def inverse_conv(st: SparseTensor, target_ids: torch.Tensor, target_grid,
                 weights: torch.Tensor, bias: torch.Tensor | None = None,
                 kernel: int = 3, stride: int = 2, padding: int = 1,
                 ndim2d: bool = False) -> SparseTensor:
    """Inverse sparse conv (spconv SparseInverseConv3d): features back onto
    a known finer active set `target_ids` on `target_grid`. Fine site f
    takes, through offset k, coarse site (f + shift - k) / stride where
    divisible. weights [K^d, Cin (coarse), Cout]."""
    target_grid = tuple(target_grid)
    offs = _offsets_t(kernel, ndim2d, st.ids.device)
    valid_t = target_ids != SENTINEL
    strides, shift = _strides_shift(kernel, stride, padding, ndim2d,
                                    st.ids.device)
    gid = _coarse_ids(delinearize(target_ids, target_grid), strides, shift,
                      offs, st.grid)
    gid = torch.where(valid_t[None], gid, SENTINEL)
    table = _occupancy_table(st) if _fits(st.grid) else None
    slot, hit = _find(st, table, gid)
    out = _gather_gemm(st.features, slot, hit, weights)
    return SparseTensor(target_ids, _finish(out, bias, valid_t,
                                            st.features.dtype), target_grid)


def _segment_into(ids, features, cap: int, tag: str, grid) -> SparseTensor:
    """unique over `ids` with `cap` live slots (+ an overflow dump) and the
    features summed into them."""
    uids, inverse, _, n_unique = unique_with_inverse(ids, SENTINEL, cap + 1)
    report_overflow(tag, n_unique, cap)
    live = (ids != SENTINEL) & (inverse < cap)
    seg = torch.where(live, inverse, cap)
    out = segment_sum(torch.where(live[:, None], features, 0.0), seg,
                      cap + 1)[:cap]
    uids = uids[:cap]
    out = torch.where((uids != SENTINEL)[:, None], out, 0.0)
    return SparseTensor(uids, out.to(features.dtype), grid)


def bev_collapse(st: SparseTensor, bev_capacity: int | None = None
                 ) -> SparseTensor:
    """Sum features over z per (y, x) site (the reference's `bev_out`):
    a 2D SparseTensor (nz == 1)."""
    nx, ny, _ = st.grid
    coords = delinearize(st.ids, st.grid)
    yx = torch.where(st.valid, coords[:, 1] * nx + coords[:, 2], SENTINEL)
    return _segment_into(yx.to(torch.int32), st.features,
                         bev_capacity or st.ids.shape[0], "bev_collapse",
                         (nx, ny, 1))


def reindex_upscale(st: SparseTensor, factor: int,
                    target_grid) -> SparseTensor:
    """Coarser-stride coords scaled onto a finer grid (y and x times
    `factor`): the stage-5/6 features re-indexed into stride-8 coords."""
    coords = delinearize(st.ids, st.grid)
    scale = torch.tensor([1, factor, factor], dtype=torch.int32,
                         device=st.ids.device)
    ids = torch.where(st.valid, linearize(coords * scale, target_grid),
                      SENTINEL)
    return _sorted(ids, st.features, target_grid)


def merge_add(a: SparseTensor, b: SparseTensor,
              capacity: int | None = None) -> SparseTensor:
    """Union of the active sets, features summed at shared sites."""
    assert a.grid == b.grid
    return _segment_into(torch.cat([a.ids, b.ids]),
                         torch.cat([a.features, b.features]),
                         capacity or a.ids.shape[0], "merge_add", a.grid)


def to_dense(st: SparseTensor) -> torch.Tensor:
    """-> [C, nz, ny, nx] dense (SparseConvTensor.dense()); index [:, 0] of
    a 2D tensor for [C, H, W]."""
    nx, ny, nz = st.grid
    ncells = nx * ny * nz
    flat = st.features.new_zeros((ncells + 1, st.features.shape[1]))
    flat.index_add_(0, torch.where(st.valid, st.ids, ncells).long(),
                    st.features)
    return flat[:-1].reshape(nz, ny, nx, -1).permute(3, 0, 1, 2)


# ------------------------------------------------------------------ planning

def plan_capacity_demand(points_xyz: np.ndarray, grid_cfg,
                         n_stages: int = 5) -> tuple:
    """Exact per-stage active-site demand of one cloud, on the host in
    numpy: the voxelizer's quantisation, then the backbone's stride-2
    (kernel 3, pad 1) chain. Returns (n_voxels, (stage 1 demand, ...,
    stage n demand)), aligned with VoxelNeXtConfig.capacity_schedule."""
    nx, ny, nz = grid_cfg.grid_size
    x0, y0, z0 = grid_cfg.point_range[:3]
    vx, vy, vz = grid_cfg.voxel_size
    xi = np.floor((points_xyz[:, 0] - x0) / vx).astype(np.int64)
    yi = np.floor((points_xyz[:, 1] - y0) / vy).astype(np.int64)
    zi = np.floor((points_xyz[:, 2] - z0) / vz).astype(np.int64)
    ok = ((xi >= 0) & (xi < nx) & (yi >= 0) & (yi < ny)
          & (zi >= 0) & (zi < nz))
    dims = np.array([nz, ny, nx], np.int64)
    lin = np.unique((zi[ok] * dims[1] + yi[ok]) * dims[2] + xi[ok])
    n_voxels = int(lin.size)
    demands = []
    for _ in range(n_stages):
        z = lin // (dims[1] * dims[2])
        y = (lin // dims[2]) % dims[1]
        x = lin % dims[2]
        out_dims = -(-dims // 2)
        # per axis: even c -> {c // 2}, odd c -> {(c - 1) // 2, (c + 1) // 2}
        cands = []
        for c, n_out in zip((z, y, x), out_dims):
            lo = np.where(c % 2 == 1, (c - 1) // 2, c // 2)
            hi = np.where(c % 2 == 1, (c + 1) // 2, c // 2)
            cands.append((lo, np.where(hi < n_out, hi, lo)))
        outs = [(az * out_dims[1] + ay) * out_dims[2] + ax
                for az in cands[0] for ay in cands[1] for ax in cands[2]]
        lin = np.unique(np.concatenate(outs))
        dims = out_dims
        demands.append(int(lin.size))
    return n_voxels, tuple(demands)


def pick_capacity_bucket(demands: tuple, buckets: tuple) -> int:
    """Index of the smallest bucket (cap0, schedule) whose capacities
    cover `demands` (no drops); else the last (largest)."""
    n_vox, stages = demands
    for i, (cap0, sched) in enumerate(buckets):
        if n_vox <= cap0 and all(s <= c for s, c in zip(stages, sched)):
            return i
    return len(buckets) - 1
