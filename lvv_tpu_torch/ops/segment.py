"""Segment and scatter ops (counterpart of lvv_tpu/ops/segment.py).

Fixed-shape, as the JAX package writes them: every output has a static
size, ids past a segment count are dropped, and nothing reads a value back
to the host (no boolean-mask indexing, no `nonzero`), so on the card the
ops issue no synchronisation. Sorts are stable (`torch.argsort(...,
stable=True)`), so the order of equal ids is the input's, as in XLA's
stable sort.

- `segment_sum` / `segment_mean` / `segment_max`: `jax.ops.segment_*`
  with a static segment count (an empty segment's max is the dtype's
  lowest value, -inf for floats). On the card `index_add_` adds in any
  order, so float sums agree to fp32 reduction order only.
- `run_ranks_sorted`, `ingroup_inds`: index of each element within its run
  or group.
- `unique_with_inverse`: fixed-capacity unique with its overflow slot and
  count rules (lvv_tpu/ops/segment.py:67-103).
"""
from __future__ import annotations

import torch


def _drop_out_of_range(segment_ids: torch.Tensor, num_segments: int):
    """ids with everything outside [0, num_segments) sent to the spare
    segment num_segments (dropped afterwards), as int64."""
    ids = segment_ids.long()
    return torch.where((ids >= 0) & (ids < num_segments), ids, num_segments)


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    out = data.new_zeros((num_segments + 1, *data.shape[1:]))
    out.index_add_(0, _drop_out_of_range(segment_ids, num_segments), data)
    return out[:num_segments]


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int, *, eps: float = 1e-12) -> torch.Tensor:
    total = segment_sum(data, segment_ids, num_segments)
    ones = torch.ones(data.shape[:1], dtype=torch.float32, device=data.device)
    count = segment_sum(ones, segment_ids, num_segments)
    return total / count.clamp_min(eps).view(-1, *(1,) * (data.dim() - 1))


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    lowest = (-torch.inf if data.is_floating_point()
              else torch.iinfo(data.dtype).min)
    out = data.new_full((num_segments + 1, *data.shape[1:]), lowest)
    idx = _drop_out_of_range(segment_ids, num_segments)
    idx = idx.view(-1, *(1,) * (data.dim() - 1)).expand_as(data)
    out.scatter_reduce_(0, idx, data, "amax", include_self=True)
    return out[:num_segments]


def run_starts(sorted_ids: torch.Tensor) -> torch.Tensor:
    """For a sorted 1-D array: True where a run of equal ids begins."""
    start = torch.ones_like(sorted_ids, dtype=torch.bool)
    start[1:] = sorted_ids[1:] != sorted_ids[:-1]
    return start


def run_ranks_sorted(ids: torch.Tensor) -> torch.Tensor:
    """For a SORTED 1-D id array: index of each element within its run.

    [3,3,3,7,7,9] -> [0,1,2,0,1,0]
    """
    idx = torch.arange(ids.shape[0], dtype=torch.int32, device=ids.device)
    starts = torch.where(run_starts(ids), idx, torch.zeros_like(idx))
    return idx - torch.cummax(starts, 0).values


def ingroup_inds(group_ids: torch.Tensor,
                 valid: torch.Tensor | None = None) -> torch.Tensor:
    """Running index of each element within its group (unsorted ids).

    Invalid elements (valid False) get index -1 and take no slot."""
    ids = group_ids.to(torch.int32)
    if valid is not None:
        ids = torch.where(valid, ids, torch.iinfo(torch.int32).max)
    order = torch.argsort(ids, stable=True)
    ranks = torch.empty_like(ids)
    ranks[order] = run_ranks_sorted(ids[order])
    if valid is not None:
        ranks = torch.where(valid, ranks, -1)
    return ranks


def unique_with_inverse(ids: torch.Tensor, fill_id: int, max_unique: int):
    """Fixed-capacity unique over a 1-D id array.

    Returns (unique_ids [max_unique], inverse [N] int32, counts
    [max_unique] int32, num_unique [] int32). Ids equal to `fill_id` are
    invalid; slots past num_unique hold `fill_id` and zero counts. Runs
    past the capacity, and invalid elements, all map to the last slot
    (max_unique - 1): its id is the last of them in sorted order (the one
    a serial scatter writes last), its count that of the real runs there
    (zero if none). Callers that reserve that slot as an overflow dump
    drop it."""
    order = torch.argsort(ids, stable=True)
    s = ids[order]
    real = s != fill_id
    start = run_starts(s) & real
    run_rank = torch.cumsum(start.to(torch.int32), 0, dtype=torch.int32) - 1
    num_unique = (run_rank[-1] + 1).clamp_min(0)
    slot = torch.where(real, run_rank, max_unique - 1).clamp_max(
        max_unique - 1)
    inverse = torch.empty_like(slot)
    inverse[order] = slot
    # slot is non-decreasing: the last element of each slot's stretch is
    # the one whose write a serial scatter keeps
    last = torch.ones_like(real)
    last[:-1] = slot[1:] != slot[:-1]
    dump = torch.full_like(slot, max_unique)
    unique_ids = ids.new_full((max_unique + 1,), fill_id)
    unique_ids[torch.where(last, slot, dump).long()] = torch.where(
        real, s, torch.full_like(s, fill_id))
    counts = segment_sum(real.to(torch.int32), slot, max_unique)
    return unique_ids[:max_unique], inverse, counts, num_unique
