"""BEV pooling of lifted camera features (counterpart of `bev_pool` in
lvv_tpu/ops/pool.py; the rest of that module, the RoI and point pools,
comes with the two-stage families).

`bev_pool` is a masked segment sum: each frustum point's feature vector
adds into its BEV bin, invalid points into a spare bin that is dropped. On
the card `index_add_` adds with float atomics in any order, so its sums
agree with the CPU's to fp32 reduction order only.
"""
from __future__ import annotations

import torch

from .segment import segment_sum


def bev_pool(features: torch.Tensor, bev_ids: torch.Tensor,
             valid: torch.Tensor, num_bins: int) -> torch.Tensor:
    """Sum the features sharing a BEV bin. features [N, C], bev_ids [N]
    (linear bin ids), valid [N] bool -> [num_bins, C]."""
    ids = torch.where(valid, bev_ids.long(), num_bins)
    feats = torch.where(valid[:, None], features, 0.0)
    return segment_sum(feats, ids, num_bins + 1)[:num_bins]
