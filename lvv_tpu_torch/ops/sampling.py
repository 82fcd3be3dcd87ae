"""Point sampling and grouping: farthest-point sampling, ball query, kNN and
inverse-distance interpolation (counterpart of lvv_tpu/ops/sampling.py).

The picks are discrete, so they follow JAX's exactly:
- squared distances are (dx² + dy²) + dz², each a separate elementwise op
  in that order (no matmul expansion, no cdist), so the card and the CPU
  round them alike;
- `farthest_point_sample` is JAX's loop, one step a sample issued from the
  host (each an O(N) distance update and an argmax in eight launches, no
  synchronisation);
  `torch.argmax` takes the first maximum, as `jnp.argmax` does;
- `ball_query` and `knn` take the k smallest distances with ties to the
  lower index, as `jax.lax.top_k` does: one `torch.topk` over an int64 key
  (the distance's float bits, which order as integers for non-negative
  floats, over the column), so no full-row sort is made.
"""
from __future__ import annotations

import torch

_BIG = 1e10


def _sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[M, 3] x [N, 3] -> [M, N] squared distances."""
    d = [(a[:, None, i] - b[None, :, i]) ** 2 for i in range(3)]
    return (d[0] + d[1]) + d[2]


def _smallest(d2: torch.Tensor, k: int):
    """(values, indices) of the k smallest of each row of a non-negative
    [M, N] float32 array, ascending, ties to the lower index."""
    cols = torch.arange(d2.shape[1], device=d2.device, dtype=torch.int64)
    key = (d2.contiguous().view(torch.int32).to(torch.int64) << 32) | cols
    key = torch.topk(key, k, dim=1, largest=False, sorted=True).values
    idx = key & 0xFFFFFFFF
    return torch.gather(d2, 1, idx), idx


def farthest_point_sample(points: torch.Tensor, num_samples: int,
                          valid: torch.Tensor | None = None) -> torch.Tensor:
    """[N, 3] -> [num_samples] int64 indices: the first valid point, then
    each step the point farthest from the chosen set. Invalid points are
    never chosen; with fewer valid points than samples the farthest valid
    one repeats."""
    n = points.shape[0]
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=points.device)
    pts = points[:, :3].float().contiguous()
    # an invalid point starts at -1 and a distance is >= 0, so the minimum
    # keeps it at -1: JAX's where(valid, d, -1) changes nothing
    mindist = torch.where(valid, _BIG, -1.0)
    idxs = torch.zeros(num_samples, dtype=torch.int64, device=points.device)
    idxs[0] = torch.argmax(valid.to(torch.int8))
    for i in range(1, num_samples):
        sq = pts - pts.index_select(0, idxs[i - 1:i])
        sq = sq * sq
        torch.minimum(mindist, (sq[:, 0] + sq[:, 1]) + sq[:, 2], out=mindist)
        idxs[i] = torch.argmax(mindist)
    return idxs


def ball_query(centers: torch.Tensor, points: torch.Tensor, radius: float,
               nsample: int, valid: torch.Tensor | None = None):
    """[M, 3] centres x [N, 3] points -> (idx [M, nsample] int64, cnt [M]
    int32): the nearest `nsample` points within `radius` of each centre;
    slots past cnt repeat the nearest; a centre with none gets cnt 0 and
    idx 0."""
    n = points.shape[0]
    d2 = _sqdist(centers[:, :3].float(), points[:, :3].float())
    if valid is not None:
        d2 = torch.where(valid[None, :], d2, _BIG)
    if n < nsample:                     # fewer points than the group
        d2 = torch.cat([d2, d2.new_full((d2.shape[0], nsample - n), _BIG)],
                       1)
    r2 = radius * radius
    in_r = d2 <= r2
    cnt = in_r.sum(1, dtype=torch.int32).clamp_max(nsample)
    vals, idx = _smallest(torch.where(in_r, d2, _BIG), nsample)
    idx = idx.clamp_max(n - 1)
    idx = torch.where(vals <= r2, idx, idx[:, :1])
    return idx, cnt


def group_points(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """[N, C] x [M, K] -> [M, K, C]."""
    return features[idx]


def knn(queries: torch.Tensor, points: torch.Tensor, k: int = 3,
        valid: torch.Tensor | None = None):
    """[M, 3] x [N, 3] -> (distances [M, k], idx [M, k] int64), nearest
    first."""
    d2 = _sqdist(queries[:, :3].float(), points[:, :3].float())
    if valid is not None:
        d2 = torch.where(valid[None, :], d2, _BIG)
    vals, idx = _smallest(d2, k)
    return torch.sqrt(vals.clamp_min(0.0)), idx


def three_interpolate(features: torch.Tensor, idx: torch.Tensor,
                      dists: torch.Tensor, eps: float = 1e-8
                      ) -> torch.Tensor:
    """Inverse-distance weighting: features [N, C], idx / dists [M, k] ->
    [M, C]."""
    w = 1.0 / dists.clamp_min(eps)
    w = w / w.sum(1, keepdim=True)
    return torch.einsum("mk,mkc->mc", w, features[idx])
