"""PointNet++ set abstraction and feature propagation (counterpart of
lvv_tpu/models/pointnet2.py).

- `SetAbstraction`: farthest-point samples, a ball query around each,
  the group's offsets (and features) through Dense + LayerNorm + ReLU
  layers, max-pooled over the group's filled slots.
- `SetAbstractionMSG`: the same at several radii, pooled features
  concatenated.
- `FeaturePropagation`: 3-NN inverse-distance interpolation onto the finer
  level, concatenated with its features, through Dense + LayerNorm + ReLU.
- `PointNet2Backbone`: four SA levels down and four FP levels back to
  every input point.

Everything has a fixed shape (npoint, nsample); the FPS loop is issued from
the host, one step a sample.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..ops.sampling import (ball_query, farthest_point_sample, knn,
                            three_interpolate)
from .pointpillars import Dense, FlaxLayerNorm


def _build_mlp(owner: nn.Module, prefix: str, cin: int,
               mlp: Sequence[int], device) -> int:
    """Dense + LayerNorm per channel count on `owner`, named
    `{prefix}fc{i}` / `{prefix}ln{i}` (the JAX tree's names) -> the last
    width."""
    for i, ch in enumerate(mlp):
        setattr(owner, f"{prefix}fc{i}", Dense(cin, ch, device=device))
        setattr(owner, f"{prefix}ln{i}", FlaxLayerNorm(ch, device=device))
        cin = ch
    return cin


def _run_mlp(owner: nn.Module, prefix: str, n: int, x: torch.Tensor):
    for i in range(n):
        x = torch.relu(getattr(owner, f"{prefix}ln{i}")(
            getattr(owner, f"{prefix}fc{i}")(x)))
    return x


def _masked_max(x: torch.Tensor, cnt: torch.Tensor, nsample: int):
    """Max over the group's first max(cnt, 1) slots: [M, K, C] -> [M, C]."""
    k_ids = torch.arange(nsample, device=x.device)[None, :]
    mask = k_ids < cnt.clamp_min(1)[:, None]
    return torch.where(mask[..., None], x, -1e9).amax(1)


def _group(xyz, feats, new_xyz, group_idx):
    grouped = xyz[group_idx] - new_xyz[:, None, :]             # [M, K, 3]
    if feats is not None:
        grouped = torch.cat([grouped, feats[group_idx]], -1)
    return grouped


class SetAbstraction(nn.Module):
    """Single-scale grouping: xyz [N, 3], feats [N, C] or None ->
    (new_xyz [npoint, 3], new_feats [npoint, mlp[-1]], new_valid)."""

    def __init__(self, cin: int, npoint: int, radius: float, nsample: int,
                 mlp: Sequence[int], *, device):
        super().__init__()
        self.npoint, self.radius, self.nsample = npoint, radius, nsample
        self.n_mlp = len(mlp)
        self.out_channels = _build_mlp(self, "", cin + 3, mlp, device)

    def forward(self, xyz, feats, valid=None):
        idx = farthest_point_sample(xyz, self.npoint, valid)
        new_xyz = xyz[idx]
        group_idx, cnt = ball_query(new_xyz, xyz, self.radius, self.nsample,
                                    valid)
        x = _run_mlp(self, "", self.n_mlp,
                     _group(xyz, feats, new_xyz, group_idx))
        pooled = _masked_max(x, cnt, self.nsample)
        new_valid = cnt > 0
        return new_xyz, torch.where(new_valid[:, None], pooled, 0.0), \
            new_valid


class SetAbstractionMSG(nn.Module):
    """Multi-scale grouping: one ball query and MLP a radius, the pooled
    features concatenated; a sample is valid where any scale found a
    point."""

    def __init__(self, cin: int, npoint: int, radii: Sequence[float],
                 nsamples: Sequence[int], mlps: Sequence[Sequence[int]], *,
                 device):
        super().__init__()
        self.npoint, self.radii, self.nsamples = npoint, radii, nsamples
        self.n_mlp = [len(m) for m in mlps]
        self.out_channels = sum(
            _build_mlp(self, f"s{si}_", cin + 3, mlp, device)
            for si, mlp in enumerate(mlps))

    def forward(self, xyz, feats, valid=None):
        idx = farthest_point_sample(xyz, self.npoint, valid)
        new_xyz = xyz[idx]
        outs, any_valid = [], None
        for si, (radius, nsample) in enumerate(zip(self.radii,
                                                   self.nsamples)):
            group_idx, cnt = ball_query(new_xyz, xyz, radius, nsample, valid)
            x = _run_mlp(self, f"s{si}_", self.n_mlp[si],
                         _group(xyz, feats, new_xyz, group_idx))
            outs.append(_masked_max(x, cnt, nsample))
            v = cnt > 0
            any_valid = v if any_valid is None else (any_valid | v)
        out = torch.cat(outs, -1)
        return new_xyz, torch.where(any_valid[:, None], out, 0.0), any_valid


class FeaturePropagation(nn.Module):
    """3-NN interpolation of the coarse level's features onto the fine
    level's points, concatenated with the fine features, then the MLP."""

    def __init__(self, cin: int, mlp: Sequence[int], *, device):
        super().__init__()
        self.n_mlp = len(mlp)
        self.out_channels = _build_mlp(self, "", cin, mlp, device)

    def forward(self, xyz_dst, feats_dst, xyz_src, feats_src,
                valid_src=None):
        d, idx = knn(xyz_dst, xyz_src, k=3, valid=valid_src)
        x = three_interpolate(feats_src, idx, d)
        if feats_dst is not None:
            x = torch.cat([x, feats_dst], -1)
        return _run_mlp(self, "", self.n_mlp, x)


class PointNet2Backbone(nn.Module):
    """Four SA levels (each mlp (ch, ch)) and four FP levels back to the
    input points: points [N, 3 + F] -> per-point features
    [N, out_channels]."""

    def __init__(self, point_features: int = 1,
                 npoints: Sequence[int] = (1024, 256, 64, 16),
                 radii: Sequence[float] = (0.5, 1.0, 2.0, 4.0),
                 nsamples: Sequence[int] = (16, 16, 16, 16),
                 channels: Sequence[int] = (32, 64, 128, 256),
                 out_channels: int = 64, *, device):
        super().__init__()
        self.levels = len(npoints)
        cins = [point_features]
        for i, (npoint, radius, nsample, ch) in enumerate(
                zip(npoints, radii, nsamples, channels)):
            setattr(self, f"sa{i}", SetAbstraction(
                cins[-1], npoint, radius, nsample, (ch, ch), device=device))
            cins.append(ch)
        c = cins[-1]
        for i in range(self.levels - 1, -1, -1):
            ch = channels[max(i - 1, 0)] if i > 0 else out_channels
            setattr(self, f"fp{i}", FeaturePropagation(
                c + cins[i], (ch, ch), device=device))
            c = ch
        self.out_channels = out_channels

    def forward(self, points, valid: Optional[torch.Tensor] = None):
        xyz = points[:, :3]
        feats = points[:, 3:] if points.shape[1] > 3 else None
        xs, fs, vs = [xyz], [feats], [valid]
        for i in range(self.levels):
            x, f, v = getattr(self, f"sa{i}")(xs[-1], fs[-1], vs[-1])
            xs.append(x)
            fs.append(f)
            vs.append(v)
        f = fs[-1]
        for i in range(self.levels - 1, -1, -1):
            f = getattr(self, f"fp{i}")(xs[i], fs[i], xs[i + 1], f,
                                        vs[i + 1])
        return f
