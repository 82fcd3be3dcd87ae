"""VAT query-compression transformers (counterpart of lvv_tpu/models/vat.py).

- VATBlock: pre-LN self-attention on the queries, cross-attention of the
  queries over the kv tokens, MLP.
- VATLiDAR: BEV [B, C, H, W] -> depthwise refine + GELU -> 1x1 projection +
  LN -> geometric PE over [x, y, r, sin, cos] -> 6-sector view embeddings
  on tokens and query groups -> VAT blocks -> final LN -> post head.
- VATVision: [B, 1536, 2048] tokens + learned queries -> VAT blocks in d_in
  space -> final LN -> post head -> projection stack to d_model.
- VisionAdapter: per-view embedding + LN, views concatenated.

On the card the cross-attentions (kv 1536 and 32,400) run the flash kernel
(K-e) through `attention`; the self-attention over 768 queries stays plain,
as in the JAX package. Dropout sits where JAX has it (the blocks' MLPs, the
post and projection heads, the adapter after its LN), at rate 0 unless the
caller sets one, and runs only with `deterministic=False`.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import (MLP, Dense, LayerNorm, MultiHeadAttention, dropout,
                     new_param)

NUM_VIEWS = 6   # nuScenes camera / sector count
_LN_EPS = 1e-5  # torch nn.LayerNorm default, as in the reference


class VATBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float,
                 dropout: float = 0.0, *, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.ln_self = LayerNorm(dim, _LN_EPS, **kw)
        self.self_attn = MultiHeadAttention(dim, num_heads, **kw)
        self.ln_cross_q = LayerNorm(dim, _LN_EPS, **kw)
        self.cross_attn = MultiHeadAttention(dim, num_heads, **kw)
        self.ln_mlp = LayerNorm(dim, _LN_EPS, **kw)
        self.mlp = MLP(dim, int(dim * mlp_ratio), dropout=dropout, **kw)

    def forward(self, q, kv, deterministic: bool = True, generator=None):
        q = q + self.self_attn(self.ln_self(q))
        q = q + self.cross_attn(self.ln_cross_q(q), kv)
        return q + self.mlp(self.ln_mlp(q), deterministic, generator)


def bev_geometry(h: int, w: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-cell [x, y, r, sin, cos] features [H·W, 5] and camera-aligned
    60° sector ids [H·W] (front=0, front_right=1, front_left=2, back=3,
    back_right=4, back_left=5) of an HxW BEV grid."""
    ys, xs = np.meshgrid(np.linspace(-1, 1, h), np.linspace(-1, 1, w),
                         indexing="ij")
    r = np.clip(np.sqrt(xs ** 2 + ys ** 2), 0.0, 1.0)
    theta = np.arctan2(ys, xs)
    geo = np.stack([xs, ys, r, np.sin(theta), np.cos(theta)],
                   axis=-1).reshape(-1, 5).astype(np.float32)
    ft = theta.reshape(-1)
    pi = math.pi
    sector = np.zeros(h * w, np.int64)
    sector[(ft >= pi / 3) & (ft < 2 * pi / 3)] = 0
    sector[(ft >= 0.0) & (ft < pi / 3)] = 1
    sector[(ft >= 2 * pi / 3) & (ft <= pi)] = 2
    sector[(ft >= -2 * pi / 3) & (ft < -pi / 3)] = 3
    sector[(ft >= -pi / 3) & (ft < 0.0)] = 4
    sector[(ft >= -pi) & (ft < -2 * pi / 3)] = 5
    return geo, sector


class VATLiDAR(nn.Module):
    """BEV feature compressor: [B, C, H, W] -> [B, n_queries, d_model]."""

    def __init__(self, bev_channels: int, d_model: int, n_queries: int,
                 n_blocks: int = 4, n_heads: int = 8, mlp_ratio: float = 4.0,
                 pe_hidden: int = 0, dw_kernel: int = 3,
                 dropout: float = 0.0, *, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        c, k = bev_channels, dw_kernel
        self.dropout = dropout
        self.dw_refine = nn.Module()   # depthwise conv, OIHW [C, 1, k, k]
        self.dw_refine.kernel = new_param((c, 1, k, k), ("lecun", k * k), **kw)
        self.dw_refine.bias = new_param((c,), "zeros", **kw)
        self.in_proj = Dense(c, d_model, **kw)
        self.in_ln = LayerNorm(d_model, _LN_EPS, **kw)
        pe_hidden = pe_hidden if pe_hidden > 0 else d_model
        self.pe_fc1 = Dense(5, pe_hidden, **kw)
        self.pe_fc2 = Dense(pe_hidden, d_model, **kw)
        self.sector_embed = new_param((NUM_VIEWS, d_model), ("normal", 0.02),
                                      **kw)
        self.queries = new_param((n_queries, d_model), ("normal", 0.02), **kw)
        self.n_blocks = n_blocks
        for i in range(n_blocks):
            setattr(self, f"block_{i}", VATBlock(d_model, n_heads, mlp_ratio,
                                                 dropout, **kw))
        self.final_ln = LayerNorm(d_model, _LN_EPS, **kw)
        self.post_ln = LayerNorm(d_model, _LN_EPS, **kw)
        self.post_fc1 = Dense(d_model, d_model, **kw)
        self.post_fc2 = Dense(d_model, d_model, **kw)

    def forward(self, bev, deterministic: bool = True, generator=None):
        b, c, h, w = bev.shape
        dtype = self.queries.dtype
        k = self.dw_refine.kernel.shape[-1]
        x = F.conv2d(bev.to(dtype), self.dw_refine.kernel,
                     self.dw_refine.bias, padding=k // 2, groups=c)
        x = F.gelu(x).permute(0, 2, 3, 1)                       # NHWC
        x = self.in_ln(self.in_proj(x))
        tokens = x.reshape(b, h * w, -1)

        geo_np, sector_np = bev_geometry(h, w)
        geo = torch.as_tensor(geo_np, device=bev.device).to(dtype)
        pe = self.pe_fc2(F.gelu(self.pe_fc1(geo)))
        sector = torch.as_tensor(sector_np, device=bev.device)
        tokens = tokens + pe[None] + self.sector_embed[sector][None]

        n_q = self.queries.shape[0]
        q_sector = torch.arange(n_q, device=bev.device) * NUM_VIEWS // n_q
        q = (self.queries + self.sector_embed[q_sector])[None].expand(
            b, -1, -1)
        for i in range(self.n_blocks):
            q = getattr(self, f"block_{i}")(q, tokens, deterministic,
                                            generator)
        q = self.post_ln(self.final_ln(q))
        q = dropout(F.gelu(self.post_fc1(q)), self.dropout, deterministic,
                    generator)
        return self.post_fc2(q)


class VATVision(nn.Module):
    """Image-token compressor: [B, n_tokens, d_in] -> [B, n_q, d_model]."""

    def __init__(self, d_in: int, d_model: int, n_tokens: int,
                 compression_factor: int = 2, n_blocks: int = 4,
                 n_heads: int = 8, mlp_ratio: float = 4.0,
                 per_view_queries: bool = True, dropout: float = 0.0, *,
                 dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.dropout = dropout
        n_q = n_tokens // compression_factor
        self.queries = new_param((n_q, d_in), ("normal", 0.02), **kw)
        # per-view query groups need n_q % NUM_VIEWS == 0
        self.per_view = per_view_queries and n_q % NUM_VIEWS == 0
        if self.per_view:
            self.view_embed = new_param((NUM_VIEWS, d_in), ("normal", 0.02),
                                        **kw)
        self.n_blocks = n_blocks
        for i in range(n_blocks):
            setattr(self, f"block_{i}", VATBlock(d_in, n_heads, mlp_ratio,
                                                 dropout, **kw))
        self.final_ln = LayerNorm(d_in, _LN_EPS, **kw)
        self.post_ln = LayerNorm(d_in, _LN_EPS, **kw)
        self.post_fc1 = Dense(d_in, d_in, **kw)
        self.post_fc2 = Dense(d_in, d_in, **kw)
        self.proj_ln = LayerNorm(d_in, _LN_EPS, **kw)
        self.proj_fc1 = Dense(d_in, d_model, **kw)
        self.proj_fc2 = Dense(d_model, d_model, **kw)
        self.out_ln = LayerNorm(d_model, _LN_EPS, **kw)

    def forward(self, kv, deterministic: bool = True, generator=None):
        b = kv.shape[0]
        kv = kv.to(self.queries.dtype)
        queries = self.queries
        if self.per_view:
            n_q = queries.shape[0]
            q_view = torch.arange(n_q, device=kv.device) * NUM_VIEWS // n_q
            queries = queries + self.view_embed[q_view]
        q = queries[None].expand(b, -1, -1)
        for i in range(self.n_blocks):
            q = getattr(self, f"block_{i}")(q, kv, deterministic, generator)
        q = self.post_ln(self.final_ln(q))
        q = self.post_fc2(dropout(F.gelu(self.post_fc1(q)), self.dropout,
                                  deterministic, generator))
        q = self.proj_ln(q)
        q = self.proj_fc2(dropout(F.gelu(self.proj_fc1(q)), self.dropout,
                                  deterministic, generator))
        return self.out_ln(q)


class VisionAdapter(nn.Module):
    """Per-camera view embedding + LN (+ dropout): [B, V, T, d] ->
    [B, V·T, d]."""

    def __init__(self, d_model: int, num_views: int = NUM_VIEWS,
                 dropout: float = 0.0, *, dtype, device):
        super().__init__()
        self.dropout = dropout
        self.view_embed = new_param((num_views, d_model), ("normal", 0.02),
                                    dtype=dtype, device=device)
        self.ln = LayerNorm(d_model, _LN_EPS, dtype=dtype, device=device)

    def forward(self, view_tokens, deterministic: bool = True,
                generator=None):
        b, v, t, d = view_tokens.shape
        if v != self.view_embed.shape[0]:
            raise ValueError(f"expected {self.view_embed.shape[0]} views, "
                             f"got {v}")
        x = view_tokens.to(self.view_embed.dtype) + self.view_embed[None, :,
                                                                    None, :]
        x = dropout(self.ln(x), self.dropout, deterministic, generator)
        return x.reshape(b, v * t, d)
