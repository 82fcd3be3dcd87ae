"""Multimodal projector family (counterpart of lvv_tpu/models/projector.py).

The reference's seven kinds, by config name:
- identity
- linear                         (the configured default, 2048 -> 2048)
- mlp_gelu                       (depth Dense layers, a GELU between
                                  each two)
- downsample_mlp_gelu            (r x r token neighbourhoods folded into
                                  channels, then the MLP)
- normlayer_downsample_mlp_gelu  (LayerNorm before the downsample)
- low_high_hybrid_split_mlp_gelu (low and high towers, concatenated, then
                                  an MLP that starts with a GELU)
- hybrid_split_feature_mlp_gelu  (the same on the two halves of x's
                                  features)
- low_high_split_mlp_gelu        (two independent MLPs, concatenated)

GELU is the tanh form, flax's default. The two low_high kinds take a
`high` input, which DeepEncoder never passes.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Dense, LayerNorm

KINDS = ("identity", "linear", "mlp_gelu", "downsample_mlp_gelu",
         "normlayer_downsample_mlp_gelu", "low_high_hybrid_split_mlp_gelu",
         "hybrid_split_feature_mlp_gelu", "low_high_split_mlp_gelu")


def token_downsample(x: torch.Tensor, ratio: int) -> torch.Tensor:
    """[B, T, D] on a square grid -> [B, T / ratio², D · ratio²], each
    ratio x ratio neighbourhood folded into the channels."""
    b, t, d = x.shape
    side = math.isqrt(t)
    if side * side != t:
        raise ValueError("token grid must be square for downsampling")
    x = x.reshape(b, side // ratio, ratio, side // ratio, ratio, d)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(
        b, (side // ratio) ** 2, ratio * ratio * d)


class MlpProjector(nn.Module):
    def __init__(self, input_dim: int, kind: str = "linear",
                 n_embed: int = 2048, depth: int = 2, mlp_ratio: int = 1,
                 downsample_ratio: int = 2, high_dim: Optional[int] = None,
                 *, dtype, device):
        """`high_dim`: the feature width of the `high` input of the two
        low_high kinds (default input_dim)."""
        super().__init__()
        if kind not in KINDS:
            raise ValueError(f"unknown projector kind {kind!r}")
        kw = dict(dtype=dtype, device=device)
        self.kind, self.ratio = kind, downsample_ratio
        d, high_dim = n_embed, high_dim or input_dim
        stack = [d * mlp_ratio] * (depth - 1) + [d]
        if kind == "linear":
            self.proj = Dense(input_dim, d, **kw)
        elif kind == "mlp_gelu":
            self._stack("mlp", input_dim, stack, **kw)
        elif kind.endswith("downsample_mlp_gelu"):
            if kind.startswith("normlayer"):
                self.pre_ln = LayerNorm(input_dim, **kw)
            self._stack("mlp", input_dim * downsample_ratio ** 2, stack, **kw)
        elif kind in ("low_high_hybrid_split_mlp_gelu",
                      "hybrid_split_feature_mlp_gelu"):
            half = input_dim // 2
            split = kind.startswith("hybrid")
            self.low = Dense(half if split else input_dim, d // 2, **kw)
            self.high = Dense(input_dim - half if split else high_dim,
                              d // 2, **kw)
            self._stack("mlp", 2 * (d // 2), [d] * depth, **kw)
        elif kind == "low_high_split_mlp_gelu":
            self._stack("low_mlp", input_dim, [d // 2] * depth, **kw)
            self._stack("high_mlp", high_dim, [d // 2] * depth, **kw)

    def _stack(self, name: str, in_dim: int, dims: Sequence[int], **kw):
        """Dense layers `{name}_{i}` (the JAX tree's names) of widths dims."""
        for i, d in enumerate(dims):
            setattr(self, f"{name}_{i}", Dense(in_dim, d, **kw))
            in_dim = d

    def _mlp(self, name: str, x, act_first: bool = False):
        """The stack `name`: a tanh GELU before each Dense but the first
        (and before the first too with `act_first`)."""
        i = 0
        while hasattr(self, f"{name}_{i}"):
            if i > 0 or act_first:
                x = F.gelu(x, approximate="tanh")
            x = getattr(self, f"{name}_{i}")(x)
            i += 1
        return x

    def forward(self, x, high: Optional[torch.Tensor] = None):
        """x [B, T, D] (the low tower's input); `high` feeds the low_high
        kinds."""
        k = self.kind
        if k == "identity":
            return x
        if k == "linear":
            return self.proj(x)
        if k == "mlp_gelu":
            return self._mlp("mlp", x)
        if k.endswith("downsample_mlp_gelu"):
            if k.startswith("normlayer"):
                x = self.pre_ln(x)
            return self._mlp("mlp", token_downsample(x, self.ratio))
        if k.startswith("low_high") and high is None:
            raise ValueError(f"projector kind {k!r} needs a `high` input")
        if k == "low_high_split_mlp_gelu":
            return torch.cat([self._mlp("low_mlp", x),
                              self._mlp("high_mlp", high)], dim=-1)
        if k == "hybrid_split_feature_mlp_gelu":
            half = x.shape[-1] // 2
            x, high = x[..., :half], x[..., half:]
        return self._mlp("mlp", torch.cat([self.low(x), self.high(high)],
                                          dim=-1), act_first=True)
