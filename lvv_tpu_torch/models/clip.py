"""CLIP ViT-L/14 vision transformer (counterpart of lvv_tpu/models/clip.py).

In the VQA stack it is fed by SAM's patch bypass: SAM's [B, 1024, 16, 16]
map becomes 256 tokens. A tower built with `patcher=True` also takes
`pixel_values` [B, 3, H, W] through its own patch conv (stride = patch,
no bias), as the JAX module does when called on pixels; the VQA stack's
tower has no patch conv, as the JAX tree has none. The CLS token is prepended
and the (bicubically resampled) position table added, then 24 pre-LN layers
(hidden 1024, 16 heads, FFN 4096, QuickGELU) give [B, 257, 1024]. The
attention over 257 tokens stays on the plain path, as in the JAX package
(`attention` sends kv < 1024 there); the MLP half runs the fused kernel
with QuickGELU on the card: K-b, or K-f with `quant8`. LoRA adapters sit
on the attention projections (Dense).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..config import q8_scope
from ..ops import fused_mlp
from .layers import (PARAM_FP32, Dense, LayerNorm, MultiHeadAttention,
                     new_param, quick_gelu, resize_1d)


def resample_abs_pos(pos: torch.Tensor, tgt_hw: int) -> torch.Tensor:
    """[1 + S·S, D] table -> [1 + T·T, D], the grid part resized as
    jax.image.resize(method="cubic") does (antialiased when shrinking)."""
    n = pos.shape[0] - 1
    side = int(round(n ** 0.5))
    if side == tgt_hw:
        return pos
    grid = pos[1:].reshape(side, side, -1)
    grid = resize_1d(resize_1d(grid, 0, tgt_hw, "cubic"), 1, tgt_hw, "cubic")
    return torch.cat([pos[:1], grid.reshape(tgt_hw * tgt_hw, -1)], dim=0)


class CLIPEncoderLayer(nn.Module):
    """Pre-LN CLIP layer."""

    def __init__(self, dim: int, num_heads: int, intermediate_size: int,
                 eps: float, lora_rank: int, lora_alpha: float,
                 quant8: bool = False, *, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.eps = eps
        self.quant8 = quant8
        self.ln1 = LayerNorm(dim, eps, **kw)
        self.attn = MultiHeadAttention(dim, num_heads, lora_rank, lora_alpha,
                                       **kw)
        self.ln2 = LayerNorm(dim, eps, **kw)
        self.fc1 = Dense(dim, intermediate_size, **kw)
        self.fc2 = Dense(intermediate_size, dim, **kw)

    def forward(self, x):
        q8 = self.quant8 and "mlp" in q8_scope()
        x = x + self.attn(self.ln1(x))
        if fused_mlp.kernel_ok(x, x.shape[-1], self.fc1.kernel.shape[1]):
            return fused_mlp.ln_mlp_residual(
                x, self.ln2.scale, self.ln2.bias, self.fc1.kernel,
                self.fc1.bias, self.fc2.kernel, self.fc2.bias, eps=self.eps,
                act="quick_gelu", quant8=q8)
        return x + self.fc2(quick_gelu(self.fc1(self.ln2(x))))


class CLIPVisionTower(nn.Module):
    """CLIP-L/14 over SAM's patch embeddings."""

    def __init__(self, image_size: int = 224, patch_size: int = 14,
                 hidden_size: int = 1024, num_layers: int = 24,
                 num_heads: int = 16, intermediate_size: int = 4096,
                 layer_norm_eps: float = 1e-5, lora_rank: int = 0,
                 lora_alpha: float = 1.0, quant8: bool = False,
                 patcher: bool = False, *, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.hidden_size = hidden_size
        self.patch_size = patch_size
        self.num_layers = num_layers
        if patcher:
            self.patch_embed = nn.Module()
            self.patch_embed.kernel = new_param(
                (hidden_size, 3, patch_size, patch_size),
                ("lecun", 3 * patch_size * patch_size), **kw)
        n_pos = (image_size // patch_size) ** 2 + 1
        self.cls_token = new_param((hidden_size,), ("normal", 0.02), **kw)
        # fp32 as in the JAX package, which resamples the fp32 table
        self.pos_embed = new_param((n_pos, hidden_size), ("normal", 0.02),
                                   dtype=PARAM_FP32, device=device)
        self.pre_ln = LayerNorm(hidden_size, layer_norm_eps, **kw)
        for i in range(num_layers):
            setattr(self, f"layer_{i}", CLIPEncoderLayer(
                hidden_size, num_heads, intermediate_size, layer_norm_eps,
                lora_rank, lora_alpha, quant8, **kw))

    def forward(self, patch_embeds: Optional[torch.Tensor] = None,
                pixel_values: Optional[torch.Tensor] = None):
        """patch_embeds [B, hidden, Gh, Gw] (SAM's bypass) or pixel_values
        [B, 3, H, W] (the tower's own patcher) -> [B, 1 + Gh·Gw, hidden]."""
        if patch_embeds is None:
            if not hasattr(self, "patch_embed"):
                raise ValueError("this CLIP tower has no patcher: build it "
                                 "with patcher=True to feed pixel_values")
            patch_embeds = F.conv2d(
                pixel_values.to(self.patch_embed.kernel.dtype),
                self.patch_embed.kernel, stride=self.patch_size)
        b, c, gh, gw = patch_embeds.shape
        if c != self.hidden_size:
            raise ValueError(f"CLIP bypass expects {self.hidden_size} "
                             f"channels, got {c}")
        tokens = patch_embeds.reshape(b, c, gh * gw).transpose(1, 2)
        cls = self.cls_token.to(tokens.dtype).expand(b, 1, c)
        x = torch.cat([cls, tokens], dim=1)
        pos = resample_abs_pos(self.pos_embed.float(), gh)
        x = x + pos[None].to(x.dtype)
        x = self.pre_ln(x)
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(x)
        return x
