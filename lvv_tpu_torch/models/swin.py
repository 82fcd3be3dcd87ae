"""Swin Transformer image backbone (counterpart of lvv_tpu/models/swin.py).

4x4 patch embedding, stages of windowed attention blocks with a learned
relative-position bias, every second block on cyclically shifted windows
with a -100 mask across the shift's regions, and PatchMerging between
stages. Parameters are named as in the JAX tree (`stage{s}_block{b}`,
`downsample{s}`, `out_norm{s}`, `final_norm`), Dense kernels [in, out],
the patch embedding's kernel OIHW; `convert.convert_swin_state` fills them
from a transformers SwinModel state dict.

The JAX package's windows reshape without padding, so it raises wherever a
stage's side is not a multiple of the window (BEVFusion's 256 x 704 views
give a 64 x 176 grid, windows of 7; ROADMAP.md queue 3). The port computes
there what transformers' SwinLayer computes: `ln1`'s output is padded
with zeros at the bottom and right to whole windows, the shifted windows'
mask is built on the padded grid, and the attention's output is cropped
back before the residual add; PatchMerging pads an odd side with a zero
row or column. Where every side is a multiple of the window, this is the
JAX package's function.

Each block's window is fixed when the backbone is built, from `image_hw`
(the bias table holds (2w - 1)² rows): the stage's window is min(window,
h, w), and a block shifts only where that is below min(h, w), the rule of
both the JAX package and transformers. A call at another size whose
windows differ raises.

The norms are `layers.LayerNorm` (eps 1e-5; kernel K-a on the card at
widths that are a multiple of 128); the attention is
`ops.attention.attention`, whose rule sends a biased call to the plain
path, as the JAX package's does.
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import attention
from .layers import PARAM_FP32, Dense, LayerNorm, new_param

SWIN_EPS = 1e-5


def relative_position_index(window: int) -> np.ndarray:
    """[w·w, w·w] indices into the (2w - 1)² bias table."""
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window),
                                  indexing="ij")).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    rel = rel.transpose(1, 2, 0) + window - 1
    return (rel[..., 0] * (2 * window - 1) + rel[..., 1]).astype(np.int32)


def shifted_window_mask(h: int, w: int, window: int,
                        shift: int) -> np.ndarray:
    """[nW, w·w, w·w] additive mask of an (h, w) grid (whole windows):
    -100 between tokens of different shift regions, else 0."""
    img = np.zeros((h, w), np.int32)
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift),
               slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift),
                   slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    wins = img.reshape(h // window, window, w // window, window)
    wins = wins.transpose(0, 2, 1, 3).reshape(-1, window * window)
    diff = wins[:, :, None] != wins[:, None, :]
    return np.where(diff, -100.0, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _index(window: int, device: str) -> torch.Tensor:
    return torch.from_numpy(relative_position_index(window)).long().to(
        device)


@functools.lru_cache(maxsize=None)
def _mask(h: int, w: int, window: int, shift: int,
          device: str) -> torch.Tensor:
    return torch.from_numpy(shifted_window_mask(h, w, window, shift)).to(
        device)


def window_partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """[B, H, W, C] (whole windows) -> [B·nW, w·w, C], windows row-major
    within each image."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // window, window, w // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window * window, c)


def window_unpartition(x: torch.Tensor, window: int, h: int, w: int,
                       b: int) -> torch.Tensor:
    x = x.reshape(b, h // window, w // window, window, window, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


def stage_window(window: int, shift: int, h: int, w: int) -> Tuple[int,
                                                                     int]:
    """(window, shift) of a block on an (h, w) grid."""
    win = min(window, h, w)
    return win, (shift if win < min(h, w) else 0)


class SwinBlock(nn.Module):
    """Windowed self-attention (pre-norm, relative-position bias, shifted
    where `shift`) and an exact-GELU MLP, each with its residual add.
    `window` is the stage's window (see `stage_window`)."""

    def __init__(self, dim: int, num_heads: int, window: int,
                 shift: int = 0, mlp_ratio: float = 4.0,
                 eps: float = SWIN_EPS, *, device):
        super().__init__()
        kw = dict(dtype=PARAM_FP32, device=device)
        self.num_heads, self.window, self.shift = num_heads, window, shift
        self.ln1 = LayerNorm(dim, eps, **kw)
        self.q = Dense(dim, dim, **kw)
        self.k = Dense(dim, dim, **kw)
        self.v = Dense(dim, dim, **kw)
        self.rel_bias_table = new_param(((2 * window - 1) ** 2, num_heads),
                                        ("normal", 0.02), **kw)
        self.proj = Dense(dim, dim, **kw)
        self.ln2 = LayerNorm(dim, eps, **kw)
        self.fc1 = Dense(dim, int(dim * mlp_ratio), **kw)
        self.fc2 = Dense(int(dim * mlp_ratio), dim, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        win, shift = self.window, self.shift
        if min(win, h, w) != win:
            raise ValueError(f"a {h} x {w} grid takes windows of "
                             f"{min(win, h, w)}; this block was built for "
                             f"{win} (SwinBackbone's image_hw)")
        heads, n = self.num_heads, win * win
        ph, pw = -h % win, -w % win
        y = self.ln1(x)
        if ph or pw:                    # zeros after ln1, as transformers
            y = F.pad(y, (0, 0, 0, pw, 0, ph))
        hp, wp = h + ph, w + pw
        if shift:
            y = torch.roll(y, (-shift, -shift), (1, 2))
        wins = window_partition(y, win)                 # [B·nW, n, C]

        def split(t):
            return t.reshape(-1, n, heads, c // heads).transpose(1, 2)
        dev = str(x.device)
        bias = self.rel_bias_table[_index(win, dev)].permute(2, 0, 1)[None]
        n_win = wins.shape[0] // b
        if shift:
            mask = _mask(hp, wp, win, shift, dev)       # [nW, n, n]
            bias = (bias[:, None] + mask[None, :, None]).expand(
                b, n_win, heads, n, n).reshape(b * n_win, heads, n, n)
        else:
            bias = bias.expand(b * n_win, heads, n, n)
        o = attention(split(self.q(wins)), split(self.k(wins)),
                      split(self.v(wins)), bias=bias)
        o = self.proj(o.transpose(1, 2).reshape(-1, n, c))
        o = window_unpartition(o, win, hp, wp, b)
        if shift:
            o = torch.roll(o, (shift, shift), (1, 2))
        x = x + o[:, :h, :w]
        return x + self.fc2(F.gelu(self.fc1(self.ln2(x))))


class PatchMerging(nn.Module):
    """2x2 neighbours concatenated (an odd side padded with zeros first),
    LayerNorm, then a bias-free Dense to 2C."""

    def __init__(self, dim: int, eps: float = SWIN_EPS, *, device):
        super().__init__()
        kw = dict(dtype=PARAM_FP32, device=device)
        self.norm = LayerNorm(4 * dim, eps, **kw)
        self.reduction = Dense(4 * dim, 2 * dim, use_bias=False, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, h, w, _ = x.shape
        if h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        y = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], -1)
        return self.reduction(self.norm(y))


class PatchEmbed(nn.Module):
    """flax nn.Conv with kernel = stride = patch and padding "VALID":
    kernel [O, 3, p, p], bias [O]."""

    def __init__(self, cin: int, dim: int, patch: int, *, device):
        super().__init__()
        kw = dict(dtype=PARAM_FP32, device=device)
        self.patch = patch
        self.kernel = new_param((dim, cin, patch, patch),
                                ("lecun", cin * patch * patch), **kw)
        self.bias = new_param((dim,), "zeros", **kw)

    def forward(self, x):
        return F.conv2d(x, self.kernel, self.bias, self.patch)


class SwinBackbone(nn.Module):
    """[B, 3, H, W] -> the final tokens [B, H'·W', C'] behind `final_norm`
    (SwinModel.last_hidden_state), or with `out_indices` (BEVFusion's
    (1, 2, 3)) the listed stages' NCHW maps, each behind its own
    `out_norm{i}`. `image_hw` fixes each stage's window (module
    docstring)."""

    def __init__(self, embed_dim: int = 96,
                 depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24), window: int = 7,
                 patch_size: int = 4, mlp_ratio: float = 4.0,
                 eps: float = SWIN_EPS,
                 image_hw: Tuple[int, int] = (224, 224),
                 out_indices: Optional[Sequence[int]] = None, *, device):
        super().__init__()
        kw = dict(device=device)
        self.depths = tuple(depths)
        self.out_indices = None if out_indices is None else tuple(
            out_indices)
        self.patch_embed = PatchEmbed(3, embed_dim, patch_size, **kw)
        self.embed_norm = LayerNorm(embed_dim, eps, dtype=PARAM_FP32, **kw)
        h, w = image_hw[0] // patch_size, image_hw[1] // patch_size
        dim = embed_dim
        for si, depth in enumerate(self.depths):
            for bi in range(depth):
                win, shift = stage_window(window, window // 2 if bi % 2
                                          else 0, h, w)
                setattr(self, f"stage{si}_block{bi}", SwinBlock(
                    dim, num_heads[si], win, shift, mlp_ratio, eps, **kw))
            if self.out_indices is not None and si in self.out_indices:
                setattr(self, f"out_norm{si}", LayerNorm(
                    dim, eps, dtype=PARAM_FP32, **kw))
            if si < len(self.depths) - 1:
                setattr(self, f"downsample{si}", PatchMerging(dim, eps, **kw))
                h, w, dim = -(-h // 2), -(-w // 2), 2 * dim
        if self.out_indices is None:
            self.final_norm = LayerNorm(dim, eps, dtype=PARAM_FP32, **kw)

    def forward(self, img_nchw: torch.Tensor):
        x = self.embed_norm(self.patch_embed(img_nchw).permute(0, 2, 3, 1))
        pyramid = []
        for si, depth in enumerate(self.depths):
            for bi in range(depth):
                x = getattr(self, f"stage{si}_block{bi}")(x)
            if self.out_indices is not None and si in self.out_indices:
                pyramid.append(getattr(self, f"out_norm{si}")(x).permute(
                    0, 3, 1, 2))
            if si < len(self.depths) - 1:
                x = getattr(self, f"downsample{si}")(x)
        if self.out_indices is not None:
            return pyramid
        b, h, w, c = x.shape
        return self.final_norm(x.reshape(b, h * w, c))
