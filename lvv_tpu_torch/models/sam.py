"""SAM ViT-B image tower with the VARY compression head (counterpart of
lvv_tpu/models/sam.py).

A 1024x1024 image -> 16x16-patch ViT (windowed attention with window 14,
global attention at layers {2, 5, 8, 11}, decomposed rel-pos bias) -> conv
neck to 256 channels -> VARY net_2 (256->512, stride 2) and net_3
(512->1024, stride 2) -> [B, 1024, 16, 16]. Token maps are NHWC inside, as
in the JAX package; images and the output are NCHW at the boundary.

On the card SAMAttention keeps the JAX package's three-way dispatch
(sam.py:139-231, with "CUDA tensor" in place of "TPU backend"): square
grids of at most 512 tokens (the windows) run the rel-pos kernel straight
from the packed qkv projection (K-c), global grids that pass the
head-packed test (64x64 at 1024²) run it too (K-d), and every other grid
(80x80 at 1280²) runs the head-split kernel K-h on bf16-rounded q·R
tables. The MLP half of every block runs the fused LN + MLP kernel with
tanh-GELU: K-b, or its W8A8 form K-f. Elsewhere (CPU) the block takes the
plain path: materialised bias, exact-erf GELU, float MLP, as the JAX
package does off the TPU.

With `quant8`, LVV_Q8_SCOPE (read at each call) picks the int8 sub-paths,
as in the JAX package: "mlp" the W8A8 MLP (K-f); "dense" the 24 qkv / proj
projections through `w8a8_matmul` (K-i on the card, `int8_dot` on the CPU);
"attn" the int8 p@v of the global layers (K-d8 on head-packed grids, K-h's
int8 arm elsewhere) and "qk" the int8 scores (K-g, which wins over "attn",
on head-packed grids only). Neither applies to the windows or on the CPU
path.
"""
from __future__ import annotations

import math
from contextlib import nullcontext
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import q8_scope
from ..ops import fused_mlp
from ..ops.attention import (attention, flash_attention_relpos,
                             relpos_attention, relpos_attention_qk8,
                             relpos_bias)
from ..ops.quant import w8a8_matmul
from .layers import MLP, Dense, LayerNorm, new_param, resize_1d


def resize_rel_pos(rel_pos: torch.Tensor, q_size: int,
                   k_size: int) -> torch.Tensor:
    """[L, d] rel-pos table -> [q_size, k_size, d] table of each query
    coordinate against each key coordinate (linear resize to
    2·max(q, k) - 1 entries first, as the JAX package does)."""
    max_dist = 2 * max(q_size, k_size) - 1
    rel_pos = resize_1d(rel_pos, 0, max_dist, "linear")
    q = torch.arange(q_size)[:, None] * max(k_size / q_size, 1.0)
    k = torch.arange(k_size)[None, :] * max(q_size / k_size, 1.0)
    rel = (q - k) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel_pos[rel.to(torch.int64).to(rel_pos.device)]


def window_partition(x: torch.Tensor, window: int):
    """[B, H, W, C] -> [B·nW, win, win, C], zero-padding bottom/right."""
    b, h, w, c = x.shape
    ph, pw = (-h) % window, (-w) % window
    x = F.pad(x, (0, 0, 0, pw, 0, ph))
    hp, wp = h + ph, w + pw
    x = x.view(b, hp // window, window, wp // window, window, c)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window, window, c)
    return x, (hp, wp)


def window_unpartition(x: torch.Tensor, window: int, padded_hw, hw):
    """Inverse of window_partition."""
    hp, wp = padded_hw
    h, w = hw
    b = x.shape[0] // ((hp // window) * (wp // window))
    x = x.reshape(b, hp // window, wp // window, window, window, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, -1)
    return x[:, :h, :w]


def _relpos_kernel_ok(x: torch.Tensor, head_dim: int, h: int, w: int) -> bool:
    """The rel-pos kernels run on the card for MMA-friendly head dims (the
    JAX rule, with "CUDA tensor" in place of "TPU backend"), at any grid:
    the dispatch in SAMAttention picks K-c / K-d or K-h by shape."""
    del h, w
    return x.is_cuda and head_dim in (64, 128)


def _hpacked_ok(h: int, w: int, head_dim: int) -> bool:
    """JAX's test for its head-packed global kernel (sam.py:159-167), the
    only place the "qk" scope applies."""
    s = h * w
    return (s > 512 and s % 1024 == 0 and head_dim + h <= 128 and w <= 128
            and s % min(s, 4096) == 0 and 1024 % w == 0)


def _pv_group(s: int) -> int:
    """K-d8's quantization group of p at S tokens: the head-packed
    kernel's kv tile, 1024 (min(1024, S padded to 128), as
    attention.py:434-438 computes it, is the same at those grids)."""
    return min(1024, -(-s // 128) * 128)


class SAMAttention(nn.Module):
    """ViT attention with the decomposed rel-pos bias."""

    def __init__(self, dim: int, num_heads: int, use_rel_pos: bool,
                 input_size: Tuple[int, int], quant8: bool = False, *, dtype,
                 device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.num_heads = num_heads
        self.use_rel_pos = use_rel_pos
        self.quant8 = quant8
        hd = dim // num_heads
        self.qkv = Dense(dim, 3 * dim, **kw)
        self.proj = Dense(dim, dim, **kw)
        if use_rel_pos:
            self.rel_pos_h = new_param((2 * input_size[0] - 1, hd), "zeros",
                                       **kw)
            self.rel_pos_w = new_param((2 * input_size[1] - 1, hd), "zeros",
                                       **kw)

    def _dense(self, layer, x, q8: bool):
        if q8:
            return w8a8_matmul(x, layer.kernel, layer.bias)
        return layer(x)

    def forward(self, x):
        b, h, w, c = x.shape
        hd = c // self.num_heads
        scale = 1.0 / math.sqrt(hd)
        scope = q8_scope() if self.quant8 else frozenset()
        dense = "dense" in scope
        qkv = self._dense(self.qkv, x.reshape(b, h * w, c), dense)
        if self.use_rel_pos and _relpos_kernel_ok(qkv, hd, h, w):
            rh = resize_rel_pos(self.rel_pos_h.to(qkv.dtype), h, h)
            rw = resize_rel_pos(self.rel_pos_w.to(qkv.dtype), w, w)
            if h == w and h * w <= 512:                   # windows: K-c
                out = relpos_attention(qkv, rh, rw, heads=self.num_heads,
                                       scale=scale)
            elif _hpacked_ok(h, w, hd):                   # K-d / K-d8 / K-g
                if "qk" in scope:
                    out = relpos_attention_qk8(qkv, rh, rw,
                                               heads=self.num_heads,
                                               scale=scale)
                else:
                    out = relpos_attention(qkv, rh, rw, heads=self.num_heads,
                                           scale=scale,
                                           pv_int8="attn" in scope,
                                           pv_group=_pv_group(h * w))
            else:                                         # K-h
                out = _kh_attention(qkv, rh, rw, self.num_heads, scale, h, w,
                                    "attn" in scope)
            return self._dense(self.proj, out, dense).view(b, h, w, c)
        q, k, v = qkv.view(b, h * w, 3, self.num_heads, hd).permute(
            2, 0, 3, 1, 4)
        bias = None
        if self.use_rel_pos:
            rh = resize_rel_pos(self.rel_pos_h.to(qkv.dtype), h, h)
            rw = resize_rel_pos(self.rel_pos_w.to(qkv.dtype), w, w)
            # SAM adds q·R with UNSCALED q; only q·k takes 1/sqrt(d)
            bias = relpos_bias(q, rh, rw, w).to(qkv.dtype)
        out = attention(q, k, v, bias=bias)
        out = out.transpose(1, 2).reshape(b, h * w, c)
        return self._dense(self.proj, out, dense).view(b, h, w, c)


def _kh_attention(qkv, rh, rw, heads: int, scale: float, h: int, w: int,
                  quant8: bool) -> torch.Tensor:
    """The JAX package's third branch (sam.py:202-231): head-split q, k, v,
    the tables q·Rh and q·Rw in fp32 rounded to qkv's dtype, and K-h with
    tiles 4096 / 1024 (256 / 256 at 256 tokens or fewer). Returns [B, S, C]
    from packed qkv [B, S, 3C]."""
    b, s, c3 = qkv.shape
    hd = c3 // 3 // heads
    q, k, v = qkv.view(b, s, 3, heads, hd).permute(2, 0, 3, 1, 4)
    qr = q.float().reshape(b, heads, h, w, hd)
    q_rh = torch.einsum("bnhwc,hkc->bnhwk", qr, rh.float()).reshape(
        b, heads, s, h).to(qkv.dtype)
    q_rw = torch.einsum("bnhwc,wkc->bnhwk", qr, rw.float()).reshape(
        b, heads, s, w).to(qkv.dtype)
    small = s <= 256
    out = flash_attention_relpos(q, k, v, q_rh, q_rw, scale=scale, grid_w=w,
                                 block_q=256 if small else 4096,
                                 block_k=256 if small else 1024,
                                 quant8=quant8)
    return out.transpose(1, 2).reshape(b, s, heads * hd)


class SAMBlock(nn.Module):
    """ViT block with optional window attention."""

    def __init__(self, dim: int, num_heads: int, window_size: int,
                 mlp_ratio: float, use_rel_pos: bool,
                 input_size: Tuple[int, int], quant8: bool = False, *,
                 dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.window_size = window_size
        self.quant8 = quant8
        attn_size = (window_size, window_size) if window_size else input_size
        self.ln1 = LayerNorm(dim, 1e-6, **kw)
        self.attn = SAMAttention(dim, num_heads, use_rel_pos, attn_size,
                                 quant8, **kw)
        self.ln2 = LayerNorm(dim, 1e-6, **kw)
        self.hidden = int(dim * mlp_ratio)
        self.mlp = MLP(dim, self.hidden, **kw)   # exact erf GELU unfused

    def forward(self, x):
        q8 = self.quant8 and "mlp" in q8_scope()
        shortcut = x
        y = self.ln1(x)
        if self.window_size:
            hw = y.shape[1:3]
            y, padded = window_partition(y, self.window_size)
        y = self.attn(y)
        if self.window_size:
            y = window_unpartition(y, self.window_size, padded, hw)
        x = shortcut + y
        if fused_mlp.kernel_ok(x, x.shape[-1], self.hidden):
            # fused LN2 + MLP + residual with tanh-GELU, as the TPU kernel
            fc1, fc2 = self.mlp.fc1, self.mlp.fc2
            return fused_mlp.ln_mlp_residual(
                x, self.ln2.scale, self.ln2.bias, fc1.kernel, fc1.bias,
                fc2.kernel, fc2.bias, eps=1e-6, act="gelu", quant8=q8)
        return x + self.mlp(self.ln2(x))


class SAMImageEncoder(nn.Module):
    """ImageEncoderViT + neck + VARY net_2/net_3."""

    def __init__(self, img_size: int = 1024, patch_size: int = 16,
                 embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 mlp_ratio: float = 4.0, out_chans: int = 256,
                 window_size: int = 14,
                 global_attn_indexes: Sequence[int] = (2, 5, 8, 11),
                 use_rel_pos: bool = True,
                 vary_dims: Sequence[int] = (512, 1024),
                 frozen_trunk: bool = True, quant8: bool = False, *, dtype,
                 device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.patch_size = patch_size
        self.frozen_trunk = frozen_trunk
        grid = img_size // patch_size
        p = patch_size
        # conv kernels in torch's OIHW layout; fan_in as flax counts it
        self.patch_embed = nn.Module()
        self.patch_embed.kernel = new_param(
            (embed_dim, 3, p, p), ("lecun", 3 * p * p), **kw)
        self.patch_embed.bias = new_param((embed_dim,), "zeros", **kw)
        self.pos_embed = new_param((1, grid, grid, embed_dim),
                                   ("normal", 0.02), **kw)
        for i in range(depth):
            ws = 0 if i in global_attn_indexes else window_size
            setattr(self, f"block_{i}", SAMBlock(
                embed_dim, num_heads, ws, mlp_ratio, use_rel_pos,
                (grid, grid), quant8, **kw))
        self.depth = depth
        convs = (("neck_conv1", embed_dim, out_chans, 1),
                 ("neck_conv2", out_chans, out_chans, 3),
                 ("net_2", out_chans, vary_dims[0], 3),
                 ("net_3", vary_dims[0], vary_dims[1], 3))
        for name, cin, cout, k in convs:
            conv = nn.Module()
            conv.kernel = new_param((cout, cin, k, k), ("lecun", cin * k * k),
                                    **kw)
            setattr(self, name, conv)
        self.neck_ln1 = LayerNorm(out_chans, 1e-6, **kw)
        self.neck_ln2 = LayerNorm(out_chans, 1e-6, **kw)

    def trunk(self, images):
        """Patch embedding, blocks and neck: [B, 3, S, S] -> the neck's
        [B, out_chans, S/16, S/16]."""
        dtype = self.pos_embed.dtype
        x = F.conv2d(images.to(dtype), self.patch_embed.kernel,
                     self.patch_embed.bias, stride=self.patch_size)
        x = x.permute(0, 2, 3, 1) + self.pos_embed              # NHWC
        for i in range(self.depth):
            x = getattr(self, f"block_{i}")(x)
        x = F.conv2d(x.permute(0, 3, 1, 2), self.neck_conv1.kernel)
        x = self.neck_ln1(x.permute(0, 2, 3, 1))                # LayerNorm2d
        x = F.conv2d(x.permute(0, 3, 1, 2), self.neck_conv2.kernel,
                     padding=1)
        return self.neck_ln2(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)

    def forward(self, images):
        """[B, 3, S, S] in [-1, 1] -> [B, vary_dims[-1], S/64, S/64]. With
        `frozen_trunk` the blocks and the neck run under torch.no_grad()
        (JAX's stop_gradient: no activation is kept for them); the VARY
        head stays in the graph."""
        with torch.no_grad() if self.frozen_trunk else nullcontext():
            x = self.trunk(images)
        # VARY head: explicit (1, 1) padding at stride 2, as the reference
        x = F.conv2d(x, self.net_2.kernel, stride=2, padding=1)
        return F.conv2d(x, self.net_3.kernel, stride=2, padding=1)
