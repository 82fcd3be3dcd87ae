"""DeepEncoder: SAM -> CLIP (patch bypass) -> concat -> projector
(counterpart of lvv_tpu/models/deepencoder.py).

Per view, SAM gives [B, 1024, 16, 16]; CLIP consumes it through the bypass
and gives [B, 257, 1024]; the CLS token is dropped and the CLIP tokens are
concatenated with the flattened SAM features to [B, 256, 2048]; the
projector maps them to the adapter width. `encode_views` folds
`views_chunk` views into the batch per pass and zeroes invalid views.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .clip import CLIPVisionTower
from .projector import MlpProjector
from .sam import SAMImageEncoder


class DeepEncoder(nn.Module):
    def __init__(self, sam: SAMImageEncoder, clip: CLIPVisionTower,
                 projector: MlpProjector, views_chunk: int = 0):
        super().__init__()
        self.sam = sam
        self.clip = clip
        self.projector = projector
        self.views_chunk = views_chunk   # 0 = all views in one pass

    def forward(self, images):
        """[B, 3, S, S] in [-1, 1] -> [B, G·G, D] tokens."""
        sam_feats = self.sam(images)                        # [B, C, G, G]
        clip_tokens = self.clip(sam_feats)                  # [B, 1+G·G, H]
        b, c, gh, gw = sam_feats.shape
        sam_flat = sam_feats.reshape(b, c, gh * gw).transpose(1, 2)
        fused = torch.cat([clip_tokens[:, 1:], sam_flat], dim=-1)
        return self.projector(fused)

    def encode_views(self, images,
                     view_valid: Optional[torch.Tensor] = None):
        """[B, V, 3, S, S] -> [B, V, G·G, D]; invalid views zeroed."""
        b, v = images.shape[:2]
        k = min(self.views_chunk or v, v)
        if v % k:
            raise ValueError(f"views_chunk={k} must divide num views {v}")
        chunks = []
        for i in range(0, v, k):
            t = self(images[:, i:i + k].reshape((b * k,) + images.shape[2:]))
            chunks.append(t.reshape((b, k) + t.shape[1:]))
        tokens = torch.cat(chunks, dim=1) if len(chunks) > 1 else chunks[0]
        if view_valid is not None:
            tokens = tokens * view_valid[:, :, None, None].to(tokens.dtype)
        return tokens


def build_deepencoder(cfg, *, dtype, device, clip_lora_rank: int = 0,
                      clip_lora_alpha: float = 1.0) -> DeepEncoder:
    """Construct from a `config.ModelConfig`."""
    kw = dict(dtype=dtype, device=device)
    s = cfg.sam
    sam = SAMImageEncoder(
        img_size=s.img_size, patch_size=s.patch_size, embed_dim=s.embed_dim,
        depth=s.depth, num_heads=s.num_heads, mlp_ratio=s.mlp_ratio,
        out_chans=s.out_chans, window_size=s.window_size,
        global_attn_indexes=tuple(s.global_attn_indexes),
        use_rel_pos=s.use_rel_pos, vary_dims=tuple(s.vary_dims),
        frozen_trunk=s.frozen_trunk, quant8=s.quant8, **kw)
    c = cfg.clip
    clip = CLIPVisionTower(
        image_size=c.image_size, patch_size=c.patch_size,
        hidden_size=c.hidden_size, num_layers=c.num_layers,
        num_heads=c.num_heads, intermediate_size=c.intermediate_size,
        layer_norm_eps=c.layer_norm_eps, lora_rank=clip_lora_rank,
        lora_alpha=clip_lora_alpha, quant8=c.quant8, **kw)
    pc = cfg.projector
    projector = MlpProjector(c.hidden_size + s.vary_dims[-1], pc.kind,
                             pc.n_embed, pc.depth, pc.mlp_ratio,
                             pc.downsample_ratio, **kw)
    chunk = cfg.views_chunk or (1 if cfg.sequential_views else 0)
    return DeepEncoder(sam, clip, projector, views_chunk=chunk)
