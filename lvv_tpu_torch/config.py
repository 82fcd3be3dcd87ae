"""Model configuration of the PyTorch port.

The port's own copy of the VQA model's config dataclasses: the fields and
defaults of the JAX package's `ModelConfig` and its sub-configs, so that one
configuration drives both stacks. The LiDAR detector configs (VoxelNeXt,
voxelization) and the training/data/mesh sections are not part of the
serving path ported so far and are left out.
"""
from __future__ import annotations

import dataclasses
import os
from dataclasses import field
from typing import Optional, Tuple

def q8_scope() -> frozenset:
    """Which sub-paths `quant8` applies to: the comma-set in LVV_Q8_SCOPE,
    default "mlp", read at call time as the JAX package's `_q8_scope` is.
    "mlp" is the W8A8 fused MLP (K-f), "dense" SAM's W8A8 qkv / proj
    projections (K-i), "attn" the int8 p@v of SAM's global attention (K-d8)
    and "qk" its int8 scores (K-g, taking precedence over "attn"). Other
    names are ignored, as in JAX; "" turns quant8 off everywhere."""
    return frozenset(os.environ.get("LVV_Q8_SCOPE", "mlp").split(","))


def config(cls):
    """A frozen config dataclass."""
    return dataclasses.dataclass(frozen=True)(cls)


@config
class SAMConfig:
    """SAM ViT-B image tower with the VARY compression head (net_2/net_3)."""
    img_size: int = 1024
    patch_size: int = 16
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    out_chans: int = 256
    window_size: int = 14
    global_attn_indexes: Tuple[int, ...] = (2, 5, 8, 11)
    use_rel_pos: bool = True
    vary_dims: Tuple[int, ...] = (512, 1024)
    frozen_trunk: bool = True
    quant8: bool = False   # int8 serving levers, by LVV_Q8_SCOPE


@config
class CLIPConfig:
    """CLIP ViT-L/14 vision transformer (fed by SAM's patch bypass)."""
    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    layer_norm_eps: float = 1e-5
    quant8: bool = False   # W8A8 serving lever (K-f under LVV_Q8_SCOPE)


@config
class ProjectorConfig:
    """Multimodal projector; only kind="linear" is ported."""
    kind: str = "linear"
    input_dim: int = 2048
    n_embed: int = 2048
    depth: int = 2
    mlp_ratio: int = 1
    downsample_ratio: int = 2
    token_pooling: bool = False


@config
class LoRAConfig:
    enabled: bool = True
    r: int = 16
    alpha: int = 32
    dropout: float = 0.05
    target_modules: Tuple[str, ...] = ("q_proj", "k_proj", "v_proj", "o_proj")


@config
class VATLiDARConfig:
    """BEV query-compression transformer."""
    d_model: int = 896
    n_queries: int = 768
    n_blocks: int = 4
    n_heads: int = 8
    mlp_ratio: float = 4.0
    dropout: float = 0.0
    num_views: int = 6
    dw_kernel: int = 3
    pe_hidden: int = 0     # <= 0 selects the reference width (d_model)


@config
class VATVisionConfig:
    """Image-token compression transformer."""
    d_in: int = 2048
    d_model: int = 896
    compression_factor: int = 2
    n_blocks: int = 4
    n_heads: int = 8
    mlp_ratio: float = 4.0
    dropout: float = 0.0
    per_view_queries: bool = True


@config
class AdapterConfig:
    """Per-camera VisionAdapter."""
    d_model: int = 2048
    num_views: int = 6
    dropout: float = 0.0


@config
class LLMConfig:
    """Qwen2.5-family causal decoder. Defaults = Qwen2.5-0.5B."""
    vocab_size: int = 151936
    hidden_size: int = 896
    num_layers: int = 24
    num_heads: int = 14
    num_kv_heads: int = 2
    head_dim: int = 64
    intermediate_size: int = 4864
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1000000.0
    max_position_embeddings: int = 32768
    tie_word_embeddings: bool = True
    special_tokens: Tuple[str, ...] = (
        "<vision_start>", "<vision_end>", "<lidar_start>", "<lidar_end>")


@config
class ModelConfig:
    sam: SAMConfig = field(default_factory=SAMConfig)
    clip: CLIPConfig = field(default_factory=CLIPConfig)
    projector: ProjectorConfig = field(default_factory=ProjectorConfig)
    adapter: AdapterConfig = field(default_factory=AdapterConfig)
    vat_lidar: VATLiDARConfig = field(default_factory=VATLiDARConfig)
    vat_vision: VATVisionConfig = field(default_factory=VATVisionConfig)
    llm: LLMConfig = field(default_factory=LLMConfig)
    llm_lora: LoRAConfig = field(default_factory=LoRAConfig)
    clip_lora: LoRAConfig = field(default_factory=lambda: LoRAConfig(
        r=8, alpha=16, target_modules=("q_proj", "v_proj")))
    # views folded into the batch per encode pass; 0 = derive from
    # sequential_views (None/False -> all views at once, True -> one)
    sequential_views: Optional[bool] = None
    views_chunk: int = 0
    prefix_scale: float = 0.2
    bev_channels: int = 128
    bev_hw: Tuple[int, int] = (180, 180)
    dtype: str = "bfloat16"


@config
class VQAConfig:
    model: ModelConfig = field(default_factory=ModelConfig)


def default_config() -> VQAConfig:
    return VQAConfig()


def tiny_config() -> VQAConfig:
    """The CPU-testable miniature of the stack (same widths as the JAX
    package's tiny_config)."""
    return VQAConfig(model=ModelConfig(
        sam=SAMConfig(img_size=64, patch_size=8, embed_dim=32, depth=2,
                      num_heads=2, out_chans=16, window_size=2,
                      global_attn_indexes=(1,), vary_dims=(32, 64)),
        clip=CLIPConfig(image_size=32, patch_size=8, hidden_size=64,
                        num_layers=2, num_heads=2, intermediate_size=128),
        projector=ProjectorConfig(input_dim=128, n_embed=128),
        adapter=AdapterConfig(d_model=128),
        vat_lidar=VATLiDARConfig(d_model=64, n_queries=12, n_blocks=2,
                                 n_heads=2, pe_hidden=16),
        vat_vision=VATVisionConfig(d_in=128, d_model=64,
                                   compression_factor=8, n_blocks=2,
                                   n_heads=2),
        llm=LLMConfig(vocab_size=512, hidden_size=64, num_layers=2,
                      num_heads=4, num_kv_heads=2, head_dim=16,
                      intermediate_size=128, max_position_embeddings=512),
        bev_channels=32,
        bev_hw=(24, 24),
    ))
