"""Config schema of the port: the JAX package's sections and fields with
their defaults (counterpart of lvv_tpu/config/schema.py), so that one
config file drives both stacks. The port runs the model sections and
`train`, `data` and `model.remat` (its Trainer); `mesh` beyond one device
raises there; it reads and keeps the others (`voxelize`, `model.voxelnext`,
`debug_level`) without acting on them.
"""
from __future__ import annotations

import os
from dataclasses import field
from typing import Optional, Tuple

from .core import config, deep_merge, from_dict, to_dict


def q8_scope() -> frozenset:
    """Which sub-paths `quant8` applies to: the comma-set in LVV_Q8_SCOPE,
    default "mlp", read at call time as the JAX package's `_q8_scope` is.
    "mlp" is the W8A8 fused MLP (K-f), "dense" SAM's W8A8 qkv / proj
    projections (K-i), "attn" the int8 p@v of SAM's global attention (K-d8)
    and "qk" its int8 scores (K-g, taking precedence over "attn"). Other
    names are ignored, as in JAX; "" turns quant8 off everywhere."""
    return frozenset(os.environ.get("LVV_Q8_SCOPE", "mlp").split(","))


@config
class SAMConfig:
    """SAM ViT-B image tower (reference sam_vary_sdpa.py:441-511 builder).

    The VARY compression head (net_2/net_3: 256->512->1024, stride-2 convs,
    reference sam_vary_sdpa.py:171-172) brings the 64x64 neck output to a
    16x16 grid of 1024-d features.
    """
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
    vary_dims: Tuple[int, ...] = (512, 1024)  # net_2, net_3 output channels
    # The reference trains ONLY net_2/net_3 (deepencoder_infer.py:406-416
    # freezes the rest of SAM); the port is inference only and reads it.
    frozen_trunk: bool = True
    # Serving lever: int8 sub-paths of the frozen trunk, by LVV_Q8_SCOPE
    # (q8_scope). Off by default: the float path.
    quant8: bool = False


@config
class CLIPConfig:
    """CLIP ViT-L/14 vision transformer (reference clip_sdpa.py:371-396)."""
    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    layer_norm_eps: float = 1e-5
    # serving lever: W8A8 the fused MLPs (K-f, see SAMConfig.quant8)
    quant8: bool = False
    # SAM bypass: patch embeddings come from SAM's [B,1024,16,16] output
    # instead of CLIP's own patch conv (reference clip_sdpa.py:147-169).


@config
class ProjectorConfig:
    """MlpProjector (reference build_linear.py:7-172). 2048 -> 2048 linear by
    default; `kind` selects among the reference's 7 projector types."""
    kind: str = "linear"
    input_dim: int = 2048
    n_embed: int = 2048
    depth: int = 2
    mlp_ratio: int = 1
    downsample_ratio: int = 2
    token_pooling: bool = False


@config
class LoRAConfig:
    """LoRA adapter hyperparams (reference lora_utils.py:10-38,
    deepencoder/lora_config.py:4-32)."""
    enabled: bool = True
    r: int = 16
    alpha: int = 32
    dropout: float = 0.05
    target_modules: Tuple[str, ...] = ("q_proj", "k_proj", "v_proj", "o_proj")


@config
class VATLiDARConfig:
    """BEV query-compression transformer (reference vat_lidar.py:42-304)."""
    d_model: int = 896           # LLM hidden size
    n_queries: int = 768
    n_blocks: int = 4
    n_heads: int = 8
    mlp_ratio: float = 4.0
    dropout: float = 0.0
    num_views: int = 6           # polar sector count (vat_lidar.py:159-183)
    dw_kernel: int = 3           # depthwise refine kernel (vat_lidar.py:82-85)
    pe_hidden: int = 0           # geometric PE MLP width; <=0 = d_model,
                                 # the reference width (vat_lidar.py:93-97)


@config
class VATVisionConfig:
    """Image-token compression transformer (reference vat_vision.py:20-235)."""
    d_in: int = 2048
    d_model: int = 896
    compression_factor: int = 2   # n_queries = 6*256 / factor
    n_blocks: int = 4
    n_heads: int = 8
    mlp_ratio: float = 4.0
    dropout: float = 0.0
    # auto-disabled if n_q % 6 != 0 (reference vat_vision.py:74-96)
    per_view_queries: bool = True


@config
class AdapterConfig:
    """Per-camera VisionAdapter (reference vision_adapter.py:35-145)."""
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
    # 4 special tokens appended to the vocab (reference model_setup.py:40-48)
    special_tokens: Tuple[str, ...] = (
        "<vision_start>", "<vision_end>", "<lidar_start>", "<lidar_end>")


@config
class VoxelizeConfig:
    """Fixed-capacity voxelization replacing spconv Point2VoxelCPU3d
    (reference data_processor.py:133-150, VoxelNeXt yaml:6,108)."""
    point_range: Tuple[float, ...] = (-54.0, -54.0, -5.0, 54.0, 54.0, 3.0)
    voxel_size: Tuple[float, ...] = (0.075, 0.075, 0.2)
    max_points: int = 300000
    max_voxels: int = 160000
    max_points_per_voxel: int = 10
    num_point_features: int = 4


@config
class VoxelNeXtConfig:
    """VoxelNeXt BEV encoder (reference spconv_backbone_voxelnext.py:69-225,
    voxelnext_head.py:50-559). `spatial_stride` 8 gives the 180x180 BEV grid
    at 0.075 m voxels over +-54 m."""
    channels: Tuple[int, ...] = (16, 32, 64, 128, 128, 128)
    out_channels: int = 128
    spatial_stride: int = 8
    kernel_size: int = 3
    # Per-downsample-stage active-voxel capacities. None -> the legacy
    # cap*3//4 shrink from the voxelizer capacity (conservative: real
    # nuScenes@0.075m counts shrink ~2x per stride because surfaces stay
    # sparse). The default_config preset pins an audited schedule; the
    # ops-level overflow telemetry (ops.sparse.set_overflow_debug) guards
    # any retuning.
    capacity_schedule: Optional[Tuple[int, ...]] = None
    # "ln" (shape-stable default) or "bn" (masked-moment BatchNorm matching
    # the reference norm_fn — required to load spconv-trained checkpoints)
    norm: str = "ln"
    # VoxelBackBone8xFocal trunk (reference spconv_backbone_focal.py):
    # focal convs close stages 1-3; focal_use_img adds the camera branch
    # (models/semseg.py) fused into importance prediction + conv output
    focal: bool = False
    focal_use_img: bool = False
    focal_spawn: int = 128
    # "gn" trains the image trunk from scratch; "frozen_bn" loads a
    # converted torchvision deeplabv3_resnet50 trunk (reference
    # sem_deeplabv3.py pretrained path; tools/validate_weights.py
    # --component deeplabv3)
    focal_trunk_norm: str = "gn"
    # DSVT trunk knobs (reference backbones_3d/dsvt.py; waymo
    # dsvt_pillar.yaml / dsvt_voxel.yaml: d_model 192, 8 heads, set 36,
    # window 12x12 in x/y). dsvt_window is (z, y, x); dsvt_max_sets 0 ->
    # the ceil(V/set_size)*2 heuristic, or plan with
    # models.dsvt.plan_max_sets for an exact per-cloud capacity.
    dsvt_channels: int = 192
    dsvt_blocks: int = 4
    dsvt_heads: int = 8
    dsvt_window: Tuple[int, int, int] = (1, 12, 12)
    dsvt_set_size: int = 36
    dsvt_max_sets: int = 0
    # multi-stage progressive z-downsampling (reference dsvt_voxel.yaml:
    # window_shape z 32 -> 8 -> 2 -> 1, downsample_stride [1,1,4]/[1,1,4]/
    # [1,1,2], attention reduction dsvt.py:292-310). Empty = single stage.
    # dsvt_stage_windows entries are (z, y, x); dsvt_downsample are the
    # z strides between consecutive stages.
    dsvt_stage_blocks: Tuple[int, ...] = ()
    dsvt_stage_windows: Tuple[Tuple[int, int, int], ...] = ()
    dsvt_downsample: Tuple[int, ...] = ()
    # learned dynamic VFE before the DSVT trunk (reference DynamicVoxelVFE
    # / DynamicPillarVFE_3d: a 2-layer PFN over absolute-xyz + cluster +
    # center offsets); False falls back to mean-voxelize + in_proj
    dsvt_learned_vfe: bool = True
    # 2D BEV trunk after the column collapse (reference dsvt yaml
    # BaseBEVResBackbone: LAYER_NUMS [1,2,2], NUM_FILTERS [128,128,256],
    # strides [1,2,2], upsample [128,128,128] -> 384-ch map at stride 1)
    dsvt_bev_channels: Tuple[int, ...] = (128, 128, 256)
    dsvt_bev_strides: Tuple[int, ...] = (1, 2, 2)
    dsvt_bev_nums: Tuple[int, ...] = (1, 2, 2)
    dsvt_bev_upsample: Tuple[int, ...] = (128, 128, 128)
    num_classes: int = 10
    class_names: Tuple[str, ...] = (
        "car", "truck", "construction_vehicle", "bus", "trailer",
        "barrier", "motorcycle", "bicycle", "pedestrian", "traffic_cone")
    nms_pre_max: int = 1000
    nms_post_max: int = 83
    nms_iou_thresh: float = 0.2
    score_thresh: float = 0.1
    code_size: int = 9  # x,y,z,dx,dy,dz,sin,cos + vx,vy for nuScenes


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
    voxelnext: VoxelNeXtConfig = field(default_factory=VoxelNeXtConfig)
    # views folded into the batch per encode pass; 0 = derive from
    # sequential_views (None/False -> all views at once, True -> one)
    sequential_views: Optional[bool] = None
    views_chunk: int = 0
    prefix_scale: float = 0.2     # reference train.py:187, trainer.py:581,594
    bev_channels: int = 128       # reference trainer.py:197-199
    bev_hw: Tuple[int, int] = (180, 180)
    dtype: str = "bfloat16"       # the port's compute and weight dtype
    # gradient checkpointing in training: each LLM layer recomputed in the
    # backward (JAX also rematerialises SAM's blocks, which keep no
    # activations in the port: its frozen trunk runs under no_grad)
    remat: bool = False


@config
class OptimConfig:
    """Multi-group AdamW + cosine warmup (reference model_setup.py:221-258).

    Five parameter groups at distinct LRs, as in the reference: vat_lidar,
    llm_lora, clip_lora, adapter+projector, vat_vision."""
    lr_vat_lidar: float = 1e-4
    lr_llm_lora: float = 5e-5
    lr_clip_lora: float = 5e-5
    lr_adapter: float = 1e-4
    lr_vat_vision: float = 1e-4
    weight_decay: float = 0.01
    betas: Tuple[float, float] = (0.9, 0.999)
    warmup_ratio: float = 0.03
    grad_clip: float = 1.0
    grad_accum_steps: int = 1


@config
class TrainConfig:
    epochs: int = 3
    batch_size: int = 4           # global batch
    seed: int = 42
    max_prompt_tokens: int = 128
    max_answer_tokens: int = 96   # reference collate.py:44-51
    save_every_steps: int = 500
    keep_last_ckpts: int = 3
    val_every_epochs: int = 1
    inference_sampling_every: int = 1
    inference_samples: int = 8
    log_every: int = 10
    optim: OptimConfig = field(default_factory=OptimConfig)
    output_dir: str = "runs/default"
    resume: bool = True
    # ablation toggles (reference train.py:159-172)
    use_vision: bool = True
    use_lidar: bool = True


@config
class DataConfig:
    nuscenes_root: str = "data/nuscenes"
    bev_features_dir: str = "data/bev_feats"
    caption_json: str = "data/nucaption_train.json"
    grounding_json: str = "data/nugrounding_train.json"
    val_caption_json: str = "data/nucaption_val.json"
    val_grounding_json: str = "data/nugrounding_val.json"
    # leakage filter (reference dataset.py:86-91)
    grounding_template_filter: str = "det_area"
    num_workers: int = 0
    val_fraction: float = 0.05
    cam_views: Tuple[str, ...] = (
        "CAM_FRONT", "CAM_FRONT_RIGHT", "CAM_FRONT_LEFT",
        "CAM_BACK", "CAM_BACK_RIGHT", "CAM_BACK_LEFT")


@config
class MeshConfig:
    """Device mesh axes. The reference only has DP (SURVEY.md §2.6); we keep a
    `model` axis so the LLM can shard over ICI, and reserve `seq` for future
    context parallelism."""
    data: int = -1     # -1: all remaining devices
    model: int = 1
    axis_names: Tuple[str, ...] = ("data", "model")


@config
class VQAConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    data: DataConfig = field(default_factory=DataConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    voxelize: VoxelizeConfig = field(default_factory=VoxelizeConfig)
    debug_level: int = 0  # 0..3, reference debug_logger.py levels


def default_config() -> VQAConfig:
    return VQAConfig()


def tiny_config() -> VQAConfig:
    """The CPU-testable miniature of the stack (the JAX package's
    tiny_config, field for field)."""
    base = to_dict(VQAConfig())
    tiny = {
        "model": {
            "sam": {"img_size": 64, "patch_size": 8, "embed_dim": 32,
                    "depth": 2, "num_heads": 2, "out_chans": 16,
                    "window_size": 2, "global_attn_indexes": [1],
                    "vary_dims": [32, 64]},
            "clip": {"image_size": 32, "patch_size": 8, "hidden_size": 64,
                     "num_layers": 2, "num_heads": 2,
                     "intermediate_size": 128},
            "projector": {"input_dim": 128, "n_embed": 128},
            "adapter": {"d_model": 128},
            "vat_lidar": {"d_model": 64, "n_queries": 12, "n_blocks": 2,
                          "n_heads": 2, "pe_hidden": 16},
            "vat_vision": {"d_in": 128, "d_model": 64, "compression_factor": 8,
                           "n_blocks": 2, "n_heads": 2},
            "llm": {"vocab_size": 512, "hidden_size": 64, "num_layers": 2,
                    "num_heads": 4, "num_kv_heads": 2, "head_dim": 16,
                    "intermediate_size": 128, "max_position_embeddings": 512},
            "voxelnext": {"channels": [8, 16, 16, 32, 32, 32],
                          "out_channels": 32, "num_classes": 3,
                          "class_names": ["car", "truck", "bus"],
                          "nms_pre_max": 64, "nms_post_max": 16},
            "bev_channels": 32,
            "bev_hw": [24, 24],
        },
        "voxelize": {"point_range": [-8.0, -8.0, -3.0, 8.0, 8.0, 1.0],
                     "voxel_size": [1.0, 1.0, 0.5],
                     "max_points": 2048, "max_voxels": 512,
                     "max_points_per_voxel": 4},
        "train": {"batch_size": 2, "max_prompt_tokens": 16,
                  "max_answer_tokens": 8},
    }
    return from_dict(VQAConfig, deep_merge(base, tiny))
