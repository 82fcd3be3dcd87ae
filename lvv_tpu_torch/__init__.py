"""lvv_tpu_torch: the PyTorch / CUDA port of lvv_tpu for NVIDIA Hopper.

The VQA model (SAM-B -> CLIP-L -> projector -> adapter -> VATVision,
VATLiDAR, Qwen2.5-0.5B prefill and KV-cached greedy decode, with bench.py's
serving levers: W8A8 SAM/CLIP MLPs under `quant8` and the int8 decode
trees, and the rest of the JAX package's generate family with its uint8
preprocessing) in plain PyTorch, with the JAX package's Pallas kernels
replaced by kernels written by hand for sm_90a (`kernels/`); its config
files (`config.load`, `_base_` inheritance), weight converters
(`convert`), tokenizers and collator (`data`), and serving runtime
(`inference`): `ModelLoader` over a checkpoint directory,
`InferenceEngine`, the dynamic-batching `ServingEngine`, the
continuous-batching `ContinuousServingEngine`, and the CLIs
`python -m lvv_tpu_torch.tools.infer_vqa` / `.serve_vqa`; and VQA training
on one card (`train`: the five-group AdamW, the train step with fp32
masters, checkpoints, the `Trainer`, `python -m
lvv_tpu_torch.tools.train_vqa`), differentiating through the kernels by
their autograd Functions (`ops.autograd`); and the LiDAR BEV producer
(`models.voxelnext.VoxelNeXtDetector` on the sparse ops `ops.voxelize`,
`ops.sparse`, `ops.nms`; `python -m lvv_tpu_torch.tools.precompute_bev`),
which makes the model's [128, 180, 180] BEV input from a point cloud, and
its training (`train.detector`, `models.voxelnext_loss`, `python -m
lvv_tpu_torch.tools.train_detector`), with sweeps read by the native host
I/O library (`native`, native/lvv_io.cpp built with g++ at first use).
Entry points run on the card
unless given `device="cpu"`, where every kernel wrapper computes its plain
PyTorch version.
"""
from .config import VQAConfig, ModelConfig, default_config, tiny_config
from .convert import from_jax_params
from .inference import (ContinuousServingEngine, InferenceEngine,
                        ModelLoader, ServingEngine)
from .models.vqa import (VQAModel, encode_prefix_fn, generate_from_prefix,
                         greedy_generate, greedy_generate_multi,
                         pipelined_serving_step, prepare_serving_params,
                         prepare_serving_params_fused, sample_generate)
from .ops.image import preprocess_views

__all__ = ["VQAConfig", "ModelConfig", "default_config", "tiny_config",
           "from_jax_params", "VQAModel", "greedy_generate",
           "greedy_generate_multi", "encode_prefix_fn",
           "generate_from_prefix", "pipelined_serving_step",
           "sample_generate", "preprocess_views", "prepare_serving_params",
           "prepare_serving_params_fused", "ModelLoader", "InferenceEngine",
           "ServingEngine", "ContinuousServingEngine"]
