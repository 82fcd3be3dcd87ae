"""Weights into the port (counterpart of lvv_tpu/convert).

`from_jax_params` takes a parameter tree of the JAX package's VQAModel,
`from_jax_detector_params` the variables of its detectors. The
checkpoint converters take a numpy state dict with the reference's key
names (HF Qwen2 / PEFT LoRA, facebook SAM, OpenCLIP, transformers Swin,
the reference's VAT, adapter and projector modules, torchvision's
deeplabv3_resnet50 trunk) and return a partial port state_dict, keys
relative to the component; `merge` overlays it onto a model's state_dict
with shape checks. All converters are torch-free on their input side.
"""
from .clip_torch import convert_clip_state, from_transformers_clip
from .deeplabv3_torch import convert_deeplabv3_state
from .params import (from_jax_detector_params, from_jax_params, merge,
                     tensors)
from .qwen_hf import convert_peft_lora, convert_qwen_state
from .sam_torch import convert_sam_state, from_transformers_sam
from .swin_torch import convert_swin_state
from .vat_torch import (convert_projector_state, convert_vat_lidar_state,
                        convert_vat_vision_state,
                        convert_vision_adapter_state)

__all__ = ["from_jax_params", "from_jax_detector_params", "merge", "tensors", "convert_qwen_state",
           "convert_peft_lora", "convert_sam_state", "from_transformers_sam",
           "convert_clip_state", "from_transformers_clip",
           "convert_swin_state", "convert_deeplabv3_state",
           "convert_vat_lidar_state", "convert_vat_vision_state",
           "convert_vision_adapter_state", "convert_projector_state"]
