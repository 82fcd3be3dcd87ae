"""Configuration of the port (counterpart of lvv_tpu/config): the typed
schema and the JSON loader with `_base_` inheritance."""
from .core import (apply_overrides, config, deep_merge, from_dict, load,
                   load_file, override, replace, save, to_dict)
from .schema import (AdapterConfig, CLIPConfig, DataConfig, LLMConfig,
                     LoRAConfig, MeshConfig, ModelConfig, OptimConfig,
                     ProjectorConfig, SAMConfig, TrainConfig, VATLiDARConfig,
                     VATVisionConfig, VoxelizeConfig, VoxelNeXtConfig,
                     VQAConfig, default_config, q8_scope, tiny_config)

__all__ = [
    "config", "to_dict", "from_dict", "override", "apply_overrides",
    "load", "load_file", "save", "replace", "deep_merge", "q8_scope",
    "VQAConfig", "ModelConfig", "TrainConfig", "DataConfig", "MeshConfig",
    "OptimConfig", "SAMConfig", "CLIPConfig", "ProjectorConfig",
    "AdapterConfig", "VATLiDARConfig", "VATVisionConfig", "LLMConfig",
    "LoRAConfig", "VoxelizeConfig", "VoxelNeXtConfig",
    "default_config", "tiny_config",
]
