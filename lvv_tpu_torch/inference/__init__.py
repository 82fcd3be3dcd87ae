"""Serving runtime of the port (counterpart of lvv_tpu/inference):
checkpoint loading, batch inference, the dynamic-batching and the
continuous-batching servers."""
from .continuous import ContinuousServingEngine
from .engine import InferenceEngine
from .loader import ModelLoader, save_checkpoint, save_params_npz
from .server import ServingEngine

__all__ = ["ContinuousServingEngine", "InferenceEngine", "ModelLoader",
           "ServingEngine", "save_checkpoint", "save_params_npz"]
