"""torchvision deeplabv3_resnet50 -> the port's `ResNetFeatures(norm=
"frozen_bn")` (counterpart of lvv_tpu/convert/deeplabv3_torch.py).

The multimodal focal conv's image trunk is a pretrained torchvision
deeplabv3_resnet50's ResNet backbone up to the layer it extracts. Its
`backbone.*` keys map to the port's names; convolution weights keep
torch's OIHW; every BatchNorm folds into the eval-mode affine that
`FrozenBN` holds: scale = γ / √(var + 1e-5), bias = β − μ·scale, in
float32.

  backbone.conv1 / bn1                     -> stem_conv / stem_norm
  backbone.layer{L}.{B}.conv1 / bn1        -> layer{L}_b{B}.a.conv / a.norm
  backbone.layer{L}.{B}.conv2 / bn2        -> layer{L}_b{B}.b.conv / b.norm
  backbone.layer{L}.{B}.conv3 / bn3        -> layer{L}_b{B}.c / c_norm
  backbone.layer{L}.{B}.downsample.{0, 1}  -> layer{L}_b{B}.proj / proj_norm

Keys are relative to the trunk (`semseg.ifn.` in a focal Voxel R-CNN;
`merge` takes the prefix).
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from ..models.semseg import LAYER_SPECS
from .params import tensors

BN_EPS = 1e-5   # torchvision's BatchNorm2d


def _frozen_bn(sd: Mapping, key: str) -> Dict:
    g = np.asarray(sd[key + ".weight"], np.float32)
    b = np.asarray(sd[key + ".bias"], np.float32)
    mu = np.asarray(sd[key + ".running_mean"], np.float32)
    var = np.asarray(sd[key + ".running_var"], np.float32)
    scale = g / np.sqrt(var + np.float32(BN_EPS))
    return {"scale": scale, "bias": b - mu * scale}


def convert_deeplabv3_state(sd: Mapping[str, np.ndarray],
                            layers: tuple = ("layer1",),
                            prefix: str = "backbone."
                            ) -> Dict[str, torch.Tensor]:
    """A numpy torchvision state dict -> the parameters of
    `ResNetFeatures(layers, norm="frozen_bn")`, the deepest requested
    layer included."""
    def conv(key):
        return {"kernel": np.asarray(sd[key + ".weight"])}

    out: Dict = {"stem_conv": conv(prefix + "conv1"),
                 "stem_norm": _frozen_bn(sd, prefix + "bn1")}
    deepest = max(int(name[-1]) for name in layers)
    for li in range(1, deepest + 1):
        name = f"layer{li}"
        for bi in range(LAYER_SPECS[name][1]):
            t = f"{prefix}{name}.{bi}."
            blk: Dict = {"a": {"conv": conv(t + "conv1"),
                               "norm": _frozen_bn(sd, t + "bn1")},
                         "b": {"conv": conv(t + "conv2"),
                               "norm": _frozen_bn(sd, t + "bn2")},
                         "c": conv(t + "conv3"),
                         "c_norm": _frozen_bn(sd, t + "bn3")}
            if t + "downsample.0.weight" in sd:
                blk["proj"] = conv(t + "downsample.0")
                blk["proj_norm"] = _frozen_bn(sd, t + "downsample.1")
            out[f"{name}_b{bi}"] = blk
    return tensors(out)
