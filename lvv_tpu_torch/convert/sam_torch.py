"""SAM checkpoint (facebook segment-anything naming) -> the port's
SAMImageEncoder (counterpart of lvv_tpu/convert/sam_torch.py). Keys of the
result are relative to "deepencoder.sam."; convolution weights keep torch's
OIHW layout, Linear weights become Dense kernels [in, out]."""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .params import tensors


def _linear(w: np.ndarray) -> np.ndarray:
    return np.transpose(np.asarray(w), (1, 0))


def convert_sam_state(sd: Mapping[str, np.ndarray], depth: int = 12,
                      prefix: str = "image_encoder."
                      ) -> Dict[str, torch.Tensor]:
    """`image_encoder.*` (plus the VARY net_2 / net_3 keys of a trained
    reference checkpoint, when present) -> SAMImageEncoder parameters.
    Missing VARY keys are absent from the result; `merge` keeps the
    model's values for them."""
    def g(k):
        return np.asarray(sd[prefix + k])

    def dense(k):
        return {"kernel": _linear(g(k + ".weight")), "bias": g(k + ".bias")}

    def ln(k):
        return {"scale": g(k + ".weight"), "bias": g(k + ".bias")}

    p: Dict = {"patch_embed": {"kernel": g("patch_embed.proj.weight"),
                               "bias": g("patch_embed.proj.bias")},
               "pos_embed": g("pos_embed")}     # [1, G, G, C] channels-last
    for i in range(depth):
        b = f"blocks.{i}."
        blk = {"ln1": ln(b + "norm1"), "ln2": ln(b + "norm2"),
               "attn": {"qkv": dense(b + "attn.qkv"),
                        "proj": dense(b + "attn.proj")},
               "mlp": {"fc1": dense(b + "mlp.lin1"),
                       "fc2": dense(b + "mlp.lin2")}}
        if prefix + b + "attn.rel_pos_h" in sd:
            blk["attn"]["rel_pos_h"] = g(b + "attn.rel_pos_h")
            blk["attn"]["rel_pos_w"] = g(b + "attn.rel_pos_w")
        p[f"block_{i}"] = blk
    p["neck_conv1"] = {"kernel": g("neck.0.weight")}
    p["neck_ln1"] = ln("neck.1")
    p["neck_conv2"] = {"kernel": g("neck.2.weight")}
    p["neck_ln2"] = ln("neck.3")
    for name in ("net_2", "net_3"):
        if prefix + name + ".weight" in sd:
            p[name] = {"kernel": g(name + ".weight")}
    return tensors(p)


def from_transformers_sam(sd: Mapping[str, np.ndarray]
                          ) -> Dict[str, np.ndarray]:
    """Rename a transformers SamVisionModel state dict to facebook naming.
    The neck's layer_norm keys are rewritten before the blocks' generic
    layer_norm patterns."""
    ren = {
        "patch_embed.projection.": "patch_embed.proj.",
        "neck.conv1.": "neck.0.", "neck.layer_norm1.": "neck.1.",
        "neck.conv2.": "neck.2.", "neck.layer_norm2.": "neck.3.",
        "layer_norm1.": "norm1.", "layer_norm2.": "norm2.",
    }
    out = {}
    for k, v in sd.items():
        k = k.replace("vision_encoder.", "").replace("layers.", "blocks.")
        for a, b in ren.items():
            k = k.replace(a, b)
        out["image_encoder." + k] = np.asarray(v)
    return out
