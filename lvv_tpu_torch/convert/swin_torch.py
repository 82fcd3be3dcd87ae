"""transformers SwinModel state dict -> the port's SwinBackbone
(counterpart of lvv_tpu/convert/swin_torch.py; the reference's
BEVFusion Swin checkpoints are mmcv-style and key-map to this naming one
to one). Linear weights become Dense kernels [in, out]; the patch
embedding keeps torch's OIHW; the relative-position tables keep their
[(2w - 1)², heads]. Keys are relative to the backbone (e.g.
"image_backbone." in BEVFusion; `merge` takes the prefix).
"""
from __future__ import annotations

from typing import Dict, Mapping, Sequence

import numpy as np
import torch

from .params import tensors


def _lin(w) -> np.ndarray:
    return np.transpose(np.asarray(w), (1, 0))


def convert_swin_state(sd: Mapping[str, np.ndarray],
                       depths: Sequence[int]) -> Dict[str, torch.Tensor]:
    """`embeddings.*`, `encoder.layers.*` and `layernorm.*` -> the
    backbone's parameters (its `final_norm`: the tokens' form, without
    `out_indices`)."""
    def g(k):
        return np.asarray(sd[k])

    def ln(k):
        return {"scale": g(k + ".weight"), "bias": g(k + ".bias")}

    def dense(k):
        return {"kernel": _lin(g(k + ".weight")), "bias": g(k + ".bias")}

    p: Dict = {
        "patch_embed": {
            "kernel": g("embeddings.patch_embeddings.projection.weight"),
            "bias": g("embeddings.patch_embeddings.projection.bias")},
        "embed_norm": ln("embeddings.norm"),
        "final_norm": ln("layernorm"),
    }
    for si, depth in enumerate(depths):
        for bi in range(depth):
            b = f"encoder.layers.{si}.blocks.{bi}."
            p[f"stage{si}_block{bi}"] = {
                "ln1": ln(b + "layernorm_before"),
                "ln2": ln(b + "layernorm_after"),
                "q": dense(b + "attention.self.query"),
                "k": dense(b + "attention.self.key"),
                "v": dense(b + "attention.self.value"),
                "proj": dense(b + "attention.output.dense"),
                "fc1": dense(b + "intermediate.dense"),
                "fc2": dense(b + "output.dense"),
                "rel_bias_table": g(
                    b + "attention.self.relative_position_bias_table"),
            }
        if si < len(depths) - 1:
            d = f"encoder.layers.{si}.downsample."
            p[f"downsample{si}"] = {
                "norm": ln(d + "norm"),
                "reduction": {"kernel": _lin(g(d + "reduction.weight"))}}
    return tensors(p)
