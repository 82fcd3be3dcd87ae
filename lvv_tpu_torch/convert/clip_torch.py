"""OpenCLIP ViT-L/14 visual tower -> the port's CLIPVisionTower
(counterpart of lvv_tpu/convert/clip_torch.py). Keys of the result are
relative to "deepencoder.clip."; `patch_embed.kernel` (torch OIHW) exists
only on a tower built with its own patcher."""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .params import tensors


def _linear(w):
    return np.transpose(np.asarray(w), (1, 0))


def convert_clip_state(sd: Mapping[str, np.ndarray], num_layers: int = 24,
                       prefix: str = "visual.") -> Dict[str, torch.Tensor]:
    """`visual.*` (class_embedding, positional_embedding, conv1, ln_pre,
    transformer.resblocks.N.{ln_1, attn.in_proj_*, attn.out_proj, ln_2,
    mlp.c_fc, mlp.c_proj}) -> CLIPVisionTower parameters; in_proj's packed
    q / k / v rows split into q_proj / k_proj / v_proj."""
    def g(k):
        return np.asarray(sd[prefix + k])

    def dense(w, b):
        return {"kernel": _linear(w), "bias": b}

    p: Dict = {"cls_token": g("class_embedding"),
               "pos_embed": g("positional_embedding"),
               "patch_embed": {"kernel": g("conv1.weight")},
               "pre_ln": {"scale": g("ln_pre.weight"),
                          "bias": g("ln_pre.bias")}}
    for i in range(num_layers):
        b = f"transformer.resblocks.{i}."
        w, bias = g(b + "attn.in_proj_weight"), g(b + "attn.in_proj_bias")
        h = w.shape[1]
        p[f"layer_{i}"] = {
            "ln1": {"scale": g(b + "ln_1.weight"), "bias": g(b + "ln_1.bias")},
            "ln2": {"scale": g(b + "ln_2.weight"), "bias": g(b + "ln_2.bias")},
            "attn": {
                name: dense(w[j * h:(j + 1) * h], bias[j * h:(j + 1) * h])
                for j, name in enumerate(("q_proj", "k_proj", "v_proj"))},
            "fc1": dense(g(b + "mlp.c_fc.weight"), g(b + "mlp.c_fc.bias")),
            "fc2": dense(g(b + "mlp.c_proj.weight"), g(b + "mlp.c_proj.bias")),
        }
        p[f"layer_{i}"]["attn"]["o_proj"] = dense(
            g(b + "attn.out_proj.weight"), g(b + "attn.out_proj.bias"))
    return tensors(p)


_LAYER_RENAMES = {"layer_norm1.weight": "ln_1.weight",
                  "layer_norm1.bias": "ln_1.bias",
                  "layer_norm2.weight": "ln_2.weight",
                  "layer_norm2.bias": "ln_2.bias",
                  "mlp.fc1.weight": "mlp.c_fc.weight",
                  "mlp.fc1.bias": "mlp.c_fc.bias",
                  "mlp.fc2.weight": "mlp.c_proj.weight",
                  "mlp.fc2.bias": "mlp.c_proj.bias",
                  "self_attn.out_proj.weight": "attn.out_proj.weight",
                  "self_attn.out_proj.bias": "attn.out_proj.bias"}


def from_transformers_clip(sd: Mapping[str, np.ndarray]
                           ) -> Dict[str, np.ndarray]:
    """transformers CLIPVisionModel naming -> OpenCLIP `visual.*` naming,
    q / k / v repacked into in_proj_(weight|bias)."""
    out: Dict[str, np.ndarray] = {}
    qkv: Dict[str, Dict[str, np.ndarray]] = {}
    for k, v in sd.items():
        v = np.asarray(v)
        k = k.replace("vision_model.", "")
        if k == "embeddings.class_embedding":
            out["visual.class_embedding"] = v
        elif k == "embeddings.position_embedding.weight":
            out["visual.positional_embedding"] = v
        elif k == "embeddings.patch_embedding.weight":
            out["visual.conv1.weight"] = v
        elif k.startswith("pre_layrnorm."):
            out["visual.ln_pre." + k.split(".", 1)[1]] = v
        elif k.startswith("encoder.layers."):
            parts = k.split(".")
            i, rest = parts[2], ".".join(parts[3:])
            if rest in _LAYER_RENAMES:
                out[f"visual.transformer.resblocks.{i}."
                    + _LAYER_RENAMES[rest]] = v
            elif rest.startswith("self_attn."):
                qkv.setdefault(i, {})[rest.split(".", 1)[1]] = v
    for i, d in qkv.items():
        b = f"visual.transformer.resblocks.{i}."
        for part in ("weight", "bias"):
            out[b + f"attn.in_proj_{part}"] = np.concatenate(
                [d[f"{n}_proj.{part}"] for n in "qkv"], 0)
    return out
