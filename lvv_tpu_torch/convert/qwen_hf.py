"""HF Qwen2 / Qwen2.5 checkpoint -> the port's QwenModel (counterpart of
lvv_tpu/convert/qwen_hf.py). Keys of the result are relative to "llm.";
Linear weights [out, in] become Dense kernels [in, out]."""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .params import tensors


def _linear(w):
    return np.transpose(np.asarray(w), (1, 0))


def _extend(w: np.ndarray, extra_tokens: int) -> np.ndarray:
    """Append `extra_tokens` rows, each the mean of the existing rows (the
    reference's resize_token_embeddings init)."""
    if not extra_tokens:
        return w
    mean = w.mean(axis=0, keepdims=True)
    return np.concatenate([w] + [mean] * extra_tokens, axis=0)


def convert_qwen_state(sd: Mapping[str, np.ndarray], num_layers: int,
                       tie_word_embeddings: bool = True,
                       extra_tokens: int = 0) -> Dict[str, torch.Tensor]:
    """HF `model.*` key space -> QwenModel parameters; with `extra_tokens`
    the embedding (and an untied lm_head) gain mean-initialised rows."""
    def g(k):
        return np.asarray(sd[k])

    p: Dict = {"embed_tokens": {"embedding": _extend(
                   g("model.embed_tokens.weight"), extra_tokens)},
               "final_ln": {"scale": g("model.norm.weight")}}
    for i in range(num_layers):
        b = f"model.layers.{i}."
        attn = {name: {"kernel": _linear(g(b + f"self_attn.{name}.weight"))}
                for name in ("q_proj", "k_proj", "v_proj", "o_proj")}
        for name in ("q_proj", "k_proj", "v_proj"):
            attn[name]["bias"] = g(b + f"self_attn.{name}.bias")
        p[f"layer_{i}"] = {
            "input_ln": {"scale": g(b + "input_layernorm.weight")},
            "post_attn_ln": {
                "scale": g(b + "post_attention_layernorm.weight")},
            "attn": attn,
            "mlp": {name: {"kernel": _linear(g(b + f"mlp.{name}.weight"))}
                    for name in ("gate_proj", "up_proj", "down_proj")},
        }
    if not tie_word_embeddings and "lm_head.weight" in sd:
        p["lm_head"] = {"kernel": _linear(_extend(g("lm_head.weight"),
                                                  extra_tokens))}
    return tensors(p)


def convert_peft_lora(sd: Mapping[str, np.ndarray],
                      num_layers: int) -> Dict[str, torch.Tensor]:
    """PEFT LoRA state dict (`...layers.N.self_attn.q_proj.lora_A.weight`
    style, as the reference trainer saves it) -> the lora_a / lora_b
    parameters alone. PEFT stores A [r, in] and B [out, r]; Dense wants
    [in, r] and [r, out]."""
    p: Dict = {}
    for k, v in sd.items():
        parts = k.split(".")
        if "layers" not in parts or "lora_A" not in k and "lora_B" not in k:
            continue
        i = int(parts[parts.index("layers") + 1])
        proj = next(s for s in parts if s.endswith("_proj"))
        which = "lora_a" if "lora_A" in k else "lora_b"
        layer = p.setdefault(f"layer_{i}", {}).setdefault("attn", {})
        layer.setdefault(proj, {})[which] = _linear(v)
    return tensors(p)
