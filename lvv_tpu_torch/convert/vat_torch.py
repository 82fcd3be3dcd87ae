"""The reference's fusion modules -> the port's VATLiDAR, VATVision,
VisionAdapter and projector (counterpart of lvv_tpu/convert/vat_torch.py).

Key names follow the reference modules: vat_lidar (refine.0 depthwise conv,
proj 1x1 conv, norm_tokens, geo_mlp.{0,2}, view_embed, query,
blocks.N.{sa_ln, sa.*, ca_ln, ca.*, mlp_ln, mlp.{0,3}}, final_ln,
post.{0,1,4}); vat_vision (query, view_query_embed, blocks.N.*, final_ln,
post.{0,1,4}, proj.{0,1,4,5}); vision_adapter (norm, view_embed); the
projector's `layers` (a Linear, or a Sequential of Linears and GELUs).
Keys of each result are relative to the module ("vat_lidar.",
"vat_vision.", "adapter.", "deepencoder.projector."); the depthwise conv
keeps torch's [C, 1, k, k] layout.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .params import tensors


def _lin(w) -> np.ndarray:
    """torch Linear weight [out, in] -> Dense kernel [in, out]."""
    return np.ascontiguousarray(np.asarray(w).T)


def _ln(sd: Mapping, pfx: str) -> Dict[str, np.ndarray]:
    return {"scale": np.asarray(sd[pfx + ".weight"]),
            "bias": np.asarray(sd[pfx + ".bias"])}


def _dense(sd: Mapping, pfx: str) -> Dict[str, np.ndarray]:
    out = {"kernel": _lin(sd[pfx + ".weight"])}
    if pfx + ".bias" in sd:
        out["bias"] = np.asarray(sd[pfx + ".bias"])
    return out


def _mha(sd: Mapping, pfx: str) -> Dict:
    """torch nn.MultiheadAttention (in_proj packs [3d, d]) ->
    q_proj / k_proj / v_proj / o_proj."""
    w = np.asarray(sd[pfx + ".in_proj_weight"])
    b = np.asarray(sd[pfx + ".in_proj_bias"])
    d = w.shape[0] // 3
    out = {name: {"kernel": _lin(w[j * d:(j + 1) * d]),
                  "bias": b[j * d:(j + 1) * d]}
           for j, name in enumerate(("q_proj", "k_proj", "v_proj"))}
    out["o_proj"] = {"kernel": _lin(sd[pfx + ".out_proj.weight"]),
                     "bias": np.asarray(sd[pfx + ".out_proj.bias"])}
    return out


def _blocks(sd: Mapping) -> Dict:
    out, n = {}, 0
    while f"blocks.{n}.sa_ln.weight" in sd:
        pfx = f"blocks.{n}"
        out[f"block_{n}"] = {
            "ln_self": _ln(sd, pfx + ".sa_ln"),
            "self_attn": _mha(sd, pfx + ".sa"),
            "ln_cross_q": _ln(sd, pfx + ".ca_ln"),
            "cross_attn": _mha(sd, pfx + ".ca"),
            "ln_mlp": _ln(sd, pfx + ".mlp_ln"),
            "mlp": {"fc1": _dense(sd, pfx + ".mlp.0"),
                    "fc2": _dense(sd, pfx + ".mlp.3")},
        }
        n += 1
    return out


def convert_vat_lidar_state(
        sd: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Reference VATLiDAR state dict -> VATLiDAR parameters."""
    return tensors({
        "dw_refine": {"kernel": np.asarray(sd["refine.0.weight"]),
                      "bias": np.asarray(sd["refine.0.bias"])},
        # 1x1 conv [d_model, C, 1, 1] -> Dense kernel [C, d_model]
        "in_proj": {"kernel": _lin(np.asarray(sd["proj.weight"])[:, :, 0, 0]),
                    "bias": np.asarray(sd["proj.bias"])},
        "in_ln": _ln(sd, "norm_tokens"),
        "pe_fc1": _dense(sd, "geo_mlp.0"),
        "pe_fc2": _dense(sd, "geo_mlp.2"),
        "sector_embed": np.asarray(sd["view_embed"]),
        "queries": np.asarray(sd["query"]),
        "final_ln": _ln(sd, "final_ln"),
        "post_ln": _ln(sd, "post.0"),
        "post_fc1": _dense(sd, "post.1"),
        "post_fc2": _dense(sd, "post.4"),
        **_blocks(sd)})


def convert_vat_vision_state(
        sd: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Reference VATVision state dict -> VATVision parameters."""
    out = {
        "queries": np.asarray(sd["query"]),
        "final_ln": _ln(sd, "final_ln"),
        "post_ln": _ln(sd, "post.0"),
        "post_fc1": _dense(sd, "post.1"),
        "post_fc2": _dense(sd, "post.4"),
        "proj_ln": _ln(sd, "proj.0"),
        "proj_fc1": _dense(sd, "proj.1"),
        "proj_fc2": _dense(sd, "proj.4"),
        "out_ln": _ln(sd, "proj.5"),
        **_blocks(sd)}
    if sd.get("view_query_embed") is not None:
        out["view_embed"] = np.asarray(sd["view_query_embed"])
    return tensors(out)


def convert_vision_adapter_state(
        sd: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Reference VisionAdapter state dict -> VisionAdapter parameters."""
    return tensors({"ln": _ln(sd, "norm"),
                    "view_embed": np.asarray(sd["view_embed"])})


def convert_projector_state(sd: Mapping[str, np.ndarray],
                            kind: str = "linear") -> Dict[str, torch.Tensor]:
    """Reference MlpProjector -> the projector's parameters, for the linear,
    mlp_gelu and downsample kinds: `layers` (linear) or the Linears of the
    Sequential as mlp_0, mlp_1, ... (the GELUs hold no parameters but take
    a slot), after the LayerNorm that the normlayer kind stacks first."""
    if kind == "identity":
        return {}
    if kind == "linear":
        return tensors({"proj": _dense(sd, "layers")})
    if kind not in ("mlp_gelu", "downsample_mlp_gelu",
                    "normlayer_downsample_mlp_gelu"):
        raise ValueError(f"no converter for projector kind {kind!r}")
    out: Dict = {}
    i = 0
    if kind.startswith("normlayer"):
        out["pre_ln"] = _ln(sd, "layers.0")
        i = 1
    li = 0
    while f"layers.{i}.weight" in sd:
        if np.asarray(sd[f"layers.{i}.weight"]).ndim != 2:
            i += 1
            continue
        out[f"mlp_{li}"] = _dense(sd, f"layers.{i}")
        li += 1
        i += 2
    return tensors(out)
