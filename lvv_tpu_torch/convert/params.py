"""Weights from the JAX package's VQAModel param tree to the port.

`from_jax_params` takes the tree as nested dicts of numpy arrays (e.g.
`jax.tree_util.tree_map(np.asarray, params)`) and returns the port's
state_dict. Keys are the tree paths joined with "."; leaves keep their
layout except convolution kernels: flax HWIO (and the depthwise (k, k, 1, C)
kernel) become torch OIHW. Dense kernels stay [in, out] and embedding
tables [V, D]. A leaf with no port parameter, a shape that does not match,
or a port parameter left unfilled raises.

`from_jax_detector_params` does the same for the JAX package's detector
variables, `{"params": ..., "batch_stats": ...}` (the running statistics
of VoxelNeXt's "bn" norm, when the config has it), for every family the
port builds: the port's buffers take the `batch_stats` leaves, sparse conv
kernels keep the [K, Cin, Cout] layout, flax Dense kernels [in, out],
flax LayerNorm scales and biases as they are, every other conv kernel
(Swin's patch embedding, the camera branches' convs) HWIO -> OIHW, Swin's
relative-position tables [(2w - 1)², heads] as they are, and a module of
the port may convert its own leaves (`from_jax_leaf`: the transposed
convs, whose flax kernels are flipped into PyTorch's layout).

`merge` overlays a partial state_dict from one of the checkpoint converters
(`convert_*_state`) onto a model's, with the same shape checks.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from ..config import ModelConfig, VoxelizeConfig, VoxelNeXtConfig
from ..models.layers import resolve_device


def _flatten(tree: Mapping, prefix: str = "",
             sep: str = ".") -> Dict[str, np.ndarray]:
    """Nested dicts -> {path joined with `sep`: numpy leaf}."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, key + sep, sep))
        else:
            out[key] = np.asarray(v)
    return out


def tensors(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Nested numpy dicts -> a flat {"a.b.c": tensor} state_dict (CPU),
    each leaf copied."""
    return {k: torch.from_numpy(np.array(v))
            for k, v in _flatten(tree).items()}


def merge(state: Mapping[str, torch.Tensor],
          converted: Mapping[str, torch.Tensor],
          prefix: str = "") -> Dict[str, torch.Tensor]:
    """Overlay `converted` (keys relative to `prefix`, e.g.
    "deepencoder.sam.") onto `state`: every converted key must name a
    parameter of the same shape, and takes its dtype and device. Keys that
    `converted` lacks keep their value (e.g. VARY net_2 / net_3 when loading
    a raw SAM checkpoint)."""
    out = dict(state)
    for k, v in converted.items():
        key = prefix + k
        if key not in out:
            raise KeyError(f"converted key {key!r} is not a model parameter")
        if tuple(out[key].shape) != tuple(v.shape):
            raise ValueError(f"shape mismatch at {key}: model "
                             f"{tuple(out[key].shape)} vs checkpoint "
                             f"{tuple(v.shape)}")
        out[key] = torch.as_tensor(v).to(dtype=out[key].dtype,
                                         device=out[key].device)
    return out


def _lora_rank(flat: Dict[str, np.ndarray], prefix: str) -> int:
    for k, v in flat.items():
        if k.startswith(prefix) and k.endswith(".lora_a"):
            return int(v.shape[1])
    return 0


def from_jax_params(params: Mapping, cfg: ModelConfig, *,
                    device=None) -> Dict[str, torch.Tensor]:
    """JAX VQAModel params -> the port's VQAModel state_dict, on `device`
    (the card unless told otherwise), in the arrays' own dtype
    (`load_state_dict` casts to the model's)."""
    from ..models.vqa import VQAModel
    flat = _flatten(params)
    # the port model built on the meta device lists every parameter to fill
    ref = VQAModel(cfg, dtype=torch.float32, device="meta",
                   llm_lora_rank=_lora_rank(flat, "llm."),
                   clip_lora_rank=_lora_rank(flat, "deepencoder.clip."))
    return _convert(flat, ref, resolve_device(device))


def from_jax_detector_params(variables: Mapping, det_cfg: VoxelNeXtConfig,
                             vox_cfg: VoxelizeConfig, *, device=None,
                             detector: str = "VoxelNeXt", **options
                             ) -> Dict[str, torch.Tensor]:
    """JAX detector variables ({"params"} and, with VoxelNeXt's norm "bn",
    {"batch_stats"}) of the family `detector` (a registry name the port
    builds, with the family's `options` where they change its shapes, as
    the JAX module's attributes do: e.g. BEVFusion's Swin widths) -> the
    port's detector's state_dict, on `device` (the card unless told
    otherwise)."""
    from ..models.registry import build_detector
    flat = {**_flatten(variables["params"]),
            **_flatten(variables.get("batch_stats", {}))}
    ref = build_detector(detector, det_cfg, vox_cfg, device="meta",
                         **options)
    return _convert(flat, ref, resolve_device(device))


def _convert(flat: Dict[str, np.ndarray], ref: torch.nn.Module,
             device) -> Dict[str, torch.Tensor]:
    """Flat JAX leaves -> tensors under the state_dict keys of `ref` (a
    model on the meta device), each checked against its shape; every key
    of `ref` must be filled."""
    expected = {k: tuple(v.shape) for k, v in ref.state_dict().items()}
    out = {}
    for key, arr in flat.items():
        if key not in expected:
            raise KeyError(f"JAX leaf {key!r} has no port parameter")
        owner, _, leaf = key.rpartition(".")
        hook = getattr(ref.get_submodule(owner), "from_jax_leaf", None)
        if hook is not None:                       # e.g. a flipped deconv
            arr = hook(leaf, arr)
        elif arr.ndim == 4 and key.endswith(".kernel"):
            arr = arr.transpose(3, 2, 0, 1)        # HWIO -> OIHW
        if tuple(arr.shape) != expected[key]:
            raise ValueError(f"{key}: JAX shape {arr.shape} does not match "
                             f"the port's {expected[key]}")
        out[key] = torch.from_numpy(np.array(arr, order="C")).to(device)
    missing = sorted(expected.keys() - out.keys())
    if missing:
        raise KeyError(f"port parameters without a JAX leaf: {missing}")
    return out
