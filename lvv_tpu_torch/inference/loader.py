"""ModelLoader: rebuild the VQA model from a checkpoint directory
(counterpart of lvv_tpu/inference/loader.py).

A checkpoint directory of the port holds `config.json` (`config.save`, the
same JSON as the JAX package's) and one of:

- `model.pt`: the port's state_dict (`torch.save`, read with
  `weights_only=True`), as `save_checkpoint` writes it;
- `params.npz`: a parameter tree of the JAX package's VQAModel, each leaf
  keyed by its path joined with "/" (flax's `flatten_dict(params,
  sep="/")`; "." is read too), converted on load by `from_jax_params`, as
  `save_params_npz` writes it. This is how a model the JAX package trained
  reaches the port.

The directory may instead be a root whose subdirectories are checkpoints
(one per step): `load_all` takes the newest one that reads.
"""
from __future__ import annotations

import logging
import pathlib
import pickle
import re
import zipfile
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from .. import config as config_lib
from ..config import VQAConfig
from ..convert import from_jax_params
from ..convert.params import _flatten
from ..data import load_tokenizer
from ..models.layers import resolve_device
from ..models.vqa import VQAModel

WEIGHT_FILES = ("model.pt", "params.npz")
# what reading a file that is not a whole checkpoint raises: torch.load's
# zip reader raises RuntimeError on a truncated archive, np.load ValueError
# on a file that is not an array archive
_READ_ERRORS = (OSError, EOFError, RuntimeError, ValueError,
                pickle.UnpicklingError, zipfile.BadZipFile)
log = logging.getLogger(__name__)


def save_checkpoint(model: VQAModel, cfg: VQAConfig,
                    directory) -> pathlib.Path:
    """Write `config.json` and `model.pt` (the model's state_dict) into
    `directory`; returns it."""
    d = pathlib.Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    config_lib.save(cfg, d / "config.json")
    torch.save(model.state_dict(), d / "model.pt")
    return d


def save_params_npz(params: Mapping, cfg: VQAConfig,
                    directory) -> pathlib.Path:
    """Write `config.json` and `params.npz` (a JAX VQAModel parameter tree
    as nested dicts of numpy arrays) into `directory`; returns it."""
    d = pathlib.Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    config_lib.save(cfg, d / "config.json")
    np.savez(d / "params.npz", **_flatten(params, sep="/"))
    return d


def _tree_from_npz(path: pathlib.Path) -> Dict:
    tree: Dict = {}
    with np.load(path) as z:
        for key in z.files:
            *parents, leaf = re.split(r"[/.]", key)
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    return tree


class ModelLoader:
    def __init__(self, checkpoint_dir, tokenizer_path: Optional[str] = None):
        self.dir = pathlib.Path(checkpoint_dir)
        self.cfg: VQAConfig = config_lib.from_dict(
            VQAConfig, config_lib.load_file(self._find_config()))
        self.tokenizer = load_tokenizer(tokenizer_path,
                                        self.cfg.model.llm.special_tokens)

    def _find_config(self) -> pathlib.Path:
        for cand in [self.dir / "config.json",
                     *sorted(self.dir.glob("*/config.json"))]:
            if cand.exists():
                return cand
        raise FileNotFoundError(f"no config.json under {self.dir}")

    def build_model(self, device=None) -> VQAModel:
        """The model of the config (its dtype and LoRA ranks), with seeded
        random weights, on `device` (the card unless told otherwise)."""
        m = self.cfg.model
        dtype = torch.bfloat16 if m.dtype == "bfloat16" else torch.float32
        return VQAModel(
            m, dtype=dtype, device=resolve_device(device),
            llm_lora_rank=m.llm_lora.r if m.llm_lora.enabled else 0,
            llm_lora_alpha=m.llm_lora.alpha,
            clip_lora_rank=m.clip_lora.r if m.clip_lora.enabled else 0,
            clip_lora_alpha=m.clip_lora.alpha)

    def checkpoints(self) -> List[pathlib.Path]:
        """Weight files in the directory and its subdirectories, newest
        first."""
        found = [d / name for d in [self.dir, *sorted(
                     p for p in self.dir.iterdir() if p.is_dir())]
                 for name in WEIGHT_FILES if (d / name).is_file()]
        return sorted(found, key=lambda p: p.stat().st_mtime, reverse=True)

    @staticmethod
    def _read(path: pathlib.Path):
        """The file's contents on the host: a state_dict (model.pt) or a
        JAX parameter tree (params.npz)."""
        if path.name == "model.pt":
            return torch.load(path, map_location="cpu", weights_only=True)
        return _tree_from_npz(path)

    def load_all(self, device=None) -> Tuple[VQAModel, Dict]:
        """-> (model, its state_dict) from the newest readable checkpoint;
        the model runs on `device` (the card unless told otherwise). A file
        that cannot be read (missing, truncated, not a checkpoint) is
        skipped with a warning and the next older one tried; a checkpoint
        that reads but does not fit the config's model raises."""
        model = self.build_model(device)
        failed = []
        for path in self.checkpoints():
            try:
                raw = self._read(path)
            except _READ_ERRORS as e:
                log.warning("skipping unreadable checkpoint %s: %s", path, e)
                failed.append(f"{path}: {e}")
                continue
            state = (raw if path.name == "model.pt" else
                     from_jax_params(raw, self.cfg.model,
                                     device=model.device))
            model.load_state_dict(state)
            return model, model.state_dict()
        raise FileNotFoundError(f"no loadable checkpoint under {self.dir}"
                                + "".join("\n  " + f for f in failed))
