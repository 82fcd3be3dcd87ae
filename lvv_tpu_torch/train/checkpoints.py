"""Checkpoint save / restore with tags and pruning (counterpart of
lvv_tpu/train/checkpoints.py, on torch.save in place of Orbax).

A checkpoint is a directory `<dir>/<name>/` holding `state/state.pt` (the
train state's `state_dict()`, or any object of tensors, dicts, lists and
numbers), `meta.json` ({"step": N}) and, given a config, `config.json`.
Names are `step_<N>`, or a tag (`latest`, `best_e<epoch>`); `best.json`
names the best one. The same policy as JAX's: keep the newest `keep_last`
`step_<N>` checkpoints plus the best one; restore from `latest` first, then
newest first, skipping a checkpoint that does not load.
"""
from __future__ import annotations

import json
import os
import pickle
import pathlib
import re
import shutil
from typing import Any, Optional

import torch

from .. import config as config_lib

STEP_RE = re.compile(r"^step_(\d+)$")


class CheckpointManager:
    def __init__(self, directory, keep_last: int = 3):
        self.dir = pathlib.Path(directory).absolute()
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep_last = keep_last

    # -------- save --------

    def save(self, state: Any, *, step: int, tag: Optional[str] = None,
             cfg=None, is_best: bool = False) -> pathlib.Path:
        name = tag or f"step_{step}"
        path = self.dir / name
        if path.exists():
            shutil.rmtree(path)
        (path / "state").mkdir(parents=True)
        payload = (state.state_dict() if hasattr(state, "state_dict")
                   else state)
        tmp = path / "state" / "state.pt.tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path / "state" / "state.pt")
        (path / "meta.json").write_text(json.dumps({"step": int(step)}))
        if cfg is not None:
            config_lib.save(cfg, path / "config.json")
        if is_best:
            (self.dir / "best.json").write_text(json.dumps(
                {"name": name, "step": int(step)}))
        self._prune()
        return path

    def _prune(self) -> None:
        """Keep the newest `keep_last` step_N directories plus the tagged
        and best ones."""
        best = None
        best_file = self.dir / "best.json"
        if best_file.exists():
            best = json.loads(best_file.read_text()).get("name")
        steps = sorted(
            (int(STEP_RE.match(p.name).group(1)), p)
            for p in self.dir.iterdir()
            if p.is_dir() and STEP_RE.match(p.name))
        for _, p in steps[:-self.keep_last] if self.keep_last else []:
            if p.name != best:
                shutil.rmtree(p)

    # -------- restore --------

    def available(self):
        """[(step, name)] of the checkpoints present, oldest first."""
        out = []
        for p in self.dir.iterdir():
            if p.is_dir() and (p / "state").exists():
                m = STEP_RE.match(p.name)
                step = int(m.group(1)) if m else -1
                meta = p / "meta.json"
                if meta.exists():
                    step = json.loads(meta.read_text()).get("step", step)
                out.append((step, p.name))
        return sorted(out)

    def latest(self) -> Optional[str]:
        if (self.dir / "latest" / "state").exists():
            return "latest"
        avail = self.available()
        return avail[-1][1] if avail else None

    def restore(self, name: str, target: Any) -> Any:
        """Load checkpoint `name`: into `target` where it has
        `load_state_dict` (a train state; returned), else the saved object
        itself (tensors on the CPU). Raises if it does not load."""
        data = torch.load(self.dir / name / "state" / "state.pt",
                          map_location="cpu", weights_only=True)
        if hasattr(target, "load_state_dict"):
            target.load_state_dict(data)
            return target
        return data

    def try_restore_newest(self, target: Any):
        """-> (state, step) from the newest loadable checkpoint (`latest`
        first), else (None, 0)."""
        names = [n for _, n in reversed(self.available())]
        lt = self.latest()
        if lt and lt in names:
            names.remove(lt)
            names.insert(0, lt)
        for name in names:
            try:
                state = self.restore(name, target)
            except (OSError, RuntimeError, KeyError, EOFError, ValueError,
                    pickle.UnpicklingError) as e:
                print(f"[ckpt] skipping {name}: {e}")
                continue
            meta = self.dir / name / "meta.json"
            step = (json.loads(meta.read_text()).get("step", 0)
                    if meta.exists() else 0)
            return state, step
        return None, 0
