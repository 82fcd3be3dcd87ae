"""MixedNuDataset: nuCaption + nuGrounding QA over precomputed BEV features
(the port's copy of lvv_tpu/data/dataset.py).

- BEV features indexed by sample token from `bev_feats/**/<token>.npy`
  (float16 [C, H, W] — the L2->L4 contract, SURVEY.md §1);
- QA rows from JSON/JSONL with `sample_token`, `question`,
  `answer`/`answer_lidar`, `template_type`;
- nuGrounding rows filtered to `template_type == "det_area"` to avoid
  answer leakage (reference dataset.py:76-91);
- camera frames resolved through the nuScenes tables when available,
  otherwise marked missing (the model zero-fills invalid views).

Host-side and framework-free: returns numpy; batching / padding happens in
the collator, device placement in the trainer's prefetcher.
"""
from __future__ import annotations

import json
import pathlib
from typing import Dict, List, Optional, Sequence

import numpy as np

CAM_VIEWS = ("CAM_FRONT", "CAM_FRONT_RIGHT", "CAM_FRONT_LEFT",
             "CAM_BACK", "CAM_BACK_RIGHT", "CAM_BACK_LEFT")


def index_bev_features(root: str) -> Dict[str, pathlib.Path]:
    """token -> npy path (reference utils.py:24-49 glob **/*.npy)."""
    out: Dict[str, pathlib.Path] = {}
    root_p = pathlib.Path(root)
    if not root_p.exists():
        return out
    for p in sorted(root_p.rglob("*.npy")):
        out[p.stem] = p
    return out


def load_qa_rows(path: str, *, answer_key: str = "answer",
                 template_filter: Optional[str] = None) -> List[dict]:
    """JSON (list) or JSONL rows; optional template_type filter
    (reference dataset.py:79-105)."""
    p = pathlib.Path(path)
    if not p.exists():
        return []
    text = p.read_text()
    if p.suffix == ".jsonl":
        rows = [json.loads(line) for line in text.splitlines() if line.strip()]
    else:
        rows = json.loads(text)
        if isinstance(rows, dict):
            rows = rows.get("data", list(rows.values()))
    out = []
    for r in rows:
        if template_filter and r.get("template_type") != template_filter:
            continue
        ans = r.get(answer_key) or r.get("answer") or r.get("answer_lidar")
        if not r.get("sample_token") or not r.get("question") or ans is None:
            continue
        out.append({"sample_token": r["sample_token"],
                    "question": r["question"], "answer": str(ans),
                    "template_type": r.get("template_type", "caption")})
    return out


def make_nusc_handle(dataroot: Optional[str]):
    """Best-effort nuScenes handle for camera-path resolution: the devkit
    when importable, else the devkit-free table reader
    (:class:`nuscenes_tables.TableNuScenes`), else None —
    downstream zero-fills missing views exactly like the reference
    (trainer.py:535-541, deepencoder_infer.py:536-549)."""
    if not dataroot:
        return None
    from .nuscenes_tables import TableNuScenes
    version = TableNuScenes.find_version(dataroot)
    if version is None:
        return None
    try:
        from nuscenes import NuScenes
        return NuScenes(version=version, dataroot=dataroot, verbose=False)
    except Exception:
        # devkit absent OR unable to load this table dump (e.g. a minimal
        # dump without devkit-only tables) — the table reader handles it
        return TableNuScenes(version=version, dataroot=dataroot)


class MixedNuDataset:
    """Caption + grounding mixture keyed by BEV availability."""

    def __init__(self, bev_dir: str, caption_json: str, grounding_json: str,
                 grounding_template_filter: str = "det_area",
                 nusc=None, dataroot: Optional[str] = None):
        self.bev_index = index_bev_features(bev_dir)
        cap = load_qa_rows(caption_json)
        grd = load_qa_rows(grounding_json, answer_key="answer_lidar",
                           template_filter=grounding_template_filter)
        rows = cap + grd
        # keep only rows whose BEV features exist (reference behavior: the
        # dataset indexes features first and drops tokens without them)
        self.rows = [r for r in rows if r["sample_token"] in self.bev_index]
        self.nusc = nusc
        self.dataroot = dataroot

    def __len__(self) -> int:
        return len(self.rows)

    def cam_paths(self, token: str) -> List[Optional[str]]:
        """Resolve 6 camera jpg paths via nuScenes tables (reference
        deepencoder_infer.py:357-373); None for missing views."""
        if self.nusc is None:
            return [None] * len(CAM_VIEWS)
        out = []
        sample = self.nusc.get("sample", token)
        for cam in CAM_VIEWS:
            try:
                sd = self.nusc.get("sample_data", sample["data"][cam])
                out.append(str(pathlib.Path(self.nusc.dataroot)
                               / sd["filename"]))
            except Exception:
                out.append(None)
        return out

    def __getitem__(self, i: int) -> dict:
        r = self.rows[i]
        token = r["sample_token"]
        bev = np.load(self.bev_index[token]).astype(np.float32)  # [C, H, W]
        return {"token": token, "bev": bev, "question": r["question"],
                "answer": r["answer"], "template_type": r["template_type"],
                "cam_paths": self.cam_paths(token)}


def split_rows(n: int, val_fraction: float, seed: int):
    """Deterministic train/val split over row indices."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    n_val = max(int(n * val_fraction), 1) if n else 0
    return perm[n_val:], perm[:n_val]


class DeterministicSampler:
    """Seeded shuffling sampler with set_epoch + per-host sharding
    (reference SingleProcessDetSampler sampler.py:8-34 and the
    DistributedSampler pair, datasets/__init__.py:31-51)."""

    def __init__(self, indices: Sequence[int], seed: int = 0,
                 shuffle: bool = True, num_shards: int = 1, shard: int = 0,
                 drop_last: bool = True):
        self.indices = np.asarray(indices)
        self.seed = seed
        self.shuffle = shuffle
        self.num_shards = num_shards
        self.shard = shard
        self.drop_last = drop_last
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __iter__(self):
        idx = self.indices.copy()
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(idx)
        if self.num_shards > 1:
            if self.drop_last:
                n = len(idx) // self.num_shards * self.num_shards
                idx = idx[:n]
            else:  # pad to divisible (eval-style, reference pad-to-divisible)
                pad = (-len(idx)) % self.num_shards
                idx = np.concatenate([idx, idx[:pad]])
            idx = idx[self.shard::self.num_shards]
        return iter(idx.tolist())

    def __len__(self):
        n = len(self.indices)
        if self.num_shards > 1 and self.drop_last:
            return n // self.num_shards
        return -(-n // self.num_shards)
