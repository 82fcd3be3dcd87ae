"""Devkit-free nuScenes / Lyft table reader (the port's copy of
lvv_tpu/data/nuscenes_tables.py).

The nuScenes devkit's ``NuScenes`` object is, at its core, (a) the
version dir's JSON tables loaded into lists, (b) a token index per
table, and (c) reverse indexes decorating each ``sample`` with
``data[channel] -> sample_data token`` and ``anns -> [annotation
tokens]`` (devkit ``NuScenes.__make_reverse_index__``).  Everything in
:mod:`lvv_tpu.data.nuscenes_utils` is duck-typed against exactly that
surface (``get``/``get_sample_data_path``/``.sample``), so this ~100-line
reader resolves the VQA dataset's camera paths (and the JAX package's info
building) with zero third-party dependencies — Lyft Level-5 uses the same
table schema (its devkit is a nuScenes-devkit fork), just different
directory names.

Layout expectations:
- nuScenes: ``<dataroot>/<version>/*.json``; blobs referenced by each
  ``sample_data.filename`` relative to ``<dataroot>``.
- Lyft: tables in ``<dataroot>/<version or 'train_data'>/*.json``; blobs
  relative to ``<dataroot>`` (``lidar/...``, ``images/...``; the usual
  setup symlinks ``train_lidar -> lidar``).
"""
from __future__ import annotations

import json
import pathlib
from typing import Dict, List, Optional

# Tables that exist in every nuScenes-schema release.  `map`/`attribute`/
# `visibility`/`log` are loaded when present but nothing here needs them.
_CORE_TABLES = ("category", "instance", "sensor", "calibrated_sensor",
                "ego_pose", "scene", "sample", "sample_data",
                "sample_annotation")
_OPTIONAL_TABLES = ("attribute", "visibility", "log", "map")


class TableNuScenes:
    """Minimal stand-in for ``nuscenes.NuScenes`` (tables + indexes only).

    Implements the members the datasets use (``get``, ``getind`` via token
    index, ``get_sample_data_path``, ``.sample``, ``.scene``) plus the
    devkit's sample/annotation reverse indexes and derived fields
    (``sample_data.channel``, ``sample_annotation.category_name``).
    """

    def __init__(self, version: str, dataroot: str,
                 table_dir: Optional[str] = None, verbose: bool = False):
        self.version = version
        self.dataroot = pathlib.Path(dataroot)
        tdir = pathlib.Path(table_dir) if table_dir else \
            self.dataroot / version
        if not tdir.is_dir():
            raise FileNotFoundError(f"table dir {tdir} does not exist")
        self._tables: Dict[str, List[Dict]] = {}
        self._index: Dict[str, Dict[str, Dict]] = {}
        for name in _CORE_TABLES + _OPTIONAL_TABLES:
            path = tdir / f"{name}.json"
            if not path.exists():
                if name in _CORE_TABLES:
                    raise FileNotFoundError(f"missing table {path}")
                continue
            with open(path) as f:
                rows = json.load(f)
            self._tables[name] = rows
            self._index[name] = {r["token"]: r for r in rows}
            if verbose:
                print(f"{len(rows)} {name}")
        self.__make_reverse_index__()

    # --- devkit API surface -------------------------------------------

    def get(self, table_name: str, token: str) -> Dict:
        return self._index[table_name][token]

    def get_table(self, table_name: str) -> List[Dict]:
        return self._tables[table_name]

    @property
    def sample(self) -> List[Dict]:
        return self._tables["sample"]

    @property
    def scene(self) -> List[Dict]:
        return self._tables["scene"]

    @property
    def sample_annotation(self) -> List[Dict]:
        return self._tables["sample_annotation"]

    def get_sample_data_path(self, sample_data_token: str) -> str:
        sd = self.get("sample_data", sample_data_token)
        return str(self.dataroot / sd["filename"])

    # --- reverse indexes (devkit __make_reverse_index__) ---------------

    def __make_reverse_index__(self) -> None:
        for ann in self._tables["sample_annotation"]:
            inst = self.get("instance", ann["instance_token"])
            ann["category_name"] = self.get(
                "category", inst["category_token"])["name"]
        for sd in self._tables["sample_data"]:
            cs = self.get("calibrated_sensor",
                          sd["calibrated_sensor_token"])
            sd["channel"] = self.get("sensor",
                                     cs["sensor_token"])["channel"]
        for sample in self._tables["sample"]:
            sample.setdefault("data", {})
            sample.setdefault("anns", [])
        for sd in self._tables["sample_data"]:
            if sd.get("is_key_frame"):
                sample = self.get("sample", sd["sample_token"])
                sample["data"][sd["channel"]] = sd["token"]
        for ann in self._tables["sample_annotation"]:
            self.get("sample", ann["sample_token"])["anns"].append(
                ann["token"])

    # --- conveniences ---------------------------------------------------

    @staticmethod
    def find_version(dataroot) -> Optional[str]:
        """Autodetect the table dir name (the subdir holding sample.json)."""
        root = pathlib.Path(dataroot)
        if not root.is_dir():
            return None
        for cand in sorted(root.iterdir()):
            if cand.is_dir() and (cand / "sample.json").exists():
                return cand.name
        return None

    def scene_splits(self, train_names, val_names):
        """Scene-name lists -> (train_tokens, val_tokens)."""
        train = [s["token"] for s in self.scene if s["name"] in
                 set(train_names)]
        val = [s["token"] for s in self.scene if s["name"] in
               set(val_names)]
        return train, val
