"""LiDAR sweeps from disk (the port's own copy of the numpy path of
lvv_tpu/native/__init__.py:load_points and tools/precompute_bev.py's
reader).

A nuScenes LIDAR_TOP `.pcd.bin` is float32 rows of 5 values (x, y, z,
intensity, ring index); the model reads the first 4, zero-padded to a
fixed `max_points` rows. The JAX package also has a C++ reader
(native/lvv_io.cpp); the port reads with numpy only.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def load_points(path, max_points: int, in_dim: int = 5,
                out_dim: int = 4) -> Tuple[np.ndarray, int]:
    """`.pcd.bin` -> ([max_points, out_dim] float32, rows kept): the first
    out_dim values of each of the first max_points rows, zeros after."""
    if out_dim > in_dim:
        raise ValueError(f"out_dim={out_dim} > in_dim={in_dim}")
    raw = np.fromfile(path, dtype=np.float32).reshape(-1, in_dim)[:, :out_dim]
    n = min(len(raw), max_points)
    out = np.zeros((max_points, out_dim), np.float32)
    out[:n] = raw[:n]
    return out, n
