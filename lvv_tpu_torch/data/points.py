"""LiDAR sweeps from disk.

A nuScenes LIDAR_TOP `.pcd.bin` is float32 rows of 5 values (x, y, z,
intensity, ring index); the model reads the first 4, zero-padded to a
fixed `max_points` rows. `load_points` reads through the port's native
host I/O library (`lvv_tpu_torch.native`, native/lvv_io.cpp built with
g++ at first use), as the JAX package's tools do; `load_points_plain` is
its numpy version.
"""
from ..native import load_points, load_points_plain

__all__ = ["load_points", "load_points_plain"]
