"""The host I/O runtime in C++ (counterpart of lvv_tpu/native/__init__.py),
bound with ctypes.

`native/lvv_io.cpp` (a plain C interface) is compiled with g++ and
native/Makefile's flags into build/lvv_tpu_torch/ at first use; the file
name carries a hash of the source, the flags and the host's CPU (the flags
include -march=native), so a checkout copied to another machine builds its
own. A failed build raises: nothing falls back to numpy by itself.

- `load_points`: a `.pcd.bin` (float32 rows of in_dim values) -> the first
  out_dim values of its first max_points rows, zero-padded.
- `voxelize_mean_host`: the host mean-VFE voxelizer (first-come slots).
- `f32_to_f16`: float32 -> float16, round to nearest even.

Each has its plain numpy version (`*_plain`), which computes the same
values bit for bit (NaN aside: the C conversion makes it infinity); the
tests hold the library to them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import platform
import shutil
import subprocess
import threading
from typing import Tuple

import numpy as np

REPO = pathlib.Path(__file__).resolve().parents[2]
SOURCE = REPO / "native" / "lvv_io.cpp"
BUILD_DIR = REPO / "build" / "lvv_tpu_torch"
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall")
_F = ctypes.POINTER(ctypes.c_float)
_I32 = ctypes.POINTER(ctypes.c_int32)
_ARGTYPES = {
    "lvv_load_pcd": ([ctypes.c_char_p, _F, ctypes.c_int, ctypes.c_int,
                      ctypes.c_int], ctypes.c_int),
    "lvv_voxelize_mean": ([_F, ctypes.c_int, ctypes.c_int, _F, _F,
                           ctypes.c_int, _F, _I32, _I32], ctypes.c_int),
    "lvv_f32_to_f16": ([_F, ctypes.POINTER(ctypes.c_uint16),
                        ctypes.c_int64], None),
}
_lib = None
_lock = threading.Lock()


def _cpu() -> str:
    """The host's CPU model (what -march=native compiles for)."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor()


def library_path() -> pathlib.Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXXFLAGS).encode())
    digest.update(f"{platform.machine()} {_cpu()}".encode())
    return BUILD_DIR / f"liblvv_io-{digest.hexdigest()[:12]}.so"


def build() -> pathlib.Path:
    """Compile the library unless it is there; -> its path. Raises
    RuntimeError when the compiler ($CXX, else g++) is missing or fails."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if not cxx:
        raise RuntimeError("no C++ compiler (g++, or $CXX): the native "
                           "host I/O library (native/lvv_io.cpp) needs one")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXXFLAGS, "-shared", "-o", str(tmp),
                           str(SOURCE)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building {SOURCE.name} failed:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def get_lib() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (args, res) in _ARGTYPES.items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = args, res
            _lib = lib
        return _lib


def _ptr(a: np.ndarray, kind):
    return a.ctypes.data_as(kind)


def load_points(path, max_points: int, in_dim: int = 5,
                out_dim: int = 4) -> Tuple[np.ndarray, int]:
    """`.pcd.bin` -> ([max_points, out_dim] float32, rows kept), read by
    the library. Raises ValueError for out_dim > in_dim and OSError when
    the file cannot be read."""
    if out_dim > in_dim:
        raise ValueError(f"out_dim={out_dim} > in_dim={in_dim}")
    out = np.zeros((max_points, out_dim), np.float32)
    n = get_lib().lvv_load_pcd(str(path).encode(), _ptr(out, _F),
                               max_points, in_dim, out_dim)
    if n < 0:
        raise OSError(f"cannot read {path}")
    return out, int(n)


def load_points_plain(path, max_points: int, in_dim: int = 5,
                      out_dim: int = 4) -> Tuple[np.ndarray, int]:
    """`load_points` in numpy."""
    if out_dim > in_dim:
        raise ValueError(f"out_dim={out_dim} > in_dim={in_dim}")
    raw = np.fromfile(path, dtype=np.float32).reshape(-1, in_dim)[:, :out_dim]
    n = min(len(raw), max_points)
    out = np.zeros((max_points, out_dim), np.float32)
    out[:n] = raw[:n]
    return out, n


def voxelize_mean_host(points: np.ndarray, point_range, voxel_size,
                       max_voxels: int):
    """points [N, D] -> (feats [V, D] per-voxel means, coords [V, 3] zyx
    (-1 in unused slots), counts [V], n_voxels), slots in first-come
    order, by the library."""
    pts = np.ascontiguousarray(points, np.float32)
    n, dim = pts.shape
    pr = np.ascontiguousarray(point_range, np.float32)
    vs = np.ascontiguousarray(voxel_size, np.float32)
    feats = np.zeros((max_voxels, dim), np.float32)
    coords = np.full((max_voxels, 3), -1, np.int32)
    counts = np.zeros((max_voxels,), np.int32)
    nv = get_lib().lvv_voxelize_mean(
        _ptr(pts, _F), n, dim, _ptr(pr, _F), _ptr(vs, _F), max_voxels,
        _ptr(feats, _F), _ptr(coords, _I32), _ptr(counts, _I32))
    return feats, coords, counts, int(nv)


def voxelize_mean_host_plain(points: np.ndarray, point_range, voxel_size,
                             max_voxels: int):
    """`voxelize_mean_host` in numpy, in the library's arithmetic: float32
    sums in point order, then a multiply by the float32 reciprocal of the
    count (the JAX package's numpy fallback divides, which can differ by
    an ulp)."""
    pts = np.ascontiguousarray(points, np.float32)
    n, dim = pts.shape
    pr = np.asarray(point_range, np.float32)
    vs = np.asarray(voxel_size, np.float32)
    feats = np.zeros((max_voxels, dim), np.float32)
    coords = np.full((max_voxels, 3), -1, np.int32)
    counts = np.zeros((max_voxels,), np.int32)
    grid = ((pr[3:] - pr[:3]) / vs + np.float32(0.5)).astype(np.int64)
    ijk = np.floor((pts[:, :3] - pr[:3]) / vs).astype(np.int64)
    ok = ((ijk >= 0) & (ijk < grid)).all(axis=1)
    lin = (ijk[:, 2] * grid[1] + ijk[:, 1]) * grid[0] + ijk[:, 0]
    slot_of, nv = {}, 0
    for i in np.flatnonzero(ok):
        s = slot_of.get(lin[i])
        if s is None:
            if nv >= max_voxels:
                continue
            s = slot_of[lin[i]] = nv
            coords[s] = ijk[i, ::-1]
            nv += 1
        feats[s] += pts[i]
        counts[s] += 1
    inv = np.float32(1) / np.maximum(counts[:nv], 1).astype(np.float32)
    feats[:nv] *= inv[:, None]
    return feats, coords, counts, nv


def f32_to_f16(arr: np.ndarray) -> np.ndarray:
    """float32 -> float16 by the library."""
    flat = np.ascontiguousarray(arr, np.float32).reshape(-1)
    out = np.empty(flat.shape, np.uint16)
    get_lib().lvv_f32_to_f16(_ptr(flat, _F),
                             _ptr(out, ctypes.POINTER(ctypes.c_uint16)),
                             flat.size)
    return out.view(np.float16).reshape(np.shape(arr))


def f32_to_f16_plain(arr: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore"):          # past 65504 -> inf, as in C
        return np.asarray(arr, np.float32).astype(np.float16)
