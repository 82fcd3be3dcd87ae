"""Hand-written Hopper kernels of the port: build, load and launch counts.

The CUDA sources in `csrc/` are compiled at first use with `nvcc` for
sm_90a into one shared library each (plain C interface, loaded with
ctypes), under `build/lvv_tpu_torch/` at the repository root. A library is
rebuilt when its sources change (the file name carries a hash of them).
`build_all()` starts one `nvcc` per source at once.

`launches` counts kernel launches by name. Each wrapper adds one where it
launches its kernel and nowhere else, so a run can show that it went
through the kernels.

A launch through ctypes is opaque to autograd: its output would be a leaf,
and the graph cut without a word. K-a, K-b, K-e and K-f have autograd
Functions (`ops/autograd.py`), which their wrappers take where
`wants_grad` holds; every launch calls `refuse_grad` on its inputs, so a
kernel without one (as in the JAX package, which has no VJP for them)
raises instead.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "lvv_tpu_torch"
SOURCES = ("ln_mlp_residual", "flash_attention", "relpos_attention",
           "ln_mlp_residual_q8", "int8_matmul", "int8_matmul_nk",
           "w8a8_matmul", "relpos_attention_qk8",
           "flash_attention_relpos", "window_attention_rows", "qr_prep",
           "norm", "flash_attention_f32")

launches: collections.Counter = collections.Counter()

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    "lvv_ln_mlp_residual": [_P] * 10 + [_I] * 3 + [_F, _I, _I, _I, _P],
    "lvv_flash_attention": [_P] * 7 + [_I] * 8 + [_F, _P, _P],
    "lvv_flash_attention_f32": [_P] * 7 + [_I] * 8 + [_F, _P, _P],
    "lvv_relpos_attention": [_P] * 7 + [_I] * 13 + [_F, _P],
    "lvv_ln_mlp_residual_q8": [_P] * 17 + [_I] * 4 + [_F, _I, _I, _P],
    "lvv_ln_mlp_residual_q8_weight": [_P] * 4 + [_I] * 3 + [_P],
    "lvv_int8_matmul": [_P] * 4 + [_I] * 11 + [_P],
    "lvv_int8_matmul_nk": [_P] * 4 + [_I] * 7 + [_P],
    "lvv_w8a8_matmul": [_P] * 9 + [_I] * 6 + [_P],
    "lvv_w8a8_rows": [_P] * 3 + [_I] * 3 + [_P],
    "lvv_relpos_attention_qk8": [_P] * 9 + [_I] * 6 + [_F, _P],
    "lvv_qk8_prep": [_P] * 8 + [_I] * 6 + [_F, _P],
    "lvv_qk8_attention": [_P] * 7 + [_I] * 5 + [_P],
    "lvv_flash_attention_relpos": [_P] * 10 + [_I] * 15 + [_F, _P],
    "lvv_pv8_quantize_v": [_P] * 2 + [_I] * 5 + [_P] * 4,
    "lvv_window_attention_rows": [_P] * 9 + [_I] * 6 + [_F, _P],
    "lvv_qr_prep": [_P] * 5 + [_I] * 8 + [_F, _P],
    "lvv_norm": [_P] * 6 + [_I] * 2 + [_F] + [_I] * 3 + [_P],
}
# C entry points beside a library's own `lvv_{name}`
_ENTRIES = {"ln_mlp_residual_q8": ("lvv_ln_mlp_residual_q8_weight",),
            "w8a8_matmul": ("lvv_w8a8_rows",),
            "flash_attention_relpos": ("lvv_pv8_quantize_v",),
            "relpos_attention_qk8": ("lvv_qk8_prep", "lvv_qk8_attention")}
_libs: dict = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (cuda / "bin" / "nvcc").exists():
        return str(cuda / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _lib_path(name: str) -> pathlib.Path:
    digest = hashlib.sha256()
    for src in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        digest.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def _nvcc_cmd(name: str, out: pathlib.Path) -> list:
    return [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
            "-I", str(CSRC), "-o", str(out), str(CSRC / f"{name}.cu")]


def build_all(names=SOURCES) -> dict:
    """Compile every missing library, one nvcc process per source, all at
    once. Returns {name: ptxas report} for the sources it compiled."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (out, tmp, subprocess.Popen(
            _nvcc_cmd(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    reports, failed = {}, []
    for name, (out, tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
        reports[name] = log
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def lib(name: str) -> ctypes.CDLL:
    """The loaded kernel library `name`, built first if needed."""
    with _lock:
        if name not in _libs:
            build_all((name,))
            handle = ctypes.CDLL(str(_lib_path(name)))
            for entry in (f"lvv_{name}", *_ENTRIES.get(name, ())):
                fn = getattr(handle, entry)
                fn.argtypes = _ARGTYPES[entry]
                fn.restype = ctypes.c_int
            _libs[name] = handle
        return _libs[name]


def wants_grad(*tensors) -> bool:
    """Whether autograd would record an op on these tensors (None skipped):
    grad mode on and one of them requiring a gradient."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def refuse_grad(name: str, *tensors) -> None:
    """Raise before a launch of `name` whose inputs autograd would have to
    differentiate: the kernel has no backward, and its output would cut the
    graph."""
    if wants_grad(*tensors):
        raise RuntimeError(
            f"{name}: the kernel has no backward (nor has the JAX package's "
            "Pallas kernel); run it under torch.no_grad() or on inputs that "
            "need no gradient")


def check(err: int, name: str) -> None:
    """Raise if a kernel's C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
