"""Stdout tee, host-0 logging, a running average and seeding (counterpart
of lvv_tpu/utils/logging.py and helpers.py's seed_all)."""
from __future__ import annotations

import pathlib
import sys
from typing import Optional, TextIO

import numpy as np
import torch


class Tee:
    """Duplicate stdout writes into a log file."""

    def __init__(self, log_path: str, stream: Optional[TextIO] = None):
        self.stream = stream or sys.stdout
        pathlib.Path(log_path).parent.mkdir(parents=True, exist_ok=True)
        self.file = open(log_path, "a", buffering=1)

    def write(self, data: str) -> int:
        self.stream.write(data)
        self.file.write(data)
        return len(data)

    def flush(self) -> None:
        self.stream.flush()
        self.file.flush()

    def close(self) -> None:
        self.file.close()

    def __enter__(self):
        self._saved = sys.stdout
        sys.stdout = self
        return self

    def __exit__(self, *exc):
        sys.stdout = self._saved
        self.close()


def is_host_zero() -> bool:
    """Rank 0 of a torch.distributed group, or the only process."""
    dist = torch.distributed
    return not (dist.is_available() and dist.is_initialized()) or (
        dist.get_rank() == 0)


def log0(*args, **kwargs) -> None:
    """Print only on host 0."""
    if is_host_zero():
        print(*args, **kwargs)


class AverageMeter:
    """Running average."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = self.sum = self.count = self.avg = 0.0

    def update(self, val: float, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


def seed_all(seed: int, device=None) -> torch.Generator:
    """Seed numpy (the host data path) and torch's global generators, and
    return a torch.Generator on `device` (default the CPU) seeded with
    `seed`: the explicit stream for dropout, as JAX threads its key."""
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator(device=device or "cpu").manual_seed(seed)
