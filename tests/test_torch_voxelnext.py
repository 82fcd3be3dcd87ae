"""The port's VoxelNeXt detector on the tiny config's grid, its sweep
reader and its precompute tool against the JAX package's, on the CPU
(the set-up and bounds: torch_voxelnext_util.py; the mid grid:
test_torch_voxelnext_mid.py)."""
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from chip_smoke import write_sweeps
from lvv_tpu.native import load_points as jax_load_points
from lvv_tpu_torch import tiny_config
from lvv_tpu_torch.config import save
from lvv_tpu_torch.data import load_points
from torch_voxelnext_util import check_detector, cloud, make_runs
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.fast

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def runs():
    return make_runs("tiny")


@pytest.mark.parametrize("norm", ["ln", "bn"])
def test_detector_matches_jax(runs, norm):
    check_detector(runs(norm))


def test_load_points_matches_jax(tmp_path):
    """A .pcd.bin of 1,000 rows read at 800 and 2,000 max points."""
    raw = np.random.default_rng(0).standard_normal((1000, 5)).astype(
        np.float32)
    path = tmp_path / "sweep.pcd.bin"
    raw.tofile(path)
    for max_points in (800, 2000):
        got, n = load_points(path, max_points)
        want, n_want = jax_load_points(str(path), max_points)
        assert n == n_want
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        load_points(path, 10, in_dim=3, out_dim=4)


def test_precompute_bev_cli_matches_jax(runs, tmp_path):
    """The tool as a subprocess on the CPU over two synthetic sweeps, with
    the converted tree as its checkpoint and the tiny config: one float16
    file per sample equal to JAX's BEV in float16, then a rerun that skips
    both."""
    r = runs("ln")
    pts, n = r["cloud"]
    pm = r["port"][3]
    out, _, _, variables = r["jax"]
    torch.save(pm.state_dict(), tmp_path / "detector.pt")
    cfg = dataclasses.replace(tiny_config(), voxelize=r["cfg"][1])
    save(cfg, tmp_path / "config.json")
    second = cloud(r["cfg"][1], 900, seed=7)
    tokens = write_sweeps(tmp_path / "nusc", [pts[:n], second[:900]])
    cmd = [sys.executable, "-m", "lvv_tpu_torch.tools.precompute_bev",
           "--dataroot", str(tmp_path / "nusc"), "--version", "v1.0-mini",
           "--out", str(tmp_path / "bev"), "--split", "val", "--batch", "2",
           "--checkpoint", str(tmp_path / "detector.pt"), "--config",
           str(tmp_path / "config.json"), "--device", "cpu"]
    env = dict(os.environ, PYTHONPATH=str(REPO))
    first = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                           text=True, timeout=300)
    assert first.returncode == 0, first.stderr
    assert "2 samples to process" in first.stdout
    assert "ms/batch" in first.stdout
    files = [tmp_path / "bev" / "val" / f"{t}.npy" for t in tokens]
    got = np.load(files[0])
    assert got.dtype == np.float16
    # float16 of the same fp32 map, one float16 step apart at most
    np.testing.assert_allclose(
        got.astype(np.float32),
        np.asarray(out["bev_dense"]).astype(np.float16).astype(np.float32),
        rtol=2 ** -10, atol=1e-6)
    assert np.load(files[1]).shape == got.shape
    stamps = [f.stat().st_mtime_ns for f in files]
    rerun = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                           text=True, timeout=300)
    assert rerun.returncode == 0, rerun.stderr
    assert "0 samples to process" in rerun.stdout
    assert [f.stat().st_mtime_ns for f in files] == stamps
