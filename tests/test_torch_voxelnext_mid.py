"""The port's VoxelNeXt detector on a 64 x 64 x 16 grid whose capacities
truncate at the voxelizer and at every stage, against the JAX package's,
on the CPU (the set-up and bounds: torch_voxelnext_util.py)."""
import pytest
import torch

from lvv_tpu_torch.ops import sparse as S
from torch_voxelnext_util import check_detector, make_runs
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.fast


@pytest.fixture(scope="module")
def runs():
    return make_runs("mid")


@pytest.mark.parametrize("norm", ["ln", "bn"])
def test_detector_matches_jax(runs, norm):
    check_detector(runs(norm))


def test_mid_grid_truncates_every_stage(runs):
    """The mid case's capacities are below its demand at the voxelizer and
    at every stage, and the telemetry says so."""
    r = runs("ln")
    pm, (pts, n) = r["port"][3], r["cloud"]
    S.reset_overflow_log()
    S.set_overflow_debug(True)
    try:
        pm(torch.from_numpy(pts), n)
    finally:
        S.set_overflow_debug(False)
    log = S.overflow_log()
    S.reset_overflow_log()
    caps = (900, 700, 250, 60, 12, 3)
    tags = ["voxelize@900"] + [f"sparse_conv@{c}" for c in caps[1:]]
    for tag in tags:
        assert log[tag]["dropped"] > 0, (tag, log)
