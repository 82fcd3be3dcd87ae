"""The port's native host I/O library (lvv_tpu_torch/native: native/
lvv_io.cpp built with g++ at first use, bound with ctypes) against its
numpy versions, bit for bit, and against the JAX package's readers.

- `load_points` on a written `.pcd.bin` at fewer, as many and more
  `max_points` than the file has rows; equal to JAX's `load_points` too.
- `voxelize_mean_host` on clouds that do and do not fill `max_voxels`:
  features, coords, counts and the voxel count equal to the numpy
  version (which multiplies by the count's float32 reciprocal, as the C
  loop does); coords and counts equal to JAX's numpy fallback, features
  within one float32 ulp of it (it divides).
- `f32_to_f16` over normal, subnormal and overflowing values.
- A failed build raises, and the port's readers go through the library.
"""
import numpy as np
import pytest

from lvv_tpu import native as jax_native
from lvv_tpu_torch import data, native
from lvv_tpu_torch.tools import precompute_bev
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.fast

RANGE, VOXEL = (-8.0, -8.0, -3.0, 8.0, 8.0, 1.0), (0.5, 0.5, 0.25)


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    raw = np.random.default_rng(0).standard_normal((1000, 5)).astype(
        np.float32)
    path = tmp_path_factory.mktemp("sweep") / "sweep.pcd.bin"
    raw.tofile(path)
    return path, raw


def test_library_builds_under_build_dir():
    path = native.build()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert path.name.startswith("liblvv_io-")
    assert native.get_lib() is native.get_lib()


@pytest.mark.parametrize("max_points", [800, 1000, 2000])
def test_load_points_matches_numpy_and_jax(sweep, max_points):
    path, raw = sweep
    got, n = native.load_points(path, max_points)
    want, n_want = native.load_points_plain(path, max_points)
    assert n == n_want == min(1000, max_points)
    assert got.dtype == np.float32 and got.shape == (max_points, 4)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:n], raw[:n, :4])
    jax_got, jax_n = jax_native.load_points(str(path), max_points)
    assert jax_n == n
    np.testing.assert_array_equal(got, jax_got)


def test_load_points_errors(sweep, tmp_path):
    path, _ = sweep
    with pytest.raises(ValueError):
        native.load_points(path, 10, in_dim=3, out_dim=4)
    with pytest.raises(OSError):
        native.load_points(tmp_path / "missing.pcd.bin", 10)


@pytest.mark.parametrize("n,max_voxels", [(3000, 4096), (3000, 200)])
def test_voxelize_mean_host_matches_numpy(n, max_voxels):
    """(3000, 200) fills every slot and drops the rest."""
    rng = np.random.default_rng(n + max_voxels)
    pts = rng.uniform(-9, 9, (n, 4)).astype(np.float32)
    pts[:, 2] = rng.uniform(-3.5, 1.5, n)
    got = native.voxelize_mean_host(pts, RANGE, VOXEL, max_voxels)
    want = native.voxelize_mean_host_plain(pts, RANGE, VOXEL, max_voxels)
    assert got[3] == want[3] and got[3] > 0
    assert (got[3] == max_voxels) == (max_voxels == 200)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a, b)
    jax_got = jax_native.voxelize_mean_host(pts, RANGE, VOXEL, max_voxels)
    assert jax_got[3] == got[3]
    np.testing.assert_array_equal(got[1], jax_got[1])
    np.testing.assert_array_equal(got[2], jax_got[2])
    np.testing.assert_array_max_ulp(got[0], jax_got[0], maxulp=1)


def test_f32_to_f16_matches_numpy():
    rng = np.random.default_rng(2)
    x = (rng.standard_normal(50000)
         * np.exp(rng.uniform(-20, 12, 50000))).astype(np.float32)
    x[:4] = [0.0, -0.0, 65504.0, 1e6]
    got = native.f32_to_f16(x.reshape(250, 200))
    assert got.dtype == np.float16 and got.shape == (250, 200)
    np.testing.assert_array_equal(got.reshape(-1).view(np.uint16),
                                  native.f32_to_f16_plain(x).view(np.uint16))


def test_failed_build_raises(monkeypatch, tmp_path):
    broken = tmp_path / "broken.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="failed"):
        native.build()
    monkeypatch.setenv("CXX", "no-such-compiler")
    with pytest.raises(RuntimeError, match="compiler"):
        native.build()


def test_readers_go_through_the_library():
    assert data.load_points is native.load_points
    assert "native" in precompute_bev.__doc__
