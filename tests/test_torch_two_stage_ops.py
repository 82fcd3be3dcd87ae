"""The port's point sampling, RoI pools and voxel query against the JAX
package's, on the CPU (fp32 on both sides, JAX op by op on XLA's CPU
backend).

- Discrete outputs are held exactly: farthest-point picks, ball-query
  neighbour lists and counts (clouds with exact duplicate points, so that
  in-radius distances tie; a centre with no neighbour; fewer points than
  `nsample`), kNN indices, point-in-box masks and owners, voxel-query
  slots and hits (on the dense occupancy table and on the binary search
  JAX takes past `_DENSE_LOOKUP_MAX_CELLS`).
- Float outputs within OP_ABS: kNN distances, three_interpolate, both
  modes of roiaware_pool3d (whose port pools only the pairs inside a box:
  JAX's broadcast form is the reference), roipoint_pool3d,
  gather_neighborhood and both modes of vector_pool.
- group_points, and PointNet++'s multi-scale set abstraction (no ported
  family builds it) from one seeded init of JAX's module.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lvv_tpu_torch.ops import pool as pp
from lvv_tpu_torch.ops import sampling as psamp
from lvv_tpu_torch.ops import sparse as ps
from lvv_tpu_torch.ops import voxel_query as pvq
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

jp, jsamp, js, jvq = (importlib.import_module(f"lvv_tpu.ops.{m}") for m in
                      ("pool", "sampling", "sparse", "voxel_query"))

pytestmark = pytest.mark.fast

OP_ABS = 1e-6


def _points(n: int, seed: int = 0, dups: int = 40, extent: float = 4.0):
    """[n, 4] clustered points, the last `dups` rows exact copies of
    earlier ones."""
    rng = np.random.default_rng(seed)
    centres = rng.uniform(-extent, extent, (max(n // 10, 1), 3))
    pts = centres[rng.integers(0, len(centres), n)] + rng.normal(
        0, 0.3, (n, 3))
    pts = np.concatenate([pts, rng.uniform(0, 1, (n, 1))], 1)
    if dups:
        pts[-dups:] = pts[rng.integers(0, n - dups, dups)]
    return pts.astype(np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


@pytest.mark.parametrize("n,k,n_valid", [(600, 64, 600), (600, 48, 420),
                                         (300, 40, 25)])
def test_farthest_point_sample_picks_equal_jax(n, k, n_valid):
    pts = _points(n)[:, :3]
    valid = np.arange(n) < n_valid
    got = psamp.farthest_point_sample(_t(pts), k, _t(valid))
    want = jsamp.farthest_point_sample(jnp.asarray(pts), k,
                                       jnp.asarray(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert valid[got.numpy()].all()


@pytest.mark.parametrize("m,n,radius,nsample", [
    (50, 600, 0.5, 16), (50, 600, 1.5, 8), (20, 5, 3.0, 8),
    (20, 600, 0.05, 4)])
def test_ball_query_lists_equal_jax(m, n, radius, nsample):
    pts = _points(n, dups=min(40, n - 1) if n > 10 else 0)[:, :3]
    rng = np.random.default_rng(1)
    centers = pts[rng.integers(0, n, m)] + rng.normal(0, 0.2, (m, 3))
    centers[0] = (50.0, 50.0, 50.0)               # no neighbour
    centers = centers.astype(np.float32)
    valid = np.arange(n) < max(n - 30, 1)
    for v in (None, valid):
        got = psamp.ball_query(_t(centers), _t(pts), radius, nsample,
                               None if v is None else _t(v))
        want = jsamp.ball_query(jnp.asarray(centers), jnp.asarray(pts),
                                radius, nsample,
                                None if v is None else jnp.asarray(v))
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        assert int(got[1][0]) == 0 and (got[0][0] == 0).all()


def test_ball_query_breaks_distance_ties_by_index():
    """Equal distances (exact duplicates) in-radius come in index order,
    as jax.lax.top_k gives them; a full-row stable sort agrees."""
    pts = np.zeros((12, 3), np.float32)
    pts[:, 0] = [0.5, 0.1, 0.5, 0.1, 2.0, 0.3, 0.1, 0.5, 0.3, 9.0, 0.1, 0.3]
    centers = np.zeros((1, 3), np.float32)
    got, cnt = psamp.ball_query(_t(centers), _t(pts), 1.0, 6)
    want, _ = jsamp.ball_query(jnp.asarray(centers), jnp.asarray(pts), 1.0,
                               6)
    d2 = (pts ** 2).sum(1)
    order = np.argsort(np.where(d2 <= 1.0, d2, 1e10), kind="stable")[:6]
    np.testing.assert_array_equal(got[0].numpy(), order)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(cnt[0]) == 6


def test_knn_and_three_interpolate_match_jax():
    src = _points(200, seed=2)[:, :3]
    dst = _points(500, seed=3, dups=0)[:, :3]
    valid = np.arange(200) < 170
    feats = np.random.default_rng(4).standard_normal((200, 6)).astype(
        np.float32)
    d, idx = psamp.knn(_t(dst), _t(src), 3, _t(valid))
    jd, jidx = jsamp.knn(jnp.asarray(dst), jnp.asarray(src), 3,
                         jnp.asarray(valid))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=0,
                               atol=OP_ABS)
    got = psamp.three_interpolate(_t(feats), idx, d)
    want = jsamp.three_interpolate(jnp.asarray(feats), jidx, jd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=OP_ABS)


def _boxes(m: int, seed: int = 5) -> np.ndarray:
    rng = np.random.default_rng(seed)
    b = np.zeros((m, 7), np.float32)
    b[:, :3] = rng.uniform(-3, 3, (m, 3))
    b[:, 3:6] = rng.uniform(1.0, 3.0, (m, 3))
    b[:, 6] = rng.uniform(-np.pi, np.pi, m)
    return b


def test_points_in_boxes_match_jax():
    pts, boxes = _points(800), _boxes(12)
    valid = np.arange(800) < 700
    got = pp.points_in_rotated_boxes(_t(pts), _t(boxes))
    want = jp.points_in_rotated_boxes(jnp.asarray(pts), jnp.asarray(boxes))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.any(0).sum() > 6
    got = pp.assign_points_to_boxes(_t(pts), _t(boxes), _t(valid))
    want = jp.assign_points_to_boxes(jnp.asarray(pts), jnp.asarray(boxes),
                                     jnp.asarray(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mode", ["max", "avg"])
def test_roiaware_pool3d_matches_jax(mode):
    """The port pools the inside pairs alone; JAX broadcasts every (point,
    box) pair: the same cells, the same values."""
    pts, boxes = _points(900), _boxes(10)
    feats = np.random.default_rng(6).standard_normal((900, 5)).astype(
        np.float32)
    valid = np.arange(900) < 850
    got = pp.roiaware_pool3d(_t(pts), _t(feats), _t(boxes), 4, mode=mode,
                             valid_points=_t(valid))
    want = jp.roiaware_pool3d(jnp.asarray(pts), jnp.asarray(feats),
                              jnp.asarray(boxes), 4, mode=mode,
                              valid_points=jnp.asarray(valid))
    assert got.shape == (10, 4, 4, 4, 5)
    assert (np.asarray(want) != 0).any(-1).sum() > 50
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=OP_ABS)


def test_roipoint_pool3d_matches_jax():
    pts, boxes = _points(900), _boxes(10)
    boxes[3, :3] = (40.0, 40.0, 40.0)              # an empty box
    feats = np.random.default_rng(7).standard_normal((900, 3)).astype(
        np.float32)
    got, empty = pp.roipoint_pool3d(_t(pts), _t(feats), _t(boxes), 16)
    want, jempty = jp.roipoint_pool3d(jnp.asarray(pts), jnp.asarray(feats),
                                      jnp.asarray(boxes), 16)
    np.testing.assert_array_equal(empty.numpy(), np.asarray(jempty))
    assert bool(empty[3]) and not bool(empty.all())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=OP_ABS)


GRID = (24, 20, 10)                               # nx, ny, nz
VS, ORIGIN = (0.4, 0.4, 0.5), (-4.8, -4.0, -2.5)


def _sparse():
    """Both packages' SparseTensor over GRID from one set of voxels."""
    rng = np.random.default_rng(8)
    nx, ny, nz = GRID
    cells = rng.choice(nx * ny * nz, 300, replace=False)
    coords = np.stack([cells // (nx * ny), (cells // nx) % ny, cells % nx],
                      1).astype(np.int32)
    coords = np.concatenate([coords, -np.ones((20, 3), np.int32)])
    feats = rng.standard_normal((320, 6)).astype(np.float32)
    return (js.from_voxels(jnp.asarray(coords), jnp.asarray(feats), GRID),
            ps.from_voxels(_t(coords), _t(feats), GRID))


def _queries(m: int = 60):
    rng = np.random.default_rng(9)
    lo, hi = np.array(ORIGIN), np.array(ORIGIN) + np.array(VS) * GRID
    xyz = rng.uniform(lo - 0.5, hi + 0.5, (m, 3)).astype(np.float32)
    qc = np.floor((xyz - lo) / np.array(VS, np.float32)).astype(
        np.int32)[:, ::-1].copy()
    return xyz, qc


@pytest.mark.parametrize("table", [True, False])
def test_voxel_query_and_vector_pool_match_jax(table, monkeypatch):
    if not table:       # the binary search that large grids take
        monkeypatch.setattr(js, "_DENSE_LOOKUP_MAX_CELLS", 16)
        monkeypatch.setattr(pvq, "_DENSE_LOOKUP_MAX_CELLS", 16)
    jst, pst = _sparse()
    xyz, qc = _queries()
    slots, hit = pvq.voxel_query(pst, _t(qc), (1, 1, 1))
    jslots, jhit = jvq.voxel_query(jst, jnp.asarray(qc), (1, 1, 1))
    np.testing.assert_array_equal(hit.numpy(), np.asarray(jhit))
    np.testing.assert_array_equal(np.where(hit, slots, -1),
                                  np.where(jhit, jslots, -1))
    assert 20 < int(hit.sum()) < hit.numel()
    for radius in (None, 0.7):
        got = pvq.gather_neighborhood(pst, _t(xyz), _t(qc), VS, ORIGIN,
                                      (1, 1, 1), radius)
        want = jvq.gather_neighborhood(jst, jnp.asarray(xyz),
                                       jnp.asarray(qc), VS, ORIGIN,
                                       (1, 1, 1), radius)
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        for g, w in zip(got[:2], want[:2]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=OP_ABS)
        for mode in ("mean", "max"):
            vp = pvq.vector_pool(*got, extent=(0.6, 0.6, 0.75), mode=mode)
            jvp = jvq.vector_pool(*want, extent=(0.6, 0.6, 0.75), mode=mode)
            assert vp.shape == (60, 8 * 6)
            np.testing.assert_allclose(vp.numpy(), np.asarray(jvp), rtol=0,
                                       atol=OP_ABS)


def test_group_points_and_msg_set_abstraction_match_jax():
    """group_points, and PointNet++'s multi-scale grouping (which no
    ported family builds) from one seeded init of JAX's module."""
    import jax

    from lvv_tpu.models.pointnet2 import SetAbstractionMSG as JaxMSG
    from lvv_tpu_torch.convert.params import tensors
    from lvv_tpu_torch.models.pointnet2 import SetAbstractionMSG
    pts = _points(300, seed=10)
    xyz, feats = pts[:, :3], np.concatenate([pts[:, 3:], pts[:, :1]], 1)
    idx = np.random.default_rng(11).integers(0, 300, (40, 8))
    np.testing.assert_array_equal(
        psamp.group_points(_t(feats), _t(idx)).numpy(),
        np.asarray(jsamp.group_points(jnp.asarray(feats), jnp.asarray(idx))))
    valid = np.arange(300) < 280
    kw = dict(npoint=32, radii=(0.4, 0.8), nsamples=(8, 16),
              mlps=((8, 8), (8, 16)))
    jm = JaxMSG(**kw)
    args = (jnp.asarray(xyz), jnp.asarray(feats), jnp.asarray(valid))
    params = jm.init(jax.random.PRNGKey(3), *args)
    want = jm.apply(params, *args)
    pm = SetAbstractionMSG(2, device="cpu", **kw)
    pm.load_state_dict(tensors(jax.tree.map(np.asarray, params["params"])))
    with torch.no_grad():
        got = pm(_t(xyz), _t(feats), _t(valid))
    assert pm.out_channels == 24
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=1e-5, atol=1e-6)
