"""The port's sparse LiDAR ops against the JAX package's, on the CPU.

Inputs are seeded numpy clouds voxelized on two grids: the tiny config's
16 x 16 x 8 and a 64 x 64 x 16 grid whose capacities truncate. JAX runs op
by op (XLA on the CPU). Active sets are held exactly: voxel coords, point
slots, rulebooks, every output's ids, unique's four outputs, NMS indices.
Float features are held to FEAT_REL_L2 relative L2 (fp32 sums in another
order), IoUs to IOU_ABS.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lvv_tpu_torch.ops import boxes as pb
from lvv_tpu_torch.ops import nms as pn
from lvv_tpu_torch.ops import segment as pseg
from lvv_tpu_torch.ops import sparse as ps
from lvv_tpu_torch.ops import voxelize as pv
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

# by module path: lvv_tpu.ops exports functions under some of these names
jb, jn, jseg, js, jv = (importlib.import_module(f"lvv_tpu.ops.{m}") for m in
                        ("boxes", "nms", "segment", "sparse", "voxelize"))

pytestmark = pytest.mark.fast

FEAT_REL_L2 = 1e-5
IOU_ABS = 1e-5
# (point range, voxel size, max points, max voxels, valid points)
GRIDS = {
    "tiny": ((-8.0, -8.0, -3.0, 8.0, 8.0, 1.0), (1.0, 1.0, 0.5), 2048, 512,
             1500),
    "mid": ((-16.0, -16.0, -4.0, 16.0, 16.0, 4.0), (0.5, 0.5, 0.5), 6000,
            700, 5000),
}


def _cloud(name: str, seed: int = 0) -> np.ndarray:
    """A seeded cloud over the grid's range (and a margin outside it),
    clustered so that voxels hold several points, zero-padded."""
    pr, _, n_max, _, n = GRIDS[name]
    rng = np.random.default_rng(seed)
    lo, hi = np.array(pr[:3]), np.array(pr[3:])
    centres = rng.uniform(lo, hi, (n // 8, 3))
    pts = centres[rng.integers(0, len(centres), n)] + rng.normal(
        0, 0.3, (n, 3))
    pts = np.where(rng.uniform(size=(n, 1)) < 0.05,
                   rng.uniform(lo - 2, hi + 2, (n, 3)), pts)
    out = np.zeros((n_max, 4), np.float32)
    out[:n, :3] = pts
    out[:n, 3] = rng.uniform(0, 1, n)
    return out


def _grid(name):
    pr, vs, _, _, _ = GRIDS[name]
    return jv.VoxelGrid.create(pr, vs), pv.VoxelGrid.create(pr, vs)


def _eq(got: torch.Tensor, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _feat(got: torch.Tensor, want):
    want = np.asarray(want, np.float64)
    got = got.numpy().astype(np.float64)
    assert got.shape == want.shape
    den = max(np.linalg.norm(want), 1e-30)
    assert np.linalg.norm(got - want) / den <= FEAT_REL_L2


@pytest.fixture(scope="module")
def tensors():
    """grid name -> (JAX SparseTensor, port SparseTensor) of the voxel
    means, random features of 8 channels."""
    out = {}
    for name in GRIDS:
        jg, pg = _grid(name)
        pts = _cloud(name)
        n = GRIDS[name][4]
        vox = jv.voxelize_mean(jnp.asarray(pts), jnp.int32(n), jg,
                               GRIDS[name][3])
        feats = np.random.default_rng(1).standard_normal(
            (GRIDS[name][3], 8)).astype(np.float32)
        jst = js.from_voxels(vox.coords, jnp.asarray(feats), jg.grid_size)
        pvox = pv.voxelize_mean(torch.from_numpy(pts), n, pg, GRIDS[name][3])
        pst = ps.from_voxels(pvox.coords, torch.from_numpy(feats),
                             pg.grid_size)
        _eq(pst.ids, jst.ids)
        out[name] = (jst, pst)
    return out


def _weights(k, cin, cout, seed=2):
    w = np.random.default_rng(seed).standard_normal((k, cin, cout)).astype(
        np.float32) / np.sqrt(k * cin)
    b = np.random.default_rng(seed + 1).standard_normal(cout).astype(
        np.float32)
    return w, b


def test_segment_ops_match_jax():
    rng = np.random.default_rng(0)
    data = rng.standard_normal((200, 3)).astype(np.float32)
    ids = rng.integers(-2, 12, 200).astype(np.int32)   # some out of range
    for name in ("segment_sum", "segment_max"):
        want = getattr(jseg, name)(jnp.asarray(data), jnp.asarray(ids), 10)
        got = getattr(pseg, name)(torch.from_numpy(data),
                                  torch.from_numpy(ids), 10)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
    ok = np.clip(ids, 0, 9)
    want = jseg.segment_mean(jnp.asarray(data), jnp.asarray(ok), 10)
    got = pseg.segment_mean(torch.from_numpy(data), torch.from_numpy(ok), 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    srt = np.sort(rng.integers(0, 20, 300)).astype(np.int32)
    _eq(pseg.run_ranks_sorted(torch.from_numpy(srt)),
        jseg.run_ranks_sorted(jnp.asarray(srt)))
    groups = rng.integers(0, 15, 300).astype(np.int32)
    valid = rng.uniform(size=300) < 0.8
    _eq(pseg.ingroup_inds(torch.from_numpy(groups), torch.from_numpy(valid)),
        jseg.ingroup_inds(jnp.asarray(groups), jnp.asarray(valid)))


@pytest.mark.parametrize("max_unique", [8, 40, 64, 100])
def test_unique_with_inverse_matches_jax(max_unique):
    """Capacity below, at and above the true count (64 distinct ids among
    fill ids): ids, inverse, counts and count bit-equal."""
    rng = np.random.default_rng(3)
    ids = rng.choice(np.arange(0, 500, 7), 64, replace=False)
    ids = np.concatenate([rng.choice(ids, 300), np.full(40, ps.SENTINEL)])
    ids = rng.permutation(ids).astype(np.int32)
    want = jseg.unique_with_inverse(jnp.asarray(ids), js.SENTINEL,
                                    max_unique)
    got = pseg.unique_with_inverse(torch.from_numpy(ids), ps.SENTINEL,
                                   max_unique)
    for g, w in zip(got, want):
        _eq(g, w)


@pytest.mark.parametrize("name", list(GRIDS))
def test_voxelize_matches_jax(name):
    """Both voxelizers, capacity truncating: coords, point slots, counts
    and num_voxels bit-equal; buckets equal, means to FEAT_REL_L2."""
    jg, pg = _grid(name)
    pts, (_, _, _, cap, n) = _cloud(name, seed=5), GRIDS[name]
    want = jv.voxelize(jnp.asarray(pts), jnp.int32(n), jg, cap, 4)
    got = pv.voxelize(torch.from_numpy(pts), n, pg, cap, 4)
    assert int(want.num_voxels) == cap            # the capacity truncates
    for field in ("coords", "num_points", "num_voxels", "point_voxel",
                  "features"):
        _eq(getattr(got, field), getattr(want, field))
    want = jv.voxelize_mean(jnp.asarray(pts), jnp.int32(n), jg, cap)
    got = pv.voxelize_mean(torch.from_numpy(pts), n, pg, cap)
    for field in ("coords", "num_points", "num_voxels", "point_voxel"):
        _eq(getattr(got, field), getattr(want, field))
    _feat(got.features, want.features)
    _feat(pv.mean_vfe(pv.voxelize(torch.from_numpy(pts), n, pg, cap, 64)),
          jv.mean_vfe(jv.voxelize(jnp.asarray(pts), jnp.int32(n), jg, cap,
                                  64)))


@pytest.mark.parametrize("ndim2d", [False, True])
@pytest.mark.parametrize("name", list(GRIDS))
def test_subm_rulebook_and_conv_match_jax(tensors, name, ndim2d):
    jst, pst = tensors[name]
    if ndim2d:        # a 2D map: the BEV collapse of the voxel tensor
        jst, pst = js.bev_collapse(jst), ps.bev_collapse(pst)
        _eq(pst.ids, jst.ids)
        _feat(pst.features, jst.features)
    want = js.build_subm_rulebook(jst, ndim2d=ndim2d)
    got = ps.build_subm_rulebook(pst, ndim2d=ndim2d)
    for g, w in zip(got, want):
        _eq(g, w)
    w, b = _weights(9 if ndim2d else 27, 8, 16)
    out_j = js.submanifold_conv(jst, jnp.asarray(w), jnp.asarray(b),
                                ndim2d=ndim2d)
    out_p = ps.submanifold_conv(pst, torch.from_numpy(w), torch.from_numpy(b),
                                ndim2d=ndim2d)
    _eq(out_p.ids, out_j.ids)
    _feat(out_p.features, out_j.features)


@pytest.mark.parametrize("path", ["gather", "scatter"])
@pytest.mark.parametrize("cap", [None, 150])
@pytest.mark.parametrize("name", list(GRIDS))
def test_sparse_conv_matches_jax(tensors, monkeypatch, name, cap, path):
    """Strided conv on both of its paths (the output-centric gather and,
    with the occupancy table turned off, the unique-sort scatter), with and
    without a truncating output capacity; then the inverse conv back onto
    the input's active set."""
    if path == "scatter":
        monkeypatch.setattr(js, "_DENSE_LOOKUP_MAX_CELLS", 1)
        monkeypatch.setattr(ps, "_DENSE_LOOKUP_MAX_CELLS", 1)
    jst, pst = tensors[name]
    w, b = _weights(27, 8, 12)
    out_j = js.sparse_conv(jst, jnp.asarray(w), jnp.asarray(b),
                           out_capacity=cap)
    out_p = ps.sparse_conv(pst, torch.from_numpy(w), torch.from_numpy(b),
                           out_capacity=cap)
    assert out_p.grid == out_j.grid
    _eq(out_p.ids, out_j.ids)
    _feat(out_p.features, out_j.features)
    wi, _ = _weights(27, 12, 8, seed=7)
    inv_j = js.inverse_conv(out_j, jst.ids, jst.grid, jnp.asarray(wi))
    inv_p = ps.inverse_conv(out_p, pst.ids, pst.grid, torch.from_numpy(wi))
    _feat(inv_p.features, inv_j.features)


@pytest.mark.parametrize("name", list(GRIDS))
def test_merge_reindex_collapse_dense_match_jax(tensors, name):
    """The backbone's fold: a stride-2 stage re-indexed onto the finer
    grid, added in with a truncating capacity, collapsed to BEV, made
    dense."""
    jst, pst = tensors[name]
    w, _ = _weights(27, 8, 8, seed=9)
    cj = js.sparse_conv(jst, jnp.asarray(w))
    cp = ps.sparse_conv(pst, torch.from_numpy(w))
    coarse_j = js.SparseTensor(cj.ids, cj.features, cj.grid)
    up_j = js.reindex_upscale(coarse_j, 2, jst.grid)
    up_p = ps.reindex_upscale(cp, 2, pst.grid)
    _eq(up_p.ids, up_j.ids)
    cap = int(np.asarray(jst.num_active())) + 20
    mj = js.merge_add(jst, up_j, capacity=cap)
    mp = ps.merge_add(pst, up_p, capacity=cap)
    _eq(mp.ids, mj.ids)
    _feat(mp.features, mj.features)
    bj, bp = js.bev_collapse(mj, 60), ps.bev_collapse(mp, 60)
    _eq(bp.ids, bj.ids)
    _feat(bp.features, bj.features)
    _feat(ps.to_dense(bp), js.to_dense(bj))
    _eq(ps.delinearize(bp.ids, bp.grid), js.delinearize(bj.ids, bj.grid))


def test_overflow_telemetry_matches_jax(tensors):
    """With debugging on, the port logs the same demand, capacity and drops
    as the JAX package; off, it logs nothing."""
    jst, pst = tensors["mid"]
    w, _ = _weights(27, 8, 4)
    logs = []
    for mod, st, wt in ((js, jst, jnp.asarray(w)),
                        (ps, pst, torch.from_numpy(w))):
        mod.reset_overflow_log()
        mod.set_overflow_debug(True)
        try:
            mod.sparse_conv(st, wt, out_capacity=100)
            mod.bev_collapse(st, 50)
        finally:
            mod.set_overflow_debug(False)
        logs.append(mod.overflow_log())
        mod.reset_overflow_log()
    assert logs[0] == logs[1] and logs[1]["sparse_conv@100"]["dropped"] > 0
    ps.sparse_conv(pst, torch.from_numpy(w), out_capacity=100)
    assert ps.overflow_log() == {}


def test_capacity_planner_matches_jax():
    jg, pg = _grid("mid")
    pts = _cloud("mid")[:GRIDS["mid"][4]]
    want = js.plan_capacity_demand(pts, jg)
    assert ps.plan_capacity_demand(pts, pg) == want
    buckets = ((100, (50, 40, 30, 20, 10)), (10 ** 6, (10 ** 6,) * 5))
    assert (ps.pick_capacity_bucket(want, buckets)
            == js.pick_capacity_bucket(want, buckets))


def _boxes(n: int, seed: int, spread: float = 6.0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    b = np.zeros((n, 7), np.float32)
    b[:, :2] = rng.uniform(-spread, spread, (n, 2))
    b[:, 2] = rng.uniform(-1, 1, n)
    b[:, 3:6] = rng.uniform(0.5, 4.0, (n, 3))
    b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    return b


def test_box_ious_match_jax():
    a, b = _boxes(40, 0), _boxes(30, 1)
    b[:5] = a[:5]                                       # identical pairs
    b[5:10, :6] = a[5:10, :6]                           # same, turned
    for name in ("iou_bev", "iou_3d", "iou_aabb_bev"):
        want = np.asarray(getattr(jb, name)(jnp.asarray(a), jnp.asarray(b)))
        got = getattr(pb, name)(torch.from_numpy(a), torch.from_numpy(b))
        np.testing.assert_allclose(got.numpy(), want, atol=IOU_ABS)
    assert np.asarray(jb.iou_bev(jnp.asarray(a[:5]), jnp.asarray(b[:5]))
                      ).diagonal().min() > 0.999
    ang = np.linspace(-7, 7, 50, dtype=np.float32)
    np.testing.assert_allclose(
        pb.limit_period(torch.from_numpy(ang), 0.5, 2 * np.pi).numpy(),
        np.asarray(jb.limit_period(jnp.asarray(ang), 0.5, 2 * np.pi)),
        atol=1e-6)


@pytest.mark.parametrize("kind", ["nms", "nms_axis_aligned",
                                  "multi_class_nms"])
def test_nms_matches_jax(kind):
    """Dense overlapping boxes, tied scores, masked rows and fewer
    candidates than post_max: kept indices, count and scores equal."""
    boxes = _boxes(120, 4, spread=5.0)
    rng = np.random.default_rng(5)
    scores = np.round(rng.uniform(0, 1, 120), 1).astype(np.float32)  # ties
    valid = rng.uniform(size=120) < 0.9
    labels = rng.integers(0, 3, 120).astype(np.int32)
    kw = dict(iou_thresh=0.2, pre_max=100, post_max=80)
    jargs = (jnp.asarray(boxes), jnp.asarray(scores))
    pargs = (torch.from_numpy(boxes), torch.from_numpy(scores))
    if kind == "multi_class_nms":
        want = jn.multi_class_nms(*jargs, jnp.asarray(labels), 3, **kw)
        got = pn.multi_class_nms(*pargs, torch.from_numpy(labels), 3, **kw)
    else:
        want = getattr(jn, kind)(*jargs, valid=jnp.asarray(valid), **kw)
        got = getattr(pn, kind)(*pargs, valid=torch.from_numpy(valid), **kw)
    _eq(got[0], want[0])
    _eq(got[1], want[1])
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert 0 < int(got[1]) < 80                     # boxes were suppressed
    small = pn.nms(*(t[:12] for t in pargs), iou_thresh=0.2, pre_max=100,
                   post_max=30)
    want = jn.nms(*(t[:12] for t in jargs), iou_thresh=0.2, pre_max=100,
                  post_max=30)
    _eq(small[0], want[0])


@pytest.mark.parametrize("miss_share", [0.0, 0.7, 1.0])
def test_gather_rows_gradient_is_autograds(miss_share):
    """`_GatherRows` (the sparse convs' row gather, a zero row past the end
    for misses) has autograd's own gradient of that gather, bit for bit on
    the CPU, with no share, most and all of the entries missing."""
    gen = torch.Generator().manual_seed(0)
    feats = torch.randn(50, 6, generator=gen)
    rows = torch.randint(0, 50, (40, 27), generator=gen)
    rows[torch.rand(40, 27, generator=gen) < miss_share] = 50
    cot = torch.randn(40, 27, 6, generator=gen)
    a = feats.clone().requires_grad_()
    ps._GatherRows.apply(a, rows).backward(cot)
    b = feats.clone().requires_grad_()
    torch.cat([b, b.new_zeros((1, 6))])[rows].backward(cot)
    assert torch.equal(ps._GatherRows.apply(feats, rows),
                       torch.cat([feats, feats.new_zeros((1, 6))])[rows])
    assert torch.equal(a.grad, b.grad)
