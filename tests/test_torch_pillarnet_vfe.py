"""The port's dynamic VFEs, residual BEV trunks, PillarNet, VoxelNeXt2D and
AnchorHeadMulti against the JAX package's, on the CPU.

- `point_pillar_slots` with overflowing pillars (slot, valid, coords and
  counts equal) and JAX's pinned five-point case
  (tests/test_zoo_round2.py).
- `DynamicPillarVFE` and `DynamicPillarVFESimple2D` (overflowing too),
  `DynamicVoxelVFE` at one and two layers: coords, counts, each point's
  voxel equal, features within 1e-5 relative L2; JAX's pinned uncapped
  pillar; the gradient into the points where the segment max ties (exact
  duplicate points): JAX's scatter-max rule splits it evenly between the
  tied points, and so must the port.
- `BaseBEVResBackbone` on even and odd grids, `BaseBEVBackboneV1`
  (tests/test_pointpillars.py's shapes, narrower), `VoxelNeXt2DBackbone`
  (tests/test_zoo_round2.py's pillar tensor): ids equal, features within
  1e-5; `AnchorHeadMulti` and `multi_anchor_table` (the pinned groups).
- PillarNet (`torch_waymo_util`: 0.25 m pillars, an 8 x 8 stride-8 map):
  forward, its PillarResBackbone's ids and features, detections, three
  train steps against JAX's with its ReLU gates replayed.
- The four PillarNet and DSVT presets, the three MPPNet presets and the
  focal multimodal Voxel R-CNN preset (JAX's init called with an image
  and proj) build on the meta device with exactly the parameter count of
  JAX's `jax.eval_shape(init)` at full width.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lvv_tpu import config as JC
from lvv_tpu.models import anchor_head as JA
from lvv_tpu.models import pointpillars as JP
from lvv_tpu.models import vfe as JV
from lvv_tpu.models import voxelnext2d as JN2
from lvv_tpu.models.registry import build_detector as jax_build
from lvv_tpu.ops import sparse as JS
from lvv_tpu.ops.voxelize import VoxelGrid as JGrid
from lvv_tpu_torch import config as C
from lvv_tpu_torch.models import anchor_head as PA
from lvv_tpu_torch.models import pointpillars as PP
from lvv_tpu_torch.models import vfe as PV
from lvv_tpu_torch.models import voxelnext2d as PN2
from lvv_tpu_torch.models.registry import build_detector
from lvv_tpu_torch.ops import sparse as PS
from lvv_tpu_torch.ops.voxelize import VoxelGrid as PGrid
from torch_waymo_util import (FWD_REL_L2, GRAD_REL_L2, REPO, Run,
                              check_detections, check_train, jax_module,
                              port_module, rel_l2)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.fast

RANGE = (-8.0, -8.0, -3.0, 8.0, 8.0, 1.0)


def _grids(voxel_size):
    return (JGrid.create(RANGE, voxel_size), PGrid.create(RANGE, voxel_size))


def _points(n=600, pad=700, seed=0):
    """Seeded clusters, some outside the range, zero rows past n."""
    rng = np.random.default_rng(seed)
    centres = rng.uniform(-9, 9, (n // 10, 3))
    pts = np.zeros((pad, 4), np.float32)
    pts[:n, :3] = (centres[rng.integers(0, len(centres), n)]
                   + rng.normal(0, 0.5, (n, 3)))
    pts[:n, 2] = rng.uniform(-3.5, 1.5, n)
    pts[:n, 3] = rng.uniform(0, 1, n)
    return pts, n


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("max_pillars", [40, 400])
def test_point_pillar_slots_match_jax(max_pillars):
    """40 pillars overflow (the cloud fills ~150 of the 16 x 16 grid): the
    rest go to the dump slot 40."""
    jg, pg = _grids((1.0, 1.0, 4.0))
    pts, n = _points()
    want = JV.point_pillar_slots(jnp.asarray(pts), jnp.int32(n), jg,
                                 max_pillars)
    got = PV.point_pillar_slots(torch.from_numpy(pts), n, pg, max_pillars)
    for g, w in zip(got, want):
        _eq(g, w)
    slot, valid = got[0], got[1]
    assert (slot[~valid] == max_pillars).all()
    assert (max_pillars == 40) == bool((slot == max_pillars).any()
                                       and (got[2][:, 0] == 0).all())


def test_point_pillar_slots_pinned_case():
    _, pg = _grids((1.0, 1.0, 4.0))
    pts = torch.tensor([[0.5, 0.5, 0.0, 1.0], [0.7, 0.3, 0.0, 2.0],
                        [3.5, 0.5, 0.0, 3.0], [99.0, 0.0, 0.0, 4.0],
                        [0.0, 0.0, 0.0, 5.0]])
    slot, valid, coords, counts = PV.point_pillar_slots(pts, 4, pg, 8)
    assert valid.tolist() == [True, True, True, False, False]
    assert slot[0] == slot[1] != slot[2]
    assert int(counts[slot[0]]) == 2
    assert coords[slot[0]].tolist() == [0, 8, 8]


@pytest.mark.parametrize("cluster, max_pillars", [(True, 40),
                                                  (False, 400)])
def test_dynamic_pillar_vfe_matches_jax(cluster, max_pillars):
    """40 pillars overflow; Simple2D at a capacity that holds them all."""
    jg, pg = _grids((1.0, 1.0, 4.0))
    pts, n = _points(seed=1)
    jcls = JV.DynamicPillarVFE if cluster else JV.DynamicPillarVFESimple2D
    pcls = PV.DynamicPillarVFE if cluster else PV.DynamicPillarVFESimple2D
    tree, want = jax_module(jcls(out_ch=16), jnp.asarray(pts), jnp.int32(n),
                            jg, max_pillars)
    pm = port_module(pcls, tree, 4, 16)
    with torch.no_grad():
        got = pm(torch.from_numpy(pts), n, pg, max_pillars)
    for key in ("coords", "num_points", "num_voxels", "point_voxel"):
        _eq(getattr(got, key), getattr(want, key))
    assert rel_l2(got.features, want.features) <= FWD_REL_L2


def test_dynamic_pillar_vfe_uncapped():
    """JAX's pinned case: 60 points in one pillar all count; Simple2D's fc
    takes 3 inputs fewer (no cluster offset)."""
    _, pg = _grids((1.0, 1.0, 4.0))
    pts = torch.zeros(64, 4)
    pts[:60, :2] = 0.5
    pts[:60, 3] = torch.from_numpy(
        np.random.default_rng(0).normal(size=60).astype(np.float32))
    vfe = PV.DynamicPillarVFE(4, 8, device="cpu")
    out = vfe(pts, 60, pg, 16)
    assert int(out.num_voxels) == 1
    assert int(out.num_points[int((out.coords[:, 1] >= 0).float().argmax())]
               ) == 60
    assert torch.isfinite(out.features).all()
    s2d = PV.DynamicPillarVFESimple2D(4, 8, device="cpu")
    assert s2d.fc.kernel.shape[0] == vfe.fc.kernel.shape[0] - 3


@pytest.mark.parametrize("num_layers, max_voxels", [(1, 600), (2, 60)])
def test_dynamic_voxel_vfe_matches_jax(num_layers, max_voxels):
    """Two layers (DSVT's) at 60 voxels, which overflow."""
    jg, pg = _grids((1.0, 1.0, 0.5))
    pts, n = _points(seed=2)
    tree, want = jax_module(JV.DynamicVoxelVFE(out_ch=16,
                                               num_layers=num_layers),
                            jnp.asarray(pts), jnp.int32(n), jg, max_voxels)
    pm = port_module(PV.DynamicVoxelVFE, tree, 4, 16, num_layers)
    with torch.no_grad():
        got = pm(torch.from_numpy(pts), n, pg, max_voxels)
    for key in ("coords", "num_points", "num_voxels", "point_voxel"):
        _eq(getattr(got, key), getattr(want, key))
    assert rel_l2(got.features, want.features) <= FWD_REL_L2
    if max_voxels == 60:
        assert int(got.num_voxels) == 60 and (got.point_voxel == -1).sum() \
            > (torch.arange(700) >= n).sum()


def test_dynamic_voxel_vfe_tied_max_gradient_matches_jax():
    """Every point of the cloud twice (exact ties in every voxel's max):
    the gradient of sum(pooled · w) into the points, two layers, JAX's
    jax.grad against the port's autograd; each copy of a point takes half,
    as JAX's scatter-max rule splits a tie."""
    jg, pg = _grids((1.0, 1.0, 0.5))
    pts, n = _points(n=200, pad=200, seed=3)
    pts = np.concatenate([pts, pts])
    m = JV.DynamicVoxelVFE(out_ch=16, num_layers=2)
    tree, _ = jax_module(m, jnp.asarray(pts), jnp.int32(400), jg, 400)
    w = np.random.default_rng(4).normal(size=(400, 16)).astype(np.float32)

    def loss(p):
        out = m.apply(tree, p, jnp.int32(400), jg, 400)
        return jnp.sum(out.features * w)
    want = jax.jit(jax.grad(loss))(jnp.asarray(pts))
    pm = port_module(PV.DynamicVoxelVFE, tree, 4, 16, 2)
    p = torch.from_numpy(pts).requires_grad_(True)
    (pm(p, 400, pg, 400).features * torch.from_numpy(w)).sum().backward()
    assert rel_l2(p.grad, want) <= GRAD_REL_L2
    got = p.grad.numpy()
    assert np.abs(got[:200] - got[200:]).max() <= 1e-6 * np.abs(got).max()


@pytest.mark.parametrize("hw", [(16, 16), (15, 13)])
def test_base_bev_res_backbone_matches_jax(hw):
    x = np.random.default_rng(5).normal(size=(8, *hw)).astype(np.float32)
    kw = dict(layer_channels=(8, 16, 16), layer_strides=(1, 2, 2),
              layer_nums=(1, 2, 1), upsample_channels=(8, 8, 8))
    tree, want = jax_module(JP.BaseBEVResBackbone(**kw), jnp.asarray(x))
    pm = port_module(PP.BaseBEVResBackbone, tree, 8, **kw)
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    assert got.shape == want.shape == (24, *hw)
    assert rel_l2(got, want) <= FWD_REL_L2


def test_base_bev_backbone_v1_matches_jax():
    rng = np.random.default_rng(6)
    x4 = rng.normal(size=(16, 10, 10)).astype(np.float32)
    x5 = rng.normal(size=(32, 5, 5)).astype(np.float32)
    kw = dict(num_filters=(16, 32), layer_nums=(2, 2),
              upsample_channels=(16, 16), upsample_strides=(1, 2))
    tree, want = jax_module(JP.BaseBEVBackboneV1(**kw), jnp.asarray(x4),
                            jnp.asarray(x5))
    pm = port_module(PP.BaseBEVBackboneV1, tree, 16, 32, **kw)
    with torch.no_grad():
        got = pm(torch.from_numpy(x4), torch.from_numpy(x5))
    assert got.shape == want.shape == (32, 10, 10)
    assert rel_l2(got, want) <= FWD_REL_L2


def _pillar_sparse(rng, cap=64, n=40, c=8, grid2d=(32, 32, 1)):
    """tests/test_zoo_round2.py's pillar tensor, in JAX and in the port."""
    nx, ny, _ = grid2d
    lin = rng.choice(nx * ny, size=n, replace=False)
    coords = np.full((cap, 3), -1, np.int32)
    coords[:n] = np.stack([np.zeros(n, np.int64), lin // nx, lin % nx], 1)
    feats = np.zeros((cap, c), np.float32)
    feats[:n] = rng.normal(size=(n, c))
    return (JS.from_voxels(jnp.asarray(coords), jnp.asarray(feats), grid2d),
            PS.from_voxels(torch.from_numpy(coords), torch.from_numpy(feats),
                           grid2d))


def test_voxelnext2d_backbone_matches_jax():
    jst, pst = _pillar_sparse(np.random.default_rng(8))
    chs = (8, 8, 16, 16, 16)
    tree, want = jax_module(JN2.VoxelNeXt2DBackbone(channels=chs,
                                                    capacity=64), jst)
    pm = port_module(PN2.VoxelNeXt2DBackbone, tree, 8, 64, chs)
    with torch.no_grad():
        got = pm(pst)
    assert got.grid == tuple(want.grid) == (4, 4, 1)
    _eq(got.ids, want.ids)
    assert rel_l2(got.features, want.features) <= FWD_REL_L2
    assert int(got.num_active()) > 0


def test_anchor_head_multi_matches_jax():
    """The pinned groups ((0, 1), (2,)): group 0's rows never score class
    2 (-1e9), group 1's never 0 or 1; the anchor table equal."""
    groups = ((0, 1), (2,))
    bev = np.random.default_rng(9).normal(size=(8, 4, 4)).astype(np.float32)
    tree, want = jax_module(JA.AnchorHeadMulti(num_classes=3,
                                               class_groups=groups),
                            jnp.asarray(bev))
    pm = port_module(PA.AnchorHeadMulti, tree, 8, 3, groups)
    with torch.no_grad():
        got = pm(torch.from_numpy(bev))
    assert got["cls"].shape == (4 * 4 * 6, 3)
    lifted = np.asarray(want["cls"]) < -1e8
    _eq(got["cls"] < -1e8, lifted)
    assert lifted[:64, 2].all() and lifted[64:, :2].all()
    assert rel_l2(got["cls"][~torch.from_numpy(lifted)],
                  np.asarray(want["cls"])[~lifted]) <= FWD_REL_L2
    for k in ("box", "dir"):
        assert rel_l2(got[k], want[k]) <= FWD_REL_L2
    sizes = [(4, 2, 1.5), (6, 2.5, 2.0), (0.8, 0.8, 1.7)]
    args = ((4, 4), groups, sizes, (-8, -8, -3, 8, 8, 1), (4.0, 4.0))
    for g, w in zip(PA.multi_anchor_table(*args),
                    JA.multi_anchor_table(*args)):
        _eq(g, w)


@pytest.fixture(scope="module")
def run():
    return Run("PillarNet")


def test_pillarnet_detector_matches_jax(run):
    """Its PillarResBackbone (to the stride-8 8 x 8 grid, stage capacities
    3/4 of the last, at least 1024) held on the way: the output's ids
    equal, its features within 1e-5."""
    jout, inter, jdets = run.jax_forward()
    trace = []
    pout, pdets = run.port_forward(trace)
    assert pout["bev_dense"].shape == (128, 8, 8)
    assert rel_l2(pout["bev_dense"], jout["bev_dense"]) <= FWD_REL_L2
    for k, v in pout["preds"].items():
        assert rel_l2(v, jout["preds"][k]) <= FWD_REL_L2, k
    want = inter["backbone2d_sparse"]["__call__"][0]
    got = trace[-1][1]
    assert [n for n, _ in trace] == ["stage1", "stage2", "stage3", "stage4"]
    assert got.grid == tuple(want.grid) == (8, 8, 1)
    assert run.pm.backbone2d_sparse.capacities == [1024, 1024, 1024]
    _eq(got.ids, want.ids)
    assert rel_l2(got.features, want.features) <= FWD_REL_L2
    assert check_detections(pdets, jdets) > 0


def test_pillarnet_train_steps_match_jax(run):
    check_train(run.train())


def _jax_init_args(name, jc):
    """ShapeDtypeStructs of the JAX family's init call at the preset's
    sizes: the focal multimodal Voxel R-CNN with an image and proj (so
    that its tree holds the image modules), MPPNet's T-frame stack and
    proposals, MPPNetE2E's bank, frame and proposals."""
    from lvv_tpu.models.mppnet import MemoryBank
    from lvv_tpu.models.voxelnext import Detections

    def f32(*shape):
        return jax.ShapeDtypeStruct(shape, jnp.float32)
    i32 = jax.ShapeDtypeStruct((), jnp.int32)
    pts = f32(jc.voxelize.max_points, 4)
    if not name.startswith("MPPNet"):
        if getattr(jc.model.voxelnext, "focal_use_img", False):
            return (pts, i32, f32(375, 1242, 3), f32(3, 4))
        return (pts, i32)
    t, per, r = 4, jc.voxelize.max_points // 4, 32
    props = Detections(boxes=f32(r, 9), scores=f32(r),
                       labels=jax.ShapeDtypeStruct((r,), jnp.int32),
                       count=i32)
    if name == "MPPNet":
        return (f32(t, per, 4), jax.ShapeDtypeStruct((t,), jnp.int32),
                props)
    bank = MemoryBank(points=f32(t - 1, per, 4),
                      counts=jax.ShapeDtypeStruct((t - 1,), jnp.int32))
    return (bank, f32(per, 4), i32, props)


@pytest.mark.parametrize("preset", ["kitti_pillarnet", "waymo_pillarnet",
                                    "waymo_dsvt_pillar", "waymo_dsvt_voxel",
                                    "waymo_mppnet_4frames",
                                    "waymo_mppnet_16frames",
                                    "waymo_mppnet_e2e",
                                    "kitti_voxel_rcnn_car_focal_multimodal"])
def test_presets_build_with_jax_parameter_counts(preset):
    path = REPO / "configs" / f"{preset}.json"
    name = C.load_file(path)["_detector"]
    jc, pc = JC.load(JC.VQAConfig, path), C.load(C.VQAConfig, path)
    jm = jax_build(name, jc.model.voxelnext, jc.voxelize)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            *_jax_init_args(name, jc))
    want = sum(int(np.prod(x.shape))
               for x in jax.tree_util.tree_leaves(shapes))
    det = build_detector(name, pc.model.voxelnext, pc.voxelize,
                         device="meta")
    assert sum(p.numel() for p in det.parameters()) == want
