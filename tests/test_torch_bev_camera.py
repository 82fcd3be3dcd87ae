"""The port's camera-input detectors, BEVFusion and CaDDN, against the JAX
package's on the CPU, on shared random weights (`torch_zoo_util.random_tree`
over `jax.eval_shape`, converted by `from_jax_detector_params`).

- The pieces: `bev_pool` (duplicate bins, invalid points, ids past the
  grid); `ConvImageBackbone`; `frustum_grid` / `frustum_to_ego` (one view
  and a batch of views);
  `project_points_to_depth` (two returns on one pixel, points behind the
  camera, out of the frame and past `num_points`); the FPN's bilinear
  upsampling 8 x 22 -> 16 x 44 against jax.image.resize (and
  F.interpolate, align_corners False, which equals it at 2x).
- BEVFusion at tiny widths (Swin embed 8, depths 2 / 2 / 2 / 2, window 7
  over 2 views of 224 x 448: grids 56 x 112 down to 7 x 14, whole windows
  where JAX runs; FPN 16, camera BEV 8, 16 queries) on `torch_zoo_util`'s
  72 x 72 x 16 LiDAR grid (a 9 x 9 BEV), in one jit of JAX's forward with
  its intermediates and decode: the Swin pyramid, the FPN, the
  DepthLSSTransform (on JAX's FPN output and depth maps) and the fuser (on
  JAX's two BEVs) each from its inputs; the assembly's outputs, sparse
  stage ids and `detect`.
- CaDDN at tiny widths (8 depth bins, 8 channels, a 48 x 160 image over a
  32 x 32 x 4 lattice): `bin_depths`, `bin_centers`, `linspace_f32` and
  the lattice against JAX's at `configs/kitti_caddn.json`'s 440 x 500 x 4
  (within 1 ulp: XLA's rewrites of linspace depend on the compile),
  `sample_frustum`, `frustum_features`; forward, detect, and `loss` (the
  anchor loss and the LID depth cross-entropy) with its gradient against
  jax.value_and_grad.
- The registry builds both (full width on the meta device: BEVFusion's
  27 LayerNorms that K-a takes on the card), neither trains (the train
  step says why, and the CLI on CaDDN's preset); no registered name is
  left unported: every one builds, an unknown one raises KeyError.

Tolerances (torch_zoo_util): fp32 forward 1e-5 relative L2, detections
equal in count and labels with boxes and scores within 1e-4, the loss 1e-5
relative, each parameter group's gradient 1e-4 relative L2; the geometry
(pixels, bins) exact, the lattice within 1 ulp.
"""
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from lvv_tpu.config import tiny_config as jax_tiny_config
from lvv_tpu.models import bevfusion as JB
from lvv_tpu.models import caddn as JC
from lvv_tpu.models import depth_lss as JD
from lvv_tpu.models.anchor_head import decode_anchor_preds
from lvv_tpu.models.transfusion import decode_queries
from lvv_tpu.ops.pool import bev_pool as jax_bev_pool
from lvv_tpu_torch import config as C
from lvv_tpu_torch import tiny_config
from lvv_tpu_torch.convert import from_jax_detector_params
from lvv_tpu_torch.convert.params import _convert, _flatten
from lvv_tpu_torch.models import caddn as PC
from lvv_tpu_torch.models import depth_lss as PD
from lvv_tpu_torch.models.layers import LayerNorm, resize_1d
from lvv_tpu_torch.models.registry import DETECTORS, PORTED, build_detector
from lvv_tpu_torch.ops.pool import bev_pool
from lvv_tpu_torch.tools import train_detector as cli
from lvv_tpu_torch.train.detector import make_detector_train_step
from torch_zoo_util import (FWD_REL_L2, GRAD_REL_L2, LOSS_REL,
                            check_detections, cloud, configs, group_rel_l2,
                            random_tree, rel_l2)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.fast

REPO = pathlib.Path(__file__).resolve().parents[1]
BEV_KW = dict(image_hw=(224, 448), swin_embed=8, swin_depths=(2, 2, 2, 2),
              swin_heads=(1, 2, 2, 4), swin_window=7, out_indices=(1, 2, 3),
              fpn_channels=16, cam_bev_channels=8, fuse_channels=16,
              num_queries=16)
CADDN_KW = dict(num_depth_bins=8, cam_channels=8, z_bins=4,
                img_downsample=4)
CADDN_GEOMETRY = dict(point_range=(0.0, -8.0, -2.0, 16.0, 8.0, 2.0),
                      voxel_size=(0.5, 0.5, 0.5))
CADDN_HW = (48, 160)


def rig(yaws, hw, f):
    """Pinhole cameras 1.5 m up on a ring, looking out at each yaw
    (camera x right, y down, z forward) -> (intrinsics [V, 3, 3],
    cam2lidar [V, 4, 4]), float32."""
    h, w = hw
    ks, ms = [], []
    for yaw in yaws:
        m = np.eye(4)
        m[:3, 0] = (np.sin(yaw), -np.cos(yaw), 0.0)
        m[:3, 1] = (0.0, 0.0, -1.0)
        m[:3, 2] = (np.cos(yaw), np.sin(yaw), 0.0)
        m[:3, 3] = (0.3 * np.cos(yaw), 0.3 * np.sin(yaw), 1.5)
        ks.append([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]])
        ms.append(m)
    return np.asarray(ks, np.float32), np.asarray(ms, np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


class BEVRun:
    """BEVFusion's JAX run (one jit: forward with intermediates, decode)
    and the port's forward and detect on one converted tree."""

    def __init__(self):
        jdet, jvox, pdet, pvox = configs("TransFusion")
        self.cfgs = (jdet, jvox, pdet, pvox)
        rng = np.random.default_rng(3)
        self.n = 3000
        self.pts = cloud(jvox, self.n)
        self.images = rng.standard_normal(
            (2, 3, *BEV_KW["image_hw"])).astype(np.float32)
        self.k, self.m = rig((0.0, 2.0), BEV_KW["image_hw"], 200.0)
        self.jm = JB.BEVFusionDetector(det_cfg=jdet, vox_cfg=jvox, **BEV_KW)
        args = self.jax_args()
        shapes = jax.eval_shape(self.jm.init, jax.random.PRNGKey(0), *args)
        self.tree = random_tree(dict(shapes))
        self.pm = build_detector("BEVFusion", pdet, pvox, device="cpu",
                                 **BEV_KW)
        self.pm.load_state_dict(from_jax_detector_params(
            self.tree, pdet, pvox, device="cpu", detector="BEVFusion",
            **BEV_KW))

        def run(tree, *a):
            out, inter = self.jm.apply(tree, *a, capture_intermediates=True,
                                       mutable=["intermediates"])
            return out, inter["intermediates"], decode_queries(
                out["preds"], jdet, jvox, jdet.spatial_stride)
        self.out, self.inter, self.dets = jax.jit(run)(self.tree, *args)
        self.trace = []
        with torch.no_grad():
            self.got = self.pm(*self.port_args(), trace=self.trace)
        self.got_dets = self.pm.detect(*self.port_args())

    def jax_args(self):
        return (jnp.asarray(self.pts), jnp.int32(self.n),
                jnp.asarray(self.images), jnp.asarray(self.k),
                jnp.asarray(self.m))

    def port_args(self):
        return (_t(self.pts), self.n, _t(self.images), _t(self.k),
                _t(self.m))


class CaDDNRun:
    """CaDDN's JAX run (forward and decode in one jit) and the port's."""

    def __init__(self):
        jc, pc = jax_tiny_config(), tiny_config()
        jdet = jc.model.voxelnext
        jvox = dataclasses.replace(jc.voxelize, **CADDN_GEOMETRY)
        pdet = pc.model.voxelnext
        pvox = dataclasses.replace(pc.voxelize, **CADDN_GEOMETRY)
        self.cfgs = (jdet, jvox, pdet, pvox)
        h, w = CADDN_HW
        rng = np.random.default_rng(4)
        self.image = rng.standard_normal((3, h, w)).astype(np.float32)
        self.k = np.array([[120.0, 0, w / 2], [0, 120.0, h / 2], [0, 0, 1]],
                          np.float32)
        # LiDAR x forward, z up -> camera z forward, y down, 1.2 m above
        self.l2c = np.array([[0, -1, 0, 0.05], [0, 0, -1, 1.2],
                             [1, 0, 0, -0.3], [0, 0, 0, 1]], np.float32)
        self.jm = JC.CaDDNDetector(det_cfg=jdet, vox_cfg=jvox, **CADDN_KW)
        shapes = jax.eval_shape(self.jm.init, jax.random.PRNGKey(0),
                                *self.jax_args())
        self.tree = random_tree(dict(shapes))
        self.pm = build_detector("CaDDN", pdet, pvox, device="cpu",
                                 **CADDN_KW)
        self.pm.load_state_dict(from_jax_detector_params(
            self.tree, pdet, pvox, device="cpu", detector="CaDDN",
            **CADDN_KW))

        def run(tree, *a):
            out = self.jm.apply(tree, *a)
            return out, decode_anchor_preds(out["preds"], out["anchors"],
                                            out["anchor_cls"], jdet)
        self.out, self.dets = jax.jit(run)(self.tree, *self.jax_args())

    def jax_args(self):
        return (jnp.asarray(self.image), jnp.asarray(self.k),
                jnp.asarray(self.l2c))

    def port_args(self):
        return (_t(self.image), _t(self.k), _t(self.l2c))

    def targets(self):
        """Six gts (one masked) in front of the camera, and a LiDAR depth
        map at the feature stride: no return, in range, past depth_max."""
        rng = np.random.default_rng(6)
        boxes = np.zeros((6, 9), np.float32)
        boxes[:, 0] = rng.uniform(2, 14, 6)
        boxes[:, 1] = rng.uniform(-6, 6, 6)
        boxes[:, 2] = -1.0
        boxes[:, 3:6] = rng.uniform(1.0, 4.0, (6, 3))
        boxes[:, 6] = rng.uniform(-np.pi, np.pi, 6)
        labels = rng.integers(0, 3, 6).astype(np.int32)
        mask = np.array([1, 1, 1, 1, 1, 0], bool)
        hf, wf = (s // CADDN_KW["img_downsample"] for s in CADDN_HW)
        depth = rng.uniform(1.0, 60.0, (hf, wf)).astype(np.float32)
        depth[rng.uniform(size=(hf, wf)) < 0.4] = 0.0
        return boxes, labels, mask, depth


@pytest.fixture(scope="module")
def bev():
    return BEVRun()


@pytest.fixture(scope="module")
def caddn():
    return CaDDNRun()


# ------------------------------------------------------------------ pieces

def test_bev_pool_matches_jax():
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((600, 5)).astype(np.float32)
    ids = rng.integers(-3, 45, 600).astype(np.int32)     # 40 bins, some out
    valid = (rng.uniform(size=600) < 0.8) & (ids >= 0) & (ids < 40)
    want = jax_bev_pool(jnp.asarray(feats), jnp.asarray(ids),
                        jnp.asarray(valid), 40)
    got = bev_pool(_t(feats), _t(ids), _t(valid), 40)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_frustum_matches_jax():
    depths = np.arange(1.0, 45.0, 0.5, dtype=np.float32)
    want_fr = JD.frustum_grid(4, 7, jnp.asarray(depths), 8)
    got_fr = PD.frustum_grid(4, 7, _t(depths), 8)
    np.testing.assert_array_equal(got_fr.numpy(), np.asarray(want_fr))
    k, m = rig((0.3, -1.9), (32, 56), 40.0)
    batched = PD.frustum_to_ego(got_fr, _t(k), _t(m))
    for vi in range(2):
        want = np.asarray(JD.frustum_to_ego(want_fr, jnp.asarray(k[vi]),
                                            jnp.asarray(m[vi])))
        got = PD.frustum_to_ego(got_fr, _t(k[vi]), _t(m[vi]))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-5)
        np.testing.assert_array_equal(batched[vi].numpy(), got.numpy())


def test_project_points_to_depth_matches_jax():
    hw = (32, 64)
    k, m = rig((0.0, np.pi), hw, 30.0)
    rng = np.random.default_rng(1)
    pts = np.zeros((400, 4), np.float32)
    pts[:300, :3] = rng.uniform((-20, -20, -2), (20, 20, 3), (300, 3))
    # two returns on one ray of view 0 (the nearer one is kept), one behind
    # view 0, then padding past num_points that lies in view
    ray = np.array([1.0, 0.1, -0.2])
    pts[300, :3] = m[0, :3, 3] + 5.0 * ray
    pts[301, :3] = m[0, :3, 3] + 10.0 * ray
    pts[302, :3] = (-3.0, 0.0, 1.5)
    pts[303:, :3] = (8.0, 0.0, 1.0)
    n = 303
    want = JD.project_points_to_depth(jnp.asarray(pts), jnp.int32(n),
                                      jnp.asarray(k), jnp.asarray(m), hw)
    got = PD.project_points_to_depth(_t(pts), n, _t(k), _t(m), hw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    d = got.numpy()[0, 0]
    assert d[d > 0].min() < 5.5 and (d > 0).sum() > 20


def test_conv_image_backbone_matches_jax():
    x = np.random.default_rng(5).standard_normal((3, 40, 56)).astype(
        np.float32)
    jm = JD.ConvImageBackbone(channels=(4, 8, 16))
    tree = random_tree(dict(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                           jnp.asarray(x))))
    pm = PD.ConvImageBackbone((4, 8, 16), device="cpu")
    pm.load_state_dict(_convert(_flatten(tree["params"]), pm,
                                torch.device("cpu")))
    want = jax.jit(jm.apply)(tree, jnp.asarray(x))
    with torch.no_grad():
        got = pm(_t(x))
    assert got.shape == want.shape == (16, 5, 7)
    assert rel_l2(got.numpy(), want) <= FWD_REL_L2


def test_fpn_upsampling_is_jax_resize():
    x = np.random.default_rng(2).standard_normal((2, 5, 8, 22)).astype(
        np.float32)
    want = jax.image.resize(jnp.asarray(x).transpose(0, 2, 3, 1),
                            (2, 16, 44, 5), "bilinear").transpose(0, 3, 1, 2)
    got = resize_1d(resize_1d(_t(x), 2, 16, "linear"), 3, 44, "linear")
    interp = F.interpolate(_t(x), (16, 44), mode="bilinear",
                           align_corners=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(interp.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


# --------------------------------------------------------------- BEVFusion

def test_bevfusion_modules_match_jax(bev):
    inter, pm = bev.inter, bev.pm
    with torch.no_grad():
        pyramid = pm.image_backbone(_t(bev.images))
        want = inter["image_backbone"]["__call__"][0]
        assert len(pyramid) == len(want) == 3
        for g, w in zip(pyramid, want):
            assert rel_l2(g.numpy(), w) <= FWD_REL_L2
        neck = pm.neck([_t(w) for w in want])
        for g, w in zip(neck, inter["neck"]["__call__"][0]):
            assert rel_l2(g.numpy(), w) <= FWD_REL_L2
        depth = JD.project_points_to_depth(
            jnp.asarray(bev.pts), jnp.int32(bev.n), jnp.asarray(bev.k),
            jnp.asarray(bev.m), BEV_KW["image_hw"])
        cam = pm.vtransform(_t(inter["neck"]["__call__"][0][0]), _t(bev.k),
                            _t(bev.m), _t(depth))
        assert rel_l2(cam.numpy(), bev.out["cam_bev"]) <= FWD_REL_L2
        fused = pm.fuser(_t(bev.out["cam_bev"]), _t(bev.out["lidar_bev"]))
        assert rel_l2(fused.numpy(),
                      inter["fuser"]["__call__"][0]) <= FWD_REL_L2
    assert float(np.abs(np.asarray(bev.out["cam_bev"])).max()) > 0


def test_bevfusion_forward_and_detect_match_jax(bev):
    got, out = bev.got, bev.out
    for k in ("lidar_bev", "cam_bev", "bev_dense"):
        assert got[k].shape == out[k].shape
        assert rel_l2(got[k].numpy(), out[k]) <= FWD_REL_L2, k
    assert got["bev_dense"].shape[1:] == (9, 9)
    for k, v in out["preds"].items():
        g = got["preds"][k].numpy()
        if np.issubdtype(g.dtype, np.floating):
            assert rel_l2(g, v) <= FWD_REL_L2, k
        else:
            np.testing.assert_array_equal(g, np.asarray(v))
    bb = bev.inter["backbone3d"]
    stages = {f"stage{i}": bb[f"res{i}"]["__call__"][0] for i in range(1, 5)}
    assert [n for n, _ in bev.trace] == list(stages)
    for name, st in bev.trace:
        np.testing.assert_array_equal(st.ids.numpy(),
                                      np.asarray(stages[name].ids))
    assert check_detections(bev.got_dets, bev.dets) > 1


# ------------------------------------------------------------------- CaDDN

def test_bins_match_jax():
    depth = np.array([-1.0, 0.0, 1.9, 2.0, 2.5, 10.0, 46.7, 46.8, 80.0,
                      np.inf, np.nan], np.float32)
    for mode in ("LID", "UD"):
        for clamp in (True, False):
            kw = dict(mode=mode, num_bins=40, clamp=clamp)
            np.testing.assert_array_equal(
                PC.bin_depths(_t(depth), **kw).numpy(),
                np.asarray(JC.bin_depths(jnp.asarray(depth), **kw)))
        np.testing.assert_array_equal(PC.bin_centers(mode, num_bins=40),
                                      JC.bin_centers(mode, num_bins=40))


def test_lattice_matches_jax_at_the_preset():
    cfg = C.load(C.VQAConfig, REPO / "configs" / "kitti_caddn.json")
    det = build_detector("CaDDN", cfg.model.voxelnext, cfg.voxelize,
                         device="meta")
    got = det.lattice.numpy()
    assert got.shape == (4, 500, 440, 3)
    pr, vs = cfg.voxelize.point_range, cfg.voxelize.voxel_size
    xs = jnp.linspace(pr[0], pr[3], 440, endpoint=False) + vs[0] / 2
    ys = jnp.linspace(pr[1], pr[4], 500, endpoint=False) + vs[1] / 2
    zs = jnp.linspace(pr[2], pr[5], 4, endpoint=False) \
        + (pr[5] - pr[2]) / 4 / 2
    zz, yy, xx = jnp.meshgrid(zs, ys, xs, indexing="ij")
    want = np.asarray(jnp.stack([xx, yy, zz], -1))
    np.testing.assert_array_max_ulp(got, want, maxulp=1)
    for lo, hi, n in ((0.0, 70.4, 440), (-40.0, 40.0, 500),
                      (-54.0, 54.0, 1440), (-3.0, 1.0, 4)):
        np.testing.assert_array_max_ulp(
            PC.linspace_f32(lo, hi, n),
            np.asarray(jnp.linspace(lo, hi, n, endpoint=False)), maxulp=1)


def test_frustum_volume_and_sampler_match_jax():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((6, 4, 7)).astype(np.float32)
    feats = rng.standard_normal((3, 4, 7)).astype(np.float32)
    vol = PC.frustum_features(_t(logits), _t(feats))
    want = JC.frustum_features(jnp.asarray(logits), jnp.asarray(feats))
    assert vol.shape == (5, 4, 7, 3)
    assert rel_l2(vol.numpy(), want) <= FWD_REL_L2
    n = 300                  # some coordinates past every edge
    u, v, d = (rng.uniform(-1.5, hi + 0.5, n).astype(np.float32)
               for hi in (7, 4, 5))
    got = PC.sample_frustum(vol, _t(u), _t(v), _t(d))
    want = JC.sample_frustum(want, jnp.asarray(u), jnp.asarray(v),
                             jnp.asarray(d))
    assert rel_l2(got.numpy(), want) <= FWD_REL_L2


def test_caddn_forward_and_detect_match_jax(caddn):
    with torch.no_grad():
        got = caddn.pm(*caddn.port_args())
    out = caddn.out
    for k in ("bev_dense", "depth_logits"):
        assert rel_l2(got[k].numpy(), out[k]) <= FWD_REL_L2, k
    for k, v in out["preds"].items():
        assert rel_l2(got["preds"][k].numpy(), v) <= FWD_REL_L2, k
    np.testing.assert_array_equal(got["anchors"].numpy(),
                                  np.asarray(out["anchors"]))
    # the lattice samples the image: part of the BEV is not the bias alone
    u, v, d = caddn.pm.sample_coords(_t(caddn.k), _t(caddn.l2c))
    inside = (u >= 0) & (u < 39) & (v >= 0) & (v < 11) & (d >= 0) & (d < 7)
    assert 0.05 < float(inside.float().mean()) < 0.95
    assert check_detections(caddn.pm.detect(*caddn.port_args()),
                            caddn.dets) > 1


def test_caddn_loss_and_gradient_match_jax(caddn):
    boxes, labels, mask, depth = caddn.targets()
    gts = tuple(jnp.asarray(x) for x in (boxes, labels, mask, depth))

    def loss(params):
        out = caddn.jm.apply({"params": params}, *caddn.jax_args())
        return caddn.jm.loss(out, *gts)
    (want, want_terms), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(caddn.tree["params"])
    pm = caddn.pm
    pm.zero_grad()
    total, terms = pm.loss(pm(*caddn.port_args()), *(_t(x) for x in
                                                       (boxes, labels, mask,
                                                        depth)))
    total.backward()
    assert set(terms) == set(want_terms) == {"cls_loss", "box_loss",
                                             "dir_loss", "depth_loss"}
    np.testing.assert_allclose(float(total.detach()), float(want),
                               rtol=LOSS_REL)
    for k, v in want_terms.items():
        np.testing.assert_allclose(float(terms[k].detach()), float(v),
                                   rtol=LOSS_REL, err_msg=k)
    _, _, pdet, pvox = caddn.cfgs
    jg = from_jax_detector_params({"params": jax.tree.map(np.asarray,
                                                          grads)},
                                  pdet, pvox, device="cpu",
                                  detector="CaDDN", **CADDN_KW)
    got = {k: p.grad for k, p in pm.named_parameters()}
    groups = group_rel_l2({k: v.numpy() for k, v in jg.items()}, got)
    assert {"ffn", "backbone2d", "head"} <= set(groups)
    assert max(groups.values()) <= GRAD_REL_L2, groups
    assert all(g is not None and g.abs().sum() > 0 for g in got.values())


# --------------------------------------------------------- registry, CLI

def test_registry_builds_both_at_full_width():
    cfg = C.load(C.VQAConfig, REPO / "configs" / "nuscenes_bevfusion.json")
    det = build_detector("BEVFusion", cfg.model.voxelnext, cfg.voxelize,
                         device="meta")
    assert det.camera_input and det.image_hw == (256, 704)
    widths = [m.scale.numel() for m in det.modules()
              if isinstance(m, LayerNorm)]
    # K-a's lane rule: Swin's 21 at widths 384 / 768 / 1536, the head's 6
    assert sum(w % 128 == 0 for w in widths) == 27
    assert sorted({w for w in widths if w % 128 == 0}) == [128, 384, 768,
                                                           1536]
    assert det.vtransform.img_stride == 8
    assert det.vtransform.bev_hw == (180, 180)
    assert len(det.vtransform.depth_values()) == 88
    with pytest.raises(NotImplementedError, match="does not train"):
        make_detector_train_step(det, None, cfg.model.voxelnext,
                                 cfg.voxelize)


def test_cli_says_camera_families_do_not_train():
    # CaDDN's preset (BEVFusion's takes the same refusal, from the train
    # step, in test_registry_builds_both_at_full_width; its full-width
    # build on the CPU draws 34M parameters)
    with pytest.raises(SystemExit, match="CaDDNDetector builds in the port "
                       "but does not train"):
        cli.main(["--config", "configs/kitti_caddn.json", "--synthetic",
                  "--steps", "2", "--device", "cpu"])


def test_other_families_still_raise():
    """No registered family raises any more: every one builds (on the
    meta device), and an unknown name still raises KeyError."""
    left = [n for n in DETECTORS if n not in PORTED]
    assert left == [] and "BEVFusion" in PORTED and "CaDDN" in PORTED
    cfg = tiny_config()
    for name in DETECTORS:
        det = build_detector(name, cfg.model.voxelnext, cfg.voxelize,
                             device="meta")
        assert type(det).__name__ == PORTED[name][1]
    with pytest.raises(KeyError, match="unknown detector"):
        build_detector("MPPNetV2", cfg.model.voxelnext, cfg.voxelize,
                       device="meta")
