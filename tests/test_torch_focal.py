"""The port's focal sparse conv, image branch and focal / multimodal Voxel
R-CNN against the JAX package's, on the CPU.

tests/test_semseg.py's sizes: images of a few tens of pixels, a few
hundred voxels, spawn 16-256; the detector at tiny_config()'s widths on
torch_two_stage_util's 72 x 72 x 16 grid (3,000 points) with `focal`,
`focal_use_img` and focal_spawn 64, a 32 x 32 image, parameters from one
seeded JAX tree (initialised with image and proj, so that it holds the
image modules) through `from_jax_detector_params`.

- flax's GroupNorm; ResNetFeatures ("gn" on odd and even sides,
  "frozen_bn") and PyramidFeat2D within 1e-5 relative L2; the projection
  (a centre on .5 of a pixel rounds half to even) and the gather equal.
- The DeepLabV3 converter on a synthetic torchvision state dict: equal to
  JAX's converter leaf for leaf, and the port's frozen_bn trunk on it
  against a torch replica of torchvision's stem and layer1 in eval mode.
- FocalSparseConv with and without the image, on both neighbour lookups
  (occupancy table, sorted search): spawned ids and output ids equal,
  some sites spawned and not all, features and importance within 1e-5,
  the image's gradient within 1e-4; the focal losses.
- The detector's direct call with image and proj (every output, each
  focal conv's importance, centres and spawned ids) and its loss and
  gradients (every parameter within 1e-4 relative L2, the image branch's
  non-zero), with JAX's ReLU gates and the RoI head's neighbour-max
  winners replayed (near-ties within float32 rounding at the stride-8
  scale, where the port's own winners differ at 32 of 2.65M entries,
  moved roi_head.mlp2's gradient by 1.3e-3 and the trunk's by ~3e-4); zeroing the image moves the
  outputs; `detect` without the image; three train steps at batch 2
  against JAX's jit'd step (torch_waymo_util's `check_train`).
- Reference traits, kept and pinned (ROADMAP.md queue 3): `detect` and the
  train step pass no image, so the image branch and the multimodal focal
  conv get no gradient from the step (JAX's are zero); the focal centres
  are delinearize's (z, y, x) scaled in (x, y, z) order.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lvv_tpu.config import tiny_config as jax_tiny_config
from lvv_tpu.convert.deeplabv3_torch import \
    convert_deeplabv3_state as jax_convert
from lvv_tpu.models import focal_conv as JF
from lvv_tpu.models import semseg as JS
from lvv_tpu.models.voxel_rcnn import VoxelRCNNDetector as JaxVoxelRCNN
from lvv_tpu.ops import sparse as JSP
from lvv_tpu.train import detector as jax_train
from lvv_tpu_torch import tiny_config
from lvv_tpu_torch.convert import (convert_deeplabv3_state,
                                   from_jax_detector_params)
from lvv_tpu_torch.convert.params import _flatten
from lvv_tpu_torch.models import focal_conv as PF
from lvv_tpu_torch.models import semseg as PS
from lvv_tpu_torch.models.registry import build_detector
from lvv_tpu_torch.ops import sparse as PSP
from lvv_tpu_torch.train import detector as port_train
from lvv_tpu_torch.train.optim import detector_optimizer
from torch_two_stage_util import compare_outputs
from torch_waymo_util import (GRAD_REL_L2, OWN_GATES, STEPS, check_train,
                              jax_chain, jax_gates, port_gates, port_module,
                              recording)
from torch_zoo_util import (SPARSE_GEOMETRY, batch, check_detections, cloud,
                            random_tree, rel_l2)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.fast

FWD_REL_L2 = 1e-5
N_POINTS = 3000
SPAWN = 64
OWN_WINNERS = 64            # RoI neighbour-max winner entries, at most
IMAGE_HW = (32, 32)
# (z, y, x)-mixed centres (see the module note) into the 32 x 32 image:
# u from the y centre, v from the x centre, depth 1; generic factors, so
# that no pixel coordinate falls on .5
PROJ = np.array([[0.0, 0.7713, 0.0, 15.917],
                 [0.0, 0.0, 0.8137, 3.311],
                 [0.0013, 0.0, 0.0, 1.0]], np.float32)


@contextlib.contextmanager
def jax_winners(log: dict):
    """While JAX traces: each `jnp.max` over Voxel R-CNN's RoI neighbours
    (lvv_tpu/models/voxel_rcnn.py's module global `jnp`, wrapped) sends its
    winners, the finite entries equal to the max, to log[site] on every
    run (one call a sample under a vmap, in sample order)."""
    import lvv_tpu.models.voxel_rcnn as JV
    real, sites = JV.jnp, [0]

    class Wrapped:
        def __getattr__(self, name):
            return getattr(real, name)

        @staticmethod
        def max(x, axis=None, **kw):
            out = real.max(x, axis=axis, **kw)
            if axis == 1 and x.ndim == 3:
                site, sites[0] = sites[0], sites[0] + 1
                won = (x == out[:, None]) & real.isfinite(x)
                jax.debug.callback(
                    lambda w, s=site: log.setdefault(s, []).append(
                        np.asarray(w)), won, ordered=True)
            return out
    JV.jnp = Wrapped()
    try:
        yield
    finally:
        JV.jnp = real


@contextlib.contextmanager
def port_winners(winners: list, own: list):
    """The port's RoI neighbour max (`voxel_rcnn.neighbour_max`) in call
    order takes its winners from `winners`: the mean of them (ties split
    evenly, as both packages split them); the entries where the port's own
    winners differ are added to own[0]."""
    from lvv_tpu_torch.models import voxel_rcnn as PV
    plain, calls = PV.neighbour_max, [0]

    def replayed(h):
        i, calls[0] = calls[0], calls[0] + 1
        want = torch.from_numpy(np.array(winners[i]))
        out = plain(h)
        mine = (h.detach() == out.detach()[:, None]) & torch.isfinite(
            h.detach())
        own[0] += int((mine != want).sum())
        cnt = want.sum(1)
        mean = torch.where(want, h, 0.0).sum(1) / cnt.clamp_min(1)
        return torch.where(cnt > 0, mean, -torch.inf)
    PV.neighbour_max = replayed
    try:
        yield
    finally:
        PV.neighbour_max = plain
    assert calls[0] == len(winners), (calls[0], len(winners))



def _nhwc(x):
    return np.asarray(x).transpose(0, 3, 1, 2)


def test_group_norm_matches_flax():
    import flax.linen as fnn
    x = np.random.default_rng(0).normal(2.0, 3.0, (2, 5, 7, 64)).astype(
        np.float32)
    m = fnn.GroupNorm(num_groups=32)
    tree = random_tree(dict(jax.eval_shape(
        lambda k: m.init(k, jnp.asarray(x)), jax.random.PRNGKey(0))))
    want = m.apply(tree, jnp.asarray(x))
    p = tree["params"]
    got = PS.flax_group_norm(torch.from_numpy(x.transpose(0, 3, 1, 2)),
                             torch.from_numpy(np.asarray(p["scale"])),
                             torch.from_numpy(np.asarray(p["bias"])), 32)
    assert rel_l2(got.numpy(), _nhwc(want)) <= FWD_REL_L2


@pytest.mark.parametrize("norm,hw", [("gn", (33, 46)), ("gn", (32, 32)),
                                     ("frozen_bn", (33, 46))])
def test_resnet_features_match_jax(norm, hw):
    """Stem and layer1: "gn" pads "SAME" (33 rows pad the stem conv
    (3, 3) and 46 columns (2, 3)), "frozen_bn" symmetrically."""
    img = np.random.default_rng(1).uniform(size=(1, *hw, 3)).astype(
        np.float32)
    jm = JS.ResNetFeatures(layers_out=("layer1",), norm=norm)
    tree = random_tree(dict(jax.eval_shape(
        lambda k: jm.init(k, jnp.asarray(img)), jax.random.PRNGKey(0))))
    want = jax.jit(lambda t: jm.apply(t, jnp.asarray(img)))(tree)
    pm = port_module(PS.ResNetFeatures, tree, ("layer1",), norm)
    with torch.no_grad():
        got = pm(torch.from_numpy(img.transpose(0, 3, 1, 2)))
    assert got["layer1"].shape[1:] == (256, -(-hw[0] // 4), -(-hw[1] // 4))
    assert rel_l2(got["layer1"].numpy(), _nhwc(want["layer1"])) <= FWD_REL_L2


def test_pyramid_reduce_matches_jax():
    img = np.random.default_rng(2).uniform(size=(1, 29, 40, 3)).astype(
        np.float32)
    jm = JS.PyramidFeat2D(feat_layers=("layer1",), reduce_out=(16,))
    tree = random_tree(dict(jax.eval_shape(
        lambda k: jm.init(k, jnp.asarray(img)), jax.random.PRNGKey(0))))
    want = jax.jit(lambda t: jm.apply(t, jnp.asarray(img)))(tree)
    pm = port_module(PS.PyramidFeat2D, tree, ("layer1",), (16,))
    with torch.no_grad():
        got = pm(torch.from_numpy(img.transpose(0, 3, 1, 2)))
    assert rel_l2(got["layer1_feat2d"].numpy(),
                  _nhwc(want["layer1_feat2d"])) <= FWD_REL_L2


def test_projection_and_gather_match_jax():
    """Pixel coordinates on .5 round half to even (2.5 -> 2, 3.5 -> 4,
    -0.5 -> 0); behind the camera and outside the image gather zeros."""
    proj = np.array([[1.0, 0, 0, 0], [0, 1.0, 0, 0], [0, 0, 1.0, 0]],
                    np.float32)
    coords = np.array([[5, 7, 2], [7, 5, 2], [-1, 3, 2], [0, 0, 0],
                       [40, 2, 2], [3, 9, 3]], np.int32)
    args = dict(voxel_size=(0.5, 0.5, 0.5), pc_range=(0, 0, 0, 1, 1, 1))
    wuv, wvalid = JS.project_voxels_to_image(jnp.asarray(coords),
                                             proj=jnp.asarray(proj), **args)
    guv, gvalid = PS.project_voxels_to_image(torch.from_numpy(coords),
                                             proj=torch.from_numpy(proj),
                                             **args)
    np.testing.assert_array_equal(guv.numpy(), np.asarray(wuv))
    np.testing.assert_array_equal(gvalid.numpy(), np.asarray(wvalid))
    assert guv[0].tolist() == [2, 4] and guv[1].tolist() == [4, 2]
    assert guv[2].tolist() == [0, 2] and not bool(gvalid[3])
    img = np.random.default_rng(0).normal(size=(6, 8, 5)).astype(np.float32)
    want = JS.gather_image_features(jnp.asarray(img), wuv, wvalid)
    got = PS.gather_image_features(torch.from_numpy(img), guv, gvalid)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not got[3].any() and not got[4].any() and got[0].any()


def _torch_trunk():
    """A torch replica of torchvision resnet50's stem and layer1 with
    random eval BatchNorm statistics (torchvision itself is not needed)."""
    nn = torch.nn
    torch.manual_seed(0)

    class Block(nn.Module):
        def __init__(self, cin, width):
            super().__init__()
            self.conv1 = nn.Conv2d(cin, width, 1, bias=False)
            self.bn1 = nn.BatchNorm2d(width)
            self.conv2 = nn.Conv2d(width, width, 3, 1, 1, bias=False)
            self.bn2 = nn.BatchNorm2d(width)
            self.conv3 = nn.Conv2d(width, width * 4, 1, bias=False)
            self.bn3 = nn.BatchNorm2d(width * 4)
            self.downsample = (nn.Sequential(
                nn.Conv2d(cin, width * 4, 1, bias=False),
                nn.BatchNorm2d(width * 4)) if cin != width * 4 else None)

        def forward(self, x):
            idt = x if self.downsample is None else self.downsample(x)
            y = torch.relu(self.bn1(self.conv1(x)))
            y = torch.relu(self.bn2(self.conv2(y)))
            return torch.relu(self.bn3(self.conv3(y)) + idt)

    class Trunk(nn.Module):
        def __init__(self):
            super().__init__()
            self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
            self.bn1 = nn.BatchNorm2d(64)
            self.maxpool = nn.MaxPool2d(3, 2, 1)
            self.layer1 = nn.Sequential(Block(64, 64), Block(256, 64),
                                        Block(256, 64))

        def forward(self, x):
            x = self.maxpool(torch.relu(self.bn1(self.conv1(x))))
            return self.layer1(x)

    trunk = Trunk()
    with torch.no_grad():
        for m in trunk.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.2)
                m.running_var.uniform_(0.5, 1.5)
                m.weight.normal_(1.0, 0.1)
                m.bias.normal_(0, 0.1)
    return trunk.eval()


def test_deeplabv3_converter():
    """A synthetic torchvision state dict: the port's converter equals
    JAX's leaf for leaf (convs in torch's OIHW), and the port's
    frozen_bn trunk on it reproduces torch's eval forward."""
    trunk = _torch_trunk()
    sd = {"backbone." + k: v.numpy() for k, v in trunk.state_dict().items()}
    got = convert_deeplabv3_state(sd)
    want = _flatten(jax_convert(sd))
    assert set(got) == set(want)
    for k, v in want.items():
        v = v.transpose(3, 2, 0, 1) if v.ndim == 4 else v
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    m = PS.ResNetFeatures(("layer1",), "frozen_bn", device="cpu")
    m.load_state_dict(got)
    x = torch.randn(1, 3, 45, 38)
    with torch.no_grad():
        assert rel_l2(m(x)["layer1"].numpy(), trunk(x).numpy()) <= 1e-5


def _sparse_input(n=300, grid=(16, 14, 6), c=8, seed=0):
    """A sorted SparseTensor of n distinct random voxels (both packages'
    forms) and its numpy parts."""
    rng = np.random.default_rng(seed)
    nx, ny, nz = grid
    cells = rng.choice(nx * ny * nz, n, replace=False)
    ids = np.sort(cells).astype(np.int32)
    ids = np.r_[ids, np.full(20, PSP.SENTINEL, np.int32)]
    feats = rng.normal(size=(len(ids), c)).astype(np.float32)
    feats[n:] = 0
    return (JSP.SparseTensor(jnp.asarray(ids), jnp.asarray(feats), grid),
            PSP.SparseTensor(torch.from_numpy(ids), torch.from_numpy(feats),
                             grid))


@pytest.mark.parametrize("lookup", ["table", "search"])
@pytest.mark.parametrize("use_img", [False, True])
def test_focal_conv_matches_jax(use_img, lookup, monkeypatch):
    jst, pst = _sparse_input()
    spawn = 256
    img = np.random.default_rng(3).normal(size=(12, 10, 8)).astype(
        np.float32)
    proj = np.array([[0.0, 0.61, 0.0, 0.37], [0.0, 0.0, 0.53, 0.21],
                     [0.013, 0.0, 0.0, 1.0]], np.float32)
    extra = (dict(voxel_size=(1.0, 1.0, 1.0), pc_range=(0, 0, 0, 16, 14, 6))
             if use_img else {})
    jm = JF.FocalSparseConv(out_ch=8, spawn=spawn, use_img=use_img)
    jargs = ((jst, jnp.asarray(img), jnp.asarray(proj)) if use_img
             else (jst,))
    tree = random_tree(dict(jax.eval_shape(
        lambda k: jm.init(k, *jargs, **extra), jax.random.PRNGKey(0))))

    def jf(t, im):
        args = (jst, im, jnp.asarray(proj)) if use_img else (jst,)
        out, imp = jm.apply(t, *args, **extra)
        return out, imp, jnp.sum(out.features ** 2)
    (wout, wimp, _), wgrad = jax.jit(lambda t, im: (
        jf(t, im), jax.grad(lambda i: jf(t, i)[2])(im)))(tree,
                                                         jnp.asarray(img))
    if lookup == "search":
        monkeypatch.setattr(PSP, "_DENSE_LOOKUP_MAX_CELLS", 0)
    pm = port_module(PF.FocalSparseConv, tree, 8, 8, spawn=spawn,
                     use_img=use_img)
    pimg = torch.from_numpy(img).requires_grad_(True)
    spawned = []
    pargs = (pimg, torch.from_numpy(proj)) if use_img else ()
    out, imp = pm(pst, *pargs, **extra, spawned=spawned)
    n_spawned = int((spawned[0] != PSP.SENTINEL).sum())
    assert 0 < n_spawned < spawn
    np.testing.assert_array_equal(out.ids.numpy(), np.asarray(wout.ids))
    assert rel_l2(out.features.detach().numpy(),
                  np.asarray(wout.features)) <= FWD_REL_L2
    assert rel_l2(imp.detach().numpy(), np.asarray(wimp)) <= FWD_REL_L2
    if use_img:
        (out.features ** 2).sum().backward()
        assert rel_l2(pimg.grad.numpy(), np.asarray(wgrad)) <= GRAD_REL_L2
        assert float(pimg.grad.abs().sum()) > 0


def test_focal_losses_match_jax():
    rng = np.random.default_rng(6)
    v = 200
    imp = rng.uniform(0, 1, v).astype(np.float32)
    imp[:3] = [0.0, 1.0, 1e-7]
    centers = rng.uniform(-6, 6, (v, 3)).astype(np.float32)
    valid = rng.uniform(size=v) < 0.9
    gt = np.zeros((3, 9), np.float32)
    gt[:, :3] = rng.uniform(-4, 4, (3, 3))
    gt[:, 3:6] = 3.0
    gt[:, 6] = rng.uniform(-np.pi, np.pi, 3)
    gm = np.array([True, True, False])
    want = JF.focal_importance_loss(jnp.asarray(imp), jnp.asarray(centers),
                                    jnp.asarray(valid), jnp.asarray(gt),
                                    jnp.asarray(gm))
    pimp = torch.from_numpy(imp).requires_grad_(True)
    got = PF.focal_importance_loss(pimp, torch.from_numpy(centers),
                                   torch.from_numpy(valid),
                                   torch.from_numpy(gt),
                                   torch.from_numpy(gm))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    got.backward()
    wgrad = jax.grad(lambda i: JF.focal_importance_loss(
        i, jnp.asarray(centers), jnp.asarray(valid), jnp.asarray(gt),
        jnp.asarray(gm)))(jnp.asarray(imp))
    assert rel_l2(pimp.grad.numpy(), np.asarray(wgrad)) <= 1e-6
    aux = [(imp, centers, valid), (imp[::-1].copy(), centers, ~valid)]
    want = JF.focal_aux_loss([tuple(map(jnp.asarray, a)) for a in aux], gt,
                             None, gm)
    got = PF.focal_aux_loss([tuple(map(torch.from_numpy, a)) for a in aux],
                            torch.from_numpy(gt), None, torch.from_numpy(gm))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def _configs():
    """(JAX voxelnext, JAX voxelize, port voxelnext, port voxelize): the
    focal multimodal trunk at tiny widths."""
    out = []
    for cfg in (jax_tiny_config(), tiny_config()):
        out += [dataclasses.replace(cfg.model.voxelnext, focal=True,
                                    focal_use_img=True, focal_spawn=SPAWN),
                dataclasses.replace(cfg.voxelize, **SPARSE_GEOMETRY)]
    return out


class FocalRun:
    """JAX's and the port's focal Voxel R-CNN on one converted tree."""

    def __init__(self):
        self.cfgs = jdet, jvox, pdet, pvox = _configs()
        self.pts = cloud(jvox, N_POINTS)
        rng = np.random.default_rng(7)
        self.image = rng.uniform(size=(*IMAGE_HW, 3)).astype(np.float32)
        self.jm = JaxVoxelRCNN(det_cfg=jdet, vox_cfg=jvox)
        shapes = jax.eval_shape(self.jm.init, jax.random.PRNGKey(0),
                                jnp.asarray(self.pts), jnp.int32(N_POINTS),
                                jnp.asarray(self.image), jnp.asarray(PROJ))
        self.tree = random_tree(dict(shapes))
        self.state = from_jax_detector_params(self.tree, pdet, pvox,
                                              device="cpu",
                                              detector="VoxelRCNN")
        self.pm = self.port_detector()
        self.gts = batch("VoxelRCNN", pvox)

    def port_detector(self):
        pm = build_detector("VoxelRCNN", *self.cfgs[2:], device="cpu")
        pm.load_state_dict(self.state)
        return pm

    def gt(self, sample=0):
        return tuple(self.gts[k][sample]
                     for k in ("gt_boxes", "gt_labels", "gt_mask"))

    def jax_call(self, image):
        """JAX's direct call with `image` and its loss's value and
        gradient, one jit; the ReLU gates logged into `self.log`."""
        boxes, labels, mask = map(jnp.asarray, self.gt())

        def loss_fn(p):
            out = self.jm.apply({"params": p}, jnp.asarray(self.pts),
                                jnp.int32(N_POINTS), image,
                                jnp.asarray(PROJ))
            loss, aux = self.jm.loss(out, boxes, labels, mask)
            return loss, (out, aux)
        self.log, self.won = {}, {}
        with jax_gates(self.log), jax_winners(self.won):
            got = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
                self.tree["params"])
        jax.effects_barrier()
        return got

    def port_call(self, image, gates, winners):
        """The port's direct call with `image` and its loss's gradient,
        JAX's ReLU gates and RoI neighbour winners replayed -> (out, loss,
        aux, gradients, spawned ids by conv, gates and winners the port
        would take otherwise)."""
        pm = self.pm
        pm.zero_grad(set_to_none=True)
        own, own_w, spawned = [0], [0], []
        with port_gates(gates, own), port_winners(winners, own_w):
            out = pm(torch.from_numpy(self.pts), N_POINTS,
                     image=torch.from_numpy(image),
                     proj=torch.from_numpy(PROJ), spawned=spawned)
        loss, aux = pm.loss(out, *map(torch.from_numpy, self.gt()))
        loss.backward()
        grads = {k: p.grad for k, p in pm.named_parameters()}
        pm.zero_grad(set_to_none=True)
        return out, loss, aux, grads, spawned, (own[0], own_w[0])


@pytest.fixture(scope="module")
def run():
    r = FocalRun()
    (r.jloss, (r.jout, r.jaux)), r.jgrads = r.jax_call(
        jnp.asarray(r.image))
    r.gates = [r.log[s][0] for s in sorted(r.log)]
    r.winners = [r.won[s][0] for s in sorted(r.won)]
    (r.pout, r.ploss, r.paux, r.pgrads, r.spawned,
     r.own) = r.port_call(r.image, r.gates, r.winners)
    return r


def _detached(tree):
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_detached(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_detached(v) for v in tree)
    return tree.detach() if isinstance(tree, torch.Tensor) else tree


def test_direct_call_with_image_matches_jax(run):
    seen = compare_outputs(run.jout, _detached(run.pout),
                           skip=("focal_aux",))
    assert {"bev_dense", "proposals", "detections", "cls", "reg"} <= set(seen)
    assert len(run.pout["focal_aux"]) == len(run.jout["focal_aux"]) == 4
    for (pi, pc, pv), (ji, jc, jv) in zip(run.pout["focal_aux"],
                                          run.jout["focal_aux"]):
        assert rel_l2(pi.detach().numpy(), np.asarray(ji)) <= FWD_REL_L2
        np.testing.assert_allclose(pc.numpy(), np.asarray(jc), rtol=0,
                                   atol=1e-5)
        np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    counts = [int((s != PSP.SENTINEL).sum()) for s in run.spawned]
    assert len(counts) == 4 and any(0 < c < SPAWN for c in counts), counts
    # the gates and neighbour winners the port would take otherwise
    # (read: 1 of 3.2M gate entries, 32 of 2.65M winner entries)
    assert run.own[0] <= OWN_GATES and run.own[1] <= OWN_WINNERS, run.own


def test_loss_and_gradients_with_image_match_jax(run):
    np.testing.assert_allclose(float(run.ploss), float(run.jloss),
                               rtol=1e-5)
    for k, v in run.jaux.items():
        np.testing.assert_allclose(float(run.paux[k]), float(v), rtol=1e-5,
                                   err_msg=k)
    assert "loss_box_of_pts" in run.paux
    cfg = run.cfgs
    want = {k: v.numpy() for k, v in from_jax_detector_params(
        {"params": jax.tree.map(np.asarray, run.jgrads)}, cfg[2], cfg[3],
        device="cpu", detector="VoxelRCNN").items()}
    for name, w in want.items():
        g = run.pgrads[name]
        if not w.any():
            assert g is None or not g.any(), name
            continue
        assert rel_l2(g.numpy(), w) <= GRAD_REL_L2, (name, rel_l2(g.numpy(),
                                                                  w))
    semseg = [k for k in want if k.startswith("semseg.")]
    assert semseg and all(float(run.pgrads[k].abs().sum()) > 0
                          for k in semseg if want[k].any())
    assert sum(float(run.pgrads[k].abs().sum()) for k in semseg) > 0


def test_zeroing_the_image_moves_the_outputs(run):
    """The trap: the same call on a zero image differs (the image reaches
    the importance and the conv output)."""
    with torch.no_grad():
        out = run.pm(torch.from_numpy(run.pts), N_POINTS,
                     image=torch.zeros(*IMAGE_HW, 3),
                     proj=torch.from_numpy(PROJ))
    moved = rel_l2(out["bev_dense"].numpy(),
                   run.pout["bev_dense"].detach().numpy())
    assert moved > 1e-3


def test_detect_without_image_matches_jax(run):
    """`detect(points, num_points)` runs the LiDAR-only focal trunk, as
    JAX's does: no image stage, three focal convs."""
    want = jax.jit(run.jm.apply)(run.tree, jnp.asarray(run.pts),
                                 jnp.int32(N_POINTS))
    pts = torch.from_numpy(run.pts)
    with torch.no_grad():
        out = run.pm(pts, N_POINTS)
    assert [n for n, _ in run.pm.stages()][:2] == ["voxelize", "trunk3d"]
    assert len(out["focal_aux"]) == len(want["focal_aux"]) == 3
    compare_outputs(want, out, skip=("focal_aux",))
    got = run.pm.detect(pts, N_POINTS)
    check_detections(got, want["detections"])


def test_train_steps_without_image_match_jax(run):
    """Three steps at batch 2 of JAX's jit'd `make_detector_train_step`
    (which passes no image) against the port's, ReLU gates replayed:
    the image branch and the multimodal focal conv get no gradient (JAX's
    are exactly zero, the port's None)."""
    jdet, jvox, pdet, pvox = run.cfgs
    b = run.gts
    tx = recording(jax_chain())
    step = jax_train.make_detector_train_step(run.jm, tx, jdet, jvox)
    state = (run.tree, tx.init(run.tree["params"]))
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    j_metrics, log, won, gates, winners = [], {}, {}, [], []
    for i in range(STEPS):
        with (jax_gates(log) if i == 0 else contextlib.nullcontext()), \
                (jax_winners(won) if i == 0 else contextlib.nullcontext()):
            state, m = step(state, jb)
        j_metrics.append({k: float(v) for k, v in m.items()})
        jax.effects_barrier()
        gates.append([log[s][2 * i + j] for j in range(2)
                      for s in sorted(log)])
        winners.append([won[s][2 * i + j] for j in range(2)
                        for s in sorted(won)])
    _, first, least, _ = state[1]

    def port_layout(tree):
        return {k: v.numpy() for k, v in from_jax_detector_params(
            {"params": jax.tree.map(np.asarray, tree)}, pdet, pvox,
            device="cpu", detector="VoxelRCNN").items()}
    pm = run.port_detector()
    ptx = detector_optimizer(1e-3, STEPS)
    pstep = port_train.make_detector_train_step(pm, ptx, pdet, pvox)
    pstate = (pm, ptx.init(dict(pm.named_parameters())))
    p_metrics, own = [], [0]
    for i in range(STEPS):
        with port_gates(gates[i], own), port_winners(winners[i], own):
            pstate, m = pstep(pstate, b)
        p_metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            grads1 = {n: None if p.grad is None else p.grad.numpy().copy()
                      for n, p in pm.named_parameters()}
    image_mods = [n for n in grads1 if n.startswith(
        ("semseg.", "backbone3d.focal_multimodal."))]
    assert image_mods and all(grads1[n] is None for n in image_mods)
    j_first = port_layout(first)
    assert not any(j_first[n].any() for n in image_mods)
    check_train({"jax": (j_metrics, j_first, port_layout(least),
                         port_layout(state[0]["params"])),
                 "port": (p_metrics, grads1,
                          {n: p.detach().numpy()
                           for n, p in pm.named_parameters()}),
                 "start": {k: v.numpy() for k, v in run.state.items()},
                 "own_gates": own[0],
                 "relu_entries": sum(int(g.size) for g in gates[0])},
                terms=("cls_loss", "box_loss", "dir_loss", "roi_cls_loss",
                       "roi_reg_loss", "loss_box_of_pts"))


def test_focal_centres_keep_jax_axis_order(run):
    """Reference trait: the focal convs' centres (and the projection) take
    delinearize's (z, y, x) times the voxel size (x, y, z) plus the
    origin, as JAX's `centers_of` does; the port's equal JAX's, and differ
    from the voxels' metric (x, y, z) centres."""
    _, pc, pv = run.pout["focal_aux"][1]
    vs = np.asarray(SPARSE_GEOMETRY["voxel_size"], np.float32)
    lo = np.asarray(SPARSE_GEOMETRY["point_range"][:3], np.float32)
    pc, pv = pc.numpy()[pv.numpy()], pv.numpy()
    zyx = (pc - lo) / vs
    np.testing.assert_allclose(zyx, np.round(zyx), atol=1e-4)
    assert not np.allclose(zyx[:, 0], zyx[:, 2])
