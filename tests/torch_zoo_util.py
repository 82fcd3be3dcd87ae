"""Shared set-up of the dense-BEV detector parity tests
(tests/test_torch_bev_dense.py, tests/test_torch_detector_zoo.py): one
seeded JAX parameter tree per family (every leaf random, scaled like a
trained one; the heatmap and class biases raised so that the decodes keep
boxes), run through JAX's detector (XLA on the CPU) and, converted by
`from_jax_detector_params`, through the port's, on one seeded cloud; and
one train step of each (JAX's jit'd `make_detector_train_step` and the
port's, a recording optimizer on each side) at batch 2.

Geometry: PointPillars on tiny_config()'s 16 x 16 pillars (an even grid
through the dense trunk); the sparse-trunk families (CenterPoint, SECOND,
TransFusion) on a 72 x 72 x 16 grid at 0.5 m, whose stride-8 BEV is 9 x 9
(an odd grid: the trunk's strided conv pads (1, 1), the upsampled level
is cropped from 10 to 9). TransFusion takes 16 queries, as many as
tiny_config()'s `nms_post_max`, where JAX's loss runs (ROADMAP.md queue 3).
"""
from __future__ import annotations

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from lvv_tpu.config import tiny_config as jax_tiny_config
from lvv_tpu.models.anchor_head import decode_anchor_preds
from lvv_tpu.models.centerpoint import CenterPointDetector as JaxCenterPoint
from lvv_tpu.models.pointpillars import PointPillarsDetector as JaxPillars
from lvv_tpu.models.pointpillars import decode_dense
from lvv_tpu.models.second import SECONDDetector as JaxSECOND
from lvv_tpu.models.transfusion import TransFusionDetector as JaxTransFusion
from lvv_tpu.models.transfusion import decode_queries
from lvv_tpu.train import detector as jax_train
from lvv_tpu_torch import tiny_config
from lvv_tpu_torch.convert import from_jax_detector_params
from lvv_tpu_torch.models.registry import build_detector
from lvv_tpu_torch.train import detector as port_train

FWD_REL_L2 = 1e-5           # fp32 forward: BEV and head outputs
BOX_ABS = 1e-4              # detections' boxes and scores
LOSS_REL = 1e-5             # a train step's loss and its terms
GRAD_REL_L2 = 1e-4          # a parameter group's gradient
QUERIES = 16
SPARSE_GEOMETRY = dict(point_range=(-18.0, -18.0, -4.0, 18.0, 18.0, 4.0),
                       voxel_size=(0.5, 0.5, 0.5), max_points=4000,
                       max_voxels=2500)
FAMILIES = {"PointPillars": JaxPillars, "CenterPoint": JaxCenterPoint,
            "SECOND": JaxSECOND, "TransFusion": JaxTransFusion}
# biases raised so that scores pass score_thresh and the decodes keep boxes
RAISED = {("head", "hm", "bias"), ("head", "cls", "bias")}


def configs(family: str):
    """(JAX voxelnext, JAX voxelize, port voxelnext, port voxelize)."""
    vox = {} if family == "PointPillars" else SPARSE_GEOMETRY
    out = []
    for cfg in (jax_tiny_config(), tiny_config()):
        out += [cfg.model.voxelnext, dataclasses.replace(cfg.voxelize,
                                                         **vox)]
    return out


def tiny_overrides() -> list:
    """The train CLI's --set pairs that cut a preset to tiny_config()'s
    sizes."""
    cfg = tiny_config()
    vox = dataclasses.asdict(cfg.voxelize)
    det = dataclasses.asdict(cfg.model.voxelnext)
    pairs = [f"voxelize.{k}={json.dumps(v)}" for k, v in vox.items()]
    pairs += [f"model.voxelnext.{k}={json.dumps(det[k])}"
              for k in ("channels", "out_channels", "num_classes",
                        "class_names", "nms_pre_max", "nms_post_max")]
    return [x for p in pairs for x in ("--set", p)]


def jax_detector(family: str, jdet, jvox):
    extra = {"num_queries": QUERIES} if family == "TransFusion" else {}
    return FAMILIES[family](det_cfg=jdet, vox_cfg=jvox, **extra)


def port_detector(family: str, pdet, pvox):
    if family == "TransFusion":
        from lvv_tpu_torch.models.transfusion import TransFusionDetector
        return TransFusionDetector(pdet, pvox, device="cpu",
                                   num_queries=QUERIES)
    return build_detector(family, pdet, pvox, device="cpu")


def cloud(vox_cfg, n: int, seed: int = 0) -> np.ndarray:
    """Seeded clusters over the range, zero-padded to max_points."""
    rng = np.random.default_rng(seed)
    lo = np.array(vox_cfg.point_range[:3])
    hi = np.array(vox_cfg.point_range[3:])
    centres = rng.uniform(lo, hi, (n // 6, 3))
    pts = centres[rng.integers(0, len(centres), n)] + rng.normal(
        0, 0.4, (n, 3))
    out = np.zeros((vox_cfg.max_points, 4), np.float32)
    out[:n, :3] = pts
    out[:n, 3] = rng.uniform(0, 1, n)
    return out


def n_points(family: str) -> int:
    return 1500 if family == "PointPillars" else 3000


def random_tree(shapes, seed: int = 1):
    """Random leaves for a detector's variables, scaled like trained
    ones."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        keys = tuple(p.key for p in path)
        name = keys[-1]
        x = rng.standard_normal(s.shape).astype(np.float32)
        if name == "kernel":
            return x / np.sqrt(np.prod(s.shape[:-1]))
        if name in ("scale", "ln_scale"):
            return 1 + 0.1 * x
        if keys[-3:] in RAISED or keys[-2:] == ("cls", "bias"):
            return 1.0 + 0.1 * x
        return 0.1 * x
    return jax.tree_util.tree_map_with_path(leaf, shapes)


class Run:
    """One family's JAX run and port run on one converted tree."""

    def __init__(self, family: str):
        self.family = family
        jdet, jvox, pdet, pvox = configs(family)
        self.cfgs = (jdet, jvox, pdet, pvox)
        n = n_points(family)
        self.pts, self.n = cloud(jvox, n), n
        self.jm = jax_detector(family, jdet, jvox)
        shapes = jax.eval_shape(self.jm.init, jax.random.PRNGKey(0),
                                jnp.asarray(self.pts), jnp.int32(n))
        self.tree = random_tree(dict(shapes))
        self.state = from_jax_detector_params(self.tree, pdet, pvox,
                                              device="cpu", detector=family)
        self.pm = port_detector(family, pdet, pvox)
        self.pm.load_state_dict(self.state)

    def jax_forward(self):
        """JAX's forward (with its intermediates) and its detections, the
        family's decode on that forward as its `detect` runs it, in one
        jit (one compile in place of an eager dispatch per op)."""
        jdet, jvox = self.cfgs[:2]

        def run(tree, pts, n):
            out, inter = self.jm.apply(tree, pts, n,
                                       capture_intermediates=True,
                                       mutable=["intermediates"])
            preds = out["preds"]
            if self.family == "SECOND":
                dets = decode_anchor_preds(preds, out["anchors"],
                                           out["anchor_cls"], jdet)
            elif self.family == "TransFusion":
                dets = decode_queries(preds, jdet, jvox,
                                      jdet.spatial_stride)
            else:
                dets = decode_dense(preds, jdet, jvox, 1 if self.family ==
                                    "PointPillars" else jdet.spatial_stride)
            return out, inter["intermediates"], dets
        return jax.jit(run)(self.tree, jnp.asarray(self.pts),
                            jnp.int32(self.n))

    def port_forward(self, trace=None):
        with torch.no_grad():
            out = self.pm(torch.from_numpy(self.pts), self.n, trace=trace)
        return out, self.pm.detect(torch.from_numpy(self.pts), self.n)


def rel_l2(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def check_detections(got, want) -> int:
    """Count and labels equal, boxes and scores within BOX_ABS."""
    count = int(want.count)
    assert int(got.count) == count
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_allclose(got.boxes.numpy()[:count],
                               np.asarray(want.boxes)[:count], rtol=0,
                               atol=BOX_ABS)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=0, atol=BOX_ABS)
    return count


# ------------------------------------------------------------ train step

def batch(family: str, pvox) -> dict:
    """Two clouds with 8 gts each (two masked in the second), gts around
    the clouds' clusters."""
    rng = np.random.default_rng(5)
    n = n_points(family)
    pts = np.stack([cloud(pvox, n, seed=s) for s in (0, 1)])
    lo, hi = pvox.point_range[0] * 0.7, pvox.point_range[3] * 0.7
    boxes = np.zeros((2, 8, 9), np.float32)
    boxes[..., :2] = rng.uniform(lo, hi, (2, 8, 2))
    boxes[..., 2] = -1.0
    boxes[..., 3:6] = rng.uniform(1.0, 4.0, (2, 8, 3))
    boxes[..., 6] = rng.uniform(-np.pi, np.pi, (2, 8))
    mask = np.ones((2, 8), bool)
    mask[1, 6:] = False
    return {"points": pts, "num_points": np.array([n, n - 300], np.int32),
            "gt_boxes": boxes,
            "gt_labels": rng.integers(0, 3, (2, 8)).astype(np.int32),
            "gt_mask": mask}


def _jax_recording():
    """An optax transformation that keeps the gradients it is given and
    moves nothing."""
    def init(p):
        return jax.tree.map(jnp.zeros_like, p)

    def update(g, state, p=None):
        return jax.tree.map(jnp.zeros_like, g), g
    return optax.GradientTransformation(init, update)


class _PortRecording:
    """The port's optimizer interface (`init`, `update` -> the global
    norm), keeping the gradients and moving nothing."""

    def init(self, params):
        return {}

    def update(self, grads, state, params):
        self.grads = {k: None if g is None else g.clone()
                      for k, g in grads.items()}
        return torch.sqrt(sum(g.double().square().sum()
                              for g in grads.values() if g is not None))


def train_step(run: Run):
    """One step at batch 2 on each side -> (JAX metrics, JAX gradients,
    port metrics, port gradients), by the port's parameter names and in
    its layouts."""
    jdet, jvox, pdet, pvox = run.cfgs
    b = batch(run.family, pvox)
    tx = _jax_recording()
    step = jax_train.make_detector_train_step(run.jm, tx, jdet, jvox)
    state = (run.tree, tx.init(run.tree["params"]))
    (_, grads), metrics = step(state, {k: jnp.asarray(v)
                                       for k, v in b.items()})
    pm = port_detector(run.family, pdet, pvox)
    pm.load_state_dict(run.state)
    rec = _PortRecording()
    pstep = port_train.make_detector_train_step(pm, rec, pdet, pvox)
    _, pmetrics = pstep((pm, rec.init(None)), b)
    jgrads = from_jax_detector_params(
        {"params": jax.tree.map(np.asarray, grads)}, pdet, pvox,
        device="cpu", detector=run.family)      # in the port's layouts
    return ({k: float(v) for k, v in metrics.items()},
            {k: v.numpy() for k, v in jgrads.items()},
            {k: float(v) for k, v in pmetrics.items()}, rec.grads)


def group_rel_l2(want: dict, got: dict) -> dict:
    """Relative L2 of each top-level group's gradient (vfe, backbone,
    backbone3d, backbone2d, head)."""
    groups = {}
    for name, w in want.items():
        g = got[name]
        g = np.zeros_like(w) if g is None else g.numpy()
        num, den = groups.get(name.split(".")[0], (0.0, 0.0))
        groups[name.split(".")[0]] = (
            num + float(np.sum((g.astype(np.float64) - w) ** 2)),
            den + float(np.sum(np.asarray(w, np.float64) ** 2)))
    return {k: np.sqrt(n) / max(np.sqrt(d), 1e-30)
            for k, (n, d) in groups.items()}
