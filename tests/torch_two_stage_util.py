"""Shared set-up of the two-stage detector parity tests
(tests/test_torch_two_stage_*.py): one seeded JAX parameter tree per
family (torch_zoo_util's `random_tree`: every leaf random, scaled like a
trained one, each class bias raised so that the decodes keep boxes), run
through JAX's detector (XLA on the CPU, one jit of the forward)
and, converted by `from_jax_detector_params`, through the port's, on one
seeded cloud; each family's loss on both packages' own outputs; one train
step of PV-RCNN and PointRCNN at batch 2 (torch_zoo_util's `train_step`:
JAX's jit'd `make_detector_train_step` and the port's).

Geometry: torch_zoo_util's 72 x 72 x 16 grid at 0.5 m (its stride-8 BEV
9 x 9 x 2), tiny_config()'s widths (channels 8 / 16 / 16 / 32, 64 boxes
before NMS, 16 after), 3,000 points of seeded clusters in 4,000 rows.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from lvv_tpu.config import tiny_config as jax_tiny_config
from lvv_tpu.models.part_a2 import PartA2Detector as JaxPartA2
from lvv_tpu.models.point_rcnn import PointRCNNDetector as JaxPointRCNN
from lvv_tpu.models.pv_rcnn import PVRCNNDetector as JaxPVRCNN
from lvv_tpu.models.pv_rcnn_pp import PVRCNNPlusPlusDetector as JaxPVRCNNPP
from lvv_tpu.models.second_iou import SECONDNetIoUDetector as JaxSECONDIoU
from lvv_tpu.models.second_iou import cal_scores_by_npoints
from lvv_tpu.models.voxel_rcnn import VoxelRCNNDetector as JaxVoxelRCNN
from lvv_tpu_torch import tiny_config
from lvv_tpu_torch.convert import from_jax_detector_params
from lvv_tpu_torch.models.registry import build_detector
from torch_zoo_util import (FWD_REL_L2, SPARSE_GEOMETRY, batch,
                            check_detections, cloud, random_tree, rel_l2)

FAMILIES = {"PVRCNN": JaxPVRCNN, "PVRCNNPlusPlus": JaxPVRCNNPP,
            "PartA2": JaxPartA2, "VoxelRCNN": JaxVoxelRCNN,
            "SECONDNetIoU": JaxSECONDIoU, "PointRCNN": JaxPointRCNN}
N_POINTS = 3000


def configs():
    """(JAX voxelnext, JAX voxelize, port voxelnext, port voxelize)."""
    out = []
    for cfg in (jax_tiny_config(), tiny_config()):
        out += [cfg.model.voxelnext,
                dataclasses.replace(cfg.voxelize, **SPARSE_GEOMETRY)]
    return out


def torch_tree(tree):
    """Nested JAX outputs (dicts, NamedTuples, arrays) as torch tensors."""
    if isinstance(tree, dict):
        return {k: torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(torch_tree(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(torch_tree(v) for v in tree)
    return torch.from_numpy(np.array(tree))


class Run:
    """One family's JAX run and port run on one converted tree."""

    def __init__(self, family: str):
        self.family = family
        jdet, jvox, pdet, pvox = configs()
        self.cfgs = (jdet, jvox, pdet, pvox)
        self.pts, self.n = cloud(jvox, N_POINTS), N_POINTS
        self.jm = FAMILIES[family](det_cfg=jdet, vox_cfg=jvox)
        shapes = jax.eval_shape(self.jm.init, jax.random.PRNGKey(0),
                                jnp.asarray(self.pts), jnp.int32(self.n))
        self.tree = random_tree(dict(shapes))
        self.state = from_jax_detector_params(self.tree, pdet, pvox,
                                              device="cpu", detector=family)
        self.pm = build_detector(family, pdet, pvox, device="cpu")
        self.pm.load_state_dict(self.state)

    def jax_forward(self):
        """JAX's forward (one jit) and its `detect`: the forward's
        "detections", or SECOND-IoU's score blend on its outputs (the
        body of its `detect`)."""
        out = jax.jit(self.jm.apply)(self.tree, jnp.asarray(self.pts),
                                     jnp.int32(self.n))
        if "detections" in out:
            return out, out["detections"]
        p = out["proposals"]
        fused = cal_scores_by_npoints(
            p.scores, jax.nn.sigmoid(out["iou_logits"]),
            out["npoints"].astype(jnp.float32))
        return out, p._replace(scores=jnp.where(p.labels >= 0, fused, 0.0))

    def port_forward(self, trace=None):
        with torch.no_grad():
            out = self.pm(torch.from_numpy(self.pts), self.n, trace=trace)
        return out, self.pm.detect(torch.from_numpy(self.pts), self.n)

    def gts(self, sample: int = 0):
        b = batch(self.family, self.cfgs[3])
        return (b["gt_boxes"][sample], b["gt_labels"][sample],
                b["gt_mask"][sample])


def compare_outputs(jax_out, port_out, skip=()) -> list:
    """Every entry of JAX's forward dict against the port's: float arrays
    within FWD_REL_L2 relative L2, integer and bool arrays equal, the
    Detections' boxes within BOX_ABS and their labels equal -> the keys
    compared."""
    seen = []
    for k, v in jax_out.items():
        if k in skip:
            continue
        got = port_out[k]
        if isinstance(v, dict):
            seen += compare_outputs(v, got)
            continue
        if hasattr(v, "_fields"):
            check_detections(got, v)
        elif np.asarray(v).dtype.kind == "f":
            assert rel_l2(got.detach().numpy(), v) <= FWD_REL_L2, k
        else:
            np.testing.assert_array_equal(got.numpy(), np.asarray(v),
                                          err_msg=k)
        seen.append(k)
    return seen


def losses(run: Run, jax_out, port_out, sample: int = 0):
    """(JAX's loss and terms on its forward, the port's on its own), as
    floats; JAX's loss in one jit."""
    boxes, labels, mask = run.gts(sample)
    want = jax.jit(run.jm.loss)(jax_out, jnp.asarray(boxes),
                                jnp.asarray(labels), jnp.asarray(mask))
    got = run.pm.loss(port_out, *map(torch.from_numpy,
                                     (boxes, labels, mask)))
    return ((float(want[0]), {k: float(v) for k, v in want[1].items()}),
            (float(got[0]), {k: float(v) for k, v in got[1].items()}))
