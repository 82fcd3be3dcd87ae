"""The port's PV-RCNN and PV-RCNN++ against the JAX package's on the CPU
(tests/torch_two_stage_util.py: one seeded tree, tiny_config()'s widths
on a 72 x 72 x 16 grid).

- Forward: every entry of JAX's output dict (keypoints, i.e. the FPS
  picks, equal; RPN, keypoint features and RoI outputs within FWD_REL_L2
  relative L2; proposals and detections as torch_zoo_util holds them:
  count and labels equal, boxes and scores within BOX_ABS); `detect`.
- The loss (`two_stage_loss`) and its terms on each package's own
  forward within LOSS_REL.
- One PV-RCNN train step at batch 2 against JAX's jit'd
  `make_detector_train_step`: the metrics within LOSS_REL, each
  parameter group's gradient within GRAD_REL_L2. The proposals are
  constants to the second stage in both (JAX's stop_gradient, the
  port's detach).
- PV-RCNN++'s keypoints come from the points near a live proposal only.
"""
import numpy as np
import pytest
import torch

from lvv_tpu_torch.models import pv_rcnn_pp as P
from torch_two_stage_util import Run, compare_outputs, losses
from torch_zoo_util import GRAD_REL_L2, LOSS_REL, group_rel_l2, train_step
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.fast

FAMILIES = ["PVRCNN", "PVRCNNPlusPlus"]
TERMS = {"cls_loss", "box_loss", "dir_loss", "roi_cls_loss", "roi_reg_loss",
         "rpn_loss"}


@pytest.fixture(scope="module")
def runs():
    made = {}

    def get(family):
        if family not in made:
            r = Run(family)
            r.jax_out = r.jax_forward()
            r.port_out = r.port_forward()
            made[family] = r
        return made[family]
    return get


@pytest.mark.parametrize("family", FAMILIES)
def test_forward_and_detect_match_jax(runs, family):
    r = runs(family)
    (jout, jdets), (pout, pdets) = r.jax_out, r.port_out
    # the converter filled every parameter of the family from JAX's tree
    assert set(r.state) == set(r.pm.state_dict())
    seen = compare_outputs(jout, pout)
    assert {"keypoints", "keypoint_features", "rois", "detections",
            "proposals", "cls", "reg"} <= set(seen)
    assert pout["keypoints"].shape == (512, 3)
    compare_outputs({"detect": jdets}, {"detect": pdets})
    assert int(pdets.count) == 16


@pytest.mark.parametrize("family", FAMILIES)
def test_loss_matches_jax(runs, family):
    r = runs(family)
    (want, want_aux), (got, got_aux) = losses(r, r.jax_out[0],
                                              r.port_out[0])
    assert set(got_aux) == set(want_aux) == TERMS
    np.testing.assert_allclose(got, want, rtol=LOSS_REL)
    for k, v in want_aux.items():
        np.testing.assert_allclose(got_aux[k], v, rtol=LOSS_REL, err_msg=k)
    assert got_aux["roi_cls_loss"] > 0


def test_pvrcnn_train_step_matches_jax(runs):
    jm, jg, pm, pg = train_step(runs("PVRCNN"))
    assert set(pm) == set(jm) == TERMS | {"loss", "grad_norm"}
    for k in TERMS | {"loss"}:
        np.testing.assert_allclose(pm[k], jm[k], rtol=LOSS_REL, err_msg=k)
    np.testing.assert_allclose(pm["grad_norm"], jm["grad_norm"],
                               rtol=GRAD_REL_L2)
    groups = group_rel_l2(jg, pg)
    assert set(groups) == {"backbone3d", "rpn", "vsa", "roi_head"}
    assert max(groups.values()) <= GRAD_REL_L2, groups
    # no RoI reaches the 0.55 foreground IoU on random gts: the RoI box
    # branch alone has no gradient, in both packages
    zero = {k for k, g in pg.items() if g is None or not g.abs().sum()}
    assert zero == {k for k, w in jg.items() if not np.abs(w).sum()}
    assert zero <= {"roi_head.reg.kernel", "roi_head.reg.bias"}


def test_pvrcnn_pp_keypoints_near_proposals(runs):
    """Every PV-RCNN++ keypoint lies within a live proposal's reach; the
    port's mask equals a direct count."""
    r = runs("PVRCNNPlusPlus")
    out = r.port_out[0]
    p = out["proposals"]
    mask = P.proposal_centric_mask(out["points"], out["valid_points"],
                                   p.boxes[:, :7], p.scores)
    assert 0 < int(mask.sum()) < r.n
    assert torch.equal(out["kp_mask"], mask)
    kp_rows = [int(np.flatnonzero((r.pts[:, :3] == k.numpy()).all(1))[0])
               for k in out["keypoints"][:32]]
    assert mask[kp_rows].all()
