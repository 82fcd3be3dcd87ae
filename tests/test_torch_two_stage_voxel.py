"""The port's Part-A² and Voxel R-CNN against the JAX package's on the CPU
(tests/torch_two_stage_util.py: one seeded tree, tiny_config()'s widths
on a 72 x 72 x 16 grid).

- Forward: every entry of JAX's output dict (Part-A²'s UNet features,
  voxel centres and point-part predictions; both families' BEV, RPN and
  RoI outputs within FWD_REL_L2 relative L2; proposals and detections:
  count and labels equal, boxes and scores within BOX_ABS); `detect`.
- Each loss and its terms on each package's own forward within LOSS_REL.
- Reference traits, kept and pinned (ROADMAP.md queue 3): Part-A²'s loss
  is the RPN's and the point-part head's only, so its RoI head gets no
  gradient; Voxel R-CNN's RoI loss reaches the RPN's box branch through
  the proposals, which JAX does not stop (PV-RCNN does).
- A focal Voxel R-CNN config builds the focal trunk (its image branch
  only with `focal_use_img`) and detects (tests/test_torch_focal.py holds
  it against JAX).
"""
import dataclasses

import numpy as np
import pytest
import torch

from lvv_tpu_torch.models.registry import build_detector
from torch_two_stage_util import Run, compare_outputs, losses
from torch_zoo_util import LOSS_REL
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.fast

FAMILIES = ["PartA2", "VoxelRCNN"]
TERMS = {"PartA2": {"cls_loss", "box_loss", "dir_loss", "seg_loss",
                    "part_loss"},
         "VoxelRCNN": {"cls_loss", "box_loss", "dir_loss", "roi_cls_loss",
                       "roi_reg_loss"}}


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
    seen = compare_outputs(jout, pout, skip=("focal_aux",))
    assert {"bev_dense", "proposals", "detections", "cls", "reg"} <= set(
        seen)
    if family == "PartA2":
        assert {"centers", "centers_valid", "point_feats", "seg",
                "part"} <= set(seen)
    compare_outputs({"detect": jdets}, {"detect": pdets})
    assert int(pdets.count) == 16


@pytest.mark.parametrize("family", FAMILIES)
def test_loss_matches_jax(runs, family):
    r = runs(family)
    (want, want_aux), (got, got_aux) = losses(r, r.jax_out[0],
                                              r.port_out[0])
    assert set(got_aux) == set(want_aux) == TERMS[family]
    np.testing.assert_allclose(got, want, rtol=LOSS_REL)
    for k, v in want_aux.items():
        np.testing.assert_allclose(got_aux[k], v, rtol=LOSS_REL, err_msg=k)


def _grads(r):
    """The port's gradient of its loss at one sample, in train mode."""
    det = r.pm
    det.zero_grad(set_to_none=True)
    det.train()
    try:
        out = det(torch.from_numpy(r.pts), r.n)
        loss, _ = det.loss(out, *map(torch.from_numpy, r.gts()))
        loss.backward()
    finally:
        det.eval()
    return {k: p.grad for k, p in det.named_parameters()}


def test_part_a2_roi_head_gets_no_gradient(runs):
    """JAX's PartA2Detector.loss sums the RPN and point-part losses only
    (part_a2.py:290-299): its RoI head is trained by nothing."""
    g = _grads(runs("PartA2"))
    roi = {k for k in g if k.startswith("roi_head.")}
    assert roi and all(g[k] is None for k in roi)
    assert all(g[k] is not None for k in g if k.startswith(("unet.",
                                                           "point_head.")))


def test_voxel_rcnn_roi_loss_reaches_the_rpn_box_branch(runs):
    """The RoI loss alone: its gradient reaches rpn.box through the
    proposals' boxes (the head's lattice and canonical targets), as JAX's
    does, where PV-RCNN stops it."""
    r = runs("VoxelRCNN")
    det = r.pm
    det.zero_grad(set_to_none=True)
    from lvv_tpu_torch.models.roi_head import proposal_targets, roi_head_loss
    out = det(torch.from_numpy(r.pts), r.n)
    boxes, _, mask = map(torch.from_numpy, r.gts())
    tgt = proposal_targets(out["proposals"].boxes[:, :7], boxes, mask)
    roi_head_loss(out["roi_preds"], tgt)[0].backward()
    assert det.rpn.box.kernel.grad is not None
    assert float(det.rpn.box.kernel.grad.abs().sum()) > 0
    det.zero_grad(set_to_none=True)


def test_focal_voxel_rcnn_raises():
    """A focal config no longer raises: it builds the focal trunk (no
    image branch without `focal_use_img`; tests/test_torch_focal.py holds
    it against JAX)."""
    from lvv_tpu_torch import tiny_config
    from lvv_tpu_torch.models.focal_conv import (FocalMultiScaleBackbone3D,
                                                 FocalSparseConv)
    cfg = tiny_config()
    det = build_detector("VoxelRCNN", dataclasses.replace(
        cfg.model.voxelnext, focal=True), cfg.voxelize, device="cpu")
    assert isinstance(det.backbone3d, FocalMultiScaleBackbone3D)
    assert not hasattr(det, "semseg")
    assert not hasattr(det.backbone3d, "focal_multimodal")
    assert sum(isinstance(m, FocalSparseConv) for m in det.modules()) == 3
    assert not det.training
