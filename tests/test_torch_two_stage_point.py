"""The port's SECOND-IoU and PointRCNN against the JAX package's on the
CPU (tests/torch_two_stage_util.py), and the two-stage families' registry,
converter and train CLI.

- Forward: every entry of JAX's output dict (SECOND-IoU's point counts
  equal, its IoU logits; PointRCNN's point features and predictions, RoIs
  and RoI outputs within FWD_REL_L2 relative L2; proposals and detections:
  count and labels equal, boxes and scores within BOX_ABS); `detect`
  (SECOND-IoU's score blend by point count).
- Each loss and its terms on each package's own forward within LOSS_REL;
  one PointRCNN train step at batch 2 against JAX's jit'd
  `make_detector_train_step` (metrics within LOSS_REL, each group's
  gradient within GRAD_REL_L2).
- A reference trait, kept and pinned (ROADMAP.md queue 3): SECOND-IoU's
  IoU loss is the mean over every proposal slot, the empty ones too.
- The registry builds all 17 registered names, none left to port
  (`from_jax_detector_params` fills every key of each family: every Run
  of the two-stage files converts a whole tree, and the converter raises
  on a key it leaves unfilled); each KITTI preset's `_detector` names its
  family; the train CLI trains PV-RCNN's and PointRCNN's presets at
  tiny_config()'s sizes and reloads the checkpoint bit-equal, and trains
  the focal Voxel R-CNN preset's LiDAR-only focal trunk.
"""
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lvv_tpu_torch import tiny_config
from lvv_tpu_torch.convert import from_jax_detector_params
from lvv_tpu_torch.models.registry import DETECTORS, PORTED, build_detector
from lvv_tpu_torch.tools import train_detector as cli
from lvv_tpu_torch.train.checkpoints import CheckpointManager
from torch_two_stage_util import (FAMILIES, Run, compare_outputs, losses,
                                  torch_tree)
from torch_zoo_util import (GRAD_REL_L2, LOSS_REL, group_rel_l2,
                            tiny_overrides, train_step)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.fast

REPO = pathlib.Path(__file__).resolve().parents[1]
TERMS = {"SECONDNetIoU": {"cls_loss", "box_loss", "dir_loss", "iou_loss"},
         "PointRCNN": {"point_cls_loss", "point_reg_loss", "roi_cls_loss",
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


@pytest.mark.parametrize("family", ["SECONDNetIoU", "PointRCNN"])
def test_forward_and_detect_match_jax(runs, family):
    r = runs(family)
    (jout, jdets), (pout, pdets) = r.jax_out, r.port_out
    # the converter filled every parameter of the family from JAX's tree
    assert set(r.state) == set(r.pm.state_dict())
    seen = compare_outputs(jout, pout)
    want = ({"npoints", "iou_logits", "proposals", "bev_dense"}
            if family == "SECONDNetIoU" else
            {"point_features", "rois", "detections", "cls", "box", "reg"})
    assert want <= set(seen)
    compare_outputs({"detect": jdets}, {"detect": pdets})
    assert int(pdets.count) > 8


@pytest.mark.parametrize("family", ["SECONDNetIoU", "PointRCNN"])
def test_loss_matches_jax(runs, family):
    r = runs(family)
    (want, want_aux), (got, got_aux) = losses(r, r.jax_out[0],
                                              r.port_out[0])
    assert set(got_aux) == set(want_aux) == TERMS[family]
    np.testing.assert_allclose(got, want, rtol=LOSS_REL)
    for k, v in want_aux.items():
        np.testing.assert_allclose(got_aux[k], v, rtol=LOSS_REL, err_msg=k)


def test_pointrcnn_train_step_matches_jax(runs):
    jm, jg, pm, pg = train_step(runs("PointRCNN"))
    assert set(pm) == set(jm) == TERMS["PointRCNN"] | {"loss", "grad_norm"}
    for k in TERMS["PointRCNN"] | {"loss"}:
        np.testing.assert_allclose(pm[k], jm[k], rtol=LOSS_REL, err_msg=k)
    np.testing.assert_allclose(pm["grad_norm"], jm["grad_norm"],
                               rtol=GRAD_REL_L2)
    groups = group_rel_l2(jg, pg)
    assert set(groups) == {"backbone", "point_head", "roi_head"}
    assert max(groups.values()) <= GRAD_REL_L2, groups


def test_second_iou_loss_averages_every_slot(runs):
    """With 6 of 16 proposal slots empty (labels -1), the IoU loss is the
    mean BCE over all 16, in both packages."""
    r = runs("SECONDNetIoU")
    jout = dict(r.jax_out[0])
    p = jout["proposals"]
    labels = jnp.where(jnp.arange(16) < 10, p.labels, -1)
    jout["proposals"] = p._replace(labels=labels, count=jnp.int32(10))
    pout = torch_tree(jout)
    (_, want), (_, got) = losses(r, jout, pout)
    np.testing.assert_allclose(got["iou_loss"], want["iou_loss"],
                               rtol=LOSS_REL)
    from lvv_tpu_torch.ops.boxes import iou_3d
    boxes, _, mask = map(torch.from_numpy, r.gts())
    best = torch.where(mask[None], iou_3d(pout["proposals"].boxes[:, :7],
                                          boxes[:, :7]), 0.0).amax(1)
    logit = pout["iou_logits"]
    bce = (logit.clamp_min(0) - logit * best
           + torch.log1p(torch.exp(-logit.abs())))
    assert got["iou_loss"] == pytest.approx(float(bce.mean()), rel=1e-6)
    assert got["iou_loss"] != pytest.approx(float(bce[:10].mean()),
                                            rel=1e-3)


def test_registry_builds_the_ported_families():
    assert len(PORTED) == len(DETECTORS) == 17
    assert set(FAMILIES) <= set(PORTED)
    assert sorted(set(DETECTORS) - set(PORTED)) == []
    cfg = tiny_config()
    for name in (*FAMILIES, "MPPNet", "MPPNetE2E"):
        det = build_detector(name, cfg.model.voxelnext, cfg.voxelize,
                             device="cpu")
        assert type(det).__name__ == PORTED[name][1] and not det.training
        assert all(p.requires_grad for p in det.parameters())


KITTI_PRESETS = {"kitti_pv_rcnn": "PVRCNN",
                 "kitti_pv_rcnn_plusplus": "PVRCNNPlusPlus",
                 "kitti_parta2": "PartA2",
                 "kitti_voxel_rcnn_car": "VoxelRCNN",
                 "kitti_second_iou": "SECONDNetIoU",
                 "kitti_pointrcnn": "PointRCNN"}


@pytest.mark.parametrize("preset", sorted(KITTI_PRESETS))
def test_cli_takes_the_kitti_presets_family(preset):
    """Each KITTI preset's `_detector` key names the family the CLI
    builds (at the preset's full width, on the meta device)."""
    from lvv_tpu_torch import config as C
    path = REPO / "configs" / f"{preset}.json"
    family = C.load_file(path)["_detector"]
    assert family == KITTI_PRESETS[preset]
    cfg = C.load(C.VQAConfig, path)
    det = build_detector(family, cfg.model.voxelnext, cfg.voxelize,
                         device="meta")
    assert type(det).__name__ == PORTED[family][1]


@pytest.mark.parametrize("preset,family", [
    ("kitti_pv_rcnn", "PVRCNN"), ("kitti_pointrcnn", "PointRCNN")])
def test_cli_trains_the_kitti_presets_family(preset, family, tmp_path):
    argv = ["--config", str(REPO / "configs" / f"{preset}.json"),
            "--synthetic", "--steps", "2", "--save-every", "1", "--out",
            str(tmp_path), "--device", "cpu", *tiny_overrides()]
    det, metrics = cli.main(argv)
    assert type(det).__name__ == PORTED[family][1]
    assert np.isfinite(metrics["loss"]) and metrics["grad_norm"] > 0
    fresh = build_detector(family, det.det_cfg, det.vox_cfg, device="cpu",
                           seed=7)
    CheckpointManager(tmp_path / "checkpoints").restore("step_2", fresh)
    for k, v in det.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    assert (tmp_path / "checkpoints" / "step_1").is_dir()


def test_cli_exits_on_the_focal_voxel_rcnn_preset(tmp_path, capsys):
    """The CLI no longer exits on the focal preset: it trains the
    LiDAR-only focal trunk (the step passes no image, as JAX's does), its
    importance loss in the log, the image branch without a gradient."""
    det, metrics = cli.main(
        ["--config", str(REPO / "configs" /
                         "kitti_voxel_rcnn_car_focal_multimodal.json"),
         "--synthetic", "--steps", "2", "--out", str(tmp_path), "--device",
         "cpu", *tiny_overrides()])
    assert det.focal and hasattr(det, "semseg")
    assert "loss_box_of_pts" in capsys.readouterr().out
    assert np.isfinite(metrics["loss_box_of_pts"])
    assert all(p.grad is None for p in det.semseg.parameters())
