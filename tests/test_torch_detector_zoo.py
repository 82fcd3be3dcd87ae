"""The port's SECOND and TransFusion, their losses and matchers, and the
zoo's registry and train CLI, against the JAX package's on the CPU.

- SECOND and TransFusion (16 queries) on `torch_zoo_util`'s 72 x 72 x 16
  grid (a 9 x 9 BEV): forward (sparse stage ids equal, BEV and head
  outputs), detect, and one train step at batch 2 (JAX's jit'd step).
- The losses on JAX's own predictions: `transfusion_loss` under both
  matchers, `SECONDDetector.loss` and `dense_center_loss`, each through
  `detector_loss`'s dispatch; the matchers alone, on ties and on inf /
  NaN costs.
- Two traits of JAX's `transfusion_loss` (ROADMAP.md queue 3): with more
  queries than `nms_post_max` (every preset: 200 > 83) its shapes do not
  broadcast and it raises, where the port's loss decodes every query (what
  JAX computes once `nms_post_max` covers them); and its class loss takes
  the logits in query order beside a match made in score order.
- JAX's CenterPoint trunk takes LayerNorm whatever the config's norm: a
  "bn" config builds the same tree in both packages.
- The train CLI trains the family of a preset's `_detector` key at
  tiny_config()'s sizes, and its checkpoint reloads bit-equal.

Tolerances as in torch_zoo_util (losses 1e-5 relative).
"""
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lvv_tpu.models import transfusion as JT
from lvv_tpu.train.detector import detector_loss as jax_detector_loss
from lvv_tpu_torch import tiny_config
from lvv_tpu_torch.models import transfusion as PT
from lvv_tpu_torch.models.registry import build_detector
from lvv_tpu_torch.tools import train_detector as cli
from lvv_tpu_torch.train.checkpoints import CheckpointManager
from lvv_tpu_torch.train.detector import detector_loss
from torch_zoo_util import (FWD_REL_L2, GRAD_REL_L2, LOSS_REL, Run, batch,
                            check_detections, group_rel_l2, rel_l2,
                            tiny_overrides, train_step)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.fast

REPO = pathlib.Path(__file__).resolve().parents[1]
FAMILIES = ["SECOND", "TransFusion"]
TERMS = {"SECOND": {"cls_loss", "box_loss", "dir_loss"},
         "TransFusion": {"tf_cls_loss", "tf_reg_loss"},
         "PointPillars": {"hm_loss", "reg_loss"}}


class _DenseMaps:
    """PointPillars' stand-in for the dense centre loss: seeded head maps
    on tiny_config()'s 16 x 16 pillar grid (hm biased to -2) and both
    packages' detector objects, whose type alone the dispatch reads."""

    def __init__(self):
        from torch_zoo_util import configs, jax_detector
        self.cfgs = configs("PointPillars")
        jdet, jvox, pdet, pvox = self.cfgs
        rng = np.random.default_rng(11)
        maps = {k: rng.standard_normal((c, 16, 16)).astype(np.float32)
                for k, c in (("hm", jdet.num_classes), ("center", 2),
                             ("center_z", 1), ("dim", 3), ("rot", 2))}
        maps["hm"] -= 2.0
        self.jax_out = ({"preds": {k: jnp.asarray(v)
                                   for k, v in maps.items()}},)
        self.jm = jax_detector("PointPillars", jdet, jvox)
        self.pm = build_detector("PointPillars", pdet, pvox, device="meta")


@pytest.fixture(scope="module")
def runs():
    made = {}

    def get(family):
        if family not in made and family == "PointPillars":
            made[family] = _DenseMaps()
        elif family not in made:
            r = Run(family)
            r.jax_out = r.jax_forward()
            made[family] = r
        return made[family]
    return get


def _torch_tree(tree):
    return {k: (_torch_tree(v) if isinstance(v, dict)
                else torch.from_numpy(np.array(v)))
            for k, v in tree.items()}


@pytest.mark.parametrize("family", FAMILIES)
def test_forward_and_detect_match_jax(runs, family):
    r = runs(family)
    out, inter, dets = r.jax_out
    trace = []
    got, got_dets = r.port_forward(trace)
    assert got["bev_dense"].shape[1:] == (9, 9)
    assert rel_l2(got["bev_dense"].numpy(), out["bev_dense"]) <= FWD_REL_L2
    bb = inter["backbone3d"]
    for name, st in trace:
        want = bb[f"res{name[-1]}"]["__call__"][0]
        np.testing.assert_array_equal(st.ids.numpy(), np.asarray(want.ids))
    assert len(trace) == 4
    for k, v in out["preds"].items():
        assert rel_l2(got["preds"][k].numpy(), v) <= FWD_REL_L2, k
    if family == "SECOND":
        for k in ("anchors", "anchor_cls"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(out[k]))
    else:
        assert set(got["preds"]) == set(out["preds"]) | {"top_idx"}
    assert check_detections(got_dets, dets) > 1


@pytest.mark.parametrize("family", FAMILIES)
def test_train_step_matches_jax(runs, family):
    jm, jg, pm, pg = train_step(runs(family))
    assert set(pm) == set(jm) == TERMS[family] | {"loss", "grad_norm"}
    for k in TERMS[family] | {"loss"}:
        np.testing.assert_allclose(pm[k], jm[k], rtol=LOSS_REL, err_msg=k)
    np.testing.assert_allclose(pm["grad_norm"], jm["grad_norm"],
                               rtol=GRAD_REL_L2)
    groups = group_rel_l2(jg, pg)
    assert set(groups) == {"backbone3d", "backbone2d", "head"}
    assert max(groups.values()) <= GRAD_REL_L2, groups


def _gts(family, r, sample=0):
    b = batch(family, r.cfgs[3])
    return (b["gt_boxes"][sample], b["gt_labels"][sample],
            b["gt_mask"][sample])


@pytest.mark.parametrize("family,matcher", [
    ("TransFusion", "hungarian"), ("TransFusion", "greedy"),
    ("SECOND", None), ("PointPillars", None)])
def test_losses_on_jax_predictions(runs, family, matcher):
    """Each family's loss on JAX's own forward output (PointPillars':
    seeded maps), through both packages' `detector_loss` (TransFusion's
    greedy matcher directly)."""
    r = runs(family)
    out = r.jax_out[0]
    boxes, labels, mask = _gts(family, r)
    jdet, jvox, pdet, pvox = r.cfgs
    pout = _torch_tree(dict(jax.tree.map(np.asarray, out)))
    pboxes, plabels, pmask = map(torch.from_numpy, (boxes, labels, mask))
    if matcher == "greedy":
        want = JT.transfusion_loss(out["preds"], jnp.asarray(boxes),
                                   jnp.asarray(labels), jnp.asarray(mask),
                                   jdet, jvox, 8, matcher="greedy")
        got = PT.transfusion_loss(pout["preds"], pboxes, plabels, pmask,
                                  pdet, pvox, 8, matcher="greedy")
    else:
        want = jax_detector_loss(r.jm, out, jnp.asarray(boxes),
                                 jnp.asarray(labels), jnp.asarray(mask),
                                 jdet, jvox)
        got = detector_loss(r.pm, pout, pboxes, plabels, pmask, pdet, pvox)
    # the dense centre loss also names its total, in both packages
    assert set(got[1]) == set(want[1])
    assert set(want[1]) - {"loss"} == TERMS[family]
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=LOSS_REL)
    for k, v in want[1].items():
        np.testing.assert_allclose(float(got[1][k]), float(v), rtol=LOSS_REL,
                                   err_msg=k)
    assert float(got[0]) > 0


def test_transfusion_loss_where_jax_raises(runs):
    """16 queries over an nms_post_max of 8: JAX's loss raises on its
    shapes; the port's decodes every query, and equals JAX's loss with
    nms_post_max at the query count."""
    r = runs("TransFusion")
    out = r.jax_out[0]
    boxes, labels, mask = _gts("TransFusion", r, 1)
    jdet, jvox, pdet, pvox = r.cfgs
    args = (jnp.asarray(boxes), jnp.asarray(labels), jnp.asarray(mask))
    with pytest.raises(TypeError, match="broadcast"):
        JT.transfusion_loss(out["preds"], *args,
                            dataclasses.replace(jdet, nms_post_max=8), jvox,
                            8)
    want = JT.transfusion_loss(out["preds"], *args, jdet, jvox, 8)
    pout = _torch_tree(dict(jax.tree.map(np.asarray, out)))
    got = PT.transfusion_loss(pout["preds"], *map(torch.from_numpy,
                                                  (boxes, labels, mask)),
                              dataclasses.replace(pdet, nms_post_max=8),
                              pvox, 8)
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=LOSS_REL)


def test_transfusion_class_loss_takes_query_order(runs):
    """The match is made on `decode_queries`' boxes in score order; the
    class loss pairs it with the logits in query order (JAX's, kept). The
    same queries put in score order match the same gts and give another
    class loss, in both packages alike."""
    r = runs("TransFusion")
    jdet, jvox, pdet, pvox = r.cfgs
    boxes, labels, mask = _gts("TransFusion", r)
    preds = {k: np.asarray(v) for k, v in r.jax_out[0]["preds"].items()}
    order = np.asarray(jax.lax.top_k(
        jax.nn.sigmoid(jnp.asarray(preds["cls"])).max(-1), 16)[1])
    assert not np.array_equal(order, np.arange(16))
    ranked = dict(preds, **{k: preds[k][order]
                            for k in ("cls", "box", "query_yx")})
    losses = []
    for p in (preds, ranked):
        want = JT.transfusion_loss({k: jnp.asarray(v) for k, v in p.items()},
                                   jnp.asarray(boxes), jnp.asarray(labels),
                                   jnp.asarray(mask), jdet, jvox, 8)
        got = PT.transfusion_loss({k: torch.from_numpy(v.copy())
                                   for k, v in p.items()},
                                  *map(torch.from_numpy,
                                       (boxes, labels, mask)), pdet, pvox, 8)
        for k, v in want[1].items():
            np.testing.assert_allclose(float(got[1][k]), float(v),
                                       rtol=LOSS_REL, err_msg=k)
        losses.append({k: float(v) for k, v in want[1].items()})
    assert losses[0]["tf_reg_loss"] == pytest.approx(
        losses[1]["tf_reg_loss"], rel=1e-6)
    assert abs(losses[0]["tf_cls_loss"] / losses[1]["tf_cls_loss"]
               - 1) > 1e-3


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_matchers_match_jax(seed):
    """Greedy and Hungarian on a [12, 6] cost with ties, a masked gt and
    (Hungarian) inf and NaN entries."""
    rng = np.random.default_rng(seed)
    cost = np.round(rng.uniform(0, 3, (12, 6)), 1).astype(np.float32)
    mask = np.array([True, True, False, True, True, True])
    got = PT.greedy_one_to_one(torch.from_numpy(cost), torch.from_numpy(mask))
    want = JT.greedy_one_to_one(jnp.asarray(cost), jnp.asarray(mask))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    bad = cost.copy()
    bad[3, 1], bad[5, 4], bad[0, 0] = np.inf, np.nan, -np.inf
    for c in (cost, bad):
        got = PT.hungarian_one_to_one(torch.from_numpy(c),
                                      torch.from_numpy(mask))
        want = JT.hungarian_one_to_one(jnp.asarray(c), jnp.asarray(mask))
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        assert got[1].sum() == 5


def test_centerpoint_trunk_takes_layernorm_whatever_the_norm():
    """JAX's CenterPointBackbone3D builds its layers with their default
    "ln": a "bn" config gives no running statistics in either package
    (SECOND and TransFusion build the same trunk)."""
    from lvv_tpu.config import tiny_config as jax_tiny
    from lvv_tpu.models.registry import build_detector as jax_build
    from torch_zoo_util import cloud
    jcfg, pcfg = jax_tiny(), tiny_config()
    jdet = dataclasses.replace(jcfg.model.voxelnext, norm="bn")
    pdet = dataclasses.replace(pcfg.model.voxelnext, norm="bn")
    pts = jnp.asarray(cloud(jcfg.voxelize, 500))
    shapes = jax.eval_shape(jax_build("CenterPoint", jdet, jcfg.voxelize).init,
                            jax.random.PRNGKey(0), pts, jnp.int32(500))
    assert set(shapes) == {"params"}
    for family in ("CenterPoint", "SECOND", "TransFusion"):
        det = build_detector(family, pdet, pcfg.voxelize, device="cpu")
        assert not list(det.buffers())


@pytest.mark.parametrize("preset,family", [
    ("nuscenes_transfusion_lidar", "TransFusion"),
    ("nuscenes_second_multihead", "SECOND"),
    ("nuscenes_pp_multihead", "PointPillars"),
    ("nuscenes_centerpoint_voxel0075", "CenterPoint")])
def test_cli_trains_the_presets_family(preset, family, tmp_path):
    argv = ["--config", str(REPO / "configs" / f"{preset}.json"),
            "--synthetic", "--steps", "2", "--save-every", "1", "--out",
            str(tmp_path), "--device", "cpu", *tiny_overrides()]
    det, metrics = cli.main(argv)
    assert type(det).__name__ == f"{family}Detector"
    assert np.isfinite(metrics["loss"]) and metrics["grad_norm"] > 0
    fresh = build_detector(family, det.det_cfg, det.vox_cfg, device="cpu",
                           seed=7)
    CheckpointManager(tmp_path / "checkpoints").restore("step_2", fresh)
    for k, v in det.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    assert (tmp_path / "checkpoints" / "step_1").is_dir()
