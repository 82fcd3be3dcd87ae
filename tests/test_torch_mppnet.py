"""The port's MPPNet and MPPNetE2E against the JAX package's, on the CPU.

tests/test_mppnet.py's widths: 3 frames, 16 samples a (proposal, frame),
the head alone at d_model 32 and one layer, the detectors at their own
(d_model 64, two layers, four heads); parameters from one seeded JAX tree
(`torch_zoo_util.random_tree`) through `from_jax_detector_params`.

- `propagate_trajectories`, `canonicalize`, the memory bank (contents
  equal), the head's pooling (pooled points and the empty mask equal, with
  filled and empty (proposal, frame) pairs) and its outputs within 1e-5
  relative L2, at point widths 4 and 3 (JAX feeds a zero feature).
- `subsample_rois` at its edge cases, `mppnet_proposal_targets` and
  `mppnet_loss` on the uniform draws that JAX's keys give: the sampled
  index, fg_mask and the min(96, R) cap equal.
- MPPNetDetector and three MPPNetE2E steps on one converted tree.
- JAX's jit'd `make_mppnet_train_step`, three steps at batch 2 of the CLI's
  chain, against the port's with JAX's draws replayed: metrics within
  1e-5 (grad_norm 1e-4), step 1's gradients within 1e-4 relative L2 a
  tensor, every parameter after three steps within 1e-5
  (`torch_waymo_util.check_train`; the attention's key biases take an
  analytically zero gradient, float32 noise on both sides).
- Reference traits, kept and pinned (ROADMAP.md queue 3): the attention
  has no key mask, so empty (proposal, frame) tokens serve as keys; the
  registry builds 4 frames whatever the preset.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lvv_tpu.config import tiny_config as jax_tiny_config
from lvv_tpu.models import mppnet as JM
from lvv_tpu.models.voxelnext import Detections as JDetections
from lvv_tpu.train import detector as jax_train
from lvv_tpu_torch import tiny_config
from lvv_tpu_torch.convert import from_jax_detector_params
from lvv_tpu_torch.models import mppnet as PM
from lvv_tpu_torch.models.registry import build_detector
from lvv_tpu_torch.models.voxelnext import Detections
from lvv_tpu_torch.train import detector as port_train
from lvv_tpu_torch.train.optim import detector_optimizer
from torch_waymo_util import (LR, STEPS, check_train, jax_chain,
                              port_module, recording)
from torch_zoo_util import random_tree, rel_l2
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.fast

FWD_REL_L2 = 1e-5
T, S, P, R = 3, 16, 256, 12
HEAD = dict(num_frames=T, samples=S, d_model=32, num_layers=1)



def _frames(feat: int = 4, seed: int = 0):
    """[T, P, feat] frames (a cluster near (5, 0) moving back 0.5 m a frame
    in x, uniform clutter), counts P, P - 40 and 0: the last frame is
    empty, so every proposal has an empty pair."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-10, 10, (T, P, feat)).astype(np.float32)
    for t in range(T):
        pts[t, :40, 0] = rng.normal(5.0 - 0.5 * t, 0.3, 40)
        pts[t, :40, 1] = rng.normal(0.0, 0.3, 40)
        pts[t, :40, 2] = rng.normal(0.0, 0.3, 40)
    return pts, np.array([P, P - 40, 0], np.int32)


def _proposals(seed: int = 1):
    """R proposals: one on the cluster (velocity 5 m/s in x, so frame t
    sits 0.5·t m back), the rest spread over the clutter, two far
    outside it."""
    rng = np.random.default_rng(seed)
    boxes = np.zeros((R, 9), np.float32)
    boxes[:, :2] = rng.uniform(-9, 9, (R, 2))
    boxes[:, 2] = rng.uniform(-1, 1, R)
    boxes[:, 3:6] = rng.uniform(2.0, 4.0, (R, 3))
    boxes[:, 6] = rng.uniform(-np.pi, np.pi, R)
    boxes[:, 7:9] = rng.normal(0, 2.0, (R, 2))
    boxes[0] = [5.0, 0.0, 0.0, 3, 3, 3, 0.2, 5.0, 0.0]
    boxes[-2:, :2] = 40.0
    return {"boxes": boxes,
            "scores": rng.uniform(0.1, 0.9, R).astype(np.float32),
            "labels": rng.integers(0, 3, R).astype(np.int32),
            "count": np.int32(R)}


def _jdets(p):
    return JDetections(**{k: jnp.asarray(v) for k, v in p.items()})


def _pdets(p):
    return Detections(**{k: torch.as_tensor(v) for k, v in p.items()})


def _check_dets(got, want, tol=1e-5):
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    assert int(got.count) == int(want.count)
    assert rel_l2(got.boxes.detach().numpy(), np.asarray(want.boxes)) <= tol
    assert rel_l2(got.scores.detach().numpy(),
                  np.asarray(want.scores)) <= tol


def test_trajectories_and_canonical_frame():
    boxes = _proposals()["boxes"]
    want = JM.propagate_trajectories(jnp.asarray(boxes), 4, dt=0.5)
    got = PM.propagate_trajectories(torch.from_numpy(boxes), 4, dt=0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    pts = np.random.default_rng(3).normal(size=(R, 8, 3)).astype(np.float32)
    want = jax.vmap(JM.canonicalize)(jnp.asarray(pts),
                                     jnp.asarray(boxes[:, :7]))
    got = PM.canonicalize(torch.from_numpy(pts),
                          torch.from_numpy(boxes[:, None, :7]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("feat", [4, 3])
def test_head_pool_and_outputs_match_jax(feat):
    """Pooled points and the empty mask equal, filled and empty pairs both
    present; cls / reg within FWD_REL_L2; F = 3 reads a zero feature."""
    pts, counts = _frames(feat)
    traj = JM.propagate_trajectories(jnp.asarray(_proposals()["boxes"]), T)
    jm = JM.MPPNetHead(**HEAD)
    args = (jnp.asarray(pts), jnp.asarray(counts), traj)
    tree = random_tree(dict(jax.eval_shape(
        lambda k: jm.init(k, *args), jax.random.PRNGKey(0))))
    want = jax.jit(lambda t: jm.apply(t, *args))(tree)
    head = port_module(PM.MPPNetHead, tree, **HEAD, point_features=feat)
    ptraj = torch.from_numpy(np.asarray(traj))
    with torch.no_grad():
        pooled, empty = head.pool(torch.from_numpy(pts),
                                  torch.from_numpy(counts), ptraj)
        got = head(pooled, empty, ptraj)
    from lvv_tpu.ops.pool import roipoint_pool3d as jpool
    for t in range(T):
        valid = jnp.arange(P) < counts[t]
        extra = pts[t, :, 3:] if feat > 3 else pts[t, :, :1] * 0.0
        jp, je = jpool(jnp.asarray(pts[t, :, :3]), jnp.asarray(extra),
                       traj[t], S, valid_points=valid)
        np.testing.assert_array_equal(pooled[t].numpy(), np.asarray(jp))
        np.testing.assert_array_equal(empty[t].numpy(), np.asarray(je))
    assert 0 < int((~empty).sum()) < empty.numel()
    assert bool(empty[2].all()) and not bool(empty[0].all())
    for k in ("cls", "reg"):
        assert rel_l2(got[k].numpy(), np.asarray(want[k])) <= FWD_REL_L2, k


def test_empty_tokens_serve_as_keys(monkeypatch):
    """Reference trait: the intertwining attention has no key mask
    (lvv_tpu/models/mppnet.py:97-101), so a filled proposal's output
    depends on its empty pairs' tokens (the LayerNorm's bias): masking
    them out of the keys moves it, and JAX's output is the unmasked
    one."""
    pts, counts = _frames()
    traj = JM.propagate_trajectories(jnp.asarray(_proposals()["boxes"]), T)
    jm = JM.MPPNetHead(**HEAD)
    args = (jnp.asarray(pts), jnp.asarray(counts), traj)
    tree = random_tree(dict(jax.eval_shape(
        lambda k: jm.init(k, *args), jax.random.PRNGKey(0))))
    want = jax.jit(lambda t: jm.apply(t, *args))(tree)
    head = port_module(PM.MPPNetHead, tree, **HEAD)
    ptraj = torch.from_numpy(np.asarray(traj))
    with torch.no_grad():
        pooled, empty = head.pool(torch.from_numpy(pts),
                                  torch.from_numpy(counts), ptraj)
        plain = head(pooled, empty, ptraj)
        keys = (~empty).t()[:, :, None].expand(R, T, S).reshape(R, -1)
        from lvv_tpu_torch.models import layers
        base = layers.attention

        def masked(q, k, v, **kw):
            bias = torch.where(keys, 0.0, -1e30)[:, None, None, :]
            return base(q, k, v, bias=bias, **kw)
        monkeypatch.setattr(layers, "attention", masked)
        with_mask = head(pooled, empty, ptraj)
    filled = (~empty).any(0) & empty.any(0)
    assert bool(filled.any())
    assert rel_l2(plain["cls"].numpy(), np.asarray(want["cls"])) <= FWD_REL_L2
    moved = (with_mask["cls"] - plain["cls"]).abs()[filled]
    assert float(moved.max()) > 1e-3


def test_memory_bank_rolls():
    pts, counts = _frames()
    jb = JM.MemoryBank.create(num_frames=T, max_points=P, feat_dim=4)
    pb = PM.MemoryBank.create(T, P, 4, device="cpu")
    for t in range(T):
        jb = jb.push(jnp.asarray(pts[t]), jnp.int32(counts[t]))
        pb = pb.push(torch.from_numpy(pts[t]), int(counts[t]))
        np.testing.assert_array_equal(pb.points.numpy(), np.asarray(jb.points))
        np.testing.assert_array_equal(pb.counts.numpy(), np.asarray(jb.counts))


@pytest.fixture(scope="module")
def tree():
    """One JAX MPPNetDetector tree (3 frames, 16 samples)."""
    jcfg = jax_tiny_config()
    jm = JM.MPPNetDetector(det_cfg=jcfg.model.voxelnext, num_frames=T,
                           samples=S)
    pts, counts = _frames()
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.asarray(pts), jnp.asarray(counts),
                            _jdets(_proposals()))
    return jm, random_tree(dict(shapes))


def _port(name, tree):
    cfg = tiny_config()
    opts = dict(num_frames=T, samples=S)
    state = from_jax_detector_params(tree, cfg.model.voxelnext, cfg.voxelize,
                                     device="cpu", detector=name, **opts)
    det = build_detector(name, cfg.model.voxelnext, cfg.voxelize,
                         device="cpu", **opts)
    det.load_state_dict(state)
    return det, state


def test_detector_and_e2e_on_one_tree(tree):
    """One converted tree loads into both classes (each names its head
    `head`); MPPNetDetector's detections and three MPPNetE2E steps (the
    bank's contents equal, detections within 1e-5) against JAX's."""
    jm, params = tree
    pts, counts = _frames()
    props = _proposals()
    det, state = _port("MPPNet", params)
    e2e, state2 = _port("MPPNetE2E", params)
    assert set(state) == set(state2) == set(det.state_dict())
    want = jax.jit(jm.apply)(params, jnp.asarray(pts), jnp.asarray(counts),
                             _jdets(props))
    _check_dets(det.detect(torch.from_numpy(pts), torch.from_numpy(counts),
                           _pdets(props)), want)

    jcfg = jax_tiny_config()
    je = JM.MPPNetE2E(det_cfg=jcfg.model.voxelnext, num_frames=T, samples=S)
    step = jax.jit(je.apply)
    jbank = JM.MemoryBank.create(num_frames=T, max_points=P, feat_dim=4)
    pbank = e2e.create_bank(P)
    for t in range(T):
        jbank, jd = step(params, jbank, jnp.asarray(pts[t]),
                         jnp.int32(counts[t]), _jdets(props))
        with torch.no_grad():
            pbank, pd = e2e(pbank, torch.from_numpy(pts[t]),
                            int(counts[t]), _pdets(props))
        np.testing.assert_array_equal(pbank.points.numpy(),
                                      np.asarray(jbank.points))
        np.testing.assert_array_equal(pbank.counts.numpy(),
                                      np.asarray(jbank.counts))
        _check_dets(pd, jd)


def _jax_draws(key, r):
    kf, kb = jax.random.split(key)
    return (np.asarray(jax.random.uniform(kf, (r,))),
            np.asarray(jax.random.uniform(kb, (r,))))


SUBSAMPLE_CASES = {
    # 10 fg, 20 hard bg, 34 easy: fg capped at round(0.5 m)
    "capped": (np.r_[np.full(10, 0.6), np.full(20, 0.3), np.full(34, 0.01)],
               16),
    "no_foreground": (np.full(64, 0.05), 16),
    "few_foregrounds": (np.r_[np.full(3, 0.7), np.full(61, 0.2)], 32),
    "all_foreground": (np.full(40, 0.8), 96),
    # r < 96: m = r; -inf ties where nothing is eligible on one side
    "r_below_96": (np.r_[np.full(5, 0.9), np.full(30, 0.0)], 96),
    "ties": (np.r_[np.full(8, 0.55), np.full(8, 0.1), np.zeros(120)], 96),
}


@pytest.mark.parametrize("case", sorted(SUBSAMPLE_CASES))
def test_subsample_rois_matches_jax(case):
    iou, per = SUBSAMPLE_CASES[case]
    iou = iou.astype(np.float32)
    key = jax.random.PRNGKey(len(case))
    ws, wf = JM.subsample_rois(key, jnp.asarray(iou), roi_per_image=per)
    uf, ub = _jax_draws(key, len(iou))
    gs, gf = PM.subsample_rois(torch.from_numpy(iou),
                               (torch.from_numpy(uf), torch.from_numpy(ub)),
                               roi_per_image=per)
    assert len(gs) == min(per, len(iou))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(gf.numpy(), np.asarray(wf))


def test_proposal_targets_and_loss_match_jax():
    rng = np.random.default_rng(0)
    t_num, r_num = 3, 40
    traj = rng.uniform(-20, 20, (t_num, r_num, 7)).astype(np.float32)
    traj[..., 3:6] = rng.uniform(1, 3, (t_num, r_num, 3))
    gt = np.zeros((4, 9), np.float32)
    gt[:3, :7] = traj[0, :3]
    gt[:3, :2] += rng.normal(0, 0.2, (3, 2))
    gmask = np.array([True, True, True, False])
    traj[0, 5:8] = traj[0, :3] + np.float32(0.3)
    key = jax.random.PRNGKey(3)
    draws = tuple(map(torch.from_numpy, _jax_draws(key, r_num)))
    vl = np.ones((t_num, r_num), bool)
    want = JM.mppnet_proposal_targets(
        key, jnp.asarray(traj), jnp.zeros(r_num), jnp.zeros(r_num, jnp.int32),
        jnp.asarray(vl), jnp.asarray(gt), jnp.asarray(gmask),
        roi_per_image=32)
    got = PM.mppnet_proposal_targets(
        draws, torch.from_numpy(traj), torch.zeros(r_num),
        torch.zeros(r_num, dtype=torch.int32), torch.from_numpy(vl),
        torch.from_numpy(gt), torch.from_numpy(gmask), roi_per_image=32)
    assert set(got) == set(want)
    assert int(want["fg_mask"].sum()) > 0
    for k, v in want.items():
        v = np.asarray(v)
        if v.dtype.kind == "f":
            np.testing.assert_allclose(got[k].numpy(), v, rtol=1e-6,
                                       atol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    preds = {"cls": rng.normal(size=r_num).astype(np.float32),
             "reg": rng.normal(size=(r_num, 7)).astype(np.float32)}
    for sampled in (True, False):
        kw = dict(key=key, trajectory_rois=jnp.asarray(traj)) if sampled \
            else {}
        pkw = dict(draws=draws, trajectory_rois=torch.from_numpy(traj)) \
            if sampled else {}
        wl, wa = JM.mppnet_loss({k: jnp.asarray(v) for k, v in preds.items()},
                                jnp.asarray(traj[0]), jnp.asarray(gt),
                                jnp.asarray(gmask), **kw)
        gl, ga = PM.mppnet_loss({k: torch.from_numpy(v)
                                 for k, v in preds.items()},
                                torch.from_numpy(traj[0]),
                                torch.from_numpy(gt),
                                torch.from_numpy(gmask), **pkw)
        np.testing.assert_allclose(float(gl), float(wl), rtol=1e-5)
        for k, v in wa.items():
            np.testing.assert_allclose(float(ga[k]), float(v), rtol=1e-5,
                                       atol=1e-7, err_msg=k)


def _train_batch():
    """Two samples: frame stacks and noisy-gt proposals (the JAX CLI's
    synthetic batch at these sizes, the clouds moved onto the boxes so
    that pairs fill)."""
    from lvv_tpu_torch.tools.train_detector import synthetic_mppnet_batch
    rng = np.random.default_rng(4)
    pr = (-10.0, -10.0, -2.0, 10.0, 10.0, 2.0)
    b = synthetic_mppnet_batch(rng, 2, T, P, 4, R, pr)
    gtb = b["gt_boxes"]
    for i in range(2):
        for t in range(T):
            idx = rng.integers(0, 4, 120)
            b["frame_points"][i, t, :120, :3] = (
                gtb[i, idx, :3] + rng.normal(0, 0.6, (120, 3)))
    b["gt_mask"][1, 3] = False
    b["frame_counts"][1, 2] = 0
    return b


def test_train_steps_match_jax(tree):
    """Three steps at batch 2: JAX's jit'd step (per-sample keys from the
    batch's rng) against the port's on the same draws, held as the Waymo
    steps are (`torch_waymo_util.check_train`: the attention's key biases
    take an analytically zero gradient, held within 1e-6 of the global
    norm)."""
    jm, params = tree
    b = _train_batch()
    tx = recording(jax_chain())
    step = jax_train.make_mppnet_train_step(jm, tx)
    state = (params, tx.init(params))
    det, start = _port("MPPNet", params)
    ptx = detector_optimizer(LR, STEPS)
    pstep = port_train.make_mppnet_train_step(det, ptx)
    pstate = (det, ptx.init(dict(det.named_parameters())))
    key = jax.random.PRNGKey(11)
    j_metrics, p_metrics = [], []
    for i in range(STEPS):
        key, sub = jax.random.split(key)
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        jb["rng"] = sub
        state, m = step(state, jb)
        j_metrics.append({k: float(v) for k, v in m.items()})
        pb = dict(b)
        pb["draws"] = np.stack([np.stack(_jax_draws(k, R))
                                for k in jax.random.split(sub, 2)])
        pstate, m = pstep(pstate, pb)
        p_metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            grads1 = {n: p.grad.numpy().copy()
                      for n, p in det.named_parameters()}
    _, first, least, _ = state[1]
    cfg = tiny_config()

    def port_layout(t):
        return {k: v.numpy() for k, v in from_jax_detector_params(
            {"params": jax.tree.map(np.asarray, t)}, cfg.model.voxelnext,
            cfg.voxelize, device="cpu", detector="MPPNet", num_frames=T,
            samples=S).items()}
    check_train({"jax": (j_metrics, port_layout(first["params"]),
                         port_layout(least["params"]),
                         port_layout(state[0]["params"])),
                 "port": (p_metrics, grads1,
                          {n: p.detach().numpy()
                           for n, p in det.named_parameters()}),
                 "start": {k: v.numpy() for k, v in start.items()},
                 "own_gates": 0, "relu_entries": 0},
                terms=("roi_cls_loss", "roi_reg_loss"))


def test_train_step_draws_from_its_generator():
    """Without draws in the batch the step takes them from its generator:
    two steps from equal starts and generators agree, another seed
    samples other RoIs."""
    cfg = tiny_config()
    b = _train_batch()
    losses = []
    for seed in (5, 5, 6):
        det = build_detector("MPPNet", cfg.model.voxelnext, cfg.voxelize,
                             device="cpu", num_frames=T, samples=S, seed=2)
        tx = detector_optimizer(1e-3, 3)
        step = port_train.make_mppnet_train_step(
            det, tx, torch.Generator().manual_seed(seed))
        _, m = step((det, tx.init(dict(det.named_parameters()))), b)
        losses.append(float(m["loss"]))
    assert losses[0] == losses[1] != losses[2]


def test_registry_builds_four_frames_for_every_preset():
    """Reference trait: JAX's registry builds MPPNet and MPPNetE2E with
    the default num_frames 4 (lvv_tpu/models/registry.py:114-128), so
    the 16-frame preset runs 4 frames; the port's does the same."""
    from lvv_tpu import config as JC
    from lvv_tpu.models.registry import build_detector as jax_build
    from lvv_tpu_torch import config as C
    from torch_waymo_util import REPO
    for preset in ("waymo_mppnet_4frames", "waymo_mppnet_16frames",
                   "waymo_mppnet_e2e"):
        path = REPO / "configs" / f"{preset}.json"
        name = C.load_file(path)["_detector"]
        jc, pc = JC.load(JC.VQAConfig, path), C.load(C.VQAConfig, path)
        assert jax_build(name, jc.model.voxelnext, jc.voxelize).num_frames \
            == 4
        det = build_detector(name, pc.model.voxelnext, pc.voxelize,
                             device="meta")
        assert det.num_frames == det.head.num_frames == 4
        assert type(det).__name__ == ("MPPNetE2E" if "e2e" in preset
                                      else "MPPNetDetector")


def test_time_embeddings_and_widths():
    """The port's head names and shapes JAX's tree leaf for leaf at the
    preset's widths (d_model 64, two layers, four frames)."""
    cfg = tiny_config()
    det = build_detector("MPPNet", cfg.model.voxelnext, cfg.voxelize,
                         device="meta")
    shapes = {k: tuple(v.shape) for k, v in det.state_dict().items()}
    assert shapes["head.time_embed_3"] == (64,)
    assert shapes["head.embed_0.kernel"] == (4, 64)
    assert shapes["head.attn1.q_proj.kernel"] == (64, 64)
    assert shapes["head.fc1a.kernel"] == (64, 128)
