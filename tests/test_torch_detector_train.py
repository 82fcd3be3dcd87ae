"""The port's VoxelNeXt training against the JAX package's, on the CPU.

tiny_config()'s detector in both norm modes on one seeded JAX tree
(`torch_voxelnext_util._tree`, converted by `from_jax_detector_params`), a
batch of two clouds with 8 gts each (two masked in the second), three
steps of the CLI's chain (clip by global norm 10, AdamW at
warmup_cosine_decay_schedule(lr / 10, lr, 1, 3)): JAX's jit'd
`make_detector_train_step` (one compile per norm mode, one more for
"bn" in float64, where the port's step runs in float64 too; a wrapper
around
the chain keeps step 1's gradients and each element's smallest non-zero
|gradient| over the steps) against the port's step.

- Every step's loss, hm_loss and reg_loss within 1e-5 relative, its
  pre-clip grad_norm within 1e-4.
- Step 1's gradient of every parameter within 1e-4 relative L2. A
  gradient that JAX makes exactly zero (the vel and iou branches, which
  the loss never reaches) is None in the port. A gradient whose norm is
  under 1e-6 of the global norm is analytically zero (the conv biases
  that a "bn" norm subtracts out again) and float32 noise in both: it is
  held absolutely, within 1e-6 of the global norm.
- "bn": the running statistics after step 1 within 1e-6.
- Every parameter after 3 steps within 1e-5, the weight-decay-only vel /
  iou parameters included. Adam moves an element by ~lr whatever |g| is
  above its eps of 1e-8, so an element whose gradient sat at float32
  noise level at some step (non-zero and under 1e-6 of its tensor's
  largest |g|), and every element of an analytically zero gradient, takes
  its own ±lr step in each stack; such elements (under 0.1% of the rest)
  are held to the largest move two Adam stacks can make apart, 2·Σ lr.
- "bn": a float32 step is itself off the float64 step by more than the
  bounds above: over three steps the batch statistics of a few active
  rows amplify float32 rounding. JAX's float32 step is 4.3e-5 (loss),
  2.0e-4 (grad_norm) and 1.05e-4 (a parameter, backbone.res4.conv2)
  relative from its float64 step, and the port's float32 step is just as
  far from both float64 steps (4.6e-5, 2.0e-4, 1.12e-4 on an AMD EPYC;
  nearer on the machine where the bounds were first set, which is
  rounding luck, not a property of the port). So the function is held in
  float64: JAX runs "bn" in float64 too (`jax.enable_x64`, one more
  compile) and the port likewise (the model's `.double()`); the two
  float64 steps agree at the bounds above (read: loss 5.7e-7, grad_norm
  4.5e-6, parameters 4.7e-6 under BN_F64_PARAM_TOL = 2e-5). The port's
  float32 step is held to JAX's float64 and float32 steps at the bounds
  JAX's own float32 step needs, BN_F32_* (loss 1e-4, grad_norm 5e-4,
  parameters 2e-4; read against JAX's float32 step: 2.1e-6, 1.9e-5,
  1.2e-5). The losses (JAX float32 / float64 / port float32 / float64):
  13.45380 / 13.45380 / 13.45380 / 13.45380, 13.03009 / 13.03014 /
  13.03009 / 13.03014, 11.96289 / 11.96342 / 11.96286 / 11.96341.
  `_readings` prints these (run this file as a script); the port's own
  float32 numbers move by ~1e-6 from run to run (the CPU's threads).
- The optax pieces alone (clip, schedule, AdamW with a None gradient),
  recall_stats, the bucketed step's pick and shared parameters, the
  registry, the CLI in-process with its checkpoint round trip, and the
  eval callers' graph-free forward.
"""
import dataclasses
import importlib.util
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lvv_tpu.models.registry import DETECTORS as JAX_DETECTORS
from lvv_tpu.models.voxelnext import VoxelNeXtDetector as JaxDetector
from lvv_tpu.train import detector as jax_train
from lvv_tpu_torch import tiny_config
from lvv_tpu_torch.convert import from_jax_detector_params
from lvv_tpu_torch.convert.params import _flatten
from lvv_tpu_torch.models.registry import DETECTORS, PORTED, build_detector
from lvv_tpu_torch.models.voxelnext import VoxelNeXtDetector
from lvv_tpu_torch.tools import train_detector as cli
from lvv_tpu_torch.train import detector as port_train
from lvv_tpu_torch.train.checkpoints import CheckpointManager
from lvv_tpu_torch.train.optim import (ClipAdamW, clip_by_global_norm,
                                       detector_optimizer,
                                       warmup_cosine_decay_schedule)
from torch_voxelnext_util import _tree, cloud, configs
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.fast

REPO = pathlib.Path(__file__).resolve().parents[1]
LR, STEPS = 1e-3, 3
METRIC_TOL = 1e-5
GRAD_TOL = 1e-4
ZERO_GRAD = 1e-6            # of the global norm: an analytically zero grad
STAT_TOL = 1e-6
PARAM_TOL = 1e-5
NOISE = 1e-6                # of a tensor's largest |g|: float32 noise level
# "bn": the port's float32 step against JAX's float64 and float32 steps,
# at what JAX's own float32 step needs from its float64 step
BN_F32_METRIC_TOL, BN_F32_GRAD_NORM_TOL, BN_F32_PARAM_TOL = 1e-4, 5e-4, 2e-4
BN_F64_PARAM_TOL = 2e-5     # "bn": the two float64 steps


def _batch(pvox):
    rng = np.random.default_rng(0)
    batch = cli.synthetic_batch(rng, 2, 512, 8, pvox.point_range)
    batch["points"] = np.stack([cloud(pvox, 1500, seed=s) for s in (0, 1)])
    batch["num_points"] = np.array([1500, 1200], np.int32)
    batch["gt_mask"][1, 6:] = False
    return batch


def _jax_chain():
    sched = optax.warmup_cosine_decay_schedule(
        LR / 10, LR, max(STEPS // 10, 1), STEPS)
    return optax.chain(optax.clip_by_global_norm(10.0), optax.adamw(sched))


def _recording(inner):
    """`inner` that also keeps step 1's gradients and each element's
    smallest non-zero |gradient| over the steps in its state."""
    def init(p):
        return (inner.init(p), jax.tree.map(jnp.zeros_like, p),
                jax.tree.map(lambda x: jnp.full_like(x, jnp.inf), p),
                jnp.zeros((), jnp.int32))

    def update(g, state, p=None):
        s, first, least, n = state
        u, s = inner.update(g, s, p)
        first = jax.tree.map(lambda a, b: jnp.where(n == 0, b, a), first, g)
        least = jax.tree.map(
            lambda a, b: jnp.minimum(a, jnp.where(b == 0, jnp.inf,
                                                  jnp.abs(b))), least, g)
        return u, (s, first, least, n + 1)
    return optax.GradientTransformation(init, update)


def _jax_float64(jm, tree, jdet, jvox, batch):
    """JAX's step in float64 from the same tree and batch -> (metrics of
    each step, final params)."""
    with jax.enable_x64(True):
        tree = jax.tree.map(lambda x: jnp.asarray(x, jnp.float64), tree)
        tx = _jax_chain()
        step = jax_train.make_detector_train_step(jm, tx, jdet, jvox)
        state = (tree, tx.init(tree["params"]))
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        for k in ("points", "gt_boxes"):
            jb[k] = jb[k].astype(jnp.float64)
        metrics = []
        for _ in range(STEPS):
            state, m = step(state, jb)
            metrics.append({k: float(v) for k, v in m.items()})
        return metrics, _flatten(jax.tree.map(np.asarray,
                                              state[0]["params"]))


def _port_steps(tree, pdet, pvox, batch, dtype=torch.float32):
    """The port's STEPS steps from `tree` -> (metrics of each, step 1's
    gradients, step 1's running statistics, the detector)."""
    pm = VoxelNeXtDetector(pdet, pvox, device="cpu").to(dtype)
    pm.load_state_dict(from_jax_detector_params(tree, pdet, pvox,
                                                device="cpu"))
    ptx = detector_optimizer(LR, STEPS)
    pstep = port_train.make_detector_train_step(pm, ptx, pdet, pvox)
    pstate = (pm, ptx.init(dict(pm.named_parameters())))
    p_metrics = []
    for i in range(STEPS):
        pstate, m = pstep(pstate, batch)
        p_metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            grads1 = {n: None if p.grad is None else p.grad.clone()
                      for n, p in pm.named_parameters()}
            stats1 = {n: b.clone() for n, b in pm.named_buffers()}
    return p_metrics, grads1, stats1, pm


def _run(norm):
    """JAX's jit'd step (float32, recording; "bn" also float64) and the
    port's (likewise), STEPS steps each from one seeded tree."""
    jdet, jvox, pdet, pvox = configs("tiny", norm)
    batch = _batch(pvox)
    jm = JaxDetector(jdet, jvox)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.asarray(batch["points"][0]), jnp.int32(1500))
    tree = _tree(dict(shapes), seed=1)
    tx = _recording(_jax_chain())
    step = jax_train.make_detector_train_step(jm, tx, jdet, jvox)
    state = (tree, tx.init(tree["params"]))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    j_metrics, j_stats1 = [], None
    for _ in range(STEPS):
        state, m = step(state, jb)
        j_metrics.append({k: float(v) for k, v in m.items()})
        if j_stats1 is None and "batch_stats" in state[0]:
            j_stats1 = _flatten(state[0]["batch_stats"])
    _, first, least, _ = state[1]
    j64 = p64 = None
    if norm == "bn":
        j64 = _jax_float64(jm, tree, jdet, jvox, batch)
        p64 = _port_steps(tree, pdet, pvox, batch, torch.float64)
    return dict(
        jax=(j_metrics, _flatten(first), j_stats1, _flatten(least),
             _flatten(state[0]["params"])),
        port=_port_steps(tree, pdet, pvox, batch), tree=tree, jax64=j64,
        port64=p64, start=_flatten(tree["params"]))


@pytest.fixture(scope="module")
def runs():
    made = {}

    def get(norm):
        if norm not in made:
            made[norm] = _run(norm)
        return made[norm]
    return get


def _param_gaps(params, ref, first, least):
    """Per parameter tensor: (name, largest |params - ref| over the
    elements held to the bound, over the noise elements, whether its step-1
    gradient is analytically zero, noise count, size)."""
    total = np.sqrt(sum(float(np.sum(np.asarray(g) ** 2))
                        for g in first.values()))
    for name, p in params.items():
        got, want = np.asarray(p, np.float64), np.asarray(ref[name],
                                                          np.float64)
        diff = np.abs(got - want)
        g1 = np.abs(np.asarray(first[name]))
        noise = np.asarray(least[name]) <= NOISE * g1.max()
        zero = bool(g1.any() and np.linalg.norm(g1) <= ZERO_GRAD * total)
        yield (name, float(diff[~noise].max(initial=0)),
               float(diff[noise].max(initial=0)), zero, int(noise.sum()),
               diff.size)


@pytest.mark.parametrize("norm", ["ln", "bn"])
def test_step_metrics_match_jax(runs, norm):
    """All three steps; "bn": the port's float64 step against JAX's at the
    bounds, its float32 step against JAX's float64 and float32 steps at
    BN_F32_*."""
    r = runs(norm)
    p_metrics = r["port"][0]
    refs = [(p_metrics, r["jax"][0], METRIC_TOL, GRAD_TOL)]
    if norm == "bn":
        refs = [(r["port64"][0], r["jax64"][0], METRIC_TOL, GRAD_TOL),
                (p_metrics, r["jax64"][0], BN_F32_METRIC_TOL,
                 BN_F32_GRAD_NORM_TOL),
                (p_metrics, r["jax"][0], BN_F32_METRIC_TOL,
                 BN_F32_GRAD_NORM_TOL)]
    for got_metrics, j_metrics, tol, norm_tol in refs:
        for jm, pm in zip(j_metrics, got_metrics):
            assert set(pm) == set(jm) == {"loss", "hm_loss", "reg_loss",
                                          "grad_norm"}
            for key, want in jm.items():
                np.testing.assert_allclose(
                    pm[key], want, err_msg=key,
                    rtol=norm_tol if key == "grad_norm" else tol)
    assert p_metrics[-1]["loss"] < p_metrics[0]["loss"]


@pytest.mark.parametrize("norm", ["ln", "bn"])
def test_gradients_match_jax(runs, norm):
    r = runs(norm)
    want, got = r["jax"][1], r["port"][1]
    total = np.sqrt(sum(float(np.sum(np.asarray(w) ** 2))
                        for w in want.values()))
    zero, small = [], []
    for name, w in want.items():
        w, g = np.asarray(w), got[name]
        if not w.any():
            assert g is None or not g.any(), name
            zero.append(name)
            continue
        err = float(np.linalg.norm(g.numpy() - w))
        if np.linalg.norm(w) <= ZERO_GRAD * total:
            assert err <= ZERO_GRAD * total, name
            small.append(name)
        else:
            assert err <= GRAD_TOL * np.linalg.norm(w), (name, err)
    # the branches that the loss never reaches; under "bn" also every
    # layer that normalises a single active row (its output is ln_bias)
    unreached = [n for n in want if n.split(".")[1].startswith(("vel_",
                                                               "iou_"))]
    assert len(unreached) == 12 and set(unreached) <= set(zero)
    assert all(got[n] is None for n in unreached)
    assert norm == "bn" or sorted(zero) == sorted(unreached)
    # the analytically zero ones: the conv biases that "bn" subtracts out
    expected = (sorted(n for n in want if n.endswith(".bias")
                       and n.rsplit(".", 1)[0] + ".ln_scale" in want
                       and n not in zero) if norm == "bn" else [])
    assert sorted(small) == expected


def test_running_stats_match_jax(runs):
    r = runs("bn")
    want, got = r["jax"][2], r["port"][2]
    assert set(want) == set(got) and len(got) == 2 * 27
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), np.asarray(w),
                                   rtol=0, atol=STAT_TOL, err_msg=name)
    start = _flatten(r["tree"]["batch_stats"])
    assert not any(np.array_equal(got[n].numpy(), start[n]) for n in got)


@pytest.mark.parametrize("norm", ["ln", "bn"])
def test_parameters_after_three_steps_match_jax(runs, norm):
    r = runs(norm)
    _, first, _, least, final = r["jax"]

    def params(run):
        return {n: p.detach().numpy() for n, p in run[3].named_parameters()}
    refs = [(params(r["port"]), final, PARAM_TOL)]
    if norm == "bn":
        refs = [(params(r["port64"]), r["jax64"][1], BN_F64_PARAM_TOL),
                (refs[0][0], r["jax64"][1], BN_F32_PARAM_TOL),
                (refs[0][0], final, BN_F32_PARAM_TOL)]
    sched = warmup_cosine_decay_schedule(LR / 10, LR, 1, STEPS)
    adam_apart = 2 * sum(sched(t) for t in range(STEPS)) * 1.01
    for got, ref, tol in refs:
        n_all = n_noise = 0
        for name, kept, noisy, zero, n, size in _param_gaps(
                got, ref, first, least):
            if zero:    # analytically zero (test_gradients_match_jax)
                assert max(kept, noisy) <= adam_apart, name
                continue
            n_all, n_noise = n_all + size, n_noise + n
            assert kept <= tol, (name, kept)
            assert noisy <= adam_apart, name
            assert not np.array_equal(ref[name], r["start"][name]), name
        assert n_noise <= 1e-3 * n_all, (n_noise, n_all)


@pytest.mark.parametrize("norm", ["ln", "bn"])
def test_weight_decay_only_parameters(runs, norm):
    """vel / iou: no gradient in either stack, so each step only decays
    them (AdamW's 1e-4·p; their moments stay zero)."""
    r = runs(norm)
    final, pm = r["jax"][4], r["port"][3]
    names = [n for n, _ in pm.named_parameters()
             if n.split(".")[1].startswith(("vel_", "iou_"))]
    assert len(names) == 12
    params = dict(pm.named_parameters())
    for name in names:
        assert params[name].grad is None
        start = r["start"][name]
        want = np.asarray(final[name])
        np.testing.assert_allclose(params[name].detach().numpy(), want,
                                   rtol=0, atol=PARAM_TOL)
        if start.any():
            assert not np.array_equal(want, start)


@pytest.mark.parametrize("scale", [0.5, 1.0, 3.0])
def test_clip_matches_optax(scale):
    """Global norms below, at and above 10."""
    rng = np.random.default_rng(7)
    grads = [rng.normal(size=s).astype(np.float32) for s in
             ((7, 5), (11,), (3, 2, 4))]
    norm = np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2))
                       for g in grads))
    grads = [g * np.float32(10 * scale / norm) for g in grads]
    want, _ = optax.clip_by_global_norm(10.0).update(
        [jnp.asarray(g) for g in grads], optax.EmptyState())
    got, got_norm = clip_by_global_norm([torch.from_numpy(g)
                                         for g in grads], 10.0)
    np.testing.assert_allclose(float(got_norm), 10 * scale, rtol=1e-6)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)
    if scale < 1:
        assert all(torch.equal(a, torch.from_numpy(g))
                   for a, g in zip(got, grads))


@pytest.mark.parametrize("lr,total", [(1e-3, 3), (1e-3, 20), (2e-4, 100)])
def test_schedule_matches_optax(lr, total):
    warmup = max(total // 10, 1)
    want = optax.warmup_cosine_decay_schedule(lr / 10, lr, warmup, total)
    got = warmup_cosine_decay_schedule(lr / 10, lr, warmup, total)
    for count in (0, warmup - 1, warmup, warmup + 1, total - 1, total,
                  total + 5):
        np.testing.assert_allclose(got(count), float(want(count)),
                                   rtol=1e-6, atol=1e-6 * lr)
    assert got(0) == pytest.approx(lr / 10)
    assert got(total) == 0.0
    with pytest.raises(ValueError):
        warmup_cosine_decay_schedule(lr / 10, lr, 2, 2)


def test_adamw_chain_matches_optax():
    """Three updates on identical seeded gradients (the second over the
    clip norm), one tensor without a gradient: AdamW's weight decay and
    the moments' decay still reach it."""
    rng = np.random.default_rng(9)
    params = {n: rng.normal(size=s).astype(np.float32) for n, s in
              (("a", (6, 4)), ("b", (5,)), ("idle", (3, 3)))}
    tx = _jax_chain()
    jp = {n: jnp.asarray(v) for n, v in params.items()}
    js = tx.init(jp)
    ours = detector_optimizer(LR, STEPS)
    assert isinstance(ours, ClipAdamW)
    tp = {n: torch.from_numpy(v.copy()) for n, v in params.items()}
    ts = ours.init(tp)
    for step in range(STEPS):
        grads = {n: rng.normal(size=v.shape).astype(np.float32)
                 * (30.0 if step == 1 else 1.0) for n, v in params.items()}
        grads["idle"] = np.zeros_like(params["idle"])
        upd, js = tx.update({n: jnp.asarray(g) for n, g in grads.items()},
                            js, jp)
        jp = optax.apply_updates(jp, upd)
        tg = {n: torch.from_numpy(g) for n, g in grads.items()}
        tg["idle"] = None
        ours.update(tg, ts, tp)
        for n in params:
            np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]),
                                       rtol=0, atol=1e-6, err_msg=n)
    assert ts["count"] == STEPS
    assert not np.array_equal(tp["idle"].numpy(), params["idle"])


def test_recall_stats_matches_jax():
    """tests/test_detector_train.py's case."""
    gt = np.array([[0, 0, 0, 4, 2, 1.5, 0.0],
                   [10, 10, 0, 4, 2, 1.5, 0.0]], np.float32)
    pred = np.array([[0.1, 0, 0, 4, 2, 1.5, 0.0]], np.float32)
    out = port_train.recall_stats(pred, 1, gt)
    assert out == jax_train.recall_stats(pred, 1, gt)
    assert out["gt"] == 2 and out["recall_0.3"] == 0.5
    assert out["recall_0.7"] in (0.0, 0.5)
    assert port_train.recall_stats(pred, 0, gt)["recall_0.5"] == 0.0


def test_bucketed_step_picks_and_shares(runs):
    """Two buckets on the tiny grid: each cloud's pick is JAX's and the
    smallest bucket that drops nothing; the buckets' detectors share
    parameters and buffers, and a step in bucket 1 moves bucket 0's."""
    jdet, jvox, pdet, pvox = configs("tiny", "bn")
    buckets = ((200, (150, 60, 20, 6, 2)), (512, (700, 300, 100, 30, 8)))
    tx = detector_optimizer(LR, STEPS)
    steps, pick = port_train.make_bucketed_detector_train_step(
        "VoxelNeXt", pdet, pvox, tx, buckets, device="cpu")
    _, jpick = jax_train.make_bucketed_detector_train_step(
        "VoxelNeXt", jdet, jvox, _jax_chain(), buckets)
    small = cloud(pvox, 60, seed=3)[None]
    big = _batch(pvox)
    assert pick(small, [60]) == jpick(small, [60]) == 0
    assert pick(big["points"], big["num_points"]) == jpick(
        big["points"], big["num_points"]) == 1
    d0, d1 = steps[0].det, steps[1].det
    assert d0.vox_cfg.max_voxels == 200 and d1.vox_cfg.max_voxels == 512
    for (n, a), (_, b) in zip(d0.state_dict(keep_vars=True).items(),
                              d1.state_dict(keep_vars=True).items()):
        assert a is b, n
    before = d0.head.hm_head_bias.detach().clone()
    state = (d0, tx.init(dict(d0.named_parameters())))
    state, metrics = steps[1](state, big)
    assert np.isfinite(float(metrics["loss"]))
    assert not torch.equal(d0.head.hm_head_bias.detach(), before)


# the widths that BEVFusion's and DSVT's own tests build them at, where
# tiny_config() leaves them at the reference's (Swin-T over 256 x 704
# views, 192-channel set attention): their seeded draws on the CPU took
# ~100 of the file's worker-seconds in a six-worker pytest run
SMALL_BUILD = {"BEVFusion": ({}, dict(image_hw=(224, 448), swin_embed=8,
                                      swin_depths=(2, 2, 2, 2),
                                      swin_heads=(1, 2, 2, 4),
                                      out_indices=(1, 2, 3), fpn_channels=16,
                                      cam_bev_channels=8, fuse_channels=16,
                                      num_queries=16)),
               "DSVT": (dict(dsvt_channels=16, dsvt_heads=2,
                             dsvt_set_size=8), {})}


@pytest.mark.parametrize("name", sorted(set(DETECTORS) - {"VoxelNeXt"}))
def test_registry_names_wait_for_the_zoo(name):
    """The families not ported yet raise, naming the zoo's item; the
    ported ones (every registered name now) build, in eval mode."""
    cfg = tiny_config()
    if name in PORTED:
        det_over, opts = SMALL_BUILD.get(name, ({}, {}))
        det = build_detector(name, dataclasses.replace(
            cfg.model.voxelnext, **det_over), cfg.voxelize, device="cpu",
            **opts)
        assert type(det).__name__ == PORTED[name][1] and not det.training
        return
    with pytest.raises(NotImplementedError, match="queue 1, item 2"):
        build_detector(name, cfg.model.voxelnext, cfg.voxelize,
                       device="cpu")


def test_registry_matches_jax():
    assert sorted(DETECTORS) == sorted(JAX_DETECTORS)
    cfg = tiny_config()
    det = build_detector("VoxelNeXt", cfg.model.voxelnext, cfg.voxelize,
                         device="cpu")
    assert isinstance(det, VoxelNeXtDetector) and not det.training
    assert all(p.requires_grad for p in det.parameters())
    with pytest.raises(KeyError):
        build_detector("NoSuchNet", cfg.model.voxelnext, cfg.voxelize,
                       device="cpu")


def _jax_cli():
    spec = importlib.util.spec_from_file_location(
        "jax_train_detector_cli", REPO / "tools" / "train_detector.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_cli_trains_and_checkpoints(tmp_path, capsys):
    """Two synthetic steps on the CPU, a checkpoint at each: the log
    lines and final JSON, the JAX CLI's batch bit for bit, and the last
    checkpoint restored bit-equal into a new detector that detects as the
    trained one does."""
    out = tmp_path / "run"
    det, metrics = cli.main(["--synthetic", "--steps", "2", "--save-every",
                             "1", "--out", str(out), "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split()[0] for ln in lines[:2]] == ["[0]", "[1]"]
    assert all(" hm_loss " in ln and " reg_loss " in ln and
               ln.endswith(" ms") for ln in lines[:2])
    final = json.loads(lines[-1])
    assert final == {"steps": 2, "final_loss": metrics["loss"]}
    assert np.isfinite(final["final_loss"])
    ckpt = CheckpointManager(out / "checkpoints")
    assert [n for _, n in ckpt.available()] == ["step_1", "step_2"]
    assert (out / "checkpoints" / "step_2" / "config.json").exists()
    cfg = tiny_config()
    fresh = VoxelNeXtDetector(cfg.model.voxelnext, cfg.voxelize,
                              device="cpu", seed=5)
    ckpt.restore("step_2", fresh)
    for (n, a), (_, b) in zip(det.state_dict().items(),
                              fresh.state_dict().items()):
        assert torch.equal(a, b), n
    rng = np.random.default_rng(0)
    want = _jax_cli().synthetic_batch(np.random.default_rng(0), 1, 512, 8,
                                      cfg.voxelize.point_range)
    got = cli.synthetic_batch(rng, 1, 512, 8, cfg.voxelize.point_range)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
    pts = torch.from_numpy(got["points"][0])
    # every scored box through NMS, so that the comparison holds boxes
    for d in (det, fresh):
        d.det_cfg = dataclasses.replace(d.det_cfg, score_thresh=-1.0)
    a, b = det.detect(pts, 512), fresh.detect(pts, 512)
    assert int(a.count) > 0
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("argv", [
    ["--steps", "1"],
    ["--synthetic", "--detector", "MPPNetE2E"],
    ["--synthetic", "--detector", "MPPNet", "--steps", "2"]])
def test_cli_names_what_it_waits_for(argv, tmp_path, capsys):
    """Real data waits for the port's datasets; MPPNetE2E exits naming
    the JAX CLI's fault; MPPNet trains two steps on JAX's synthetic
    multi-frame batch and checkpoints."""
    args = argv + ["--out", str(tmp_path), "--device", "cpu"]
    if "--synthetic" not in argv:
        with pytest.raises(SystemExit, match="queue 1, item 2"):
            cli.main(args)
    elif "MPPNetE2E" in argv:
        with pytest.raises(SystemExit, match="TypeError"):
            cli.main(args)
    else:
        det, metrics = cli.main(args)
        lines = capsys.readouterr().out.strip().splitlines()
        assert type(det).__name__ == "MPPNetDetector"
        assert [ln.split()[0] for ln in lines[:2]] == ["[0]", "[1]"]
        assert "roi_cls_loss" in lines[0]
        assert json.loads(lines[-1])["steps"] == 2
        assert np.isfinite(metrics["loss"]) and metrics["grad_norm"] > 0
        assert (tmp_path / "checkpoints" / "step_2").is_dir()


def test_jax_cli_cannot_train_mppnet_e2e():
    """Reference trait, pinned (ROADMAP.md queue 3): the JAX CLI's
    `run_mppnet` inits every MPPNet-like family with MPPNet's call, which
    MPPNetE2E refuses (its call takes the bank first), so JAX cannot train
    it; the port's CLI exits on it instead. Its synthetic batch is the
    port's bit for bit."""
    import argparse
    from lvv_tpu.config import tiny_config as jax_tiny_config
    from lvv_tpu.models.registry import build_detector as jax_build
    mod = _jax_cli()
    jcfg = jax_tiny_config()
    args = argparse.Namespace(synthetic=True, batch=1, lr=1e-3, steps=1,
                              log_every=1, save_every=0, out="unused")
    det = jax_build("MPPNetE2E", jcfg.model.voxelnext, jcfg.voxelize)
    with pytest.raises(TypeError, match="proposals"):
        mod.run_mppnet(args, jcfg, det, np.random.default_rng(0))
    want = mod.synthetic_mppnet_batch(np.random.default_rng(0), 2, 4, 64, 8,
                                      32, jcfg.voxelize.point_range)
    got = cli.synthetic_mppnet_batch(np.random.default_rng(0), 2, 4, 64, 8,
                                     32, jcfg.voxelize.point_range)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize("option", [
    ["--tiny"], ["--augment"], ["--max-gt", "64"], ["--cbgs"],
    ["--dataroot", "/data"]])
def test_cli_refuses_real_data_options(option):
    """The JAX CLI's real-data options wait with that mode: argparse
    refuses them rather than letting --synthetic ignore them."""
    with pytest.raises(SystemExit) as exc:
        cli.parse_args(["--synthetic"] + option)
    assert exc.value.code == 2


def test_eval_callers_stay_graph_free_and_equal(runs):
    """The detector is built in eval mode: a forward with autograd on
    gives the same values as under no_grad (as the eval callers run), and
    detect() runs the eval form whatever the mode, leaving it as it
    was."""
    r = runs("bn")
    _, _, pdet, pvox = configs("tiny", "bn")
    det = VoxelNeXtDetector(pdet, pvox, device="cpu")
    det.load_state_dict(from_jax_detector_params(r["tree"], pdet, pvox,
                                                 device="cpu"))
    pts = torch.from_numpy(cloud(pvox, 1500))
    with torch.no_grad():
        quiet = det(pts, 1500)
    graph = det(pts, 1500)
    assert graph["bev_dense"].requires_grad
    assert not quiet["bev_dense"].requires_grad
    assert torch.equal(graph["bev_dense"].detach(), quiet["bev_dense"])
    stats = {n: b.clone() for n, b in det.named_buffers()}
    want = det.detect(pts, 1500)
    det.train()
    got = det.detect(pts, 1500)
    assert det.training
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(torch.equal(b, stats[n]) for n, b in det.named_buffers())
    # the train form moves the running statistics by the momentum
    with torch.no_grad():
        det(pts, 1500)
    assert not any(torch.equal(b, stats[n]) for n, b in det.named_buffers())


def _readings(norm="bn"):
    """The readings the module's docstring quotes: each step's loss and
    grad_norm of JAX in float32 and float64 and of the port in float32 and
    float64, and the largest parameter gap after STEPS steps (the elements
    held to the bound) between each pair.

        PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_detector_train.py
    """
    r = _run(norm)
    p64 = r["port64"]
    _, first, _, least, final = r["jax"]
    metrics = {"jax32": r["jax"][0], "jax64": r["jax64"][0],
               "port32": r["port"][0], "port64": p64[0]}
    for i in range(STEPS):
        print(f"{norm} step {i + 1}: " + "; ".join(
            f"{k} loss {m[i]['loss']:.7f} grad_norm {m[i]['grad_norm']:.7f}"
            for k, m in metrics.items()))
    params = {"jax32": final, "jax64": r["jax64"][1],
              "port32": {n: p.detach().numpy()
                         for n, p in r["port"][3].named_parameters()},
              "port64": {n: p.detach().numpy()
                         for n, p in p64[3].named_parameters()}}
    for a, b in (("port32", "jax32"), ("jax32", "jax64"), ("port32", "jax64"),
                 ("port64", "jax64"), ("port32", "port64")):
        worst = max((kept, name) for name, kept, _, zero, _, _ in
                    _param_gaps(params[a], params[b], first, least)
                    if not zero)
        print(f"{norm} parameters after {STEPS} steps, {a} vs {b}: "
              f"{worst[0]:.3g} ({worst[1]})")


if __name__ == "__main__":
    _readings()
