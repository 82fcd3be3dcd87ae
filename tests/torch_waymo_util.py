"""Shared set-up of the Waymo detector parity tests
(tests/test_torch_pillarnet_vfe.py, tests/test_torch_dsvt.py): one seeded
JAX parameter tree per family (`torch_zoo_util.random_tree`: leaves
scaled like trained ones, the heatmap bias raised so that the decodes keep
boxes), run through JAX's detector (one jit with the decode) and,
converted by `from_jax_detector_params`, through the port's, on one seeded
cloud; and three steps of the train CLI's chain (clip by global norm 10,
AdamW at warmup_cosine_decay_schedule(lr / 10, lr, 1, 3)) on each side at
batch 2, JAX's jit'd `make_detector_train_step` against the port's, with
every ReLU gate of JAX's steps replayed in the port's (`jax_gates`,
`port_gates`): a ReLU input within float32 rounding of 0 (read on
PillarNet's second cloud: |x| = 1.1e-7 of its layer's largest, at
res3a.conv1) takes its gate from the rounding, and one such gate moved
every gradient below it by ~4e-3 at these widths. The gates the port
would have taken otherwise are counted and must be few.

Geometry, at tiny widths so that each file builds and compiles each JAX
detector once for its forward and once for its train step:
- PillarNet on tiny_config()'s range at 0.25 m pillars (64 x 64; the
  stride-8 map is 8 x 8, where tiny_config()'s 1 m gives 2 x 2);
- DSVT in its progressive ("voxel") form on tiny_config()'s 16 x 16 x 8
  grid: 16 channels, 2 heads, sets of 8, two stages of one block at
  windows (8, 4, 4) and (2, 4, 4) with ZPoolAttention by 4 between, a
  two-level residual BEV trunk (its single-stage form is held at module
  level in tests/test_torch_dsvt.py).

Tolerances: fp32 forward 1e-5 relative L2; detections equal in count and
labels, boxes and scores within 1e-4; a step's loss and terms within 1e-5
relative, its grad_norm within 1e-4; step 1's gradient of each parameter
within 1e-4 relative L2; every parameter after three steps within 1e-5,
except elements whose gradient sat at float32 noise (under 1e-6 of the
tensor's largest |g|) at some step, which Adam moves by about ±lr whatever
the sign's source, held to the most two Adam stacks can move apart,
2·Σ lr (read: 5 such elements of PillarNet's 4.05M beyond 1e-5, none of
DSVT's 81k; at most 1e-4 of them may be). A gradient under 1e-6 of the
global norm is analytically zero (the attention's key bias: a constant
added to every key's logit) and float32 noise on both sides: held within
1e-6 of the global norm, its parameters within 2·Σ lr.
"""
from __future__ import annotations

import contextlib
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from lvv_tpu.config import tiny_config as jax_tiny_config
from lvv_tpu.models.pointpillars import decode_dense
from lvv_tpu.models.registry import build_detector as jax_build
from lvv_tpu.train import detector as jax_train
from lvv_tpu_torch import tiny_config
from lvv_tpu_torch.convert import from_jax_detector_params
from lvv_tpu_torch.convert.params import _flatten
from lvv_tpu_torch.models.registry import build_detector
from lvv_tpu_torch.train import detector as port_train
from lvv_tpu_torch.train.optim import (detector_optimizer,
                                       warmup_cosine_decay_schedule)
from torch_zoo_util import cloud, random_tree, rel_l2  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parents[1]
FWD_REL_L2 = 1e-5
BOX_ABS = 1e-4
METRIC_TOL = 1e-5
GRAD_NORM_TOL = 1e-4
GRAD_REL_L2 = 1e-4
PARAM_TOL = 1e-5
NOISE = 1e-6                # of a tensor's largest |g|: float32 noise level
ZERO_GRAD = 1e-6            # of the global norm: an analytically zero grad
OWN_GATES = 16              # gates the port would take otherwise, at most
NOISE_APART = 1e-4          # of all elements: noise elements beyond PARAM_TOL
LR, STEPS = 1e-3, 3
N_POINTS = 1500

# DSVT in its progressive ("voxel") form at tiny widths: two stages of one
# block joined by ZPoolAttention, a two-level residual BEV trunk
DSVT_TINY = dict(dsvt_channels=16, dsvt_blocks=2, dsvt_heads=2,
                 dsvt_window=(8, 4, 4), dsvt_set_size=8,
                 dsvt_stage_blocks=(1, 1),
                 dsvt_stage_windows=((8, 4, 4), (2, 4, 4)),
                 dsvt_downsample=(4,), dsvt_bev_channels=(16, 32),
                 dsvt_bev_strides=(1, 2), dsvt_bev_nums=(1, 1),
                 dsvt_bev_upsample=(16, 16))
# case -> (registry name, voxelnext overrides, voxelize overrides)
CASES = {"PillarNet": ("PillarNet", {}, dict(voxel_size=(0.25, 0.25,
                                                         0.5))),
         "DSVT": ("DSVT", DSVT_TINY, {})}


def configs(case: str):
    """(JAX voxelnext, JAX voxelize, port voxelnext, port voxelize)."""
    _, det, vox = CASES[case]
    out = []
    for cfg in (jax_tiny_config(), tiny_config()):
        out += [dataclasses.replace(cfg.model.voxelnext, **det),
                dataclasses.replace(cfg.voxelize, **vox)]
    return out


def decode_stride(case: str, det_cfg) -> int:
    return det_cfg.spatial_stride if case == "PillarNet" else 1


def batch(pvox) -> dict:
    """Two clouds with 8 gts each (two masked in the second), gts inside
    the range."""
    rng = np.random.default_rng(5)
    pts = np.stack([cloud(pvox, N_POINTS, seed=s) for s in (0, 1)])
    lo, hi = pvox.point_range[0] * 0.7, pvox.point_range[3] * 0.7
    boxes = np.zeros((2, 8, 9), np.float32)
    boxes[..., :2] = rng.uniform(lo, hi, (2, 8, 2))
    boxes[..., 2] = -1.0
    boxes[..., 3:6] = rng.uniform(1.0, 4.0, (2, 8, 3))
    boxes[..., 6] = rng.uniform(-np.pi, np.pi, (2, 8))
    mask = np.ones((2, 8), bool)
    mask[1, 6:] = False
    return {"points": pts,
            "num_points": np.array([N_POINTS, N_POINTS - 300], np.int32),
            "gt_boxes": boxes,
            "gt_labels": rng.integers(0, 3, (2, 8)).astype(np.int32),
            "gt_mask": mask}


def jax_chain():
    sched = optax.warmup_cosine_decay_schedule(
        LR / 10, LR, max(STEPS // 10, 1), STEPS)
    return optax.chain(optax.clip_by_global_norm(10.0), optax.adamw(sched))


def recording(inner):
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


@contextlib.contextmanager
def jax_gates(log: dict):
    """While JAX traces: each call of flax's nn.relu (site s, in trace
    order) sends its gate x > 0 to log[s] on every run (one call a sample
    under the step's vmap, in sample order)."""
    import flax.linen as fnn
    plain, sites = fnn.relu, [0]

    def relu(x):
        site, sites[0] = sites[0], sites[0] + 1
        jax.debug.callback(
            lambda g, s=site: log.setdefault(s, []).append(np.asarray(g)),
            x > 0, ordered=True)
        return plain(x)
    fnn.relu = relu
    try:
        yield
    finally:
        fnn.relu = plain


@contextlib.contextmanager
def port_gates(gates: list, own: list):
    """Every torch.relu in call order takes its gate from `gates` (4-D
    gates are JAX's NHWC maps, permuted to the port's NCHW): x · gate; the
    entries where x > 0 says otherwise are added to own[0]."""
    relu, calls = torch.relu, [0]

    def gated(x):
        i, calls[0] = calls[0], calls[0] + 1
        g = torch.from_numpy(np.array(gates[i]))
        if g.dim() == 4:                 # JAX's NHWC map, the port's NCHW
            g = g.permute(0, 3, 1, 2)
        assert g.shape == x.shape, (i, g.shape, x.shape)
        own[0] += int(((x.detach() > 0) != g).sum())
        return x * g.to(x.dtype)
    torch.relu = gated
    try:
        yield
    finally:
        torch.relu = relu
    assert calls[0] == len(gates), (calls[0], len(gates))


class Run:
    """One case's JAX and port detectors on one converted tree, their
    forwards on one cloud, and (`train`) three steps of each."""

    def __init__(self, case: str):
        self.case = case
        self.name = CASES[case][0]
        self.cfgs = jdet, jvox, pdet, pvox = configs(case)
        self.pts = cloud(jvox, N_POINTS)
        self.jm = jax_build(self.name, jdet, jvox)
        shapes = jax.eval_shape(self.jm.init, jax.random.PRNGKey(0),
                                jnp.asarray(self.pts), jnp.int32(N_POINTS))
        self.tree = random_tree(dict(shapes))
        self.state = from_jax_detector_params(self.tree, pdet, pvox,
                                              device="cpu",
                                              detector=self.name)
        self.pm = self.port_detector()
        self._train = None

    def port_detector(self):
        pm = build_detector(self.name, *self.cfgs[2:], device="cpu")
        pm.load_state_dict(self.state)
        return pm

    def jax_forward(self):
        """JAX's forward with its intermediates and its decode, in one
        jit."""
        jdet, jvox = self.cfgs[:2]
        stride = decode_stride(self.case, jdet)

        def run(tree, pts, n):
            out, inter = self.jm.apply(tree, pts, n,
                                       capture_intermediates=True,
                                       mutable=["intermediates"])
            dets = decode_dense(out["preds"], jdet, jvox, stride)
            return out, inter["intermediates"], dets
        return jax.jit(run)(self.tree, jnp.asarray(self.pts),
                            jnp.int32(N_POINTS))

    def port_forward(self, trace=None):
        pts = torch.from_numpy(self.pts)
        with torch.no_grad():
            out = self.pm(pts, N_POINTS, trace=trace)
        return out, self.pm.detect(pts, N_POINTS)

    def train(self):
        """Three steps on each side -> {"jax": (metrics, step-1 grads,
        least |g|, final params), "port": (metrics, step-1 grads, final
        params)}, by the port's names and in its layouts."""
        if self._train is None:
            self._train = self._steps()
        return self._train

    def _steps(self):
        jdet, jvox, pdet, pvox = self.cfgs
        b = batch(pvox)
        tx = recording(jax_chain())
        step = jax_train.make_detector_train_step(self.jm, tx, jdet, jvox)
        state = (self.tree, tx.init(self.tree["params"]))
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        j_metrics, log, gates = [], {}, []
        for i in range(STEPS):
            with jax_gates(log) if i == 0 else contextlib.nullcontext():
                state, m = step(state, jb)
            j_metrics.append({k: float(v) for k, v in m.items()})
            jax.effects_barrier()
            # this step's gates, sample 0's sites then sample 1's
            gates.append([log[s][2 * i + j] for j in range(2)
                          for s in sorted(log)])
        _, first, least, _ = state[1]

        def port_layout(tree):
            return {k: v.numpy() for k, v in from_jax_detector_params(
                {"params": jax.tree.map(np.asarray, tree)}, pdet, pvox,
                device="cpu", detector=self.name).items()}
        pm = self.port_detector()
        ptx = detector_optimizer(LR, STEPS)
        pstep = port_train.make_detector_train_step(pm, ptx, pdet, pvox)
        pstate = (pm, ptx.init(dict(pm.named_parameters())))
        p_metrics, own = [], [0]
        for i in range(STEPS):
            with port_gates(gates[i], own):
                pstate, m = pstep(pstate, b)
            p_metrics.append({k: float(v) for k, v in m.items()})
            if i == 0:
                grads1 = {n: None if p.grad is None else p.grad.numpy().copy()
                          for n, p in pm.named_parameters()}
        return {"jax": (j_metrics, port_layout(first), port_layout(least),
                        port_layout(state[0]["params"])),
                "port": (p_metrics, grads1,
                         {n: p.detach().numpy()
                          for n, p in pm.named_parameters()}),
                "start": {k: v.numpy() for k, v in self.state.items()},
                "own_gates": own[0],
                "relu_entries": sum(int(g.size) for g in gates[0])}


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


def check_train(r: dict, terms=("hm_loss", "reg_loss")) -> None:
    """The three steps' metrics (the loss, the family's `terms` and
    grad_norm), step 1's gradients and the final parameters at the
    tolerances above."""
    j_metrics, j_first, j_least, j_final = r["jax"]
    p_metrics, p_first, p_final = r["port"]
    for jm, pm in zip(j_metrics, p_metrics):
        assert set(pm) == set(jm) == {"loss", "grad_norm", *terms}
        for key, want in jm.items():
            np.testing.assert_allclose(
                pm[key], want, err_msg=key,
                rtol=GRAD_NORM_TOL if key == "grad_norm" else METRIC_TOL)
    assert p_metrics[-1]["loss"] < p_metrics[0]["loss"]
    assert r["own_gates"] <= OWN_GATES, (r["own_gates"], r["relu_entries"])
    total = np.sqrt(sum(float(np.sum(np.asarray(w, np.float64) ** 2))
                        for w in j_first.values()))
    zero = set()
    for name, w in j_first.items():
        g = p_first[name]
        if not w.any():
            assert g is None or not g.any(), name
            continue
        if np.linalg.norm(w) <= ZERO_GRAD * total:
            zero.add(name)
            assert np.linalg.norm(g - w) <= ZERO_GRAD * total, name
            continue
        assert rel_l2(g, w) <= GRAD_REL_L2, (name, rel_l2(g, w))
    sched = warmup_cosine_decay_schedule(LR / 10, LR, 1, STEPS)
    adam_apart = 2 * sum(sched(t) for t in range(STEPS)) * 1.01
    n_all = n_apart = 0
    for name, want in j_final.items():
        diff = np.abs(p_final[name].astype(np.float64) - want)
        if name in zero:
            assert diff.max() <= adam_apart, name
            continue
        noise = j_least[name] <= NOISE * np.abs(j_first[name]).max()
        assert diff[~noise].max(initial=0) <= PARAM_TOL, name
        assert diff[noise].max(initial=0) <= adam_apart, name
        assert not np.array_equal(want, r["start"][name]), name
        n_all += diff.size
        n_apart += int((diff[noise] > PARAM_TOL).sum())
    assert n_apart <= NOISE_APART * n_all, (n_apart, n_all)


def jax_module(module, *args):
    """(a random tree for the flax `module`, its jit'd apply on `args`);
    the args are closed over, so grids stay static."""
    tree = random_tree(dict(jax.eval_shape(
        lambda key: module.init(key, *args), jax.random.PRNGKey(0))))
    return tree, jax.jit(lambda t: module.apply(t, *args))(tree)


def port_module(cls, tree, *args, **kw):
    """The port's module `cls(*args, **kw)` on the CPU from a JAX params
    tree, by the converter's rules."""
    from lvv_tpu_torch.convert.params import _convert
    ref = cls(*args, device="meta", **kw)
    m = cls(*args, device="cpu", **kw)
    m.load_state_dict(_convert(_flatten(tree["params"]), ref,
                               torch.device("cpu")))
    return m
