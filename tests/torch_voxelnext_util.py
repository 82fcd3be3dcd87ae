"""Shared set-up of the VoxelNeXt parity tests (tests/test_torch_voxelnext*.py):
one seeded JAX parameter tree per grid (every leaf random; the heatmap
bias raised to +1 and the size bias to 1.5, so that the decode keeps boxes
that overlap and NMS suppresses some), run through JAX's detector (XLA on
the CPU, op by op) and, converted by `from_jax_detector_params`, through
the port's, in either norm mode ("bn" with random running statistics).
The grids: the tiny config's 16 x 16 x 8, and 64 x 64 x 16 with capacities
that truncate at the voxelizer and at every stage. Held: every stage's
active ids exactly, the dense BEV within BEV_REL_L2, the detections' count
and labels exactly, their boxes and scores within BOX_TOL."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from lvv_tpu.config import tiny_config as jax_tiny_config
from lvv_tpu.models.voxelnext import VoxelNeXtDetector as JaxDetector
from lvv_tpu.models.voxelnext import decode_detections as jax_decode
from lvv_tpu_torch import tiny_config
from lvv_tpu_torch.convert import from_jax_detector_params
from lvv_tpu_torch.models.voxelnext import VoxelNeXtDetector, decode_detections

BEV_REL_L2 = 1e-5
BOX_TOL = 1e-4
# grid -> (voxelize overrides, voxelnext overrides, points in the cloud)
CASES = {
    "tiny": ({}, {}, 1500),
    "mid": (dict(point_range=(-16.0, -16.0, -4.0, 16.0, 16.0, 4.0),
                 voxel_size=(0.5, 0.5, 0.5), max_points=6000,
                 max_voxels=900),
            dict(capacity_schedule=(700, 250, 60, 12, 3)), 5000),
}


def configs(grid: str, norm: str):
    """(JAX voxelnext, JAX voxelize, port voxelnext, port voxelize)."""
    vox, det, _ = CASES[grid]
    out = []
    for cfg in (jax_tiny_config(), tiny_config()):
        out += [dataclasses.replace(cfg.model.voxelnext, norm=norm, **det),
                dataclasses.replace(cfg.voxelize, **vox)]
    return out


def cloud(vox_cfg, n: int, seed: int = 0) -> np.ndarray:
    """Seeded clusters over the range (a few points outside it),
    zero-padded to max_points."""
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


def _tree(shapes, seed: int):
    """Random leaves for the detector's variables, scaled like trained
    ones."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        x = rng.standard_normal(s.shape).astype(np.float32)
        if name.endswith("kernel"):
            return x / np.sqrt(np.prod(s.shape[:-1]))
        if name == "ln_scale":
            return 1 + 0.1 * x
        if name == "var":
            return 1 + 0.5 * np.abs(x)
        if name == "hm_head_bias":
            return 1.0 + 0.1 * x
        if name == "dim_head_bias":
            return 1.5 + 0.1 * x
        return 0.1 * x
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def make_runs(grid: str):
    """norm -> the JAX run and the port's on one converted tree of `grid`
    (the "bn" variables are the "ln" ones plus batch_stats)."""
    made = {}

    def get(norm):
        if norm in made:
            return made[norm]
        jdet, jvox, pdet, pvox = configs(grid, norm)
        n = CASES[grid][2]
        pts = cloud(jvox, n)
        jm = JaxDetector(jdet, jvox)
        if "bn" not in made and "ln" not in made:
            bn = dataclasses.replace(jdet, norm="bn")
            shapes = jax.eval_shape(JaxDetector(bn, jvox).init,
                                    jax.random.PRNGKey(0), jnp.asarray(pts),
                                    jnp.int32(n))
            made["tree"] = _tree(dict(shapes), seed=1)
        variables = dict(made["tree"])
        if norm == "ln":
            variables.pop("batch_stats")
        out, inter = jm.apply(variables, jnp.asarray(pts), jnp.int32(n),
                              capture_intermediates=True,
                              mutable=["intermediates"])
        dets = jax_decode(out["preds"], jdet, jvox, jdet.spatial_stride)
        bb = inter["intermediates"]["backbone"]
        stages = {f"stage{i}": bb[f"res{i}"]["__call__"][0]
                  for i in range(1, 7)}
        stages["bev"] = bb["shared_conv"]["__call__"][0]
        pm = VoxelNeXtDetector(pdet, pvox, device="cpu")
        pm.load_state_dict(from_jax_detector_params(variables, pdet, pvox,
                                                    device="cpu"))
        trace = []
        with torch.no_grad():
            got = pm(torch.from_numpy(pts), n, trace=trace)
            got_dets = decode_detections(got["preds"], pdet, pvox,
                                         pdet.spatial_stride)
        made[norm] = dict(jax=(out, dets, stages, variables),
                          port=(got, got_dets, dict(trace), pm),
                          cloud=(pts, n), cfg=(pdet, pvox))
        return made[norm]
    return get


def check_detector(r) -> None:
    """The port's run against JAX's: stage ids, dense BEV, detections, and
    detect() against the forward's decode."""
    out, dets, stages, _ = r["jax"]
    got, got_dets, trace, pm = r["port"]
    for name, st in stages.items():
        np.testing.assert_array_equal(trace[name].ids.numpy(),
                                      np.asarray(st.ids), err_msg=name)
    want = np.asarray(out["bev_dense"])
    bev = got["bev_dense"].numpy()
    assert bev.shape == want.shape
    assert np.linalg.norm(bev - want) / np.linalg.norm(want) <= BEV_REL_L2
    count = int(dets.count)
    assert int(got_dets.count) == count and count > 1
    np.testing.assert_array_equal(got_dets.labels.numpy(),
                                  np.asarray(dets.labels))
    np.testing.assert_allclose(got_dets.boxes.numpy()[:count],
                               np.asarray(dets.boxes)[:count], rtol=BOX_TOL,
                               atol=BOX_TOL)
    np.testing.assert_allclose(got_dets.scores.numpy(),
                               np.asarray(dets.scores), rtol=BOX_TOL,
                               atol=BOX_TOL)
    # detect() is the forward without the dense map, then the decode
    again = pm.detect(*map(torch.as_tensor, r["cloud"]))
    assert torch.equal(again.boxes, got_dets.boxes)
