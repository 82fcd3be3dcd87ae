"""The port's VoxelNeXt targets and losses against the JAX package's, on the
CPU (lvv_tpu_torch/models/voxelnext_loss.py vs lvv_tpu/models/
voxelnext_loss.py).

A seeded sparse BEV map (a 24 x 20 grid at stride 2 of 0.5 m voxels, 64
slots) with gts placed to reach every branch of the assigner: classes out
of range (clipped), a masked gt, a gt far from every site (unassigned; it
writes a zero row to the last slot), and two gts whose nearest site is the
same. "padded" leaves the last 14 slots empty; "full" fills every slot and
puts the shared site at the last one, where the unassigned gt writes after
them. Where gts write one site's regression row, JAX on the CPU keeps the
last writer; the port keeps it by construction, on the CPU and on the card.
Targets exact or within 1e-6; every loss term within 1e-5 relative; the
loss's gradient with respect to the head's outputs within 1e-5.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lvv_tpu.config import tiny_config as jax_tiny_config
from lvv_tpu.ops.sparse import SparseTensor as JaxSparse
from lvv_tpu_torch import tiny_config
from lvv_tpu_torch.models.voxelnext_loss import _scatter_last
from lvv_tpu_torch.ops.sparse import SENTINEL, SparseTensor
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.fast

# the modules (each package's models/__init__ may export a function of
# the same name)
J = importlib.import_module("lvv_tpu.models.voxelnext_loss")
P = importlib.import_module("lvv_tpu_torch.models.voxelnext_loss")

TGT_TOL = 1e-6
LOSS_TOL = 1e-5
GRID, V, STRIDE = (24, 20, 1), 64, 2
VOX = dict(point_range=(-6.0, -5.0, -3.0, 6.0, 5.0, 1.0),
           voxel_size=(0.5, 0.5, 0.5))
CHANNELS = {"hm": 3, "center": 2, "center_z": 1, "dim": 3, "rot": 2}


def _cfgs():
    """(JAX det, JAX vox, port det, port vox)."""
    out = []
    for cfg in (jax_tiny_config(), tiny_config()):
        out += [cfg.model.voxelnext,
                dataclasses.replace(cfg.voxelize, **VOX)]
    return out


def _case(kind: str, seed: int = 0):
    """(ids [V] int32, gt_boxes [12, 9], gt_labels [12], gt_mask [12])."""
    rng = np.random.default_rng(seed)
    n_valid = V if kind == "full" else V - 14
    cells = np.sort(rng.choice(GRID[0] * GRID[1], n_valid, replace=False))
    ids = np.full(V, SENTINEL, np.int64)
    ids[:n_valid] = cells
    x0, y0 = VOX["point_range"][:2]
    unit = VOX["voxel_size"][0] * STRIDE

    def centre_of(cell, dx, dy):
        return (x0 + (cell % GRID[0] + dx) * unit,
                y0 + (cell // GRID[0] + dy) * unit)
    boxes = np.zeros((12, 9), np.float32)
    boxes[:, 3:6] = rng.uniform(0.6, 4.0, (12, 3))
    boxes[:, 2] = rng.uniform(-2, 0, 12)
    boxes[:, 6] = rng.uniform(-np.pi, np.pi, 12)
    boxes[:, 7:] = rng.normal(0, 1, (12, 2))
    for g in range(8):
        boxes[g, :2] = rng.uniform((x0, y0), (-x0, -y0))
    # gts 8 and 9 nearest to one site: the last valid one in "full"
    shared = cells[-1] if kind == "full" else cells[n_valid // 2]
    boxes[8, :2] = centre_of(shared, 0.1, 0.2)
    boxes[9, :2] = centre_of(shared, -0.2, 0.1)
    boxes[10, :2] = (60.0, 60.0)                  # far from every site
    boxes[11, :2] = boxes[0, :2]                  # masked out
    labels = np.array([0, 1, 2, 5, -1, 0, 1, 2, 1, 2, 0, 1], np.int32)
    mask = np.ones(12, bool)
    mask[11] = False
    return ids.astype(np.int32), boxes, labels, mask, int(
        np.searchsorted(cells, shared))


def _targets(kind: str):
    jdet, jvox, pdet, pvox = _cfgs()
    ids, boxes, labels, mask, shared = _case(kind)
    feats = np.zeros((V, 1), np.float32)
    want = J.assign_targets(
        JaxSparse(jnp.asarray(ids), jnp.asarray(feats), GRID),
        jnp.asarray(boxes), jnp.asarray(labels), jnp.asarray(mask), jdet,
        jvox, STRIDE)
    got = P.assign_targets(
        SparseTensor(torch.from_numpy(ids), torch.from_numpy(feats), GRID),
        torch.from_numpy(boxes), torch.from_numpy(labels),
        torch.from_numpy(mask), pdet, pvox, STRIDE)
    return ({k: np.asarray(v) for k, v in want.items()},
            {k: v.numpy() for k, v in got.items()}, boxes, shared)


@pytest.mark.parametrize("kind", ["padded", "full"])
def test_assign_targets_match_jax(kind):
    want, got, _, _ = _targets(kind)
    np.testing.assert_array_equal(got["reg_mask"], want["reg_mask"])
    for key in ("hm", "reg"):
        np.testing.assert_allclose(got[key], want[key], rtol=TGT_TOL,
                                   atol=TGT_TOL, err_msg=key)
    assert (want["hm"] == 1).sum() >= 5         # centre sites pinned to 1


def test_two_gts_one_site_keeps_the_last_writer():
    """Gts 8 and 9 share a centre site: its row is gt 9's in both."""
    want, got, boxes, site = _targets("padded")
    assert want["reg_mask"][site] and got["reg_mask"][site]
    np.testing.assert_allclose(got["reg"][site, 2:], want["reg"][site, 2:],
                               rtol=TGT_TOL, atol=TGT_TOL)
    np.testing.assert_allclose(got["reg"][site, 2], boxes[9, 2], rtol=1e-6)


def test_unassigned_gt_overwrites_the_last_slot():
    """The reference trait at the last slot: gts 8 and 9 are centred
    there, then gt 10 (no site near it) writes its zero row and False
    mask last, so neither keeps a regression target."""
    want, got, _, site = _targets("full")
    assert site == V - 1
    assert not want["reg_mask"][site] and not got["reg_mask"][site]
    assert not got["reg"][site].any()


def test_scatter_last_keeps_the_highest_writer():
    rng = np.random.default_rng(3)
    index = rng.integers(0, 9, 200)
    values = rng.normal(size=(200, 3)).astype(np.float32)
    want = np.zeros((11, 3), np.float32)
    for g in range(200):
        want[index[g]] = values[g]
    got = _scatter_last(11, torch.from_numpy(index),
                        torch.from_numpy(values))
    np.testing.assert_array_equal(got.numpy(), want)
    jax_got = jnp.zeros((11, 3)).at[jnp.asarray(index)].set(
        jnp.asarray(values))
    np.testing.assert_array_equal(np.asarray(jax_got), want)


def test_gaussian_radius_matches_jax():
    rng = np.random.default_rng(1)
    dx, dy = rng.uniform(0.05, 12, (2, 300)).astype(np.float32)
    want = np.asarray(J.gaussian_radius(jnp.asarray(dx), jnp.asarray(dy)))
    got = P.gaussian_radius(torch.from_numpy(dx), torch.from_numpy(dy))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def _preds(seed: int = 2):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(0, 1.5, (V, c)).astype(np.float32)
            for k, c in CHANNELS.items()}


def _sparse_losses(kind: str):
    """JAX's and the port's voxelnext_loss terms, and each one's gradient
    with respect to the head outputs."""
    jdet, jvox, pdet, pvox = _cfgs()
    ids, boxes, labels, mask, _ = _case(kind)
    preds = _preds()
    jbev = JaxSparse(jnp.asarray(ids), jnp.zeros((V, 1)), GRID)

    def jax_loss(feats):
        jp = {k: JaxSparse(jbev.ids, f, GRID) for k, f in feats.items()}
        return J.voxelnext_loss(jp, jbev, jnp.asarray(boxes),
                                jnp.asarray(labels), jnp.asarray(mask), jdet,
                                jvox, STRIDE)
    (_, jaux), jgrad = jax.value_and_grad(jax_loss, has_aux=True)(
        {k: jnp.asarray(v) for k, v in preds.items()})
    tids = torch.from_numpy(ids)
    feats = {k: torch.from_numpy(v).requires_grad_() for k, v in
             preds.items()}
    pbev = SparseTensor(tids, torch.zeros((V, 1)), GRID)
    loss, paux = P.voxelnext_loss(
        {k: SparseTensor(tids, f, GRID) for k, f in feats.items()}, pbev,
        torch.from_numpy(boxes), torch.from_numpy(labels),
        torch.from_numpy(mask), pdet, pvox, STRIDE)
    loss.backward()
    return jaux, jgrad, paux, {k: f.grad for k, f in feats.items()}


@pytest.mark.parametrize("kind", ["padded", "full"])
def test_voxelnext_loss_matches_jax(kind):
    jaux, jgrad, paux, pgrad = _sparse_losses(kind)
    for key in ("hm_loss", "reg_loss", "loss"):
        np.testing.assert_allclose(paux[key].item(), float(jaux[key]),
                                   rtol=LOSS_TOL, err_msg=key)
    for key, g in pgrad.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(jgrad[key]),
                                   rtol=LOSS_TOL, atol=LOSS_TOL, err_msg=key)


def test_loss_terms_alone_match_jax():
    """gaussian_focal_loss and reg_l1_loss (with code weights) on the
    targets that each package assigned."""
    want, got, _, _ = _targets("padded")
    preds = _preds(5)
    ids = _case("padded")[0]
    valid = ids != SENTINEL
    jfocal = J.gaussian_focal_loss(jnp.asarray(preds["hm"]),
                                   jnp.asarray(want["hm"]),
                                   jnp.asarray(valid))
    pfocal = P.gaussian_focal_loss(torch.from_numpy(preds["hm"]),
                                   torch.from_numpy(got["hm"]),
                                   torch.from_numpy(valid))
    np.testing.assert_allclose(float(pfocal), float(jfocal), rtol=LOSS_TOL)
    weights = [1.0, 1.0, 1.0, 0.5, 0.5, 0.5, 0.2, 0.2]
    jreg = J.reg_l1_loss(
        {k: JaxSparse(jnp.asarray(ids), jnp.asarray(v), GRID)
         for k, v in preds.items()},
        {k: jnp.asarray(v) for k, v in want.items()}, weights)
    preg = P.reg_l1_loss(
        {k: SparseTensor(torch.from_numpy(ids), torch.from_numpy(v), GRID)
         for k, v in preds.items()},
        {k: torch.from_numpy(v) for k, v in got.items()}, weights)
    np.testing.assert_allclose(float(preg), float(jreg), rtol=LOSS_TOL)


@pytest.mark.parametrize("stride", [None, 4])
def test_dense_center_loss_matches_jax(stride):
    """Dense [C, 10, 12] maps: the all-active assigner, focal and L1."""
    jdet, jvox, pdet, pvox = _cfgs()
    _, boxes, labels, mask, _ = _case("padded")
    rng = np.random.default_rng(4)
    preds = {k: rng.normal(0, 1.5, (c, 10, 12)).astype(np.float32)
             for k, c in CHANNELS.items()}
    jl, jaux = J.dense_center_loss(
        {k: jnp.asarray(v) for k, v in preds.items()}, jnp.asarray(boxes),
        jnp.asarray(labels), jnp.asarray(mask), jdet, jvox, stride)
    pl, paux = P.dense_center_loss(
        {k: torch.from_numpy(v) for k, v in preds.items()},
        torch.from_numpy(boxes), torch.from_numpy(labels),
        torch.from_numpy(mask), pdet, pvox, stride)
    for key in ("hm_loss", "reg_loss", "loss"):
        np.testing.assert_allclose(paux[key].item(), float(jaux[key]),
                                   rtol=LOSS_TOL, err_msg=key)
    assert float(paux["reg_loss"]) > 0
