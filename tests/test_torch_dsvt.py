"""The port's DSVT against the JAX package's, on the CPU.

- `window_coords` with and without the half-window shift, and with a
  window that spans the whole z extent (no z shift): ids and in-window
  coords equal.
- `rotated_set_partition` over the y- and x-sorted orders, with a
  `max_sets` that overflows into the dump row: (set_row, col, ok) equal,
  no live (row, col) written twice; JAX's pinned contract
  (tests/test_dsvt.py) on the port's tables.
- `plan_max_sets`: equal ints, JAX's scattered-lattice case included.
- `SetAttentionLayer` (with overflowing sets), `DSVTBlock` in both window
  phases, `ZPoolAttention` (on JAX's pinned oracle input), and
  `DSVTBackbone` single-stage and in two stages joined by one reduction,
  each from one random flax tree converted to the port: within 1e-5
  relative L2.
- The detector in its progressive form (`torch_waymo_util`): the VFE's
  voxels, the forward's BEV and head outputs within 1e-5 relative L2,
  every block's and reduction's ids equal, the detections; three train
  steps of JAX's `make_detector_train_step` against the port's with JAX's
  ReLU gates replayed (the tolerances in torch_waymo_util).
- The train CLI with `--synthetic` on configs/waymo_dsvt_pillar.json cut
  to tiny widths by --set: two steps, the fewest its schedule takes.

JAX runs in fp32 on the CPU; its attention takes its plain path here (36
or 48 keys, or a bias), as it does on the card.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lvv_tpu.models import dsvt as JD
from lvv_tpu.ops import sparse as JS
from lvv_tpu_torch.models import dsvt as PD
from lvv_tpu_torch.ops import sparse as PS
from lvv_tpu_torch.tools import train_detector as cli
from torch_waymo_util import (FWD_REL_L2, N_POINTS, REPO, Run,
                              check_detections, check_train, jax_module,
                              port_module, rel_l2)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.fast

GRID = (16, 16, 4)


def _sparse(rng, grid=GRID, n=40, c=8, cap=64):
    """The same seeded sparse tensor in JAX and in the port (tests/
    test_dsvt.py's `_sparse`)."""
    nx, ny, nz = grid
    lin = rng.choice(nx * ny * nz, size=n, replace=False)
    z, y, x = lin // (nx * ny), (lin // nx) % ny, lin % nx
    coords = np.full((cap, 3), -1, np.int32)
    coords[:n] = np.stack([z, y, x], 1)
    feats = np.zeros((cap, c), np.float32)
    feats[:n] = rng.normal(size=(n, c))
    return (JS.from_voxels(jnp.asarray(coords), jnp.asarray(feats), grid),
            PS.from_voxels(torch.from_numpy(coords), torch.from_numpy(feats),
                           grid))


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("window, shift", [((4, 4, 4), False),
                                           ((2, 4, 4), True),
                                           ((4, 8, 8), True)])
def test_window_coords_match_jax(window, shift):
    """(4, 8, 8) spans the grid's 4 z cells: no z shift, as JAX's."""
    jst, pst = _sparse(np.random.default_rng(0))
    jwid, jin = JD.window_coords(jst, window, shift)
    pwid, pin = PD.window_coords(pst, window, shift)
    _eq(pwid, jwid)
    _eq(pin, jin)
    valid = pst.valid
    inner = pin[valid]
    assert inner.min() >= 0 and (inner < torch.tensor(window)).all()
    if window[0] == GRID[2]:
        coords = PS.delinearize(pst.ids, pst.grid)
        assert torch.equal(pin[valid, 0], coords[valid, 0])


@pytest.mark.parametrize("axis", ["y", "x"])
@pytest.mark.parametrize("max_sets", [6, 64])
def test_rotated_set_partition_matches_jax(axis, max_sets):
    """max_sets 6 overflows (40 voxels in sets of 4 over 8 windows): the
    overflowing sets and the invalid slots go to the dump row 6."""
    jst, pst = _sparse(np.random.default_rng(1))
    window = (4, 4, 4)
    jwid, jin = JD.window_coords(jst, window, False)
    pwid, pin = PD.window_coords(pst, window, False)
    want = JD.rotated_set_partition(jwid, jin, jst.valid, window, 4,
                                    max_sets, axis)
    got = PD.rotated_set_partition(pwid, pin, pst.valid, window, 4,
                                   max_sets, axis)
    for g, w in zip(got, want):
        _eq(g, w)
    row, col, ok = got
    valid = pst.valid
    live = (row[ok].long() * 4 + col[ok].long()).tolist()
    assert len(set(live)) == len(live)              # no live slot twice
    assert (row[~ok] == max_sets).all()
    if max_sets == 6:
        assert (valid & ~ok).any() and (row[ok] < 6).all()
    else:                        # JAX's pinned contract: nothing dropped
        assert torch.equal(ok, valid)
        for r in row[ok].unique():
            assert pwid[ok & (row == r)].unique().numel() == 1


def test_rotated_sets_differ_by_axis():
    jst, pst = _sparse(np.random.default_rng(2))
    wid, inner = PD.window_coords(pst, (4, 4, 4), False)
    y = PD.rotated_set_partition(wid, inner, pst.valid, (4, 4, 4), 4, 64,
                                 "y")
    x = PD.rotated_set_partition(wid, inner, pst.valid, (4, 4, 4), 4, 64,
                                 "x")
    same = (y[0] == x[0]) & (y[1] == x[1])
    assert not same[pst.valid].all()


@pytest.mark.parametrize("window, set_size, bucket",
                         [((4, 4, 4), 4, 1), ((2, 8, 8), 8, 16),
                          ((4, 4, 4), 32, 1024)])
def test_plan_max_sets_matches_jax(window, set_size, bucket):
    ids = np.asarray(_sparse(np.random.default_rng(3), n=50)[1].ids)
    want = JD.plan_max_sets(ids, GRID, window, set_size, bucket)
    assert PD.plan_max_sets(ids, GRID, window, set_size, bucket) == want
    assert PD.plan_max_sets(np.full(8, PS.SENTINEL), GRID, window,
                            set_size, bucket) == bucket


def test_plan_max_sets_covers_a_scattered_lattice():
    """JAX's pinned case: one voxel a window needs one set a window, more
    than ceil(V / set_size) · 2; at the planned capacity nothing drops."""
    grid, window, set_size = (64, 64, 4), (4, 8, 8), 32
    yx = np.stack(np.meshgrid(np.arange(0, 64, 8), np.arange(0, 64, 8),
                              indexing="ij"), -1).reshape(-1, 2)
    ids = np.full(128, PS.SENTINEL, np.int64)
    ids[:64] = yx[:, 0] * 64 + yx[:, 1]
    planned = PD.plan_max_sets(ids, grid, window, set_size, bucket=1)
    assert planned == JD.plan_max_sets(ids, grid, window, set_size, 1)
    assert planned >= 64 > -(-128 // set_size) * 2
    st = PS.SparseTensor(torch.from_numpy(ids.astype(np.int32)),
                         torch.zeros(128, 8), grid)
    for shift in (False, True):
        wid, inner = PD.window_coords(st, window, shift)
        for axis in ("y", "x"):
            _, _, ok = PD.rotated_set_partition(wid, inner, st.valid, window,
                                                set_size, planned, axis)
            assert int(ok.sum()) == 64


def test_set_attention_layer_matches_jax():
    """Over overflowing y-sorted sets (max_sets 6): the dump row's
    repeated zero writes leave the live sets as JAX's."""
    jst, pst = _sparse(np.random.default_rng(4), c=16)
    window, max_sets, set_size = (4, 4, 4), 6, 4
    jwid, jin = JD.window_coords(jst, window, True)
    jt = JD.rotated_set_partition(jwid, jin, jst.valid, window, set_size,
                                  max_sets, "y")
    pwid, pin = PD.window_coords(pst, window, True)
    pt = PD.rotated_set_partition(pwid, pin, pst.valid, window, set_size,
                                  max_sets, "y")
    pos = np.random.default_rng(5).normal(size=(64, 16)).astype(np.float32)
    jm = JD.SetAttentionLayer(num_heads=2)
    tree, want = jax_module(jm, jst.features, jnp.asarray(pos), *jt, max_sets,
                      set_size)
    pm = port_module(PD.SetAttentionLayer, tree, 16, 2)
    got = pm(pst.features, torch.from_numpy(pos), *pt, max_sets, set_size)
    assert rel_l2(got.detach(), want) <= FWD_REL_L2


@pytest.mark.parametrize("shift", [False, True])
def test_dsvt_block_matches_jax(shift):
    jst, pst = _sparse(np.random.default_rng(6), c=16)
    kw = dict(window=(4, 4, 4), set_size=4, max_sets=64, shift=shift)
    jm = JD.DSVTBlock(num_heads=2, **kw)
    tree, want = jax_module(jm, jst)
    pm = port_module(PD.DSVTBlock, tree, 16, 2, **kw)
    with torch.no_grad():
        got = pm(pst)
    _eq(got.ids, want.ids)
    assert rel_l2(got.features, want.features) <= FWD_REL_L2
    assert not got.features[~pst.valid].any()


def test_zpool_attention_matches_jax():
    """tests/test_dsvt.py's oracle input: 20 voxels of a 4 x 3 x 8 grid
    (holes inside z groups) and 6 empty slots, pooled by 4 over z."""
    nx, ny, nz, c, stride = 4, 3, 8, 16, 4
    r = np.random.default_rng(0)
    ids = np.sort(np.concatenate([r.permutation(nx * ny * nz)[:20],
                                  np.full(6, PS.SENTINEL)])).astype(np.int32)
    feats = r.normal(size=(26, c)).astype(np.float32)
    feats[ids == PS.SENTINEL] = 0
    jst = JS.SparseTensor(jnp.asarray(ids), jnp.asarray(feats), (nx, ny, nz))
    pst = PS.SparseTensor(torch.from_numpy(ids), torch.from_numpy(feats),
                          (nx, ny, nz))
    jm = JD.ZPoolAttention(stride=stride, num_heads=4)
    tree, want = jax_module(jm, jst)
    pm = port_module(PD.ZPoolAttention, tree, c, stride, 4)
    with torch.no_grad():
        got = pm(pst)
    assert got.grid == tuple(want.grid) == (nx, ny, 2)
    _eq(got.ids, want.ids)
    assert rel_l2(got.features, want.features) <= FWD_REL_L2
    assert not got.features[~got.valid].any()


@pytest.mark.parametrize("staged", [False, True])
def test_dsvt_backbone_matches_jax(staged):
    jst, pst = _sparse(np.random.default_rng(7), grid=(16, 16, 8), n=60,
                       c=6)
    kw = dict(channels=16, num_blocks=2, num_heads=2, window=(8, 4, 4),
              set_size=4)
    if staged:
        kw.update(stage_blocks=(1, 2), stage_windows=((8, 4, 4), (2, 4, 4)),
                  downsample=(4,))
    jm = JD.DSVTBackbone(**kw)
    tree, want = jax_module(jm, jst)
    pm = port_module(PD.DSVTBackbone, tree, 6, 64, **kw)
    trace = []
    with torch.no_grad():
        got = pm(pst, trace)
    assert pm.max_sets == -(-64 // 4) * 2
    assert [n for n, _ in trace] == (
        ["stage_0_block_0", "stage_0_reduction", "stage_1_block_0",
         "stage_1_block_1"] if staged else ["block_0", "block_1"])
    assert got.grid == tuple(want.grid) == (16, 16, 2 if staged else 8)
    _eq(got.ids, want.ids)
    assert rel_l2(got.features, want.features) <= FWD_REL_L2


@pytest.fixture(scope="module")
def run():
    return Run("DSVT")


def test_dsvt_detector_matches_jax(run):
    jout, inter, jdets = run.jax_forward()
    trace = []
    pout, pdets = run.port_forward(trace)
    assert rel_l2(pout["bev_dense"], jout["bev_dense"]) <= FWD_REL_L2
    for k, v in pout["preds"].items():
        assert rel_l2(v, jout["preds"][k]) <= FWD_REL_L2, k
    # the VFE's voxels and each point's voxel, every block's and
    # reduction's active ids
    jvox = inter["vfe"]["__call__"][0]
    grid = run.pm.voxel_grid()
    with torch.no_grad():
        pvox = run.pm.vfe(torch.from_numpy(run.pts), N_POINTS, grid,
                          run.cfgs[3].max_voxels)
    for key in ("coords", "num_points", "point_voxel", "num_voxels"):
        _eq(getattr(pvox, key), getattr(jvox, key))
    assert rel_l2(pvox.features, jvox.features) <= FWD_REL_L2
    backbone = inter["backbone3d"]
    assert len(trace) == len(run.pm.backbone3d.names)
    for name, st in trace:
        _eq(st.ids, backbone[name]["__call__"][0].ids)
    assert check_detections(pdets, jdets) > 0


def test_dsvt_train_steps_match_jax(run):
    check_train(run.train())


def test_cli_trains_dsvt_preset(tmp_path, capsys):
    """The CLI on the pillar preset at tiny widths (--set): two steps (the
    CLI's warmup-cosine schedule, as optax's, needs more than its one
    warmup step), the log lines and final JSON, the last checkpoint."""
    sets = ["voxelize.point_range=[-8, -8, -3, 8, 8, 1]",
            "voxelize.voxel_size=[1.0, 1.0, 4.0]",
            "voxelize.max_points=2048", "voxelize.max_voxels=512",
            "model.voxelnext.dsvt_channels=16",
            "model.voxelnext.dsvt_heads=2", "model.voxelnext.dsvt_blocks=2",
            "model.voxelnext.dsvt_window=[1, 4, 4]",
            "model.voxelnext.dsvt_set_size=8",
            "model.voxelnext.dsvt_max_sets=0",
            "model.voxelnext.dsvt_bev_channels=[16, 16, 32]",
            "model.voxelnext.dsvt_bev_upsample=[16, 16, 16]"]
    argv = ["--config", str(REPO / "configs" / "waymo_dsvt_pillar.json"),
            "--synthetic",
            "--steps", "2", "--out", str(tmp_path), "--device", "cpu"]
    for s in sets:
        argv += ["--set", s]
    cli.main(argv)
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split()[:2] for ln in lines[:2]] == [["[0]", "loss"],
                                                    ["[1]", "loss"]]
    assert "hm_loss" in lines[0]
    final = json.loads(lines[-1])
    assert final["steps"] == 2 and np.isfinite(final["final_loss"])
    assert (tmp_path / "checkpoints" / "step_2").is_dir()
