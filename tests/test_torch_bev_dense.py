"""The port's dense BEV core against the JAX package's, on the CPU.

- `BaseBEVBackbone` on even and odd grids, in PointPillars' shape (three
  stride-2 levels) and in the sparse families' (strides 1 and 2): flax's
  strided "SAME" pads (0, 1) on an even side and (1, 1) on an odd one, its
  nn.ConvTranspose does not flip its kernel, and the deeper levels are
  cropped to the first's upsampled size (the odd grid at strides 1 and 2:
  15 -> 8 -> 16, cropped to 15; at three stride-2 levels every level comes
  back at 16, the first's 8 x 2). Each
  flax trait has its own test, with the PyTorch default it replaces shown
  to differ.
- flax's nn.LayerNorm (eps 1e-6, one-pass variance clamped at 0) and the
  port's `flax_layer_norm`; ties in `top_k` against jax.lax.top_k.
- `DenseCenterHead` and `decode_dense` on a map with empty regions, whose
  heatmap cells tie.
- PointPillars' `PillarVFE` and `pillar_scatter`, the detector's forward,
  detect and a train step at batch 2 (tiny_config(): 16 x 16 pillars);
  CenterPoint's, with its sparse stage ids, on the 9 x 9 BEV of
  `torch_zoo_util`'s grid.
- K-e's fp32 form: its plain version (the CPU path of `flash_attention`)
  against JAX's `attention(..., interpret=True)` at head dim 32 with Sq and
  Sk that are not tile multiples; the kernel's split-kv arithmetic at
  `flash_f32_plan`'s tiles and splits against the plain version; its 3xTF32
  products emulated (`flash_attention_tf32_plain`, TF32 rounding by bit
  operations as cvt.rna) within 1e-5 of the plain version, where a single
  TF32 pass must fail; the plan pinned at TransFusion's shape.

Tolerances (torch_zoo_util): fp32 forward 1e-5 relative L2, detections
equal in count and labels with boxes and scores within 1e-4, a train
step's loss and terms 1e-5 relative, each parameter group's gradient
1e-4 relative L2.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import linen as nn

from lvv_tpu.models import pointpillars as JP
from lvv_tpu.ops.attention import attention as jax_attention
from lvv_tpu_torch.convert.params import _convert, _flatten
from lvv_tpu_torch.models import pointpillars as PP
from lvv_tpu_torch.models.centerpoint import TRUNK2D
from lvv_tpu_torch.ops import attention as A
from lvv_tpu_torch.ops.nms import top_k
from torch_zoo_util import (FWD_REL_L2, GRAD_REL_L2, LOSS_REL, Run,
                            check_detections, group_rel_l2, random_tree,
                            rel_l2, train_step)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.fast

PILLAR_TRUNK = dict(layer_channels=(16, 32, 64), layer_strides=(2, 2, 2),
                    upsample_channels=(8, 8, 8))


def _port(module_cls, tree, *args, **kw):
    """The port's module from a JAX params tree (the converter's rules)."""
    ref = module_cls(*args, device="meta", **kw)
    state = _convert(_flatten(tree["params"]), ref, torch.device("cpu"))
    m = module_cls(*args, device="cpu", **kw)
    m.load_state_dict(state)
    return m


def _bev(c, h, w, seed=0, empty=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((c, h, w)).astype(np.float32)
    if empty:                       # empty regions, as a sparse scene has
        x[:, h // 3:, : w // 2] = 0.0
        x[:, : h // 4, w // 2:] = 0.0
    return x


@pytest.mark.parametrize("trunk", ["pillars", "sparse"])
@pytest.mark.parametrize("hw", [(16, 16), (15, 13)])
def test_base_bev_backbone_matches_flax(trunk, hw):
    kw = PILLAR_TRUNK if trunk == "pillars" else TRUNK2D
    x = _bev(8, *hw)
    jm = JP.BaseBEVBackbone(**kw)
    tree = random_tree(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                      jnp.asarray(x)))
    want = np.asarray(jm.apply(tree, jnp.asarray(x)))
    pm = _port(PP.BaseBEVBackbone, tree, 8, **kw)
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    s0 = kw["layer_strides"][0]      # level 0's upsampled size
    assert got.shape == want.shape == (sum(kw["upsample_channels"]),
                                       *(-(-n // s0) * s0 for n in hw))
    assert rel_l2(got, want) <= FWD_REL_L2


@pytest.mark.parametrize("n,pads", [(16, (0, 1)), (15, (1, 1)), (2, (0, 1)),
                                    (9, (1, 1))])
def test_strided_same_padding(n, pads):
    """flax's "SAME" at stride 2: (0, 1) on an even side, (1, 1) on an odd
    one; PyTorch's padding=1 is off wherever flax pads (0, 1)."""
    assert PP.same_pads(n, 3, 2) == pads
    assert PP.same_pads(n, 3, 1) == (1, 1)
    x = _bev(4, n, n)[None]
    conv = nn.Conv(6, (3, 3), strides=2, padding="SAME")
    p = conv.init(jax.random.PRNGKey(1), x.transpose(0, 2, 3, 1))
    want = np.asarray(conv.apply(p, x.transpose(0, 2, 3, 1))).transpose(
        0, 3, 1, 2)
    kernel = torch.from_numpy(np.asarray(p["params"]["kernel"]).transpose(
        3, 2, 0, 1).copy())
    bias = torch.from_numpy(np.array(p["params"]["bias"]))
    got = PP.same_conv(torch.from_numpy(x), kernel, bias, 2).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    torch_pad = F.conv2d(torch.from_numpy(x), kernel, bias, 2, 1).numpy()
    assert (np.abs(torch_pad - want).max() > 0.1) == (pads == (0, 1))


@pytest.mark.parametrize("stride", [1, 2, 4])
def test_conv_transpose_is_unflipped(stride):
    """flax's nn.ConvTranspose applies its kernel unflipped: the port's
    converted kernel (flipped into [in, out, k, k]) matches, the plain
    layout change does not (at strides above 1)."""
    x = _bev(5, 6, 7)[None]
    conv = nn.ConvTranspose(3, (stride, stride), strides=(stride, stride))
    p = conv.init(jax.random.PRNGKey(2), x.transpose(0, 2, 3, 1))
    want = np.asarray(conv.apply(p, x.transpose(0, 2, 3, 1))).transpose(
        0, 3, 1, 2)
    hwio = np.asarray(p["params"]["kernel"])
    bias = torch.from_numpy(np.array(p["params"]["bias"]))
    kernel = PP.ConvTranspose2d.from_jax_leaf("kernel", hwio).copy()
    got = F.conv_transpose2d(torch.from_numpy(x), torch.from_numpy(kernel),
                             bias, stride).numpy()
    assert got.shape == want.shape == (1, 3, 6 * stride, 7 * stride)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    plain = torch.from_numpy(hwio.transpose(2, 3, 0, 1).copy())
    off = np.abs(F.conv_transpose2d(torch.from_numpy(x), plain, bias,
                                    stride).numpy() - want).max()
    assert (off > 0.1) == (stride > 1)


def test_flax_layer_norm_one_pass():
    """flax's LayerNorm: on rows whose mean is near their spread the port
    matches it to float32 rounding; a constant row gives the bias (the
    variance clamped at 0); at a row mean 30x the spread flax's one-pass
    variance itself is 1e-4-1e-3 off an exact LayerNorm (ROADMAP.md queue
    3), and so is any float32 reading, the port's included."""
    rng = np.random.default_rng(0)
    ln = nn.LayerNorm()
    scale = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(64)).astype(np.float32)
    p = {"params": {"scale": scale, "bias": bias}}
    port = (lambda x: PP.flax_layer_norm(torch.from_numpy(x),
                                         torch.from_numpy(scale),
                                         torch.from_numpy(bias)).numpy())
    x = rng.standard_normal((512, 64)).astype(np.float32)
    x[0] = 3.0
    want = np.asarray(ln.apply(p, x))
    np.testing.assert_allclose(port(x), want, rtol=0, atol=2e-6)
    np.testing.assert_array_equal(want[0], bias)
    np.testing.assert_array_equal(port(x)[0], bias)
    far = (30.0 + rng.standard_normal((512, 64))).astype(np.float32)
    x64 = far.astype(np.float64)
    exact = ((x64 - x64.mean(-1, keepdims=True))
             / np.sqrt(x64.var(-1, keepdims=True) + 1e-6) * scale + bias)
    flax_off = np.abs(np.asarray(ln.apply(p, far)) - exact).max()
    assert 1e-4 < flax_off < 1e-2
    assert np.abs(port(far) - exact).max() < 1e-2


def test_top_k_breaks_ties_to_the_lower_index():
    """Runs of equal values (empty BEV cells) pick in index order, as
    jax.lax.top_k does."""
    rng = np.random.default_rng(3)
    vals = np.repeat(rng.uniform(0, 1, 12).astype(np.float32), 9)
    rng.shuffle(vals)
    for k in (1, 10, 50, len(vals)):
        _, want = jax.lax.top_k(jnp.asarray(vals), k)
        _, got = top_k(torch.from_numpy(vals), k)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_dense_center_head_and_decode_with_tied_cells():
    """Empty regions give equal heatmap cells; the decode keeps JAX's
    picks, boxes and NMS survivors."""
    from lvv_tpu.config import tiny_config as jax_tiny
    from lvv_tpu_torch import tiny_config
    x = _bev(24, 20, 20, empty=True)
    jm = JP.DenseCenterHead(num_classes=3)
    tree = random_tree(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                      jnp.asarray(x)))
    tree["params"]["hm"]["bias"] = tree["params"]["hm"]["bias"] + 1.0
    want = jm.apply(tree, jnp.asarray(x))
    pm = _port(PP.DenseCenterHead, tree, 24, 3)
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    for k, v in want.items():
        assert rel_l2(got[k].numpy(), v) <= FWD_REL_L2, k
    hm = np.asarray(want["hm"])
    assert np.unique(hm, return_counts=True)[1].max() > 50   # ties
    # every cell a candidate, so that NMS walks the tied runs in the
    # order top-K leaves them
    jdet, pdet = (dataclasses.replace(c.model.voxelnext,
                                      nms_pre_max=hm.size)
                  for c in (jax_tiny(), tiny_config()))
    jd = JP.decode_dense(want, jdet, jax_tiny().voxelize, 1)
    # the port's decode on JAX's own maps, then on the port's
    for preds in ({k: torch.from_numpy(np.array(v))
                   for k, v in want.items()}, got):
        pd = PP.decode_dense(preds, pdet, tiny_config().voxelize, 1)
        assert check_detections(pd, jd) > 1


def test_pillar_vfe_and_scatter():
    from lvv_tpu.config import tiny_config as jax_tiny
    from lvv_tpu.ops.voxelize import voxelize as jax_voxelize
    from lvv_tpu_torch.ops.voxelize import voxelize
    from torch_zoo_util import cloud
    run_cfg = jax_tiny().voxelize
    pts = cloud(run_cfg, 1500)
    det = JP.PointPillarsDetector(det_cfg=jax_tiny().model.voxelnext,
                                  vox_cfg=run_cfg)
    grid = det.voxel_grid()
    vox = jax_voxelize(jnp.asarray(pts), jnp.int32(1500), grid,
                       max_voxels=run_cfg.max_voxels,
                       max_points_per_voxel=run_cfg.max_points_per_voxel)
    jm = JP.PillarVFE(64, run_cfg)
    tree = random_tree(jax.eval_shape(jm.init, jax.random.PRNGKey(0), vox,
                                      grid))
    want = jm.apply(tree, vox, grid)
    nx, ny, _ = grid.grid_size
    canvas = JP.pillar_scatter(want, vox.coords, (ny, nx))
    pvox = voxelize(torch.from_numpy(pts), 1500, PP.VoxelGrid(*grid),
                    max_voxels=run_cfg.max_voxels,
                    max_points_per_voxel=run_cfg.max_points_per_voxel)
    np.testing.assert_array_equal(pvox.coords.numpy(),
                                  np.asarray(vox.coords))
    pm = _port(PP.PillarVFE, tree, 4, 64)
    with torch.no_grad():
        got = pm(pvox, PP.VoxelGrid(*grid))
    assert rel_l2(got.numpy(), want) <= FWD_REL_L2
    pc = PP.pillar_scatter(got, pvox.coords, (ny, nx)).numpy()
    assert pc.shape == (64, ny, nx)
    assert rel_l2(pc, canvas) <= FWD_REL_L2


@pytest.fixture(scope="module")
def runs():
    made = {}

    def get(family):
        if family not in made:
            made[family] = Run(family)
        return made[family]
    return get


FAMILIES = ["PointPillars", "CenterPoint"]


@pytest.mark.parametrize("family", FAMILIES)
def test_forward_and_detect_match_jax(runs, family):
    r = runs(family)
    out, inter, dets = r.jax_forward()
    trace = []
    got, got_dets = r.port_forward(trace)
    assert rel_l2(got["bev_dense"].numpy(), out["bev_dense"]) <= FWD_REL_L2
    assert set(got["preds"]) == set(out["preds"])
    for k, v in out["preds"].items():
        assert rel_l2(got["preds"][k].numpy(), v) <= FWD_REL_L2, k
    if family == "CenterPoint":
        bb = inter["backbone3d"]
        stages = {f"stage{i}": bb[f"res{i}"]["__call__"][0]
                  for i in range(1, 5)}
        assert [n for n, _ in trace] == list(stages)
        for name, st in trace:
            np.testing.assert_array_equal(st.ids.numpy(),
                                          np.asarray(stages[name].ids))
        assert got["bev_dense"].shape[1:] == (9, 9)        # the odd grid
    assert check_detections(got_dets, dets) > 1


@pytest.mark.parametrize("family", FAMILIES)
def test_train_step_matches_jax(runs, family):
    jm, jg, pm, pg = train_step(runs(family))
    assert set(pm) == set(jm) == {"loss", "hm_loss", "reg_loss",
                                  "grad_norm"}
    for k in ("loss", "hm_loss", "reg_loss"):
        np.testing.assert_allclose(pm[k], jm[k], rtol=LOSS_REL, err_msg=k)
    np.testing.assert_allclose(pm["grad_norm"], jm["grad_norm"],
                               rtol=GRAD_REL_L2)
    groups = group_rel_l2(jg, pg)
    assert set(groups) == ({"vfe", "backbone", "head"}
                           if family == "PointPillars"
                           else {"backbone3d", "backbone2d", "head"})
    assert max(groups.values()) <= GRAD_REL_L2, groups
    assert all(g is not None and g.abs().sum() > 0 for g in pg.values())


@pytest.mark.parametrize("kv_len", [None, (300, 123)])
def test_flash_fp32_plain_matches_pallas(kv_len):
    """K-e's fp32 form: the port's CPU path (its plain version) against
    JAX's flash kernel in interpret mode (head dim 32 padded to 64 by
    `_flash_padded`, Sq 24 and Sk 300 off its tiles)."""
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((2, 4, 24, 32), (2, 4, 300, 32), (2, 4, 300, 32)))
    lens = None if kv_len is None else np.array(kv_len, np.int32)
    want = jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         kv_len=None if lens is None else jnp.asarray(lens),
                         interpret=True)
    got = A.flash_attention(*(torch.from_numpy(t) for t in (q, k, v)),
                            kv_len=None if lens is None
                            else torch.from_numpy(lens))
    assert got.dtype == torch.float32
    assert rel_l2(got.numpy(), want) <= 1e-5


def test_flash_fp32_split_arithmetic():
    """The fp32 kernel's split arithmetic at `flash_f32_plan`'s 32-key
    tiles and split count against the plain version, at a smaller kv than
    TransFusion's (32 splits of 5 tiles, the first 26 holding them all)."""
    rng = np.random.default_rng(8)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((1, 4, 200, 32), (1, 4, 4100, 32),
                         (1, 4, 4100, 32)))
    plan = A.flash_f32_plan(1, 4, 200, 4100, 32)
    assert (plan["keys"], plan["splits"]) == (32, 32)
    got = A.flash_attention_split_plain(q, k, v, n_split=plan["splits"],
                                        block_k=plan["keys"])
    want = A.flash_attention_plain(q, k, v)
    assert rel_l2(got.numpy(), want.numpy()) <= 1e-6


def test_flash_f32_plan():
    """The fp32 form's launch from the shapes alone: at TransFusion's shape
    (q [1, 4, 200, 32] over 32,400 keys) 2 blocks of 7 warps (112 rows) a
    head and 33 kv splits, 264 blocks, two on each of the 132 SMs; at the
    train step's batch of 2 17 splits; head dims padded to a multiple of 8;
    enough q blocks need no split, a kv under 8 tiles none either."""
    assert A.flash_f32_plan(1, 4, 200, 32400, 32) == dict(
        dp=32, keys=32, rows=112, q_blocks=2, splits=33, blocks=264)
    assert A.flash_f32_plan(2, 4, 200, 32400, 32)["splits"] == 17
    assert A.flash_f32_plan(1, 4, 200, 32400, 7)["dp"] == 8
    wide = A.flash_f32_plan(2, 8, 70, 2000, 64)
    assert (wide["dp"], wide["rows"], wide["splits"]) == (64, 80, 15)
    assert A.flash_f32_plan(8, 16, 4096, 4096, 64)["splits"] == 1
    assert A.flash_f32_plan(2, 4, 24, 200, 32)["splits"] == 1


@pytest.mark.parametrize("b,hq,hkv,sq,sk,causal,ragged", [
    (1, 4, 4, 200, 4100, False, False),     # TransFusion's head, cut kv
    (2, 4, 2, 130, 1500, True, True)])      # causal, GQA, ragged kv_len
def test_flash_fp32_3xtf32_arithmetic(b, hq, hkv, sq, sk, causal, ragged):
    """The kernel's 3xTF32 products (operands split into TF32 big + small,
    small·small dropped) emulated in PyTorch stay within the 1e-5 bound of
    the plain version (read 5.1e-7 in both cases), while a single TF32
    pass fails it (read 4.4e-4 and 4.7e-4). `tf32_round` rounds to
    nearest, ties away from zero, as cvt.rna.tf32.f32."""
    x = torch.tensor([1.0, 1 + 2 ** -11, 1 + 3 * 2 ** -11, -1 - 2 ** -11,
                      1 + 2 ** -11 - 2 ** -20])
    assert A.tf32_round(x).tolist() == [1.0, 1 + 2 ** -10, 1 + 2 ** -9,
                                        -1 - 2 ** -10, 1.0]
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((b, hq, sq, 32), (b, hkv, sk, 32),
                         (b, hkv, sk, 32)))
    kw = dict(causal=causal, kv_len=torch.tensor([sk, sk - 77])
              if ragged else None)
    want = A.flash_attention_plain(q, k, v, **kw).numpy()
    three = A.flash_attention_tf32_plain(q, k, v, **kw).numpy()
    one = A.flash_attention_tf32_plain(q, k, v, passes=1, **kw).numpy()
    assert rel_l2(three, want) <= 1e-5
    assert rel_l2(one, want) > 1e-5
