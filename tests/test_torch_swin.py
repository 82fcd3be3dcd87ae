"""The port's Swin backbone against the JAX package's and transformers', on
the CPU.

- The relative-position index and the shifted-window mask equal JAX's.
- Where every stage's grid is whole windows of 7 (an image of 56 x 112:
  grids 14 x 28, then 7 x 14), with a shifted block in the first stage:
  JAX's SwinBackbone and the port's on shared weights, in the tokens form
  (`final_norm`) and in BEVFusion's `out_indices` form.
- Where a grid is not whole windows (an image of 120 x 128: grids 30 x
  32, 15 x 16, then 8 x 8 after PatchMerging pads the odd 15): JAX's
  SwinBackbone raises (ROADMAP.md queue 3), and the port's padded windows
  give transformers' SwinModel's last_hidden_state, its state dict loaded
  through the port's `convert_swin_state`. (The last stage has one block:
  transformers sizes each stage's window from the floor of the halved
  grid, 7 x 8 here, where the grid it runs is the ceiling's, 8 x 8, so a
  shifted block there would run unshifted.)
- The port's converter against the JAX package's, leaf by leaf.
- A backbone built for one image size refuses a size whose windows
  differ.

Tolerance: fp32, 1e-5 relative L2 (FWD_REL_L2).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lvv_tpu.convert.swin_torch import convert_swin_state as jax_convert
from lvv_tpu.models import swin as JS
from lvv_tpu_torch.convert import convert_swin_state
from lvv_tpu_torch.convert.params import _convert, _flatten
from lvv_tpu_torch.models import swin as PS
from torch_zoo_util import FWD_REL_L2, random_tree, rel_l2
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.fast

TINY = dict(embed_dim=8, depths=(2, 2), num_heads=(1, 2), window=7)


def _port(image_hw, out_indices=None, **kw):
    kw = {**TINY, **kw}
    return PS.SwinBackbone(kw["embed_dim"], kw["depths"], kw["num_heads"],
                           kw["window"], image_hw=image_hw,
                           out_indices=out_indices, device="cpu")


def _shared(image_hw, out_indices=None, seed=0):
    """(JAX module, its random params, the port's backbone on them, the
    image batch)."""
    jm = JS.SwinBackbone(**TINY)
    x = np.random.default_rng(seed).standard_normal(
        (2, 3, *image_hw)).astype(np.float32)
    shapes = jax.eval_shape(lambda k, x: jm.init(k, x, out_indices),
                            jax.random.PRNGKey(0), jnp.asarray(x))
    tree = random_tree(dict(shapes))
    pm = _port(image_hw, out_indices)
    pm.load_state_dict(_convert(_flatten(tree["params"]), pm,
                                torch.device("cpu")))
    return jm, tree, pm, x


@pytest.mark.parametrize("window,shift", [(7, 3), (4, 2)])
def test_index_and_mask_match_jax(window, shift):
    np.testing.assert_array_equal(PS.relative_position_index(window),
                                  JS.relative_position_index(window))
    np.testing.assert_array_equal(
        PS.shifted_window_mask(2 * window, 3 * window, window, shift),
        JS.shifted_window_mask(2 * window, 3 * window, window, shift))


@pytest.mark.parametrize("out_indices", [None, (0, 1)])
def test_whole_windows_match_jax(out_indices):
    jm, tree, pm, x = _shared((56, 112), out_indices)
    assert pm.stage0_block1.shift == 3 and pm.stage1_block1.shift == 0
    want = jm.apply(tree, jnp.asarray(x), out_indices)
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    if out_indices is None:
        want, got = [want], [got]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        assert rel_l2(g.numpy(), w) <= FWD_REL_L2


def test_jax_swin_raises_off_whole_windows():
    jm = JS.SwinBackbone(**TINY)
    x = jnp.zeros((1, 3, 120, 128), jnp.float32)
    with pytest.raises(TypeError, match="cannot reshape"):
        jax.eval_shape(jm.init, jax.random.PRNGKey(0), x)


def test_padded_windows_match_transformers():
    transformers = pytest.importorskip("transformers")
    depths, heads = (2, 2, 1), (1, 2, 4)
    cfg = transformers.SwinConfig(
        image_size=(120, 128), patch_size=4, num_channels=3, embed_dim=8,
        depths=list(depths), num_heads=list(heads), window_size=7,
        mlp_ratio=4.0, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0, drop_path_rate=0.0,
        layer_norm_eps=1e-5)
    torch.manual_seed(0)
    oracle = transformers.SwinModel(cfg, add_pooling_layer=False).eval()
    with torch.no_grad():       # trained-like tables, biases and norms
        for name, p in oracle.named_parameters():
            if "relative_position_bias_table" in name or name.endswith(
                    ".bias"):
                p.normal_(0.0, 0.1)
            elif "norm" in name:
                p.normal_(1.0, 0.1)
    sd = {k: v.numpy() for k, v in oracle.state_dict().items()}
    pm = _port((120, 128), embed_dim=8, depths=depths, num_heads=heads)
    # stage 0: 30 x 32 padded to 35 x 35; stage 1: 15 x 16 padded to 21 x
    # 21; stage 2: 8 x 8 after the odd 15 is padded, padded to 14 x 14
    assert (pm.stage0_block1.window, pm.stage0_block1.shift) == (7, 3)
    assert (pm.stage1_block1.window, pm.stage1_block1.shift) == (7, 3)
    assert (pm.stage2_block0.window, pm.stage2_block0.shift) == (7, 0)
    state = convert_swin_state(sd, depths)
    assert set(state) == set(pm.state_dict())
    pm.load_state_dict(state)
    x = np.random.default_rng(1).standard_normal((2, 3, 120, 128)).astype(
        np.float32)
    with torch.no_grad():
        want = oracle(torch.from_numpy(x)).last_hidden_state
        got = pm(torch.from_numpy(x))
    assert got.shape == want.shape == (2, 64, 32)
    assert rel_l2(got.numpy(), want.numpy()) <= FWD_REL_L2


def test_converter_matches_jax():
    depths = (2, 2)
    rng = np.random.default_rng(2)
    pm = _port((56, 112))
    # a transformers-named state dict with random leaves of the right shapes
    sd = {}
    for k, shape in swin_model_shapes(pm, depths):
        sd[k] = rng.standard_normal(shape).astype(np.float32)
    got = convert_swin_state(sd, depths)
    want = _convert(_flatten(jax_convert(sd, depths)), pm,
                    torch.device("cpu"))
    assert set(got) == set(want)
    for k in got:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)


def swin_model_shapes(pm, depths):
    """transformers' SwinModel keys and shapes for the port's backbone."""
    p = dict(pm.state_dict())
    out = [("embeddings.patch_embeddings.projection.weight",
            p["patch_embed.kernel"].shape),
           ("embeddings.patch_embeddings.projection.bias",
            p["patch_embed.bias"].shape)]
    for ours, theirs in (("embed_norm", "embeddings.norm"),
                         ("final_norm", "layernorm")):
        out += [(f"{theirs}.weight", p[f"{ours}.scale"].shape),
                (f"{theirs}.bias", p[f"{ours}.bias"].shape)]
    names = {"ln1": "layernorm_before", "ln2": "layernorm_after",
             "q": "attention.self.query", "k": "attention.self.key",
             "v": "attention.self.value", "proj": "attention.output.dense",
             "fc1": "intermediate.dense", "fc2": "output.dense"}
    for si, depth in enumerate(depths):
        for bi in range(depth):
            blk = f"stage{si}_block{bi}."
            b = f"encoder.layers.{si}.blocks.{bi}."
            for ours, theirs in names.items():
                w = p[blk + ours + (".scale" if ours.startswith("ln")
                                    else ".kernel")].shape
                out += [(b + theirs + ".weight", tuple(reversed(w))),
                        (b + theirs + ".bias", p[blk + ours + ".bias"].shape)]
            out.append((b + "attention.self.relative_position_bias_table",
                        p[blk + "rel_bias_table"].shape))
        if si < len(depths) - 1:
            d, dd = f"downsample{si}.", f"encoder.layers.{si}.downsample."
            out += [(dd + "norm.weight", p[d + "norm.scale"].shape),
                    (dd + "norm.bias", p[d + "norm.bias"].shape),
                    (dd + "reduction.weight",
                     tuple(reversed(p[d + "reduction.kernel"].shape)))]
    return out


def test_window_fixed_at_build():
    pm = _port((56, 112))
    with pytest.raises(ValueError, match="windows of"):
        with torch.no_grad():
            pm(torch.zeros(1, 3, 16, 112))
