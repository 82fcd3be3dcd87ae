"""The VQA model's options a config file can name, against the JAX package:
the projector's kinds, CLIP's own patcher, and an untied lm_head.

Seeded float32 parameter trees shared through their flax paths (conv
kernels HWIO -> OIHW), run on the CPU on both sides. Tolerance: 1e-4
relative to (1 + |JAX|) for modules (float32 round-off of sums taken in
another order; measured ~1e-6); greedy tokens exactly equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lvv_tpu import config as J
from lvv_tpu.models import VQABatch
from lvv_tpu.models import VQAModel as JaxVQAModel
from lvv_tpu.models import greedy_generate as jax_greedy
from lvv_tpu.models.clip import CLIPVisionTower as JaxCLIP
from lvv_tpu.models.projector import MlpProjector as JaxProjector
from lvv_tpu.models.vqa import prepare_serving_params as jax_prep
from lvv_tpu_torch import config as C
from lvv_tpu_torch import (VQAModel, from_jax_params, greedy_generate,
                           prepare_serving_params,
                           prepare_serving_params_fused)
from lvv_tpu_torch.convert import tensors
from lvv_tpu_torch.models.clip import CLIPVisionTower
from lvv_tpu_torch.models.projector import KINDS, MlpProjector
from torch_parity_util import _leaf, close, inputs
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.fast

TOL = 1e-4


def _random_tree(shapes, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, s: _leaf("/".join(k.key for k in p), s.shape, rng), shapes)


def _port_state(params):
    """A flax param tree -> the port's state_dict (4-D kernels to OIHW)."""
    return {k: v.permute(3, 2, 0, 1).contiguous() if v.ndim == 4 else v
            for k, v in tensors(params).items()}


# ------------------------------------------------------------- projector

@pytest.mark.parametrize("kind", KINDS)
def test_projector_kind_matches_jax(kind):
    """Every kind at depth 2, mlp_ratio 2, downsample 2 on a 4x4 token
    grid; the low_high kinds with a `high` input of another width."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 16, 12)).astype(np.float32)
    high = rng.standard_normal((2, 16, 10)).astype(np.float32)
    jp = JaxProjector(kind=kind, n_embed=16, depth=2, mlp_ratio=2,
                      downsample_ratio=2)
    shapes = jax.eval_shape(jp.init, jax.random.PRNGKey(0), x, high)
    params = _random_tree(shapes.get("params", {}), 2)
    want = np.asarray(jp.apply({"params": params}, x, high))
    pm = MlpProjector(12, kind, 16, 2, 2, 2, high_dim=10,
                      dtype=torch.float32, device="cpu")
    pm.load_state_dict(_port_state(params))
    with torch.no_grad():
        got = pm(torch.as_tensor(x), torch.as_tensor(high)).numpy()
    close(got, want, TOL)


def test_projector_refusals():
    kw = dict(dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="unknown projector kind"):
        MlpProjector(8, "conv", 8, **kw)
    pm = MlpProjector(8, "low_high_split_mlp_gelu", 8, **kw)
    with pytest.raises(ValueError, match="high"):
        pm(torch.zeros(1, 4, 8))
    pm = MlpProjector(8, "downsample_mlp_gelu", 8, **kw)
    with pytest.raises(ValueError, match="square"):
        pm(torch.zeros(1, 6, 8))


def test_deepencoder_builds_the_configured_projector():
    """The config's projector fields reach the model: a downsample kind
    folds SAM's 2x2 token grid into one token."""
    cfg = C.override(C.tiny_config(), "model.projector.kind",
                     "normlayer_downsample_mlp_gelu").model
    m = VQAModel(cfg, dtype=torch.float32, device="cpu")
    s = cfg.sam.img_size
    with torch.no_grad():
        out = m.deepencoder(torch.zeros(1, 3, s, s))
    assert out.shape == (1, 1, cfg.projector.n_embed)
    assert m.deepencoder.projector.pre_ln.scale.shape == (128,)


# ------------------------------------------------------------------ CLIP

@pytest.mark.parametrize("size", [32, 48])
def test_clip_patcher_matches_jax(size):
    """CLIP on pixel_values through its own patch conv (the position table
    resampled at 48), against the JAX tower on the same weights."""
    kw = dict(image_size=32, patch_size=8, hidden_size=64, num_layers=2,
              num_heads=2, intermediate_size=128)
    pix = np.random.default_rng(3).uniform(
        -1, 1, (2, 3, size, size)).astype(np.float32)
    jc = JaxCLIP(**kw)
    params = _random_tree(jax.eval_shape(
        jc.init, jax.random.PRNGKey(0), pixel_values=pix)["params"], 4)
    want = np.asarray(jc.apply({"params": params}, pixel_values=pix))
    pc = CLIPVisionTower(**kw, patcher=True, dtype=torch.float32,
                         device="cpu")
    pc.load_state_dict(_port_state(params))
    with torch.no_grad():
        got = pc(pixel_values=torch.as_tensor(pix)).numpy()
    close(got, want, TOL)
    bare = CLIPVisionTower(**kw, dtype=torch.float32, device="cpu")
    assert "patch_embed.kernel" not in bare.state_dict()
    with pytest.raises(ValueError, match="patcher"):
        bare(pixel_values=torch.as_tensor(pix))


# ------------------------------------------------------- untied lm_head

@pytest.fixture(scope="module")
def untied():
    """(JAX model, params, port model, port config) of the tiny config with
    tie_word_embeddings false."""
    jcfg = J.override(J.tiny_config(), "model.llm.tie_word_embeddings",
                      False).model
    jm = JaxVQAModel(jcfg)
    b, t = 1, 4
    batch = VQABatch(
        bev=jnp.zeros((b, jcfg.bev_channels, *jcfg.bev_hw)),
        images=jnp.zeros((b, 6, 3, jcfg.sam.img_size, jcfg.sam.img_size)),
        view_valid=jnp.ones((b, 6), bool),
        text_ids=jnp.zeros((b, t), jnp.int32),
        text_len=jnp.full((b,), t, jnp.int32),
        labels=jnp.full((b, t), -100, jnp.int32),
        use_vision=jnp.asarray(True), use_lidar=jnp.asarray(True))
    params = _random_tree(jax.eval_shape(
        jm.init, jax.random.PRNGKey(0), batch)["params"], 0)
    cfg = C.from_dict(C.VQAConfig, J.to_dict(J.override(
        J.tiny_config(), "model.llm.tie_word_embeddings", False))).model
    pm = VQAModel(cfg, dtype=torch.float32, device="cpu")
    pm.load_state_dict(from_jax_params(params, cfg, device="cpu"))
    return jm, params, pm, cfg


@pytest.mark.parametrize("int8", [False, True])
def test_untied_lm_head_matches_jax(untied, int8):
    """greedy_generate with the untied head, float decode and the unfused
    int8 tree (the head stays float in both packages): JAX's tokens."""
    jm, params, pm, cfg = untied
    assert tuple(pm.llm.lm_head.kernel.shape) == (
        cfg.llm.hidden_size, cfg.llm.vocab_size + 4)
    x = inputs(cfg, b=2, seed=2)
    args = (x["bev"], x["images"], x["view_valid"], x["prompt_ids"],
            x["prompt_len"])
    j_tok, j_len = jax_greedy(jm, params, *args, max_new_tokens=8, eos_id=2,
                              params_decode=jax_prep(params) if int8
                              else None)
    j_tok = np.asarray(j_tok)
    assert len(set(j_tok.ravel().tolist())) > 2   # a non-degenerate answer
    p_tok, p_len = greedy_generate(
        pm, *args, max_new_tokens=8, eos_id=2,
        params_decode=prepare_serving_params(pm) if int8 else None)
    np.testing.assert_array_equal(p_tok.numpy(), j_tok)
    np.testing.assert_array_equal(p_len.numpy(), np.asarray(j_len))


def test_packed_decode_refuses_an_untied_head(untied):
    """JAX asserts where the pack needs the tied table; the port raises."""
    with pytest.raises(ValueError, match="tied"):
        prepare_serving_params_fused(untied[2])
