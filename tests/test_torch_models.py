"""Each model module of the port against its JAX counterpart.

One seeded parameter tree for the JAX package's tiny VQAModel (LoRA rank 2
on CLIP and the LLM, every leaf non-zero) is converted with
`from_jax_params` into the port's tiny VQAModel; each submodule then runs on
the same seeded float32 inputs on both sides (JAX on the CPU, jitted; the
port on the CPU, where every kernel wrapper computes its plain version).
Tolerance: 1e-4 relative to (1 + |JAX|), float32 round-off through a few
layers whose sums are taken in another order (measured errors are ~1e-6).
"""
import jax
import numpy as np
import pytest
import torch

from lvv_tpu_torch import VQAModel, from_jax_params, tiny_config
from torch_parity_util import close, inputs, jax_model_and_params
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.fast

TOL = 1e-4


@pytest.fixture(scope="module")
def pair():
    jm, params = jax_model_and_params(lora_rank=2)
    cfg = tiny_config().model
    pm = VQAModel(cfg, dtype=torch.float32, device="cpu", llm_lora_rank=2,
                  llm_lora_alpha=4.0, clip_lora_rank=2, clip_lora_alpha=4.0)
    pm.load_state_dict(from_jax_params(params, cfg, device="cpu"))
    return jm, params, pm, cfg


def _jax(jm, params, fn, *args):
    f = jax.jit(lambda p, *a: jm.apply({"params": p}, *a, method=fn))
    return np.asarray(f(params, *args))


def _port(fn, *args):
    with torch.no_grad():
        return fn(*(torch.as_tensor(a) for a in args)).numpy()


def test_sam(pair):
    jm, params, pm, cfg = pair
    img = inputs(cfg)["images"][0]                      # 6 views
    want = _jax(jm, params, lambda m, x: m.deepencoder.sam(x), img)
    close(_port(pm.deepencoder.sam, img), want, TOL)


def test_clip_bypass_with_resampled_pos(pair):
    """CLIP over SAM-shaped features; the 4x4 position grid is resampled
    to 2x2 (antialiased cubic, as jax.image.resize)."""
    jm, params, pm, cfg = pair
    feats = np.random.default_rng(2).standard_normal(
        (2, cfg.clip.hidden_size, 2, 2)).astype(np.float32)
    want = _jax(jm, params,
                lambda m, x: m.deepencoder.clip(patch_embeds=x), feats)
    close(_port(pm.deepencoder.clip, feats), want, TOL)


def test_projector(pair):
    jm, params, pm, cfg = pair
    x = np.random.default_rng(3).standard_normal((2, 4, 128)).astype(
        np.float32)
    want = _jax(jm, params, lambda m, x: m.deepencoder.projector(x), x)
    close(_port(pm.deepencoder.projector, x), want, TOL)


def test_deepencoder_views_with_invalid_view(pair):
    jm, params, pm, cfg = pair
    x = inputs(cfg)
    valid = np.array([[True, True, False, True, True, True]])
    want = _jax(jm, params, lambda m, i, v: m.deepencoder.encode_views(i, v),
                x["images"], valid)
    got = _port(pm.deepencoder.encode_views, x["images"], valid)
    close(got, want, TOL)
    assert not got[0, 2].any()


def test_adapter(pair):
    jm, params, pm, cfg = pair
    x = np.random.default_rng(4).standard_normal((1, 6, 4, 128)).astype(
        np.float32)
    want = _jax(jm, params, lambda m, x: m.adapter(x), x)
    close(_port(pm.adapter, x), want, TOL)


def test_vat_vision(pair):
    jm, params, pm, cfg = pair
    kv = np.random.default_rng(5).standard_normal((2, 24, 128)).astype(
        np.float32)
    want = _jax(jm, params, lambda m, x: m.vat_vision(x), kv)
    close(_port(pm.vat_vision, kv), want, TOL)


def test_vat_lidar(pair):
    jm, params, pm, cfg = pair
    bev = inputs(cfg, b=2)["bev"]
    want = _jax(jm, params, lambda m, x: m.vat_lidar(x), bev)
    close(_port(pm.vat_lidar, bev), want, TOL)


def test_qwen_padded_batch(pair):
    """Causal LLM over inputs_embeds with right padding (kv_len) and GQA."""
    jm, params, pm, cfg = pair
    rng = np.random.default_rng(6)
    emb = rng.standard_normal((2, 10, 64)).astype(np.float32)
    seq_len = np.array([10, 7], np.int32)
    want = _jax(jm, params, lambda m, e, s: m.llm(e, seq_len=s), emb, seq_len)
    got = _port(lambda e, s: pm.llm(e, seq_len=s), emb, seq_len)
    close(got[0], want[0], TOL)
    close(got[1, :7], want[1, :7], TOL)   # padded rows are don't-care
