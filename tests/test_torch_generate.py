"""The generate family and the uint8 preprocessing in the port against the
JAX package.

On the tiny config with one seeded parameter tree shared through
`from_jax_params`, in float32 on the CPU (both stacks take their plain
paths there): `greedy_generate_multi` (float images and uint8 frames, G = 2
groups of B = 2 with a right-padded prompt), `encode_prefix_fn` /
`generate_from_prefix` and `pipelined_serving_step` give JAX's tokens and
lengths, and each group or batch gives greedy_generate's. The prefix
embeddings agree within 1e-4 relative to (1 + |JAX|), as in
tests/test_torch_vqa.py.

`preprocess_views` agrees with JAX's within 1e-6 absolute on values in
[-1, 1] (the same triangle-filter weights summed in another order;
measured at most 1.2e-7), on a downsampled non-square frame, a square one
and an upsampled one; the resize without antialiasing is another function,
more than 1e-2 away on the downsampled frame.

Sampling: torch cannot draw jax.random's numbers, so the draw is split
from the filter. `_filter_logits` (temperature, top-k, top-p) is bit-equal
to the logits JAX's `_sample_token` hands to jax.random.categorical, and
given the same Gumbel noise (numpy, fed to both) the sampled token and the
whole `sample_generate` answer equal JAX's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax._src.random as jax_random_impl
from lvv_tpu.models import vqa as jvqa
from lvv_tpu.ops import image as jimage
from lvv_tpu_torch import (VQAModel, encode_prefix_fn, from_jax_params,
                           generate_from_prefix, greedy_generate,
                           greedy_generate_multi, pipelined_serving_step,
                           preprocess_views, sample_generate, tiny_config)
from lvv_tpu_torch.models import vqa as tvqa
from lvv_tpu_torch.ops import image as timage
from torch_parity_util import close, inputs, jax_model_and_params
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.fast

TOL = 1e-4
N_NEW = 8
G, B = 2, 2


@pytest.fixture(scope="module")
def pair():
    """(JAX model, params, port model, cfg) on one seeded tree."""
    jm, params = jax_model_and_params()
    cfg = tiny_config().model
    pm = VQAModel(cfg, dtype=torch.float32, device="cpu")
    pm.load_state_dict(from_jax_params(params, cfg, device="cpu"))
    return jm, params, pm, cfg


def _batch(cfg, seed):
    """One batch of B frames, the second prompt right-padded (4 of 6)."""
    x = inputs(cfg, b=B, seed=seed)
    x["prompt_len"] = np.array([6, 4], np.int32)
    return x


def _groups(cfg, frames_u8=False):
    """G batches stacked on a leading axis; with frames_u8, raw uint8
    nuScenes-like frames [G, B, 6, 45, 80, 3] in place of the images."""
    xs = [_batch(cfg, seed) for seed in (3, 4)]
    out = {k: np.stack([x[k] for x in xs]) for k in xs[0]}
    if frames_u8:
        rng = np.random.default_rng(5)
        out["images"] = rng.integers(0, 256, (G, B, 6, 45, 80, 3),
                                     dtype=np.uint8)
    return out


def _args(x):
    return (x["bev"], x["images"], x["view_valid"], x["prompt_ids"],
            x["prompt_len"])


# ------------------------------------------------------------ image ------

@pytest.mark.parametrize("h,w", [(90, 160), (64, 64), (40, 30)])
def test_preprocess_views_matches_jax(h, w):
    """[V, H, W, 3] uint8 -> [V, 3, 64, 64] float32: downsampled
    non-square (90x160 -> 36x64), square, and upsampled portrait."""
    u8 = np.random.default_rng(h).integers(0, 256, (3, h, w, 3),
                                           dtype=np.uint8)
    want = np.asarray(jimage.preprocess_views(jnp.asarray(u8), 64))
    got = preprocess_views(torch.as_tensor(u8), 64)
    assert got.dtype == torch.float32 and got.shape == (3, 3, 64, 64)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def test_preprocess_steps_match_jax_and_the_resize_antialiases():
    """Each step on its own (normalise, resize, letterbox, one frame) equals
    JAX's; a bilinear resize without antialiasing misses by far more."""
    u8 = np.random.default_rng(1).integers(0, 256, (90, 160, 3),
                                           dtype=np.uint8)
    x_j = jimage.normalize_pm1(jnp.asarray(u8))
    x_t = timage.normalize_pm1(torch.as_tensor(u8))
    np.testing.assert_array_equal(x_t.numpy(), np.asarray(x_j))
    for got, want in (
            (timage.resize_bilinear(x_t, 36, 64),
             jimage.resize_bilinear(x_j, 36, 64)),
            (timage.resize_and_pad_to_square(x_t, 64, 0.5),
             jimage.resize_and_pad_to_square(x_j, 64, 0.5)),
            (timage.preprocess_camera_frame(torch.as_tensor(u8), 64),
             jimage.preprocess_camera_frame(jnp.asarray(u8), 64))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                                   rtol=0)
    plain = F.interpolate(x_t.permute(2, 0, 1)[None], size=(36, 64),
                          mode="bilinear", align_corners=False)
    want = np.asarray(jimage.resize_bilinear(x_j, 36, 64)).transpose(2, 0, 1)
    assert np.abs(plain[0].numpy() - want).max() > 1e-2


# ---------------------------------------------------------- generate -----

@pytest.mark.parametrize("frames_u8", [False, True])
def test_greedy_generate_multi_matches_jax(pair, frames_u8):
    """G = 2 groups of B = 2: tokens and lengths equal JAX's, and each
    group's equal a greedy_generate of that group (uint8 frames through
    preprocess_views first)."""
    jm, params, pm, cfg = pair
    x = _groups(cfg, frames_u8)
    j_tok, j_len = jvqa.greedy_generate_multi(
        jm, params, *(jnp.asarray(a) for a in _args(x)),
        max_new_tokens=N_NEW, eos_id=2)
    j_tok = np.asarray(j_tok)
    assert len(set(j_tok.ravel().tolist())) > 2   # a non-degenerate answer
    p_tok, p_len = greedy_generate_multi(pm, *_args(x), max_new_tokens=N_NEW,
                                         eos_id=2)
    assert p_tok.shape == (G, B, N_NEW) and p_len.shape == (G, B)
    np.testing.assert_array_equal(p_tok.numpy(), j_tok)
    np.testing.assert_array_equal(p_len.numpy(), np.asarray(j_len))
    for g in range(G):
        args = [a[g] for a in _args(x)]
        if frames_u8:
            args[1] = preprocess_views(torch.as_tensor(args[1]).flatten(0, 1),
                                       cfg.sam.img_size).unflatten(0, (B, 6))
        tok, lens = greedy_generate(pm, *args, max_new_tokens=N_NEW, eos_id=2)
        assert torch.equal(tok, p_tok[g]) and torch.equal(lens, p_len[g])


def test_generate_from_prefix_matches_jax_and_greedy(pair):
    """encode_prefix_fn equals JAX's encoder; generate_from_prefix on it
    gives JAX's tokens and greedy_generate's."""
    jm, params, pm, cfg = pair
    x = _batch(cfg, 6)
    sensors = (x["bev"], x["images"], x["view_valid"])
    j_prefix = jvqa.encode_prefix_fn(jm)(params, *sensors)
    prefix = encode_prefix_fn(pm)(*sensors)
    close(prefix.numpy(), j_prefix, TOL)
    j_tok, j_len = jvqa.generate_from_prefix(
        jm, params, j_prefix, x["prompt_ids"], x["prompt_len"],
        max_new_tokens=N_NEW, eos_id=2)
    p_tok, p_len = generate_from_prefix(pm, prefix, x["prompt_ids"],
                                        x["prompt_len"],
                                        max_new_tokens=N_NEW, eos_id=2)
    np.testing.assert_array_equal(p_tok.numpy(), np.asarray(j_tok))
    np.testing.assert_array_equal(p_len.numpy(), np.asarray(j_len))
    g_tok, g_len = greedy_generate(pm, *_args(x), max_new_tokens=N_NEW,
                                   eos_id=2)
    assert torch.equal(g_tok, p_tok) and torch.equal(g_len, p_len)


def test_pipelined_serving_step_matches_jax(pair):
    """Three batches through the pipeline (answer batch i, encode batch
    i + 1): every stage's tokens, lengths and next prefix equal JAX's, and
    each batch's answer equals its greedy_generate."""
    jm, params, pm, cfg = pair
    xs = [_batch(cfg, seed) for seed in (7, 8, 9)]
    j_prefix = jvqa.encode_prefix_fn(jm)(params, xs[0]["bev"],
                                         xs[0]["images"], xs[0]["view_valid"])
    prefix = encode_prefix_fn(pm)(xs[0]["bev"], xs[0]["images"],
                                  xs[0]["view_valid"])
    for i, x in enumerate(xs):
        nxt = xs[(i + 1) % len(xs)]
        sensors = (nxt["bev"], nxt["images"], nxt["view_valid"])
        j_tok, j_len, j_prefix = jvqa.pipelined_serving_step(
            jm, params, j_prefix, x["prompt_ids"], x["prompt_len"], *sensors,
            max_new_tokens=N_NEW, eos_id=2)
        p_tok, p_len, prefix = pipelined_serving_step(
            pm, prefix, x["prompt_ids"], x["prompt_len"], *sensors,
            max_new_tokens=N_NEW, eos_id=2)
        np.testing.assert_array_equal(p_tok.numpy(), np.asarray(j_tok))
        np.testing.assert_array_equal(p_len.numpy(), np.asarray(j_len))
        close(prefix.numpy(), j_prefix, TOL)
        g_tok, _ = greedy_generate(pm, *_args(x), max_new_tokens=N_NEW,
                                   eos_id=2)
        assert torch.equal(g_tok, p_tok)


# ---------------------------------------------------------- sampling -----

def _jax_filtered(logits, temperature, top_k, top_p):
    """The logits JAX's `_sample_token` hands to jax.random.categorical."""
    seen = {}

    def grab(key, lg, axis=-1):
        seen["logits"] = np.asarray(lg)
        return jnp.zeros(lg.shape[0], jnp.int32)
    saved = jax.random.categorical
    jax.random.categorical = grab
    try:
        jvqa._sample_token(jax.random.PRNGKey(0), jnp.asarray(logits),
                           temperature, top_k, top_p)
    finally:
        jax.random.categorical = saved
    return seen["logits"]


FILTERS = [(0.7, 50, 0.9), (1.0, 0, 1.0), (0.0, 5, 1.0), (1.3, 0, 0.5),
           (0.5, 200, 0.95)]


@pytest.mark.parametrize("temperature,top_k,top_p", FILTERS)
def test_filter_logits_bit_equal_jax(temperature, top_k, top_p):
    """Temperature (floored at 1e-5), top-k and top-p, bit for bit: the
    kept logits and the -1e30 of the masked ones."""
    logits = np.random.default_rng(11).normal(size=(3, 1000)).astype(
        np.float32) * 3
    want = _jax_filtered(logits, temperature, top_k, top_p)
    got = tvqa._filter_logits(torch.as_tensor(logits), temperature, top_k,
                              top_p)
    np.testing.assert_array_equal(got.numpy(), want)
    kept = (want > -1e29).sum(-1)
    assert np.all(kept >= 1) and (top_k == 0 and top_p == 1.0
                                  or np.all(kept < 1000))


class _Noise:
    """One numpy table of Gumbel noise [N, B, V] fed to both frameworks:
    the port's `_gumbel` takes its rows in turn; JAX's gumbel (which
    jax.random.categorical calls) takes the row of the step whose key it
    is given, found among jax.random.split(rng, N)."""

    def __init__(self, n, b, v, rng_key):
        r = np.random.default_rng(12)
        self.table = -np.log(-np.log(r.uniform(np.finfo(np.float32).tiny, 1,
                                               (n, b, v)))).astype(np.float32)
        self.keys = np.asarray(jax.random.split(rng_key, n))
        self.step = 0

    def torch_draw(self, shape, generator, device):
        row = torch.as_tensor(self.table[self.step], device=device)
        self.step += 1
        assert tuple(row.shape) == tuple(shape)
        return row

    def jax_draw(self, key, shape=(), dtype=jnp.float32, mode=None):
        kd = jax.random.key_data(key)
        idx = jnp.argmax(jnp.all(jnp.asarray(self.keys) == kd[None], axis=1))
        return jnp.asarray(self.table)[idx].reshape(shape).astype(dtype)


def test_sample_token_matches_jax_given_noise(monkeypatch):
    """_sample_token's pick is jax.random.categorical's: argmax of noise
    plus the filtered logits."""
    logits = np.random.default_rng(13).normal(size=(4, 500)).astype(
        np.float32) * 2
    key = jax.random.PRNGKey(3)
    noise = _Noise(1, 4, 500, key)
    monkeypatch.setattr(jax_random_impl, "gumbel", noise.jax_draw)
    want = np.asarray(jvqa._sample_token(noise.keys[0], jnp.asarray(logits),
                                         0.8, 40, 0.9))
    got = tvqa._sample_token(torch.as_tensor(logits), 0.8, 40, 0.9,
                             gumbel=torch.as_tensor(noise.table[0]))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32


def test_sample_generate_matches_jax_given_noise(pair, monkeypatch):
    """The whole sampled answer (B = 2, right-padded prompt) equals JAX's
    when both draw the same Gumbel noise at every step."""
    jm, params, pm, cfg = pair
    x = _batch(cfg, 14)
    rng = jax.random.PRNGKey(1)
    v = cfg.llm.vocab_size + len(cfg.llm.special_tokens)
    noise = _Noise(N_NEW, B, v, rng)
    monkeypatch.setattr(jax_random_impl, "gumbel", noise.jax_draw)
    monkeypatch.setattr(tvqa, "_gumbel", noise.torch_draw)
    # a max_cache of its own: a program that JAX traced under another
    # gumbel is not reused
    kw = dict(max_new_tokens=N_NEW, eos_id=2, temperature=0.9, top_k=20,
              top_p=0.95, max_cache=97)
    j_tok, j_len = jvqa.sample_generate(jm, params, rng, *_args(x), **kw)
    gen = torch.Generator().manual_seed(0)
    p_tok, p_len = sample_generate(pm, gen, *_args(x), **kw)
    assert noise.step == N_NEW
    j_tok = np.asarray(j_tok)
    assert len(set(j_tok.ravel().tolist())) > 2
    np.testing.assert_array_equal(p_tok.numpy(), j_tok)
    np.testing.assert_array_equal(p_len.numpy(), np.asarray(j_len))


def test_sample_generate_draws_from_its_generator(pair):
    """Without noise fed in, the answer is a function of the generator's
    seed: the same seed repeats it."""
    _, _, pm, cfg = pair
    x = _batch(cfg, 15)
    kw = dict(max_new_tokens=N_NEW, eos_id=-1, temperature=1.0, top_k=0,
              top_p=1.0)
    runs = [sample_generate(pm, torch.Generator().manual_seed(s), *_args(x),
                            **kw)[0] for s in (0, 0, 1)]
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])


def test_new_entry_points_need_a_device_without_a_card(pair, monkeypatch):
    """With no card, the preprocessing given host arrays and no device
    raises instead of falling back to the CPU; the generate family runs on
    its model's device, which the caller chose (here the CPU), and returns
    tensors there."""
    _, _, pm, cfg = pair
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    u8 = np.zeros((6, 45, 80, 3), np.uint8)
    for fn, arg in ((preprocess_views, u8),
                    (timage.preprocess_camera_frame, u8[0])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(arg, 64)
        assert fn(arg, 64, device="cpu").device.type == "cpu"
    x = _groups(cfg, frames_u8=True)
    outs = [greedy_generate_multi(pm, *_args(x), max_new_tokens=2,
                                  eos_id=2)[0]]
    y = _batch(cfg, 16)
    prefix = encode_prefix_fn(pm)(y["bev"], y["images"], y["view_valid"])
    outs += [prefix, generate_from_prefix(pm, prefix, y["prompt_ids"],
                                          y["prompt_len"], max_new_tokens=2,
                                          eos_id=2)[0],
             pipelined_serving_step(pm, prefix, y["prompt_ids"],
                                    y["prompt_len"], y["bev"], y["images"],
                                    y["view_valid"], max_new_tokens=2,
                                    eos_id=2)[2],
             sample_generate(pm, torch.Generator().manual_seed(0), *_args(y),
                             max_new_tokens=2, eos_id=2)[0]]
    assert all(t.device.type == "cpu" for t in outs)
