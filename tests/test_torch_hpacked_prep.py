"""The q·R prep kernels (K-l's rows, K-m's lane blocks) and K-m's prepped
global attention, in the port against the JAX package.

JAX builds grouped q·R rows in Pallas: `_window_bias_prep` (the bias rows of
`window_attention_v4`) and `hpacked_prep_pallas` (q_aug, k_aug, v_aug of
`flash_attention_relpos_hpacked_prepped`, which runs the head-packed flash
kernel on them). The port's plain versions (what its wrappers compute on CPU
tensors) are held here to those kernels run in interpret mode on the same
seeded inputs (numpy).

Tolerances. The prep outputs are rows of fp32 sums of exact products,
rounded once: in bfloat16 the two sides agree within one bf16 ulp everywhere
(of the value, or of rms / 256 where a sum nearly cancels: a 2.4e-5 row
entry measured 2 of its own ulps apart) and bit for bit in at least 99.9% of
the elements (a sum taken in another order may land on the other side of a
rounding; measured 99.957% at least);
in float32 within atol / rtol 2e-5. The prepped attention in float32 within
atol / rtol 2e-5 (measured 2.4e-6), in bfloat16 within 2 bf16 ulps of
(|JAX| + rms(JAX)) elementwise (measured 0.0031 of that scale).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lvv_tpu_torch import kernels
from lvv_tpu_torch.ops import attention as tattn
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.fast

jattn = importlib.import_module("lvv_tpu.ops.attention")

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(b, s, c, gh, gw, d, dtype, seed=0):
    """qkv N(0, 1) [b, s, 3c] and tables 0.3·N(0, 1) [gh, gh, d],
    [gw, gw, d], as the benchmarks draw them, in `dtype` for both sides."""
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((b, s, 3 * c)),
            0.3 * rng.standard_normal((gh, gh, d)),
            0.3 * rng.standard_normal((gw, gw, d))]
    arrs = [np.asarray(jnp.asarray(a, jd).astype(jnp.float32)) for a in arrs]
    return ([jnp.asarray(a, jd) for a in arrs],
            [torch.tensor(a).to(td) for a in arrs])


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rows_agree(got, want, dtype):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
        return
    # one bf16 ulp, 2^(e - 8) for |x| = m·2^e with m in [0.5, 1), of the
    # larger magnitude, or of rms / 256 where a sum nearly cancels (the two
    # fp32 sums, in another order, then differ by more than the ulps of
    # their tiny result)
    floor = np.sqrt(np.mean(want ** 2)) / 256
    _, e = np.frexp(np.maximum(np.maximum(np.abs(got), np.abs(want)), floor))
    assert np.all(np.abs(got - want) <= np.ldexp(1.0, e - 8))
    assert np.mean(got == want) >= 0.999


WINDOWS = [(4, 2, 32), (7, 3, 64), (14, 2, 64)]       # (win, heads, hd)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("win,heads,hd", WINDOWS)
def test_window_bias_prep_matches_pallas(win, heads, hd, dtype):
    (jq, jh, jw), (tq, th, tw) = _inputs(2, win * win, heads * hd, win, win,
                                         hd, dtype)
    want = jattn._window_bias_prep(jq, jh, jw, heads=heads, win=win,
                                   interpret=True)
    before = dict(kernels.launches)
    got = tattn.window_bias_prep(tq, th, tw, heads=heads, win=win)
    assert dict(kernels.launches) == before      # CPU: the plain version
    assert len(got) == 2
    for g, w in zip(got, want):
        _rows_agree(g, w, dtype)


GRIDS = [(1, 2, 16, 64), (2, 3, 8, 32)]               # (b, heads, gh, gw)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,heads,gh,gw", GRIDS)
def test_hpacked_prep_matches_pallas(b, heads, gh, gw, dtype):
    (jq, jh, jw), (tq, th, tw) = _inputs(b, gh * gw, heads * 64, gh, gw, 64,
                                         dtype)
    kw = dict(heads=heads, grid_w=gw, scale=0.125)
    want = jattn.hpacked_prep_pallas(jq, jh, jw, interpret=True, **kw)
    got = tattn.hpacked_prep(tq, th, tw, **kw)
    assert len(got) == 3
    for g, w in zip(got, want):
        _rows_agree(g, w, dtype)
    # one mode at a time gives the same blocks
    q_aug, k_aug = tattn.hpacked_prep(tq, th, tw, modes=("qk",), **kw)
    (v_aug,) = tattn.hpacked_prep(tq, th, tw, modes=("v",), **kw)
    assert all(torch.equal(x, y) for x, y in zip((q_aug, k_aug, v_aug), got))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_hpacked_prepped_attention_matches_pallas(dtype):
    """gh 16, gw 64, d 64, 2 heads, tiles 1024 / 512: two kv tiles of the
    online softmax, the width table read from v_aug's lanes."""
    (jq, jh, jw), (tq, th, tw) = _inputs(1, 1024, 128, 16, 64, 64, dtype)
    kw = dict(scale=0.125, grid_w=64, heads=2, block_q=1024, block_k=512)
    want = _f32(jattn.flash_attention_relpos_hpacked_prepped(
        jq, jh, jw, interpret=True, **kw))
    got = tattn.flash_attention_relpos_hpacked_prepped(tq, th, tw, **kw)
    assert got.dtype == DTYPES[dtype][1]
    got = _f32(got)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    else:
        scale = np.abs(want) + np.sqrt(np.mean(want ** 2))
        assert np.all(np.abs(got - want) <= scale / 64)


def test_hpacked_prepped_is_the_global_function_in_float32():
    """In float32 nothing is rounded, so K-m computes the function of K-d,
    the head-packed kernel SAM runs (`relpos_attention`, base e)."""
    _, (tq, th, tw) = _inputs(1, 1024, 128, 16, 64, 64, "float32", seed=1)
    got = tattn.flash_attention_relpos_hpacked_prepped(
        tq, th, tw, scale=0.125, grid_w=64, heads=2, block_q=1024,
        block_k=512)
    want = tattn.relpos_attention(tq, th, tw, heads=2, scale=0.125)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("gh,gw,d,blocks", [
    (16, 64, 64, (1024, 96)),        # block_k is not a multiple of S
    (16, 64, 64, (1024, 32)),        # grid_w does not divide block_k
    (16, 64, 64, (768, 512)),        # block_q is not a multiple of S
    (8, 128, 64, (1024, 512)),       # grid_w > 128 - d
    (16, 64, 128, (1024, 512))])     # d + gh > 128
def test_hpacked_prepped_refuses_what_jax_asserts(gh, gw, d, blocks):
    _, (tq, th, tw) = _inputs(1, gh * gw, 2 * d, gh, gw, d, "float32")
    with pytest.raises(ValueError):
        tattn.flash_attention_relpos_hpacked_prepped(
            tq, th, tw, scale=0.1, grid_w=gw, heads=2, block_q=blocks[0],
            block_k=blocks[1])
