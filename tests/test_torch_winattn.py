"""K-l, SAM's window-attention alternates, in the port against the JAX package.

The JAX package keeps five window-attention bodies beside the one its model
runs: `window_attention_fused`, `_fused2`, `_v3` (two bias modes), `_v4`
(after its Pallas prep of the q·R rows) and `_phased`. They compute one
function, window attention over bf16 q·R bias rows in base 2, and differ in
where q·scale·log2e is rounded and in how their glue rounds the rows. The
port's wrappers compute their plain versions on CPU tensors; each is held
here to its Pallas kernel run in interpret mode on the same seeded inputs
(numpy), in float32 and in bfloat16.

Tolerances: float32 within atol / rtol 2e-5, as JAX's own window tests
(measured at most 2.8e-6: the same logits summed in another order).
bfloat16 within 2 bf16 ulps of (|JAX| + rms(JAX)) elementwise, i.e.
(|JAX| + rms) / 64: both sides round at the same points, so they differ only
where an fp32 sum taken in another order lands on the other side of a bf16
rounding (measured at most 0.0088 of that scale).
"""
import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lvv_tpu_torch import kernels
from lvv_tpu_torch.ops import attention as tattn
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.fast

jattn = importlib.import_module("lvv_tpu.ops.attention")

KINDS = [("fused", {}), ("fused2", {}), ("v3", {"bias_mode": "edot"}),
         ("v3", {"bias_mode": "bcast"}), ("v4", {}), ("phased", {})]
SHAPES = [(4, 2, 32), (7, 3, 64), (14, 2, 64)]        # (win, heads, hd)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(win, heads, hd, dtype, b=2, seed=0):
    """qkv N(0, 1) [b, win², 3·heads·hd] and tables 0.3·N(0, 1), as the
    window benchmarks draw them, in `dtype` for both frameworks."""
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((b, win * win, 3 * heads * hd)),
            0.3 * rng.standard_normal((win, win, hd)),
            0.3 * rng.standard_normal((win, win, hd))]
    arrs = [np.asarray(jnp.asarray(a, jd).astype(jnp.float32)) for a in arrs]
    return ([jnp.asarray(a, jd) for a in arrs],
            [torch.tensor(a).to(td) for a in arrs])


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _agree(got, want, dtype):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    else:
        scale = np.abs(want) + np.sqrt(np.mean(want ** 2))
        assert np.all(np.abs(got - want) <= scale / 64), float(
            np.max(np.abs(got - want)))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("win,heads,hd", SHAPES)
@pytest.mark.parametrize("kind,opts", KINDS)
def test_window_variant_matches_pallas(kind, opts, win, heads, hd, dtype):
    (jq, jh, jw), (tq, th, tw) = _inputs(win, heads, hd, dtype)
    kw = dict(scale=1.0 / math.sqrt(hd), heads=heads, win=win, **opts)
    want = getattr(jattn, f"window_attention_{kind}")(jq, jh, jw,
                                                      interpret=True, **kw)
    before = dict(kernels.launches)
    got = getattr(tattn, f"window_attention_{kind}")(tq, th, tw, **kw)
    assert dict(kernels.launches) == before      # CPU: the plain version
    assert got.dtype == DTYPES[dtype][1]
    _agree(got, want, dtype)


@pytest.mark.parametrize("kind,opts", [
    ("fused", {"wchunk": 2}), ("phased", {"gwin": 2})])
def test_window_schedules_match_pallas(kind, opts):
    """wchunk and gwin change the TPU's schedule, not the function: the
    port takes them and computes the same output."""
    (jq, jh, jw), (tq, th, tw) = _inputs(7, 3, 64, "bfloat16")
    kw = dict(scale=0.125, heads=3, win=7, **opts)
    want = getattr(jattn, f"window_attention_{kind}")(jq, jh, jw,
                                                      interpret=True, **kw)
    got = getattr(tattn, f"window_attention_{kind}")(tq, th, tw, **kw)
    _agree(got, want, "bfloat16")
    base = getattr(tattn, f"window_attention_{kind}")(tq, th, tw, scale=0.125,
                                                     heads=3, win=7)
    assert torch.equal(got, base)


def test_phased_batched_is_a_reference_fault():
    """JAX's `window_attention_phased(batched=True)` raises in its p@v phase
    (attention.py:1707: v3's axis 1 is both a batch and a contracting
    dimension), and its A/B script records the variant as an error. The port
    takes `batched` as the schedule it is meant to be and computes the
    unbatched output (ROADMAP queue 3)."""
    (jq, jh, jw), (tq, th, tw) = _inputs(4, 2, 32, "bfloat16")
    kw = dict(scale=0.125, heads=2, win=4)
    with pytest.raises(TypeError):
        jattn.window_attention_phased(jq, jh, jw, batched=True,
                                      interpret=True, **kw)
    assert torch.equal(
        tattn.window_attention_phased(tq, th, tw, batched=True, **kw),
        tattn.window_attention_phased(tq, th, tw, **kw))


@pytest.mark.parametrize("kind,opts", KINDS)
def test_window_variants_compute_the_packed_function(kind, opts):
    """In float32 nothing is rounded, so every variant is the function of
    K-c, the window kernel SAM runs (`relpos_attention`, base e)."""
    _, (tq, th, tw) = _inputs(7, 3, 64, "float32", b=3, seed=1)
    got = getattr(tattn, f"window_attention_{kind}")(
        tq, th, tw, scale=0.125, heads=3, win=7, **opts)
    want = tattn.relpos_attention(tq, th, tw, heads=3, scale=0.125)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("kind,win,hd,opts", [
    ("fused", 8, 128, {}),                      # hd + 2·win > 128
    ("fused", 4, 32, {"wchunk": 3}),            # 2 windows in chunks of 3
    ("phased", 4, 32, {"gwin": 3}),
    ("v3", 4, 32, {"bias_mode": "gather"})])
def test_window_variants_refuse_what_jax_asserts(kind, win, hd, opts):
    _, (tq, th, tw) = _inputs(win, 2, hd, "float32")
    fn = getattr(tattn, f"window_attention_{kind}")
    with pytest.raises(ValueError):
        fn(tq, th, tw, scale=0.1, heads=2, win=win, **opts)
    with pytest.raises(ValueError):             # qkv is not win x win
        fn(tq, th, tw, scale=0.1, heads=2, win=win + 1)
