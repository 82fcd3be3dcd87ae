"""The port's kernel modules against the JAX package's Pallas kernels.

Each Hopper kernel's plain PyTorch version (what its wrapper computes on a
CPU tensor) is held to the TPU kernel it replaces, run in Pallas interpret
mode on the CPU, on the same seeded float32 inputs at small kernel-eligible
shapes. Tolerances are float32 round-off over sums of a few hundred terms
taken in another order: 2e-5 relative to (1 + |reference|), 5e-5 where a
matmul or softmax over >= 1024 terms sits in between.
"""
import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lvv_tpu.ops import fused_mlp as jmlp
from lvv_tpu_torch import kernels
from lvv_tpu_torch.ops import attention as tattn
from lvv_tpu_torch.ops import fused_mlp as tmlp
from torch_parity_util import close
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.fast

# lvv_tpu.ops re-exports a function named `attention` over its module
jattn = importlib.import_module("lvv_tpu.ops.attention")


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("rms", [False, True])
def test_norm_matches_pallas(rms):
    """K-a: row LayerNorm / RMSNorm, C = 256, ragged N."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((37, 256)).astype(np.float32) * 3 + 1
    s = 1 + 0.1 * rng.standard_normal(256).astype(np.float32)
    b = 0.1 * rng.standard_normal(256).astype(np.float32)
    bias = None if rms else b
    want = jmlp.norm_fast(jnp.asarray(x), jnp.asarray(s),
                          None if rms else jnp.asarray(b), eps=1e-6, rms=rms,
                          interpret=True)
    got = tmlp.norm(_t(x), _t(s), None if bias is None else _t(bias),
                    eps=1e-6, rms=rms)
    close(got, want, 2e-5)
    close(tmlp.norm_fast(_t(x), _t(s), None if bias is None else _t(bias),
                         eps=1e-6, rms=rms), want, 2e-5)


@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
def test_ln_mlp_residual_matches_pallas(act):
    """K-b: x + act(LN(x) W1 + b1) W2 + b2 at C = 128, H = 256, ragged N."""
    rng = np.random.default_rng(1)
    n, c, h = 50, 128, 256
    args = [rng.standard_normal((n, c)).astype(np.float32),
            1 + 0.1 * rng.standard_normal(c).astype(np.float32),
            0.1 * rng.standard_normal(c).astype(np.float32),
            rng.standard_normal((c, h)).astype(np.float32) / math.sqrt(c),
            0.1 * rng.standard_normal(h).astype(np.float32),
            rng.standard_normal((h, c)).astype(np.float32) / math.sqrt(h),
            0.1 * rng.standard_normal(c).astype(np.float32)]
    want = jmlp.ln_mlp_residual(*map(jnp.asarray, args), eps=1e-6, act=act,
                                interpret=True)
    got = tmlp.ln_mlp_residual(*map(_t, args), eps=1e-6, act=act)
    close(got, want, 2e-5)


def test_flash_attention_causal_kvlen_gqa_matches_pallas():
    """K-e: causal with per-batch kv_len and GQA (4 q heads over 2 kv).

    The length is a whole number of both tiles: the TPU wrapper takes the
    causal offset from the PADDED lengths, so where pad(S, block_q) !=
    pad(S, block_k) (e.g. S = 1564 at its default tiles) its mask shifts and
    it disagrees with its own attention_reference. The port keeps the
    reference's mask."""
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 4, 256, 64)).astype(np.float32)
    k = rng.standard_normal((2, 2, 256, 64)).astype(np.float32)
    v = rng.standard_normal((2, 2, 256, 64)).astype(np.float32)
    kv_len = np.array([256, 97], np.int32)
    want = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=True,
                                 kv_len=jnp.asarray(kv_len), block_q=64,
                                 block_k=128, interpret=True)
    got = tattn.flash_attention(_t(q), _t(k), _t(v), causal=True,
                                kv_len=_t(kv_len))
    close(got, want, 2e-5)


def test_jax_flash_causal_offset_shifts_under_padding():
    """The reference fault the port does not copy: at S = 160 with tiles
    64 / 128 the TPU wrapper pads q to 192 and k to 256, so its causal
    offset becomes +64 and each query row also sees the next 64 keys. The
    port's flash_attention keeps attention_reference's mask."""
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal((1, 2, 160, 64)).astype(np.float32)
               for _ in range(3))
    want = jattn.attention_reference(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=True)
    shifted = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=True, block_q=64,
                                    block_k=128, interpret=True)
    assert float(jnp.abs(shifted - want).max()) > 0.1
    close(tattn.flash_attention(_t(q), _t(k), _t(v), causal=True), want,
          2e-5)


def test_flash_attention_noncausal_hd112_matches_pallas():
    """K-e: non-causal cross-attention at head dim 112 (VATLiDAR's), ragged
    kv length (the TPU kernel pads it and masks)."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((1, 2, 40, 112)).astype(np.float32)
    k = rng.standard_normal((1, 2, 300, 112)).astype(np.float32)
    v = rng.standard_normal((1, 2, 300, 112)).astype(np.float32)
    want = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), block_k=128, interpret=True)
    got = tattn.flash_attention(_t(q), _t(k), _t(v))
    close(got, want, 2e-5)


def _relpos_inputs(b, heads, gh, gw, d, seed):
    rng = np.random.default_rng(seed)
    qkv = 0.5 * rng.standard_normal((b, gh * gw, 3 * heads * d))
    rel_h = 0.1 * rng.standard_normal((gh, gh, d))
    rel_w = 0.1 * rng.standard_normal((gw, gw, d))
    return [a.astype(np.float32) for a in (qkv, rel_h, rel_w)]


def test_relpos_window_matches_pallas():
    """K-c: 14x14 window attention with the rel-pos bias, 2 heads, hd 64."""
    qkv, rh, rw = _relpos_inputs(2, 2, 14, 14, 64, seed=4)
    want = jattn.window_attention_packed(
        jnp.asarray(qkv), jnp.asarray(rh), jnp.asarray(rw), scale=0.125,
        heads=2, win=14, interpret=True)
    got = tattn.relpos_attention(_t(qkv), _t(rh), _t(rw), heads=2,
                                 scale=0.125)
    close(got, want, 2e-5)


def test_relpos_global_matches_pallas():
    """K-d: global attention over a 32x32 grid with the rel-pos bias,
    2 heads, hd 64, one 1024 x 1024 tile."""
    qkv, rh, rw = _relpos_inputs(1, 2, 32, 32, 64, seed=5)
    want = jattn.flash_attention_relpos_hpacked(
        jnp.asarray(qkv), jnp.asarray(rh), jnp.asarray(rw), scale=0.125,
        grid_w=32, heads=2, block_q=1024, block_k=1024, interpret=True)
    got = tattn.relpos_attention(_t(qkv), _t(rh), _t(rw), heads=2,
                                 scale=0.125)
    close(got, want, 5e-5)


def test_attention_dispatch_matches_reference():
    """`attention` keeps the JAX rule; on the CPU every branch computes the
    reference, including GQA decode over a cache."""
    rng = np.random.default_rng(6)
    q = _t(rng.standard_normal((1, 4, 1, 16)).astype(np.float32))
    kc = _t(rng.standard_normal((1, 2, 20, 16)).astype(np.float32))
    vc = _t(rng.standard_normal((1, 2, 20, 16)).astype(np.float32))
    n = torch.tensor([7])
    want = jattn.decode_attention(jnp.asarray(q.numpy()),
                                  jnp.asarray(kc.numpy()),
                                  jnp.asarray(vc.numpy()), jnp.asarray([7]))
    close(tattn.decode_attention(q, kc, vc, n), want, 2e-5)
    close(tattn.attention(q, kc, vc, kv_len=n), want, 2e-5)


def test_cpu_wrappers_launch_nothing():
    """On CPU tensors the wrappers take their plain versions: no launch is
    counted and no kernel library is built."""
    kernels.launches.clear()
    x = torch.randn(4, 128)
    tmlp.norm(x, torch.ones(128), torch.zeros(128), eps=1e-6)
    tmlp.add_norm(x, x, torch.ones(128), eps=1e-6, rms=True)
    tattn.flash_attention(torch.randn(1, 1, 8, 64), torch.randn(1, 1, 8, 64),
                          torch.randn(1, 1, 8, 64))
    assert sum(kernels.launches.values()) == 0
    assert not kernels._libs
