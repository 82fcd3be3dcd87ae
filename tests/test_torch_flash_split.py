"""The flash kernel's split-kv arithmetic (K-e) against the JAX package's
Pallas flash attention, and the rule that picks the split count.

On the card, `flash_attention` cuts the kv axis into `flash_splits(...)`
pieces when the q tiles, heads and batch alone give too few blocks; each
piece keeps its own softmax state (m, l, o) and a combine kernel merges
them. `flash_attention_split_plain` is that arithmetic in plain PyTorch; here
it is held, at 1, 2 and 5 splits, to the TPU kernel run in Pallas interpret
mode on the same seeded float32 inputs, within 5e-5 of (1 + |reference|)
(float32 round-off over softmax sums of >= 1024 terms taken in another
order, as tests/test_torch_ops.py states).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lvv_tpu_torch.ops import attention as tattn
from torch_parity_util import close
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.fast

# lvv_tpu.ops re-exports a function named `attention` over its module
jattn = importlib.import_module("lvv_tpu.ops.attention")


def _inputs(seed, b, hq, hkv, sq, sk, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d))]


CASES = {
    # non-causal at VATLiDAR's head dim, ragged kv (1300 is no whole number
    # of tiles) and a second row cut to 1000 keys
    "noncausal_d112_ragged": dict(shape=(2, 2, 2, 40, 1300, 112),
                                  causal=False, kv_len=[1300, 1000]),
    # causal GQA; row 1's 60 keys end before the second split starts, so
    # that split holds none of its keys and must weigh 0. The length is a
    # whole number of both Pallas tiles (tests/test_torch_ops.py says why)
    "causal_gqa_kvlen_short": dict(shape=(2, 4, 2, 256, 256, 64),
                                   causal=True, kv_len=[256, 60]),
    # q and kv of different lengths, non-causal
    "cross_sq_ne_sk": dict(shape=(1, 2, 2, 100, 2000, 64), causal=False,
                           kv_len=None),
}


@pytest.mark.parametrize("n_split", [1, 2, 5])
@pytest.mark.parametrize("case", sorted(CASES))
def test_split_plain_matches_pallas(case, n_split):
    c = CASES[case]
    q, k, v = _inputs(11, *c["shape"])
    kv_len = (None if c["kv_len"] is None
              else np.array(c["kv_len"], np.int32))
    want = jattn.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=c["causal"],
        kv_len=None if kv_len is None else jnp.asarray(kv_len), block_q=64,
        block_k=128, interpret=True)
    got = tattn.flash_attention_split_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        n_split=n_split, causal=c["causal"],
        kv_len=None if kv_len is None else torch.from_numpy(kv_len))
    close(got, want, 5e-5)


def test_a_split_past_kv_len_weighs_nothing():
    """Splits wholly past a row's last key change nothing: 5 splits over
    2048 keys with kv_len 100 give the 1-split result."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(3, 1, 2, 2, 64, 2048,
                                                     64))
    kv_len = torch.tensor([100], dtype=torch.int32)
    one = tattn.flash_attention_split_plain(q, k, v, n_split=1,
                                            kv_len=kv_len)
    five = tattn.flash_attention_split_plain(q, k, v, n_split=5,
                                             kv_len=kv_len)
    close(five, one.numpy(), 2e-6)
    close(one, tattn.attention_reference(q, k, v, kv_len=kv_len).numpy(),
          2e-5)


def test_split_count_fills_the_card_at_vatlidar():
    """VATLiDAR's cross-attention (q 768 over kv 32,400, 8 heads, batch 1)
    gives 6 q tiles x 8 heads = 48 blocks alone; its splits bring the grid
    to at least one block per SM of the H100's 132, each split holding at
    least 512 keys."""
    n = tattn.flash_splits(1, 8, 768, 32400)
    assert n > 1
    assert 6 * 8 * n >= 132
    assert 32400 // n >= 512


@pytest.mark.parametrize("shape", [
    (1, 14, 1564, 1564),      # the causal Qwen prefill: 13 x 14 blocks
    (8, 8, 768, 32400),       # VATLiDAR at serving batch 8: 384 blocks
    (1, 8, 768, 700),         # too few keys to split
])
def test_split_count_is_one_where_it_should_be(shape):
    assert tattn.flash_splits(*shape) == 1


def test_split_count_is_a_function_of_the_shapes_only():
    shapes = [(1, 8, 768, 32400), (1, 8, 768, 1536), (1, 8, 1200, 2400),
              (2, 2, 40, 5000)]
    first = [tattn.flash_splits(*s) for s in shapes]
    assert first == [tattn.flash_splits(*s) for s in shapes]
    for (b, hq, sq, sk), n in zip(shapes, first):
        assert 1 <= n <= max(1, sk // 512)
