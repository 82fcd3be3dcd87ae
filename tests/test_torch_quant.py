"""The port's int8 ops against the JAX package's (lvv_tpu/ops/quant.py and
the W8A8 fused MLP in lvv_tpu/ops/fused_mlp.py).

- Quantization is bit-equal: the same float weights give equal int8 arrays
  and equal scales.
- Each kernel's plain version (what its wrapper computes on a CPU tensor)
  is held to the Pallas kernel it replaces, run in interpret mode on the
  CPU, on the same seeded float32 inputs. Tolerance 2e-5 relative to
  (1 + |reference|): float32 round-off of sums taken in another order. The
  W8A8 MLP's int8 products are exact on both sides; an int8 rounding flip
  (a borderline LN value rounded the other way) would exceed it, and none
  occurs on these inputs.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lvv_tpu.ops import fused_mlp as jmlp
from lvv_tpu.ops import quant as jq
from lvv_tpu_torch import kernels
from lvv_tpu_torch.ops import fused_mlp as tmlp
from lvv_tpu_torch.ops import quant as tq
from torch_parity_util import close
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.fast

TOL = 2e-5


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_quantization_is_bit_equal(dtype):
    """quantize_weight (per column) and quantize_rows (per row), including
    all-zero columns / rows (the 1e-8 scale floor) and bf16 inputs."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((300, 200)).astype(np.float32)
    w[:, 7] = 0.0
    w[11] = 0.0
    jw, tw = jnp.asarray(w), _t(w)
    if dtype == "bfloat16":
        jw, tw = jw.astype(jnp.bfloat16), tw.to(torch.bfloat16)
    for jfn, tfn in ((jq.quantize_weight, tq.quantize_weight),
                     (jq.quantize_rows, tq.quantize_rows)):
        jqv, js = jfn(jw)
        tqv, ts = tfn(tw)
        assert tqv.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(tqv.numpy(), np.asarray(jqv))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_int8_dot_matches_jax():
    """The plain W8A8 product (exact integer sums, fp32 rescale, bias)."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 256)).astype(np.float32)
    w = (0.05 * rng.standard_normal((256, 96))).astype(np.float32)
    b = (0.1 * rng.standard_normal(96)).astype(np.float32)
    want = jq.int8_dot(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    close(tq.int8_dot(_t(x), _t(w), _t(b)), want, TOL)


def _mlp_args(n, c, h, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((n, c)).astype(np.float32),
            1 + 0.1 * rng.standard_normal(c).astype(np.float32),
            0.1 * rng.standard_normal(c).astype(np.float32),
            rng.standard_normal((c, h)).astype(np.float32) / math.sqrt(c),
            0.1 * rng.standard_normal(h).astype(np.float32),
            rng.standard_normal((h, c)).astype(np.float32) / math.sqrt(h),
            0.1 * rng.standard_normal(c).astype(np.float32)]


@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
def test_ln_mlp_residual_q8_matches_pallas(act):
    """K-f: C = 128, H = 256 in two 128-wide chunks (each with its own row
    scales of h), 50 tokens (not a multiple of 8)."""
    args = _mlp_args(50, 128, 256, seed=1)
    want = jmlp.ln_mlp_residual(*map(jnp.asarray, args), eps=1e-6, act=act,
                                block_h=128, quant8=True, interpret=True)
    got = tmlp.ln_mlp_residual_q8_plain(*map(_t, args), eps=1e-6, act=act,
                                        block_h=128)
    close(got, want, TOL)
    # one whole-row scale of h (one chunk) is another function
    one = tmlp.ln_mlp_residual_q8_plain(*map(_t, args), eps=1e-6, act=act,
                                        block_h=256)
    assert float((one - got).abs().max()) > 1e-3


def test_ln_mlp_residual_q8_wrapper_and_chunk_rule():
    """The CPU wrapper (and ln_mlp_residual(quant8=True)) computes the plain
    version at the JAX package's own chunk, which depends on the dtype:
    SAM 3072 / CLIP 2048 in bf16, 1536 / 1024 in fp32."""
    for c, h, size, want in ((768, 3072, 2, 3072), (1024, 4096, 2, 2048),
                             (768, 3072, 4, 1536), (1024, 4096, 4, 1024),
                             (128, 192, 2, 64)):
        assert tmlp.q8_block_h(c, h, size) == want
    args = _mlp_args(20, 128, 256, seed=2)
    want = jmlp.ln_mlp_residual(*map(jnp.asarray, args), eps=1e-6,
                                act="gelu", quant8=True, interpret=True)
    close(tmlp.ln_mlp_residual(*map(_t, args), eps=1e-6, act="gelu",
                               quant8=True), want, TOL)
    close(tmlp.ln_mlp_residual_q8(*map(_t, args), eps=1e-6, act="gelu"),
          want, TOL)


@pytest.mark.parametrize("m,k,n", [(1, 384, 640), (3, 256, 200)])
def test_quantized_matmul_matches_pallas(m, k, n):
    """K-j: x [M, K] @ int8 [K, N] * s [N]; x bf16-representable (the Pallas
    wrapper casts it to bf16); N = 200 is no multiple of 128."""
    rng = np.random.default_rng(3)
    x = np.asarray(jnp.asarray(rng.standard_normal((m, k)), jnp.bfloat16),
                   np.float32)
    q, s = jq.quantize_weight(jnp.asarray(rng.standard_normal((k, n)),
                                          jnp.float32))
    want = jq.quantized_matmul(jnp.asarray(x), q, s, interpret=True)
    got = tq.quantized_matmul(_t(x), _t(q), _t(s))
    close(got, want, TOL)


@pytest.mark.parametrize("m,k,n", [(1, 256, 1000), (3, 128, 200)])
def test_quantized_matmul_nk_matches_pallas(m, k, n):
    """K-k: x [M, K] @ int8 [N, K]ᵀ * s [N] (per-row scales of the table).
    The Pallas wrapper computes in the dtype of its bf16 copy of x, so its
    output is rounded to bf16: tolerance 2^-8 relative to (1 + |JAX|)."""
    rng = np.random.default_rng(4)
    x = np.asarray(jnp.asarray(rng.standard_normal((m, k)), jnp.bfloat16),
                   np.float32)
    table = (0.02 * rng.standard_normal((n, k))).astype(np.float32)
    tab = tq.quantize_rows_table(_t(table))
    q, s = jq.quantize_rows(jnp.asarray(table))
    np.testing.assert_array_equal(tab["q"].numpy(), np.asarray(q))
    want = jq.quantized_matmul_nk(jnp.asarray(x), q, s[:, 0], interpret=True)
    close(tq.quantized_matmul_nk(_t(x), tab["q"], tab["s"]), want, 2 ** -8)


def test_sam_block_quant8_matches_jax(monkeypatch):
    """One quant8 SAMBlock (width 256, 4 heads, window 14) against JAX's
    with every Pallas kernel in interpret mode (the W8A8 MLP among them).
    The port's CPU tensor takes the q8 plain version once kernel_ok admits
    it. Tolerance 1e-4 relative to (1 + |JAX|): the port's attention is the
    plain path with a materialised bias, JAX's the window kernel."""
    import jax
    from lvv_tpu.models.sam import SAMBlock as JaxSAMBlock
    from lvv_tpu_torch.models.sam import SAMBlock
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1, 14, 14, 256)).astype(np.float32)
    blk = JaxSAMBlock(num_heads=4, window_size=14, input_size=(14, 14),
                      quant8=True)
    shapes = jax.eval_shape(blk.init, jax.random.PRNGKey(0), x)["params"]
    params = jax.tree_util.tree_map(
        lambda s: (0.05 * rng.standard_normal(s.shape)).astype(np.float32),
        shapes)
    for ln in ("ln1", "ln2"):
        params[ln]["scale"] = params[ln]["scale"] + 1.0
    jmlp.set_interpret(True)
    try:
        want = np.asarray(blk.apply({"params": params}, jnp.asarray(x)))
    finally:
        jmlp.set_interpret(False)
    port = SAMBlock(256, 4, 14, 4.0, True, (14, 14), quant8=True,
                    dtype=torch.float32, device="cpu")
    flat = {}

    def walk(tree, prefix):
        for key, val in tree.items():
            if isinstance(val, dict):
                walk(val, f"{prefix}{key}.")
            else:
                flat[prefix + key] = _t(val)
    walk(params, "")
    port.load_state_dict(flat)
    calls = []

    def ok(t, c, h):
        calls.append((c, h))
        return c % 128 == 0 and h % 128 == 0
    monkeypatch.setattr(tmlp, "kernel_ok", ok)
    with torch.no_grad():
        got = port(_t(x))
    assert (256, 1024) in calls
    close(got, want, 1e-4)
    # and the quant8 block is not the float block
    port.quant8 = False
    with torch.no_grad():
        assert float((port(_t(x)) - got).abs().max()) > 1e-3


def test_cpu_int8_wrappers_launch_nothing():
    """On CPU tensors the int8 wrappers take their plain versions."""
    kernels.launches.clear()
    q, s = tq.quantize_weight(torch.randn(64, 32))
    tq.quantized_matmul(torch.randn(2, 64), q, s)
    tq.quantized_matmul_nk(torch.randn(2, 32), q, torch.ones(64))
    tmlp.ln_mlp_residual_q8(torch.randn(3, 128), torch.ones(128),
                            torch.zeros(128), torch.randn(128, 256),
                            None, torch.randn(256, 128), None)
    tq.w8a8_matmul(torch.randn(3, 128), torch.randn(128, 256))
    assert sum(kernels.launches.values()) == 0
    assert not kernels._libs
