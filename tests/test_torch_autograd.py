"""The port's autograd Functions against jax.vjp of the JAX package's ops.

Each Function (ops/autograd.py) runs the kernel wrapper forward (its plain
version on a CPU tensor) and a plain recompute backward, as the JAX
package's custom VJPs do (the Pallas kernel forward, run here in
interpret mode, and an XLA recompute backward). Inputs and one seeded
cotangent are shared as numpy arrays; in float32 the outputs and every
input gradient agree within TOL relative to (1 + |JAX|) (measured at most
2.2e-6, the W8A8 forward of K-f included). Each test also checks that the port's output came from its
Function (its grad_fn), so a silent graph cut fails it. Kernels without a
VJP in the JAX package refuse a gradient on a CUDA tensor; the refusal
itself is held on the CPU through `kernels.refuse_grad`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lvv_tpu.ops import fused_mlp as jmlp
from lvv_tpu.ops.attention import flash_attention as jax_flash_attention
from lvv_tpu_torch import kernels
from lvv_tpu_torch.ops import attention as A
from lvv_tpu_torch.ops import fused_mlp as M
from torch_parity_util import close
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.fast

TOL = 1e-4


def _rand(rng, *shape, std=1.0):
    return (std * rng.standard_normal(shape)).astype(np.float32)


def port_vjp(fn, inputs, cotangents):
    """(outputs, input grads) of the port's fn on float32 CPU tensors."""
    ts = [torch.tensor(a, requires_grad=True) for a in inputs]
    out = fn(*ts)
    outs = out if isinstance(out, tuple) else (out,)
    torch.autograd.backward(outs, [torch.tensor(c) for c in cotangents])
    return outs, [t.grad.numpy() for t in ts]


def jax_vjp(fn, inputs, cotangents):
    out, pull = jax.vjp(fn, *(jnp.asarray(a) for a in inputs))
    outs = out if isinstance(out, tuple) else (out,)
    cot = tuple(jnp.asarray(c) for c in cotangents)
    grads = pull(cot if isinstance(out, tuple) else cot[0])
    return [np.asarray(o) for o in outs], [np.asarray(g) for g in grads]


def compare(port_fn, jax_fn, inputs, cotangents, fn_name):
    outs, grads = port_vjp(port_fn, inputs, cotangents)
    assert all(fn_name in type(o.grad_fn).__name__ for o in outs), \
        [type(o.grad_fn).__name__ for o in outs]
    j_outs, j_grads = jax_vjp(jax_fn, inputs, cotangents)
    for o, jo in zip(outs, j_outs):
        close(o.detach().numpy(), jo, TOL)
    for g, jg in zip(grads, j_grads):
        close(g, jg, TOL)
        assert np.abs(jg).max() > 0


@pytest.mark.parametrize("case", ["causal_ragged", "gqa", "cross"])
def test_flash_attention_fn_matches_jax_vjp(case):
    """K-e: causal self-attention over 128 keys (one tile each way, so the
    Pallas kernel's padded causal offset does not shift) with ragged
    kv_len; GQA 4 / 2 heads; cross-attention 24 queries over 200 keys."""
    rng = np.random.default_rng(0)
    b, hq, hkv, sq, sk, d = {"causal_ragged": (2, 2, 2, 128, 128, 64),
                             "gqa": (2, 4, 2, 128, 128, 64),
                             "cross": (2, 2, 2, 24, 200, 112)}[case]
    causal = case != "cross"
    kv_len = np.array([sk, sk - 37], np.int32)
    inputs = [_rand(rng, b, hq, sq, d), _rand(rng, b, hkv, sk, d),
              _rand(rng, b, hkv, sk, d)]
    g = _rand(rng, b, hq, sq, d)

    def port(q, k, v):
        return A.flash_attention(q, k, v, causal=causal,
                                 kv_len=torch.tensor(kv_len))

    def jfn(q, k, v):
        return jax_flash_attention(q, k, v, causal=causal,
                                   kv_len=jnp.asarray(kv_len), block_k=128,
                                   interpret=True)
    compare(port, jfn, inputs, [g], "FlashAttentionFn")


@pytest.mark.parametrize("rms", [False, True], ids=["layernorm", "rms"])
def test_norm_fn_matches_jax_vjp(rms):
    """K-a: LayerNorm (scale and bias) and RMSNorm over 128 lanes, 20 rows
    (padded to a tile inside the Pallas kernel)."""
    rng = np.random.default_rng(1)
    inputs = [_rand(rng, 4, 5, 128), 1 + _rand(rng, 128, std=0.1)]
    if not rms:
        inputs.append(_rand(rng, 128, std=0.1))
    g = _rand(rng, 4, 5, 128)

    def port(x, s, b=None):
        return M.norm_fast(x, s, b, eps=1e-6, rms=rms)

    def jfn(x, s, b=None):
        return jmlp.norm_fast(x, s, b, eps=1e-6, rms=rms, interpret=True)
    compare(port, jfn, inputs, [g], "NormFn")


def test_add_norm_fn_carries_both_cotangents():
    """K-a's add form: (s, n) = (x + y, RMS(x + y)); JAX computes the add
    in XLA before its norm kernel. Both outputs get a cotangent, and x and
    y each receive the sum of both paths."""
    rng = np.random.default_rng(2)
    inputs = [_rand(rng, 6, 128), _rand(rng, 6, 128),
              1 + _rand(rng, 128, std=0.1)]
    cots = [_rand(rng, 6, 128), _rand(rng, 6, 128)]

    def port(x, y, s):
        return M.add_norm_fast(x, y, s, eps=1e-6, rms=True)

    def jfn(x, y, s):
        t = x + y
        return t, jmlp.norm_fast(t, s, eps=1e-6, rms=True, interpret=True)
    compare(port, jfn, inputs, cots, "AddNormFn")
    # the n path alone still reaches x and y through s
    _, grads = port_vjp(port, inputs, [np.zeros_like(cots[0]), cots[1]])
    assert np.abs(grads[0]).max() > 0 and np.abs(grads[1]).max() > 0


@pytest.mark.parametrize("quant8", [False, True], ids=["k_b", "k_f"])
@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
def test_ln_mlp_residual_fn_matches_jax_vjp(act, quant8):
    """K-b (float) and K-f (W8A8 forward, straight-through float
    backward): x [3, 7, 128], hidden 256, with the caller's activation."""
    rng = np.random.default_rng(3)
    c, h = 128, 256
    inputs = [_rand(rng, 3, 7, c), 1 + _rand(rng, c, std=0.1),
              _rand(rng, c, std=0.1), _rand(rng, c, h, std=c ** -0.5),
              _rand(rng, h, std=0.1), _rand(rng, h, c, std=h ** -0.5),
              _rand(rng, c, std=0.1)]
    g = _rand(rng, 3, 7, c)

    def port(*args):
        return M.ln_mlp_residual(*args, eps=1e-6, act=act, quant8=quant8)

    def jfn(*args):
        return jmlp.ln_mlp_residual(*args, eps=1e-6, act=act, quant8=quant8,
                                    interpret=True)
    compare(port, jfn, inputs, [g],
            "LnMlpResidualQ8Fn" if quant8 else "LnMlpResidualFn")


def _bf16_steps(a, b):
    """How many bf16 values lie between a and b, elementwise (0: equal,
    1: neighbours), from the bit patterns in sign-magnitude order."""
    def key(x):
        i = torch.tensor(x).to(torch.bfloat16).view(torch.int16).numpy()
        i = i.astype(np.int32)
        return np.where(i < 0, -(i & 0x7FFF), i)
    return np.abs(key(a) - key(b))


def _is_xla_forward(got, want) -> bool:
    """Every output within one bf16 step of JAX's, at most 1% differing."""
    steps = _bf16_steps(got, want)
    return steps.max() <= 1 and (steps > 0).mean() <= 0.01


def test_recompute_is_jax_xla_forward():
    """K-b's recompute (`ln_mlp_residual_xla`) is JAX's `_xla_forward` in
    bf16: z not rounded before the activation. Bit equality cannot hold
    across CPUs: z = y·w1 comes from two fp32 GEMMs that sum in their own
    order (up to 6.0e-7 apart at these inputs on an AMD EPYC) and the
    activation from two vector maths (up to 4.8e-7 apart), so a bf16
    rounding tie may land on either side: there 1 of 1,152 quick_gelu
    outputs is one step off, none of gelu's. The check (every output
    within one bf16 step, at most 1% differing) still tells the recompute
    from the kernel's arithmetic, which rounds z before the activation
    (`ln_mlp_residual_plain`: 455 and 497 of 1,152 differ, by up to 76
    and 235 steps)."""
    rng = np.random.default_rng(4)
    c, h = 128, 256
    args = [_rand(rng, 9, c), 1 + _rand(rng, c, std=0.1),
            _rand(rng, c, std=0.1), _rand(rng, c, h, std=c ** -0.5),
            _rand(rng, h, std=0.1), _rand(rng, h, c, std=h ** -0.5),
            _rand(rng, c, std=0.1)]
    targs = [torch.tensor(a).to(torch.bfloat16) for a in args]
    for act in ("gelu", "quick_gelu"):
        want = np.asarray(jmlp._xla_forward(
            *(jnp.asarray(a, jnp.bfloat16) for a in args), 1e-6, act),
            np.float32)
        got = M.ln_mlp_residual_xla(*targs, eps=1e-6, act=act)
        assert _is_xla_forward(got.float().numpy(), want), act
        # the trap: z rounded before the activation fails the same check
        trap = M.ln_mlp_residual_plain(*targs, eps=1e-6, act=act)
        assert not _is_xla_forward(trap.float().numpy(), want), act


def test_guarded_kernels_refuse_a_gradient():
    """A kernel with no Function raises before a launch whose input needs a
    gradient, instead of returning a leaf; without grad mode, or on inputs
    that need none, it passes."""
    x = torch.zeros(2, 3, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        kernels.refuse_grad("relpos_attention", x)
    with torch.no_grad():
        kernels.refuse_grad("relpos_attention", x)
    kernels.refuse_grad("relpos_attention", x.detach(), None)
    assert kernels.wants_grad(None, x) and not kernels.wants_grad(x.detach())
    # each guarded wrapper checks its inputs before its launch, also where
    # the operands are otherwise fine (a CPU tensor reaches no launch)
    from lvv_tpu_torch.ops import quant
    q = torch.zeros(128, 128, dtype=torch.int8)
    with pytest.raises(RuntimeError, match="no backward"):
        quant._launch("int8_matmul", torch.zeros(1, 128, requires_grad=True),
                      q, torch.ones(128), 128, 128, nk=False)
    with pytest.raises(RuntimeError, match="no backward"):
        A._relpos_launch(torch.zeros(1, 4, 6 * 64, requires_grad=True),
                         torch.zeros(2, 2, 64), torch.zeros(2, 2, 64),
                         heads=2, scale=0.125)
