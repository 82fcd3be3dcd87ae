"""The autograd Functions of the port's kernels on the card: the kernel
forward and its recompute backward against native autograd through the
plain version, at one small shape and one shape of a full-width train step
(batch 4).

These need a CUDA card (and nvcc): they carry the `gpu` marker and skip,
with the reason, where there is none. Run them on the card with

    python -m pytest tests/test_torch_gpu_autograd.py -q --noconftest

Inputs and the cotangent are seeded bf16 on the card, each input requiring
a gradient. The output is held to the plain version with the kernel
tolerance of tests/test_torch_gpu.py (4 bf16 ulps of (|plain| +
rms(plain)) elementwise, 1/128 relative L2; a causal attention output
also max|v| / 128, chip_smoke's allowance for rows over few keys, where
the two round p to bf16 at different points); every input gradient to
native autograd through the function the backward recomputes
(`attention_reference`, `norm_plain`, `add_norm_plain`,
`ln_mlp_residual_xla`), on the kernel's saved inputs, within the same
tolerance. Each output's grad_fn is the Function's, and the kernel
launched once. A kernel without a Function refuses a gradient on the card.
"""
import pytest
import torch

from lvv_tpu_torch import kernels
from lvv_tpu_torch.ops import attention as A
from lvv_tpu_torch.ops import fused_mlp as M

pytestmark = [pytest.mark.fast, pytest.mark.gpu]


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only "
                    "there")
    return torch.Generator(device="cuda").manual_seed(0)


def _rnd(gen, *shape, std=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * std).to(
        torch.bfloat16)


def _agree(got, want, extra=0.0):
    got, want = got.detach().float(), want.float()
    err = (got - want).abs()
    scale = want.abs() + want.square().mean().sqrt()
    assert torch.isfinite(got).all()
    assert bool((err <= scale / 32 + extra).all()), float(err.max())
    assert float((got - want).norm() / want.norm()) <= 1 / 128


def _check(name, fn_name, kernel, plain, reference, inputs, gen,
           extra=0.0):
    """kernel(*leaves) through its Function against plain(*inputs) and the
    gradients of reference(*leaves) by native autograd."""
    leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
    before = kernels.launches[name]
    out = kernel(*leaves)
    torch.cuda.synchronize()
    assert kernels.launches[name] == before + 1
    outs = out if isinstance(out, tuple) else (out,)
    assert all(fn_name in type(o.grad_fn).__name__ for o in outs)
    with torch.no_grad():
        want = plain(*inputs)
    for o, w in zip(outs, want if isinstance(want, tuple) else (want,)):
        _agree(o, w, extra)
    cots = [_rnd(gen, *o.shape) for o in outs]
    torch.autograd.backward(outs, cots)
    ref_leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
    ref = reference(*ref_leaves)
    torch.autograd.backward(ref if isinstance(ref, tuple) else (ref,), cots)
    for got, r in zip(leaves, ref_leaves):
        _agree(got.grad, r.grad)


@pytest.mark.parametrize("b,sq,sk,hq,hkv,d,causal", [
    (2, 300, 300, 4, 2, 64, True),          # small: GQA, ragged
    (4, 1765, 1765, 14, 2, 64, True),       # the train step's LLM layers
    (2, 64, 1100, 8, 8, 112, False),        # small cross
    (4, 768, 1536, 8, 8, 256, False),       # the train step's VATVision
])
def test_flash_attention_fn(gen, b, sq, sk, hq, hkv, d, causal):
    q = _rnd(gen, b, sq, hq * d).view(b, sq, hq, d).transpose(1, 2)
    k = _rnd(gen, b, hkv, sk, d)
    v = _rnd(gen, b, hkv, sk, d)
    kv_len = torch.tensor([sk] * (b - 1) + [sk - 61], dtype=torch.int32,
                          device="cuda")
    kw = dict(causal=causal, kv_len=kv_len)
    _check("flash_attention", "FlashAttentionFn",
           lambda *t: A.flash_attention(*t, **kw),
           lambda *t: A.flash_attention_plain(*t, **kw),
           lambda *t: A.attention_reference(*t, **kw), (q, k, v), gen,
           extra=float(v.abs().max()) / 128 if causal else 0.0)


@pytest.mark.parametrize("rms", [False, True])
@pytest.mark.parametrize("n,c", [(37, 256), (4 * 1765, 896),
                                 (4 * 1542, 1024)])
def test_norm_fn(gen, rms, n, c):
    ins = [_rnd(gen, n, c), 1 + _rnd(gen, c, std=0.1)]
    if not rms:
        ins.append(_rnd(gen, c, std=0.1))
    _check("norm", "NormFn",
           lambda *t: M.norm_fast(*t, eps=1e-6, rms=rms),
           lambda *t: M.norm_plain(*t, eps=1e-6, rms=rms),
           lambda *t: M.norm_plain(*t, eps=1e-6, rms=rms), ins, gen)


@pytest.mark.parametrize("n", [5, 4 * 1765])
def test_add_norm_fn(gen, n):
    ins = [_rnd(gen, n, 896), _rnd(gen, n, 896), 1 + _rnd(gen, 896, std=0.1)]
    _check("norm[add]", "AddNormFn",
           lambda *t: M.add_norm_fast(*t, eps=1e-6, rms=True),
           lambda *t: M.add_norm_plain(*t, eps=1e-6, rms=True),
           lambda *t: M.add_norm_plain(*t, eps=1e-6, rms=True), ins, gen)


@pytest.mark.parametrize("quant8", [False, True], ids=["k_b", "k_f"])
@pytest.mark.parametrize("n,c,h,act", [
    (50, 128, 256, "gelu"),
    (4 * 6 * 257, 1024, 4096, "quick_gelu"),   # the train step's CLIP MLP
])
def test_ln_mlp_residual_fn(gen, quant8, n, c, h, act):
    ins = [_rnd(gen, n, c), 1 + _rnd(gen, c, std=0.1), _rnd(gen, c, std=0.1),
           _rnd(gen, c, h, std=c ** -0.5), _rnd(gen, h, std=0.1),
           _rnd(gen, h, c, std=h ** -0.5), _rnd(gen, c, std=0.1)]
    kw = dict(eps=1e-6, act=act)
    plain = M.ln_mlp_residual_q8_plain if quant8 else M.ln_mlp_residual_plain
    name = "ln_mlp_residual_q8" if quant8 else "ln_mlp_residual"
    if quant8:      # the W8A8 forward's own bound (chip_smoke.Q8_REL_L2_TOL)
        leaves = [t.detach().clone().requires_grad_(True) for t in ins]
        out = M.ln_mlp_residual(*leaves, quant8=True, **kw)
        assert "LnMlpResidualQ8Fn" in type(out.grad_fn).__name__
        got, want = out.detach().float(), plain(*ins, **kw).float()
        assert float((got - want).norm() / want.norm()) <= 1 / 512
        g = _rnd(gen, n, c)
        out.backward(g)
        ref = [t.detach().clone().requires_grad_(True) for t in ins]
        M.ln_mlp_residual_xla(*ref, **kw).backward(g)
        for a, r in zip(leaves, ref):
            _agree(a.grad, r.grad)
        return
    _check(name, "LnMlpResidualFn",
           lambda *t: M.ln_mlp_residual(*t, **kw), lambda *t: plain(*t, **kw),
           lambda *t: M.ln_mlp_residual_xla(*t, **kw), ins, gen)


def test_kernels_without_a_function_refuse_a_gradient(gen):
    qkv = _rnd(gen, 2, 196, 3 * 128)
    rel = _rnd(gen, 14, 14, 64, std=0.2)
    with pytest.raises(RuntimeError, match="no backward"):
        A.relpos_attention(qkv.requires_grad_(True), rel, rel, heads=2,
                           scale=0.125)
    with torch.no_grad():
        A.relpos_attention(qkv, rel, rel, heads=2, scale=0.125)
    from lvv_tpu_torch.ops import quant as Q
    q, s = Q.quantize_weight(_rnd(gen, 896, 1152))
    x = _rnd(gen, 1, 896).requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        Q.quantized_matmul(x, q.contiguous(), s)
