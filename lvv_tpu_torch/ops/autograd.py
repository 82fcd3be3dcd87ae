"""Autograd for the kernels that training differentiates through
(counterpart of the JAX package's custom VJPs).

The JAX package has no Pallas backward. Each of its VJPs runs the kernel
forward and, for the backward, recomputes the function in plain XLA and
differentiates that (`_flash_diff_bwd`, lvv_tpu/ops/attention.py:224-239;
`_norm_vjp_bwd`, ops/fused_mlp.py:263-267; `_vjp_bwd`, :322-331, which
K-f's W8A8 form takes as a straight-through backward, :357-360). Each
Function here does the same: its forward calls the kernel wrapper (the
hand-written kernel on a CUDA tensor, the plain version on a CPU tensor),
its backward re-runs the plain PyTorch function under `enable_grad` and
returns `torch.autograd.grad` of it.

- `FlashAttentionFn`: K-e, causal with the true lengths' offset, kv_len,
  GQA and the cross form, recomputed through `attention_reference` (the
  forward's mask, not the Pallas kernel's padded offset: ROADMAP queue 3).
- `NormFn` and `AddNormFn`: K-a and its add form, two outputs (s = x + y
  and norm(s)) whose cotangents both reach x and y.
- `LnMlpResidualFn`: K-b, recomputed as `_xla_forward` computes it
  (`ln_mlp_residual_xla`).
- `LnMlpResidualQ8Fn`: K-f forward, K-b's float recompute backward.

The wrappers route here where `kernels.wants_grad` holds (grad mode on
and an input or weight that requires a gradient); the kernels without a
VJP in the JAX package refuse such inputs (`kernels.refuse_grad`).
"""
from __future__ import annotations

import torch

from . import attention as A
from . import fused_mlp as M


def _vjp(fn, inputs, needs, cotangents):
    """Gradients of fn(*inputs) with respect to the inputs marked in
    `needs`, for the outputs' `cotangents` (None: that output is unused):
    fn re-run on detached copies under enable_grad."""
    with torch.enable_grad():
        xs = [None if t is None else t.detach().requires_grad_(need)
              for t, need in zip(inputs, needs)]
        outs = fn(*xs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        pairs = [(o, c) for o, c in zip(outs, cotangents) if c is not None]
        wrt = [x for x, need in zip(xs, needs) if need]
        grads = iter(torch.autograd.grad(
            [o for o, _ in pairs], wrt, [c for _, c in pairs],
            allow_unused=True))
    return [next(grads) if need else None for need in needs]


class FlashAttentionFn(torch.autograd.Function):
    """K-e forward; backward through `attention_reference` on the saved q,
    k, v (the [B, H, Sq, Sk] scores exist only inside the backward)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, kv_len, scale):
        ctx.save_for_backward(q, k, v, kv_len)
        ctx.causal, ctx.scale = causal, scale
        return A.flash_attention(q, k, v, causal=causal, kv_len=kv_len,
                                 scale=scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v, kv_len = ctx.saved_tensors

        def fn(q, k, v):
            return A.attention_reference(q, k, v, causal=ctx.causal,
                                         kv_len=kv_len, scale=ctx.scale)
        return (*_vjp(fn, (q, k, v), ctx.needs_input_grad[:3], (g,)),
                None, None, None)


class NormFn(torch.autograd.Function):
    """K-a forward through `fn` (`norm` or `norm_fast`); backward through
    `norm_plain` (JAX's `_norm_xla`)."""

    @staticmethod
    def forward(ctx, fn, x, scale, bias, eps, rms):
        ctx.save_for_backward(x, scale, bias)
        ctx.eps, ctx.rms = eps, rms
        return fn(x, scale, bias, eps=eps, rms=rms)

    @staticmethod
    def backward(ctx, g):
        def fn(x, scale, bias):
            return M.norm_plain(x, scale, bias, eps=ctx.eps, rms=ctx.rms)
        return (None, *_vjp(fn, ctx.saved_tensors,
                            ctx.needs_input_grad[1:4], (g,)), None, None)


class AddNormFn(torch.autograd.Function):
    """K-a's add form through `fn` (`add_norm` or `add_norm_fast`): (s, n)
    with s = x + y and n = norm(s); the backward carries both cotangents
    through `add_norm_plain`."""

    @staticmethod
    def forward(ctx, fn, x, y, scale, bias, eps, rms):
        ctx.save_for_backward(x, y, scale, bias)
        ctx.eps, ctx.rms = eps, rms
        return fn(x, y, scale, bias, eps=eps, rms=rms)

    @staticmethod
    def backward(ctx, gs, gn):
        def fn(x, y, scale, bias):
            return M.add_norm_plain(x, y, scale, bias, eps=ctx.eps,
                                    rms=ctx.rms)
        return (None, *_vjp(fn, ctx.saved_tensors,
                            ctx.needs_input_grad[1:5], (gs, gn)), None,
                None)


class LnMlpResidualFn(torch.autograd.Function):
    """K-b forward through `fn`; backward through `ln_mlp_residual_xla`
    with the caller's activation. K-f's W8A8 forward takes the same
    backward (`LnMlpResidualQ8Fn`)."""

    @staticmethod
    def forward(ctx, fn, x, ls, lb, w1, b1, w2, b2, eps, act):
        ctx.save_for_backward(x, ls, lb, w1, b1, w2, b2)
        ctx.eps, ctx.act = eps, act
        return fn(x, ls, lb, w1, b1, w2, b2, eps=eps, act=act)

    @staticmethod
    def backward(ctx, g):
        def fn(*args):
            return M.ln_mlp_residual_xla(*args, eps=ctx.eps, act=ctx.act)
        return (None, *_vjp(fn, ctx.saved_tensors,
                            ctx.needs_input_grad[1:8], (g,)), None, None)


class LnMlpResidualQ8Fn(LnMlpResidualFn):
    """K-f forward (the weights quantized per call, as the wrapper does);
    straight-through backward: the float recompute of K-b."""
