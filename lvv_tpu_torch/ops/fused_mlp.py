"""Row norms and the fused pre-LN MLP (counterpart of lvv_tpu/ops/fused_mlp.py).

- `norm` (K-a, Triton), `ln_mlp_residual` (K-b, CUDA) and its W8A8 form
  `ln_mlp_residual_q8` (K-f, CUDA) are the kernel wrappers: on a CUDA
  tensor they launch their kernel or raise, on a CPU tensor they compute
  their plain version.
- `norm_plain` / `ln_mlp_residual_plain` / `ln_mlp_residual_q8_plain` are
  those plain PyTorch versions: the CPU path, and the oracle the kernels are
  held to on the card.
- `norm_fast` and `kernel_ok` keep the JAX package's dispatch: the kernel
  for lane-aligned widths (multiples of 128), the plain path otherwise.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import kernels
from . import quant

_LANE = 128
_ACTS = {"gelu": 0, "quick_gelu": 1}


def kernel_ok(x: torch.Tensor, c: int, hidden: int) -> bool:
    """The fused kernels need lane-aligned feature dims and a CUDA tensor
    (the JAX rule, with "on a CUDA tensor" in place of "TPU backend")."""
    return x.is_cuda and c % _LANE == 0 and hidden % _LANE == 0


def _act(name: str, z: torch.Tensor) -> torch.Tensor:
    if name == "gelu":                       # tanh approximation
        return F.gelu(z, approximate="tanh")
    if name == "quick_gelu":
        return z / (1.0 + torch.exp(-1.702 * z))
    raise ValueError(f"unknown activation {name!r}")


def norm_plain(x, scale, bias=None, *, eps: float, rms: bool = False):
    """LayerNorm / RMSNorm over the last dim with fp32 internals."""
    xf = x.float()
    if rms:
        y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
        return (y * scale.float()).to(x.dtype)
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps) * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def norm(x, scale, bias=None, *, eps: float, rms: bool = False):
    """Kernel K-a: row LayerNorm (RMSNorm when rms) of x [..., C]."""
    if not x.is_cuda:
        return norm_plain(x, scale, bias, eps=eps, rms=rms)
    c = x.shape[-1]
    params = [scale] + ([] if bias is None else [bias])
    if any(p.shape != (c,) or p.device != x.device for p in params):
        raise ValueError("norm: scale/bias must be [C] on the input's device")
    if x.dtype not in (torch.bfloat16, torch.float32) or c > 8192:
        raise ValueError(f"norm: unsupported {x.dtype} / C={c}")
    x2 = x.reshape(-1, c).contiguous()
    out = torch.empty_like(x2)
    if x2.shape[0]:
        from ..kernels import norm_triton
        norm_triton.launch(x2, scale.contiguous(),
                           None if bias is None else bias.contiguous(), out,
                           eps, rms)
        kernels.launches["norm"] += 1
    return out.view(x.shape)


def norm_fast(x, scale, bias=None, *, eps: float = 1e-6, rms: bool = False):
    """The JAX package's norm entry: kernel for lane-aligned widths on the
    card, plain path otherwise."""
    c = x.shape[-1]
    if kernel_ok(x, c, c):
        return norm(x, scale, bias, eps=eps, rms=rms)
    return norm_plain(x, scale, bias, eps=eps, rms=rms)


def ln_mlp_residual_plain(x, ls, lb, w1, b1, w2, b2, *, eps: float = 1e-6,
                          act: str = "gelu"):
    """x + act(LN(x) @ w1 + b1) @ w2 + b2 with the kernel's arithmetic: fp32
    LN and accumulation, the pre-activation rounded to x's dtype."""
    y = norm_plain(x, ls, lb, eps=eps)
    z = torch.matmul(y.float(), w1.float())
    if b1 is not None:
        z = z + b1.float()
    h = _act(act, z.to(x.dtype).float()).to(x.dtype)
    o = torch.matmul(h.float(), w2.float())
    if b2 is not None:
        o = o + b2.float()
    return (x.float() + o).to(x.dtype)


def ln_mlp_residual(x, ls, lb, w1, b1, w2, b2, *, eps: float = 1e-6,
                    act: str = "gelu", quant8: bool = False):
    """Kernel K-b: x [..., C] -> x + act(LN(x) @ w1 + b1) @ w2 + b2 with
    w1 [C, H], w2 [H, C]; act "gelu" (tanh) or "quick_gelu". With quant8
    the W8A8 form, kernel K-f (`ln_mlp_residual_q8`)."""
    if quant8:
        return ln_mlp_residual_q8(x, ls, lb, w1, b1, w2, b2, eps=eps,
                                  act=act)
    if not x.is_cuda:
        return ln_mlp_residual_plain(x, ls, lb, w1, b1, w2, b2, eps=eps,
                                     act=act)
    c, h = x.shape[-1], w1.shape[1]
    if b1 is None:
        b1 = torch.zeros(h, dtype=x.dtype, device=x.device)
    if b2 is None:
        b2 = torch.zeros(c, dtype=x.dtype, device=x.device)
    ops = (x, ls, lb, w1, b1, w2, b2)
    shapes = ((c,), (c,), (c, h), (h,), (h, c), (c,))
    if any(t.dtype != torch.bfloat16 or t.device != x.device for t in ops):
        raise ValueError("ln_mlp_residual: every operand must be bf16 on the "
                         "input's device")
    if any(t.shape != s for t, s in zip(ops[1:], shapes)):
        raise ValueError("ln_mlp_residual: parameter shapes do not match "
                         f"C={c}, H={h}")
    if c % _LANE or c > 1024 or h % 64 or act not in _ACTS:
        raise ValueError(f"ln_mlp_residual: unsupported C={c} H={h} "
                         f"act={act!r}")
    x2 = x.reshape(-1, c).contiguous()
    out = torch.empty_like(x2)
    if x2.shape[0]:
        args = [t.contiguous() for t in (x2, ls, lb, w1, b1, w2, b2)]
        fn = kernels.lib("ln_mlp_residual").lvv_ln_mlp_residual
        err = fn(*(t.data_ptr() for t in args), out.data_ptr(), x2.shape[0],
                 c, h, ctypes.c_float(eps), _ACTS[act],
                 torch.cuda.current_stream(x.device).cuda_stream)
        kernels.check(err, "ln_mlp_residual")
        kernels.launches["ln_mlp_residual"] += 1
    return out.view(x.shape)


# ------------------------------------------------------------- W8A8 (K-f) --

def q8_block_h(c: int, h: int, itemsize: int) -> int:
    """The JAX package's hidden chunk for a [C, H] MLP: the widest that
    keeps the two streamed bf16/fp32 weight chunks under 10 MiB, a multiple
    of 128 that divides H. In the W8A8 form each chunk has its own row
    scales for h, so the chunk is part of the function."""
    block_h = h
    while 2 * c * block_h * itemsize > 10 * 2 ** 20:
        block_h //= 2
    block_h = max(-(-block_h // _LANE) * _LANE, _LANE)
    while h % block_h:
        block_h //= 2
    return block_h


def _ln_f32(x, scale, bias, eps):
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    return (xf - mean) * torch.rsqrt(var + eps) * scale.float() + bias.float()


def ln_mlp_residual_q8_plain(x, ls, lb, w1, b1, w2, b2, *, eps: float = 1e-6,
                             act: str = "gelu", block_h=None):
    """The W8A8 fused MLP with _kernel_q8's arithmetic: per-column int8
    weights, LN(x) quantized per row, z = i32·sy·s1 + b1 in fp32, the
    activation on z rounded to x's dtype, h quantized per row of each
    `block_h` chunk, int8 products summed exactly (float64)."""
    c, h = x.shape[-1], w1.shape[1]
    if block_h is None:
        block_h = q8_block_h(c, h, x.element_size())
    while h % block_h:
        block_h //= 2
    b1 = torch.zeros(h, dtype=x.dtype, device=x.device) if b1 is None else b1
    b2 = torch.zeros(c, dtype=x.dtype, device=x.device) if b2 is None else b2
    w1q, s1 = quant.quantize_weight(w1)
    w2q, s2 = quant.quantize_weight(w2)
    x2 = x.reshape(-1, c)
    y8, sy = quant.quantize_rows(_ln_f32(x2, ls, lb, eps))
    acc = None
    for j in range(0, h, block_h):
        cols = slice(j, j + block_h)
        z = (quant.int8_exact(y8, w1q[:, cols]) * sy * s1[cols]
             + b1[cols].float())
        hh = _act(act, z.to(x.dtype).float()).to(x.dtype).float()
        h8, sh = quant.quantize_rows(hh)
        part = quant.int8_exact(h8, w2q[cols]) * sh * s2
        acc = part if acc is None else acc + part
    return ((x2.float() + acc) + b2.float()).to(x.dtype).view(x.shape)


def ln_mlp_residual_q8(x, ls, lb, w1, b1, w2, b2, *, eps: float = 1e-6,
                       act: str = "gelu"):
    """Kernel K-f: the W8A8 form of ln_mlp_residual, x [..., C] bf16 with
    float weights w1 [C, H], w2 [H, C], quantized per output column here on
    every call (as the JAX package does, outside its kernel)."""
    if not x.is_cuda:
        return ln_mlp_residual_q8_plain(x, ls, lb, w1, b1, w2, b2, eps=eps,
                                        act=act)
    c, h = x.shape[-1], w1.shape[1]
    if b1 is None:
        b1 = torch.zeros(h, dtype=x.dtype, device=x.device)
    if b2 is None:
        b2 = torch.zeros(c, dtype=x.dtype, device=x.device)
    ops = (x, ls, lb, w1, b1, w2, b2)
    shapes = ((c,), (c,), (c, h), (h,), (h, c), (c,))
    if any(t.dtype != torch.bfloat16 or t.device != x.device for t in ops):
        raise ValueError("ln_mlp_residual_q8: every operand must be bf16 on "
                         "the input's device")
    if any(t.shape != s for t, s in zip(ops[1:], shapes)):
        raise ValueError("ln_mlp_residual_q8: parameter shapes do not match "
                         f"C={c}, H={h}")
    block_h = q8_block_h(c, h, x.element_size())
    if (c % _LANE or c > 1024 or block_h % 64 or block_h > 4096
            or act not in _ACTS):
        raise ValueError(f"ln_mlp_residual_q8: unsupported C={c} H={h} "
                         f"(chunk {block_h}) act={act!r}")
    # the kernel reads each B fragment as 4 consecutive k of one column:
    # the quantized weights are handed over transposed ([H, C], [C, H])
    w1q, s1 = quant.quantize_weight(w1)
    w2q, s2 = quant.quantize_weight(w2)
    w1t, w2t = w1q.t().contiguous(), w2q.t().contiguous()
    x2 = x.reshape(-1, c).contiguous()
    out = torch.empty_like(x2)
    if x2.shape[0]:
        args = (x2, ls.contiguous(), lb.contiguous(), w1t, s1,
                b1.contiguous(), w2t, s2, b2.contiguous())
        fn = kernels.lib("ln_mlp_residual_q8").lvv_ln_mlp_residual_q8
        err = fn(*(t.data_ptr() for t in args), out.data_ptr(), x2.shape[0],
                 c, h, block_h, ctypes.c_float(eps), _ACTS[act],
                 torch.cuda.current_stream(x.device).cuda_stream)
        kernels.check(err, "ln_mlp_residual_q8")
        kernels.launches["ln_mlp_residual_q8"] += 1
    return out.view(x.shape)
