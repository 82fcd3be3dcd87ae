"""Row norms and the fused pre-LN MLP (counterpart of lvv_tpu/ops/fused_mlp.py).

- `norm` and its add form `add_norm` (K-a), `ln_mlp_residual` (K-b) and
  its W8A8 form `ln_mlp_residual_q8` (K-f) are the kernel wrappers (CUDA):
  on a CUDA tensor they launch their kernel or raise, on a CPU tensor they
  compute their plain version.
- `norm_plain` / `add_norm_plain` / `ln_mlp_residual_plain` /
  `ln_mlp_residual_q8_plain` are those plain PyTorch versions: the CPU
  path, and the oracle the kernels are held to on the card.
- `norm_fast`, `add_norm_fast` and `kernel_ok` keep the JAX package's
  dispatch: the kernel for lane-aligned widths (multiples of 128), the
  plain path otherwise.
- The norms' scale and bias (K-a's, and K-b's / K-f's `ls` / `lb`) may be
  fp32 beside bf16 activations, as the model keeps them, or of the
  activations' dtype (`_param_fp32`).
- `mlp_plan` is the MLP kernels' schedule (tile widths, tiles, blocks,
  K-f's chunk slices), from the shapes alone.
- Where autograd needs a gradient (`kernels.wants_grad`), `norm`,
  `add_norm`, their `_fast` entries, `ln_mlp_residual` and
  `ln_mlp_residual_q8` run through their Functions in `ops/autograd.py`:
  the kernel forward, a plain recompute backward (`norm_plain`,
  `add_norm_plain`, `ln_mlp_residual_xla`), as the JAX package's VJPs do.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import kernels
from . import quant

_LANE = 128
_ACTS = {"gelu": 0, "quick_gelu": 1}
_SMS = 132                  # streaming multiprocessors of an H100 SXM
_TILE = 128                 # rows and columns of a GEMM tile (gemm_sm90.cuh)


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


def add_norm_plain(x, y, scale, bias=None, *, eps: float,
                   rms: bool = False):
    """(s, n): s = x + y as PyTorch adds (one rounding to x's dtype), n =
    norm_plain(s)."""
    s = x + y
    return s, norm_plain(s, scale, bias, eps=eps, rms=rms)


_NORM_TYPES = {torch.bfloat16: 0, torch.float32: 1}


def _param_fp32(name: str, x, params, c: int) -> int:
    """1 if the norm parameters `params` (None skipped) are fp32, 0 if of
    x's dtype; raises unless all are [c] of one of those types, one type,
    on x's device."""
    ops = [p for p in params if p is not None]
    kinds = {p.dtype for p in ops}
    if (len(kinds) != 1 or not kinds <= {x.dtype, torch.float32}
            or any(p.shape != (c,) or p.device != x.device for p in ops)):
        raise ValueError(f"{name}: scale / bias must be [C={c}] on the "
                         f"input's device, all of {x.dtype} or all fp32")
    return int(ops[0].dtype == torch.float32)


def _norm_launch(x, y, scale, bias, eps: float, rms: bool):
    """K-a's launch (kernels/csrc/norm.cu) on x [..., C] (and y, the add
    form): returns (s or None, n)."""
    c = x.shape[-1]
    kernels.refuse_grad("norm", x, y, scale, bias)
    if x.dtype not in _NORM_TYPES or c > 8192:
        raise ValueError(f"norm: unsupported {x.dtype} / C={c}")
    pfp32 = _param_fp32("norm", x, (scale, None if rms else bias), c)
    if y is not None and (y.shape != x.shape or y.dtype != x.dtype
                          or y.device != x.device):
        raise ValueError("add_norm: y must match x in shape, dtype and "
                         "device")
    x = x.contiguous()
    out = torch.empty_like(x)
    s = None if y is None else torch.empty_like(x)
    n = x.numel() // c if c else 0
    if n:
        err = kernels.lib("norm").lvv_norm(
            x.data_ptr(), None if y is None else y.contiguous().data_ptr(),
            scale.contiguous().data_ptr(),
            None if bias is None or rms else bias.contiguous().data_ptr(),
            None if s is None else s.data_ptr(), out.data_ptr(), n, c,
            ctypes.c_float(eps), int(rms), _NORM_TYPES[x.dtype], pfp32,
            torch.cuda.current_stream(x.device).cuda_stream)
        kernels.check(err, "norm")
        kernels.launches["norm"] += 1
        if s is not None:
            kernels.launches["norm[add]"] += 1
    return s, out


def norm(x, scale, bias=None, *, eps: float, rms: bool = False):
    """Kernel K-a: row LayerNorm (RMSNorm when rms) of x [..., C], bf16 or
    fp32, C <= 8192; scale and bias of x's dtype or fp32."""
    if kernels.wants_grad(x, scale, bias):
        from .autograd import NormFn
        return NormFn.apply(norm, x, scale, bias, eps, rms)
    if not x.is_cuda:
        return norm_plain(x, scale, bias, eps=eps, rms=rms)
    return _norm_launch(x, None, scale, bias, eps, rms)[1]


def add_norm(x, y, scale, bias=None, *, eps: float, rms: bool = False):
    """Kernel K-a's add form: (s, n) with s = x + y rounded to x's dtype
    (bit-equal to PyTorch's add) and n = norm(s), in one launch; x and y
    [..., C] of one shape and dtype. Counted under "norm" and
    "norm[add]"."""
    if kernels.wants_grad(x, y, scale, bias):
        from .autograd import AddNormFn
        return AddNormFn.apply(add_norm, x, y, scale, bias, eps, rms)
    if not x.is_cuda:
        return add_norm_plain(x, y, scale, bias, eps=eps, rms=rms)
    return _norm_launch(x, y, scale, bias, eps, rms)


def norm_fast(x, scale, bias=None, *, eps: float = 1e-6, rms: bool = False):
    """The JAX package's norm entry: kernel for lane-aligned widths on the
    card, plain path otherwise."""
    if kernels.wants_grad(x, scale, bias):
        from .autograd import NormFn
        return NormFn.apply(norm_fast, x, scale, bias, eps, rms)
    c = x.shape[-1]
    if kernel_ok(x, c, c):
        return norm(x, scale, bias, eps=eps, rms=rms)
    return norm_plain(x, scale, bias, eps=eps, rms=rms)


def add_norm_fast(x, y, scale, bias=None, *, eps: float = 1e-6,
                  rms: bool = False):
    """A residual add and the norm after it, (x + y, norm_fast(x + y)):
    the add form of the kernel where norm_fast takes the kernel, else
    PyTorch's add and the plain norm."""
    if kernels.wants_grad(x, y, scale, bias):
        from .autograd import AddNormFn
        return AddNormFn.apply(add_norm_fast, x, y, scale, bias, eps, rms)
    c = x.shape[-1]
    if kernel_ok(x, c, c):
        return add_norm(x, y, scale, bias, eps=eps, rms=rms)
    return add_norm_plain(x, y, scale, bias, eps=eps, rms=rms)


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


def ln_mlp_residual_xla(x, ls, lb, w1, b1, w2, b2, *, eps: float = 1e-6,
                        act: str = "gelu"):
    """The fused MLP as the JAX package's backward recomputes it
    (`_xla_forward`, lvv_tpu/ops/fused_mlp.py:290-298): fp32 LN rounded to
    x's dtype, z = y @ w1 in fp32 plus b1, act(z) rounded to x's dtype, then
    x + h @ w2 + b2 in fp32. It differs from the kernel's arithmetic
    (`ln_mlp_residual_plain`) only in that z is not rounded before the
    activation. K-b's and K-f's backward differentiate it."""
    y = _ln_f32(x, ls, lb, eps).to(x.dtype)
    z = torch.matmul(y.float(), w1.float())
    if b1 is not None:
        z = z + b1.float()
    h = _act(act, z).to(x.dtype)
    o = x.float() + torch.matmul(h.float(), w2.float())
    if b2 is not None:
        o = o + b2.float()
    return o.to(x.dtype)


def mlp_plan(n: int, c: int, h: int, block_h=None) -> dict:
    """The MLP kernels' schedule for x [n, c] and a hidden width h, from the
    shapes alone (gemm_sm90.cuh). Each product runs [128, 128] output tiles
    on persistent blocks, two an SM, except K-b's second product: [128,
    256] tiles (`bn2`), one block an SM, where C divides by 256 and that
    leaves at least two waves of tiles. `tiles` counts each product's
    tiles, the second's over `slices` hidden slices: one a `block_h` chunk
    for K-f, whose parts are added in chunk order afterwards, none for K-b
    (1). `blocks` is what each launch takes."""
    rows = -(-n // _TILE)
    slices = 1 if block_h is None else h // block_h
    wide = (block_h is None and c % 256 == 0
            and rows * (c // 256) >= 2 * _SMS)
    bn2 = 256 if wide else _TILE
    tiles = (rows * -(-h // _TILE), rows * -(-c // bn2) * slices)
    blocks = (min(tiles[0], 2 * _SMS),
              min(tiles[1], (1 if wide else 2) * _SMS))
    return dict(tiles=tiles, bn2=bn2, slices=slices, blocks=blocks)


def _mlp_operands(name: str, x, ls, lb, w1, b1, w2, b2) -> int:
    """Checks K-b's and K-f's operands: x, w1 [C, H], b1 [H], w2 [H, C], b2
    [C] bf16, ls / lb [C] both bf16 or both fp32, all on x's device.
    Returns 1 for fp32 ls / lb, else 0."""
    c, h = x.shape[-1], w1.shape[1]
    ops = (x, w1, b1, w2, b2)
    if any(t.dtype != torch.bfloat16 or t.device != x.device for t in ops):
        raise ValueError(f"{name}: x, the weights and the biases must be "
                         "bf16 on the input's device")
    shapes = ((c, h), (h,), (h, c), (c,))
    if any(t.shape != s for t, s in zip(ops[1:], shapes)):
        raise ValueError(f"{name}: parameter shapes do not match C={c}, "
                         f"H={h}")
    return _param_fp32(name, x, (ls, lb), c)


def ln_mlp_residual(x, ls, lb, w1, b1, w2, b2, *, eps: float = 1e-6,
                    act: str = "gelu", quant8: bool = False):
    """Kernel K-b: x [..., C] -> x + act(LN(x) @ w1 + b1) @ w2 + b2 with
    w1 [C, H], w2 [H, C], bf16; ls / lb bf16 or fp32; act "gelu" (tanh)
    or "quick_gelu". With quant8 the W8A8 form, kernel K-f
    (`ln_mlp_residual_q8`)."""
    if quant8:
        return ln_mlp_residual_q8(x, ls, lb, w1, b1, w2, b2, eps=eps,
                                  act=act)
    if kernels.wants_grad(x, ls, lb, w1, b1, w2, b2):
        from .autograd import LnMlpResidualFn
        return LnMlpResidualFn.apply(ln_mlp_residual, x, ls, lb, w1, b1, w2,
                                     b2, eps, act)
    if not x.is_cuda:
        return ln_mlp_residual_plain(x, ls, lb, w1, b1, w2, b2, eps=eps,
                                     act=act)
    c, h = x.shape[-1], w1.shape[1]
    if b1 is None:
        b1 = torch.zeros(h, dtype=x.dtype, device=x.device)
    if b2 is None:
        b2 = torch.zeros(c, dtype=x.dtype, device=x.device)
    ops = (x, ls, lb, w1, b1, w2, b2)
    pfp32 = _mlp_operands("ln_mlp_residual", x, ls, lb, w1, b1, w2, b2)
    if c % _LANE or c > 1024 or h % 64 or act not in _ACTS:
        raise ValueError(f"ln_mlp_residual: unsupported C={c} H={h} "
                         f"act={act!r}")
    kernels.refuse_grad("ln_mlp_residual", *ops)
    x2 = x.reshape(-1, c).contiguous()
    n = x2.shape[0]
    out = torch.empty_like(x2)
    if n:
        # scratch: LN(x) and the hidden activation, both bf16
        y, hb = x2.new_empty(n, c), x2.new_empty(n, h)
        args = [t.contiguous() for t in (x2, ls, lb, w1, b1, w2, b2)]
        fn = kernels.lib("ln_mlp_residual").lvv_ln_mlp_residual
        err = fn(*(t.data_ptr() for t in args + [out, y, hb]), n, c, h,
                 ctypes.c_float(eps), _ACTS[act], mlp_plan(n, c, h)["bn2"],
                 pfp32, torch.cuda.current_stream(x.device).cuda_stream)
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
    if kernels.wants_grad(x, ls, lb, w1, b1, w2, b2):
        from .autograd import LnMlpResidualQ8Fn
        return LnMlpResidualQ8Fn.apply(ln_mlp_residual_q8, x, ls, lb, w1, b1,
                                       w2, b2, eps, act)
    if not x.is_cuda:
        return ln_mlp_residual_q8_plain(x, ls, lb, w1, b1, w2, b2, eps=eps,
                                        act=act)
    c, h = x.shape[-1], w1.shape[1]
    if b1 is None:
        b1 = torch.zeros(h, dtype=x.dtype, device=x.device)
    if b2 is None:
        b2 = torch.zeros(c, dtype=x.dtype, device=x.device)
    _mlp_operands("ln_mlp_residual_q8", x, ls, lb, w1, b1, w2, b2)
    block_h = q8_block_h(c, h, x.element_size())
    if (c % _LANE or c > 1024 or block_h % 64 or block_h > 4096
            or act not in _ACTS):
        raise ValueError(f"ln_mlp_residual_q8: unsupported C={c} H={h} "
                         f"(chunk {block_h}) act={act!r}")
    w1t, s1 = quantize_weight_t(w1)
    w2t, s2 = quantize_weight_t(w2)
    return ln_mlp_residual_q8_launch(x, ls, lb, w1t, s1, b1, w2t, s2, b2,
                                     block_h=block_h, eps=eps, act=act)


def quantize_weight_t(w):
    """quant.quantize_weight of a bf16 or fp32 weight w [K, N] on the card,
    the int8 matrix transposed ([N, K]: int8 wgmma reads both operands
    K-major) -> (int8 [N, K], scale [N] fp32), by the two kernels of
    quant_weight.cuh. Part of K-f's wrapper (its launch is not counted
    apart); K-i's launch runs the same kernels itself."""
    k, n = w.shape
    kernels.refuse_grad("quantize_weight_t", w)
    if w.dtype not in quant._KINDS:
        raise ValueError(f"quantize_weight_t: unsupported {w.dtype}")
    wt = torch.empty(n, k, dtype=torch.int8, device=w.device)
    s = torch.empty(n, dtype=torch.float32, device=w.device)
    pm = torch.empty(-(-k // 128), n, dtype=torch.float32, device=w.device)
    fn = kernels.lib("ln_mlp_residual_q8").lvv_ln_mlp_residual_q8_weight
    err = fn(quant._aligned(w).data_ptr(), wt.data_ptr(), s.data_ptr(),
             pm.data_ptr(), k, n, quant._KINDS[w.dtype],
             torch.cuda.current_stream(w.device).cuda_stream)
    kernels.check(err, "ln_mlp_residual_q8 weights")
    return wt, s


def ln_mlp_residual_q8_launch(x, ls, lb, w1t, s1, b1, w2t, s2, b2, *,
                              block_h: int, eps: float, act: str):
    """K-f's launch on weights already quantized and transposed (w1t [H, C],
    w2t [C, H] int8, s1 [H], s2 [C] fp32), as ln_mlp_residual_q8 hands them
    over after checking its operands; b1 / b2 bf16, ls / lb bf16 or
    fp32."""
    c, h = x.shape[-1], w1t.shape[0]
    pfp32 = _param_fp32("ln_mlp_residual_q8", x, (ls, lb), c)
    kernels.refuse_grad("ln_mlp_residual_q8", x, ls, lb, b1, b2)
    x2 = x.reshape(-1, c).contiguous()
    n = x2.shape[0]
    out = torch.empty_like(x2)
    if n:
        chunks = mlp_plan(n, c, h, block_h)["slices"]
        i8, f32 = torch.int8, torch.float32
        # scratch: y8, sy, h, the |h| maxima of each 64-column panel, h8,
        # sh and, with more than one chunk, the chunks' fp32 parts
        scratch = [x2.new_empty(n, c, dtype=i8), x2.new_empty(n, dtype=f32),
                   x2.new_empty(n, h), x2.new_empty(n, h // 64, dtype=f32),
                   x2.new_empty(n, h, dtype=i8),
                   x2.new_empty(n, chunks, dtype=f32)]
        part = x2.new_empty(chunks, n, c, dtype=f32) if chunks > 1 else None
        args = (x2, ls.contiguous(), lb.contiguous(), w1t, s1,
                b1.contiguous(), w2t, s2, b2.contiguous(), out, *scratch)
        fn = kernels.lib("ln_mlp_residual_q8").lvv_ln_mlp_residual_q8
        err = fn(*(t.data_ptr() for t in args),
                 None if part is None else part.data_ptr(), n, c, h, block_h,
                 ctypes.c_float(eps), _ACTS[act], pfp32,
                 torch.cuda.current_stream(x.device).cuda_stream)
        kernels.check(err, "ln_mlp_residual_q8")
        kernels.launches["ln_mlp_residual_q8"] += 1
    return out.view(x.shape)
