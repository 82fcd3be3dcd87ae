"""Shared layers of the port (counterpart of lvv_tpu/models/layers.py).

Conventions:
- parameters are created in the model's dtype (bf16 on the card, fp32 in
  the CPU tests) and named as in the JAX param tree, so a flattened JAX tree
  and the port's state_dict share their keys (`convert.from_jax_params`);
  the exceptions are the parameters that the JAX package reads in fp32
  before any rounding: the norms' scales and biases (`LayerNorm`,
  `RMSNorm`: JAX's norms take its fp32 parameters as they are) and CLIP's
  position table (resampled in fp32), which are fp32 whatever the model's
  dtype (`PARAM_FP32`);
- a Dense kernel keeps the JAX layout [in, out] (y = x @ kernel);
- parameters are random from a seed, drawn as flax's initialisers draw them
  (`init_parameters`), and made with requires_grad False: training marks
  its trainable ones (`set_trainable`, from `train.optim.group_labels`);
- norms and attention go through `ops` (the hand-written kernels on the
  card, with their autograd Functions where a gradient is needed);
- dropout (`dropout`) draws its mask from an explicit torch.Generator and
  runs only with `deterministic=False`, as flax's nn.Dropout.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import quant
from ..ops.attention import attention
from ..ops.fused_mlp import add_norm_fast, norm_fast

# flax's lecun_normal draws a normal truncated at +-2 and divides by the
# standard deviation of that truncated distribution
_TRUNC_STD = 0.87962566103423978
# the dtype of the parameters that the JAX package reads in fp32
PARAM_FP32 = torch.float32


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `device` when given, else the card.
    Without a card and without an explicit device this raises; nothing falls
    back to the CPU by itself."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "port's plain CPU path")
    return torch.device("cuda")


def new_param(shape, init, *, dtype, device) -> nn.Parameter:
    """An uninitialised parameter that remembers how flax would draw it:
    init is "zeros", "ones", ("constant", value), ("normal", std),
    ("lecun", fan_in) or ("he", fan_in) (he_normal: lecun's truncated
    normal at twice the variance)."""
    p = nn.Parameter(torch.empty(tuple(shape), dtype=dtype, device=device),
                     requires_grad=False)
    p.lvv_init = init
    return p


@torch.no_grad()
def init_parameters(module: nn.Module, seed: int) -> None:
    """Draw every parameter of `module` from one seeded generator, in
    state_dict order, with flax's initialiser for it."""
    gen = None
    for p in module.parameters():
        if p.device.type == "meta":
            continue
        if gen is None or gen.device != p.device:
            gen = torch.Generator(device=p.device).manual_seed(seed)
        init = p.lvv_init
        if init == "zeros":
            p.zero_()
        elif init == "ones":
            p.fill_(1.0)
        elif init[0] == "constant":
            p.fill_(init[1])
        else:
            kind, arg = init
            t = torch.empty(p.shape, dtype=torch.float32, device=p.device)
            if kind == "normal":
                t.normal_(0.0, arg, generator=gen)
            else:
                gain = 2.0 if kind == "he" else 1.0
                std = math.sqrt(gain / arg) / _TRUNC_STD
                nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                      generator=gen)
            p.copy_(t)


def set_trainable(module: nn.Module, names) -> None:
    """requires_grad True for the parameters named in `names` (state_dict
    names), False for every other one."""
    names = set(names)
    for name, p in module.named_parameters():
        p.requires_grad_(name in names)


def dropout(x: torch.Tensor, rate: float, deterministic: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax's nn.Dropout: with deterministic False and rate > 0, each
    element kept with probability 1 - rate (a uniform draw from
    `generator`, on x's device) and scaled by 1 / (1 - rate); else x."""
    if deterministic or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def quick_gelu(x):
    """CLIP's QuickGELU."""
    return x * torch.sigmoid(1.702 * x)


def resize_1d(x: torch.Tensor, axis: int, out_size: int,
              method: str) -> torch.Tensor:
    """Resize one axis as jax.image.resize does (half-pixel centres,
    antialiased when shrinking): method "linear" (triangle) or "cubic"
    (Keys, a = -0.5)."""
    in_size = x.shape[axis]
    if in_size == out_size:
        return x
    scale = out_size / in_size
    kscale = max(1.0 / scale, 1.0)
    sample = (np.arange(out_size, dtype=np.float64) + 0.5) / scale - 0.5
    dist = np.abs(sample[None, :] - np.arange(in_size)[:, None]) / kscale
    if method == "linear":
        w = np.maximum(0.0, 1.0 - dist)
    elif method == "cubic":
        w = ((1.5 * dist - 2.5) * dist) * dist + 1.0
        w = np.where(dist >= 1.0, ((-0.5 * dist + 2.5) * dist - 4.0) * dist
                     + 2.0, w)
        w = np.where(dist >= 2.0, 0.0, w)
    else:
        raise ValueError(f"unknown resize method {method!r}")
    total = w.sum(0, keepdims=True)
    w = np.where(np.abs(total) > 1000 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0.0)
    w = np.where(((sample >= -0.5) & (sample <= in_size - 0.5))[None], w, 0.0)
    wt = torch.as_tensor(w, dtype=torch.float32, device=x.device)  # [in, out]
    moved = x.float().movedim(axis, -1)
    return (moved @ wt).movedim(-1, axis).to(x.dtype)


class LayerNorm(nn.Module):
    """LayerNorm with fp32 internals (kernel K-a on the card); scale and
    bias in fp32 whatever the model's `dtype`."""

    def __init__(self, dim: int, eps: float = 1e-6, *, dtype, device):
        super().__init__()
        self.eps = eps
        kw = dict(dtype=PARAM_FP32, device=device)
        self.scale = new_param((dim,), "ones", **kw)
        self.bias = new_param((dim,), "zeros", **kw)

    def forward(self, x):
        return norm_fast(x, self.scale, self.bias, eps=self.eps)


class RMSNorm(nn.Module):
    """RMSNorm (Qwen2-style), fp32 internals (kernel K-a on the card);
    the scale in fp32 whatever the model's dtype."""

    def __init__(self, dim: int, eps: float = 1e-6, *, dtype, device):
        super().__init__()
        self.eps = eps
        self.scale = new_param((dim,), "ones", dtype=PARAM_FP32,
                               device=device)

    def forward(self, x):
        return norm_fast(x, self.scale, eps=self.eps, rms=True)

    def add(self, x, y):
        """(x + y, self(x + y)) in one launch of K-a's add form on the
        card."""
        return add_norm_fast(x, y, self.scale, eps=self.eps, rms=True)


class Dense(nn.Module):
    """Linear layer y = x @ kernel + bias, with an optional additive LoRA
    branch (alpha / r) * (x @ lora_a) @ lora_b.

    `forward(x, kernel)` may be given a weight-only int8 kernel {"q": int8
    [K, N], "s": f32 [N]} (from `ops.quant.quantize_llm_params`) in place of
    the float one: y = (x @ q) * s through kernel K-j, the scale on the
    output side, then the bias, then LoRA as its own branch over the float
    adapter (not folded in), as the JAX package's Dense does."""

    def __init__(self, in_dim: int, features: int, use_bias: bool = True,
                 lora_rank: int = 0, lora_alpha: float = 1.0, *, dtype,
                 device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.kernel = new_param((in_dim, features), ("lecun", in_dim), **kw)
        self.bias = (new_param((features,), "zeros", **kw) if use_bias
                     else None)
        self.lora_rank = lora_rank
        self.scaling = lora_alpha / lora_rank if lora_rank else 0.0
        if lora_rank:
            self.lora_a = new_param((in_dim, lora_rank),
                                    ("normal", 1.0 / lora_rank), **kw)
            self.lora_b = new_param((lora_rank, features), "zeros", **kw)

    def forward(self, x, kernel=None):
        if kernel is None:
            y = x @ self.kernel
        else:
            y = quant.quantized_matmul(x.to(self.kernel.dtype), kernel["q"],
                                       kernel["s"])
        if self.bias is not None:
            y = y + self.bias
        if self.lora_rank:
            y = y + (x @ self.lora_a) @ self.lora_b * self.scaling
        return y


class MLP(nn.Module):
    """fc1 -> act (exact erf GELU by default) -> fc2 -> dropout."""

    def __init__(self, dim: int, hidden: int, act=F.gelu,
                 out: Optional[int] = None, dropout: float = 0.0, *, dtype,
                 device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.fc1 = Dense(dim, hidden, **kw)
        self.fc2 = Dense(hidden, dim if out is None else out, **kw)
        self.act = act
        self.dropout = dropout

    def forward(self, x, deterministic: bool = True, generator=None):
        return dropout(self.fc2(self.act(self.fc1(x))), self.dropout,
                       deterministic, generator)


class MultiHeadAttention(nn.Module):
    """Self / cross multi-head attention over `ops.attention`."""

    def __init__(self, dim: int, num_heads: int, lora_rank: int = 0,
                 lora_alpha: float = 1.0, qkv_bias: bool = True, *, dtype,
                 device):
        super().__init__()
        self.num_heads = num_heads
        kw = dict(lora_rank=lora_rank, lora_alpha=lora_alpha, dtype=dtype,
                  device=device)
        self.q_proj = Dense(dim, dim, qkv_bias, **kw)
        self.k_proj = Dense(dim, dim, qkv_bias, **kw)
        self.v_proj = Dense(dim, dim, qkv_bias, **kw)
        self.o_proj = Dense(dim, dim, **kw)

    def forward(self, q_in, kv_in=None, *, causal: bool = False,
                kv_len=None):
        kv_in = q_in if kv_in is None else kv_in
        d = q_in.shape[-1]
        hd = d // self.num_heads

        def split(x):
            b, s, _ = x.shape
            return x.view(b, s, self.num_heads, hd).transpose(1, 2)

        out = attention(split(self.q_proj(q_in)), split(self.k_proj(kv_in)),
                        split(self.v_proj(kv_in)), causal=causal,
                        kv_len=kv_len)
        b, _, s, _ = out.shape
        return self.o_proj(out.transpose(1, 2).reshape(b, s, d))
