"""int8 quantization and the weight-only int8 products of the serving
decode (counterpart of lvv_tpu/ops/quant.py).

Layout: per-output-channel symmetric quantization
    q[k, n] = round(w[k, n] / scale[n]),  scale[n] = max_k |w[k, n]| / 127
and out[m, n] = (x @ q)[m, n] * scale[n]. Quantization divides (not a
multiply by the reciprocal), rounds half to even, clips to +-127 and floors
the scale at 1e-8, so it is bit-equal to the JAX package's.

- `w8a8_matmul` (K-i, CUDA): SAM's W8A8 projections (the "dense" scope),
  x quantized per row inside the kernel, the float weight per column on
  every call; `int8_dot` is its plain version and its fallback for K or N
  off the 128 grid, as in JAX.
- `quantized_matmul` (K-j, CUDA) and `quantized_matmul_nk` (K-k, CUDA) are
  the kernel wrappers of the decode: on a CUDA tensor they launch their kernel or raise,
  on a CPU tensor they compute their plain version. Both read the int8
  weight as stored ([K, N], or [N, K] for the tied unembed) and dequantize
  in registers; no dequantized copy of a weight is made on the card.
- `quantized_matmul_plain` / `quantized_matmul_nk_plain` follow the JAX
  decode's arithmetic: x @ q rounded to x's dtype, then scaled and rounded
  again (the kernels round once).
- `quantize_llm_params` is the serving transform of the Qwen weights.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from .. import kernels

_KINDS = {torch.float32: 0, torch.bfloat16: 1}


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[K, N] float -> (int8 [K, N], scale [N] f32)."""
    w = w.float()
    scale = torch.clamp_min(w.abs().amax(dim=0) / 127.0, 1e-8)
    q = torch.clamp(torch.round(w / scale[None, :]), -127, 127)
    return q.to(torch.int8), scale


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., K] float -> (int8 [..., K], per-row scale [..., 1] f32)."""
    xf = x.float()
    scale = torch.clamp_min(xf.abs().amax(dim=-1, keepdim=True) / 127.0,
                            1e-8)
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale


def int8_exact(a8: torch.Tensor, b8: torch.Tensor) -> torch.Tensor:
    """a8 [M, K] @ b8 [K, N] of int8 values as float32, as an int32
    accumulation converted to float32 would give: the products are summed
    exactly in float64 (exact below 2^53) and rounded once."""
    return torch.matmul(a8.double(), b8.double()).float()


def int8_dot(x: torch.Tensor, w: torch.Tensor,
             bias: Optional[torch.Tensor] = None,
             out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """W8A8 x [..., K] @ w [K, N]: per-row int8 x, per-column int8 w, exact
    integer accumulation, float32 rescale (K-i's plain version, and its
    fallback off the 128 grid)."""
    out_dtype = out_dtype or x.dtype
    lead, k = x.shape[:-1], x.shape[-1]
    xq, sx = quantize_rows(x.reshape(-1, k))
    wq, sw = quantize_weight(w)
    out = int8_exact(xq, wq) * sx * sw[None, :]
    if bias is not None:
        out = out + bias.float()
    return out.to(out_dtype).reshape(*lead, w.shape[1])


def w8a8_matmul(x: torch.Tensor, w: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel K-i: W8A8 x [..., K] @ w [K, N] (+ bias) -> [..., N] in x's
    dtype, with JAX's dispatch: K or N off the 128 grid take `int8_dot`
    (also the plain version, on a CPU tensor); otherwise the weight is
    quantized here, per call, and the kernel quantizes x per row."""
    k, n = w.shape
    if k % 128 or n % 128 or not x.is_cuda:
        return int8_dot(x, w, bias)
    if x.dtype not in _KINDS or x.shape[-1] != k or k > 1536:
        raise ValueError(f"w8a8_matmul: unsupported x {tuple(x.shape)} "
                         f"{x.dtype} / weight {tuple(w.shape)}")
    if any(t is not None and t.device != x.device for t in (w, bias)):
        raise ValueError("w8a8_matmul: operands must be on one device")
    wq, sw = quantize_weight(w)
    wt = wq.t().contiguous()                 # B fragments: 4 k of a column
    b = (torch.zeros(n, dtype=torch.float32, device=x.device)
         if bias is None else bias.float().contiguous())
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k).contiguous()
    out = torch.empty(x2.shape[0], n, dtype=x.dtype, device=x.device)
    if x2.shape[0]:
        err = kernels.lib("w8a8_matmul").lvv_w8a8_matmul(
            x2.data_ptr(), wt.data_ptr(), sw.data_ptr(), b.data_ptr(),
            out.data_ptr(), x2.shape[0], k, n, _KINDS[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
        kernels.check(err, "w8a8_matmul")
        kernels.launches["w8a8_matmul"] += 1
    return out.view(*lead, n)


def quantized_matmul_plain(x: torch.Tensor, q: torch.Tensor,
                           scale: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ int8 q [K, N] * scale [N] in x's dtype, as the JAX
    decode computes it: ((x @ q) rounded, times the f32 scale) rounded."""
    return ((x @ q.to(x.dtype)) * scale).to(x.dtype)


def quantized_matmul_nk_plain(x: torch.Tensor, q: torch.Tensor,
                              scale: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ int8 q [N, K]ᵀ * scale [N] (the tied unembed's
    layout)."""
    return ((x @ q.t().to(x.dtype)) * scale).to(x.dtype)


def _launch(name: str, x, q, scale, n: int, k: int, *, nk: bool):
    if x.dtype not in _KINDS or q.dtype != torch.int8 or (
            scale.dtype != torch.float32):
        raise ValueError(f"{name}: x must be bf16 or fp32, the weight int8 "
                         "and the scale fp32")
    if any(t.device != x.device for t in (q, scale)):
        raise ValueError(f"{name}: operands must be on one device")
    if not (q.is_contiguous() and scale.is_contiguous()):
        raise ValueError(f"{name}: the weight and scale must be contiguous "
                         "(they are read as stored)")
    if scale.shape != (n,) or (n % 4 if not nk else k % 16):
        raise ValueError(f"{name}: unsupported weight {tuple(q.shape)} / "
                         f"scale {tuple(scale.shape)}")
    if q.data_ptr() % 16:
        raise ValueError(f"{name}: the weight must be 16-byte aligned")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k).contiguous()
    if x2.data_ptr() % 16:                   # rows are read 16 bytes a time
        x2 = x2.clone()
    out = torch.empty(x2.shape[0], n, dtype=x.dtype, device=x.device)
    if x2.shape[0]:
        fn = getattr(kernels.lib(name), f"lvv_{name}")
        err = fn(x2.data_ptr(), q.data_ptr(), scale.data_ptr(),
                 out.data_ptr(), x2.shape[0], k, n, _KINDS[x.dtype],
                 torch.cuda.current_stream(x.device).cuda_stream)
        kernels.check(err, name)
        kernels.launches[name] += 1
    return out.view(*lead, n)


def quantized_matmul(x: torch.Tensor, q: torch.Tensor,
                     scale: torch.Tensor) -> torch.Tensor:
    """Kernel K-j: x [..., K] @ int8 q [K, N] * scale [N] -> [..., N] in x's
    dtype (any number of rows; N a multiple of 4)."""
    if not x.is_cuda:
        return quantized_matmul_plain(x, q, scale)
    k, n = q.shape
    if x.shape[-1] != k:
        raise ValueError(f"int8_matmul: x {tuple(x.shape)} vs weight "
                         f"{tuple(q.shape)}")
    return _launch("int8_matmul", x, q, scale, n, k, nk=False)


def quantized_matmul_nk(x: torch.Tensor, q: torch.Tensor,
                        scale: torch.Tensor) -> torch.Tensor:
    """Kernel K-k: x [..., K] @ int8 q [N, K]ᵀ * scale [N] -> [..., N] in x's
    dtype (any number of rows; K a multiple of 16)."""
    if not x.is_cuda:
        return quantized_matmul_nk_plain(x, q, scale)
    n, k = q.shape
    if x.shape[-1] != k:
        raise ValueError(f"int8_matmul_nk: x {tuple(x.shape)} vs weight "
                         f"{tuple(q.shape)}")
    return _launch("int8_matmul_nk", x, q, scale, n, k, nk=True)


def quantize_rows_table(table: torch.Tensor) -> Dict[str, torch.Tensor]:
    """[V, H] table -> {"q": int8 [V, H], "s": f32 [V]}, one scale per row
    (the tied unembed's output channels)."""
    q, s = quantize_rows(table)
    return {"q": q, "s": s[:, 0]}


@torch.no_grad()
def quantize_llm_params(llm) -> Dict:
    """Weight-only int8 serving transform of a port QwenModel.

    -> {"layer_i": {"attn" | "mlp": {proj: {"q": int8 [K, N], "s": f32
    [N]}}}, "unembed_q": {"q": int8 [V, H], "s": f32 [V]}}: every attention
    and MLP projection kernel, and the tied embedding table with per-row
    scales. The decode reads its weight matrices from this tree; biases,
    norms, LoRA and the embedding gather stay the module's (the JAX tree
    carries copies of the same values)."""
    out: Dict = {}
    for i in range(llm.cfg.num_layers):
        layer = getattr(llm, f"layer_{i}")
        out[f"layer_{i}"] = {
            block: {name: dict(zip(("q", "s"), quantize_weight(sub.kernel)))
                    for name, sub in getattr(layer, block).named_children()
                    if name.endswith("_proj")}
            for block in ("attn", "mlp")}
    out["unembed_q"] = quantize_rows_table(llm.embed_tokens.embedding)
    return out
