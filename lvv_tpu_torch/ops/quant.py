"""int8 quantization and the weight-only int8 products of the serving
decode (counterpart of lvv_tpu/ops/quant.py).

Layout: per-output-channel symmetric quantization
    q[k, n] = round(w[k, n] / scale[n]),  scale[n] = max_k |w[k, n]| / 127
and out[m, n] = (x @ q)[m, n] * scale[n]. Quantization divides (not a
multiply by the reciprocal), rounds half to even, clips to +-127 and floors
the scale at 1e-8, so it is bit-equal to the JAX package's.

- `w8a8_matmul` (K-i, CUDA): SAM's W8A8 projections (the "dense" scope):
  the float weight quantized per column on every call and x per row, each
  by a pass of the kernel's own, then the int8 product on the sm_90a GEMM
  core, scheduled by `w8a8_plan`; `int8_dot` is its plain version and the
  JAX dispatch's path for K or N off the 128 grid.
- `quantized_matmul` (K-j, CUDA) and `quantized_matmul_nk` (K-k, CUDA) are
  the kernel wrappers of the decode: on a CUDA tensor they launch their kernel or raise,
  on a CPU tensor they compute their plain version. Both read the int8
  weight as stored ([K, N], or [N, K] for the tied unembed) and dequantize
  in registers; no dequantized copy of a weight is made on the card. K-j
  takes its grid and split-K clusters from `qmv_plan`, K-k its form and
  its one wave of blocks from `qmv_nk_plan`.
- `quantized_matmul_plain` / `quantized_matmul_nk_plain` follow the JAX
  decode's arithmetic: x @ q rounded to x's dtype, then scaled and rounded
  again (the kernels round once).
- `quantize_llm_params` is the serving transform of the Qwen weights.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch

from .. import kernels

_KINDS = {torch.float32: 0, torch.bfloat16: 1}
_SMS = 132                  # the H100's streaming multiprocessors
_SMEM_SM = 233472           # shared memory of an SM, bytes (1 KB a block
                            # of it reserved)


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


def w8a8_plan(m: int, k: int, n: int) -> dict:
    """K-i's schedule (w8a8_matmul.cu on gemm_sm90.cuh) for x [m, k] and a
    weight [k, n], from the shapes alone, as the C launch computes it from
    the card's SM count: [128, `bn`] output tiles, `tiles` = (row tiles,
    column tiles), on `blocks` persistent blocks, two an SM, at most one
    wave. bn is 128 at every shape: int8 tiles of 256 columns hold one
    block an SM, whose epilogue then stalls its own products (slower at
    every SAM shape on the H100)."""
    tiles = (-(-m // 128), -(-n // 128))
    return dict(bn=128, tiles=tiles,
                blocks=min(tiles[0] * tiles[1], 2 * _SMS))


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t contiguous at a 16-byte aligned address (the kernels read 16
    bytes at a time; TMA needs it)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def w8a8_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K-i's row pass alone: x [M, K] (bf16 or fp32, on the card) ->
    (int8 [M, K], per-row scale [M] fp32), the scale max|row| / 127 by a
    true division, as the kernel quantizes x."""
    m, k = x.shape
    if x.dtype not in _KINDS or k % 128 or k > 1536 or m == 0:
        raise ValueError(f"w8a8_rows: unsupported {tuple(x.shape)} {x.dtype}")
    kernels.refuse_grad("w8a8_rows", x)
    xc = _aligned(x)
    x8 = torch.empty(m, k, dtype=torch.int8, device=x.device)
    sx = torch.empty(m, dtype=torch.float32, device=x.device)
    err = kernels.lib("w8a8_matmul").lvv_w8a8_rows(
        xc.data_ptr(), x8.data_ptr(), sx.data_ptr(), m, k, _KINDS[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    kernels.check(err, "w8a8_rows")
    return x8, sx


def w8a8_matmul(x: torch.Tensor, w: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel K-i: W8A8 x [..., K] @ w [K, N] (+ bias) -> [..., N] in x's
    dtype, with JAX's dispatch: K or N off the 128 grid take `int8_dot`
    (also the plain version, on a CPU tensor). Otherwise one C call
    launches the weight's quantization (per column, every call, bf16 or
    fp32 w), x's row pass and the int8 product with its epilogue."""
    k, n = w.shape
    if k % 128 or n % 128 or not x.is_cuda:
        return int8_dot(x, w, bias)
    if (x.dtype not in _KINDS or w.dtype not in _KINDS or x.shape[-1] != k
            or k > 1536 or (bias is not None and (
                bias.dtype not in _KINDS or bias.shape != (n,)))):
        raise ValueError(f"w8a8_matmul: unsupported x {tuple(x.shape)} "
                         f"{x.dtype} / weight {tuple(w.shape)} {w.dtype}")
    if any(t is not None and t.device != x.device for t in (w, bias)):
        raise ValueError("w8a8_matmul: operands must be on one device")
    kernels.refuse_grad("w8a8_matmul", x, w, bias)
    lead = x.shape[:-1]
    x2 = _aligned(x.reshape(-1, k))
    m = x2.shape[0]
    out = torch.empty(m, n, dtype=x.dtype, device=x.device)
    if m:
        wc = _aligned(w)
        b = None if bias is None else _aligned(bias)
        i8, f32 = torch.int8, torch.float32
        # scratch: x8, sx, the weight transposed and its scales, and the
        # column maxima of each 128-row slab of the weight
        scratch = (x2.new_empty(m, k, dtype=i8), x2.new_empty(m, dtype=f32),
                   x2.new_empty(n, k, dtype=i8), x2.new_empty(n, dtype=f32),
                   x2.new_empty(k // 128, n, dtype=f32))
        err = kernels.lib("w8a8_matmul").lvv_w8a8_matmul(
            x2.data_ptr(), wc.data_ptr(), None if b is None else b.data_ptr(),
            out.data_ptr(), *(t.data_ptr() for t in scratch), m, k, n,
            _KINDS[x.dtype], _KINDS[w.dtype],
            0 if b is None else 1 + _KINDS[b.dtype],
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


def qmv_plan(m: int, k: int, n: int) -> dict:
    """K-j's launch plan (int8_matmul.cu) from the shapes alone. `rows`: x
    rows a block (1, 2, 4 or 8; more rows take more row groups); `vec`:
    weight columns a thread loads at once (16, or 8 at 8 rows; 4 where N is
    no multiple of those). A thread's rows·vec sums set `stages`, the
    weight loads it issues ahead (8 up to 16 sums, else 4), and the blocks
    an SM its registers allow (3 up to 32 sums, else 2), whose 7/8 (the
    clusters do not pack every SM) make one wave. `n_tile`: columns a
    block, 128 where the tiles fill that wave with K split 8 ways, else 32;
    `splits`: K ranges of `k_split` rows (the last may be shorter, none is
    empty), as many as the wave holds, at most 8 and each at least 16 rows;
    `cluster`: the blocks of one N tile's splits, whose partials the kernel
    adds in rank order."""
    rows = 1 if m <= 1 else 2 if m <= 2 else 4 if m <= 4 else 8
    vec = 8 if rows == 8 else 16
    vec = vec if n % vec == 0 else 4
    sums = rows * vec
    wave = (3 if sums <= 32 else 2) * _SMS * 7 // 8
    n_tile = 128 if -(-n // 128) * 8 >= wave else 32
    tiles = -(-n // n_tile)
    splits = max(1, min(8, wave // tiles, -(-k // 16)))
    k_split = -(-k // splits)
    splits = -(-k // k_split)
    return dict(rows=rows, vec=vec, n_tile=n_tile, splits=splits,
                k_split=k_split, cluster=splits,
                stages=8 if sums <= 16 else 4)


@functools.lru_cache(maxsize=256)
def _qmv_args(m: int, k: int, n: int) -> tuple:
    """`qmv_plan` as the C entry takes it, kept per shape: the decode asks
    for a few shapes thousands of times a generate, and the decode's pace
    is the host's."""
    plan = qmv_plan(m, k, n)
    return tuple(plan[key] for key in ("n_tile", "splits", "cluster",
                                       "k_split", "stages", "rows", "vec"))


def qmv_nk_plan(m: int, k: int, n: int, fp32: bool = False) -> dict:
    """K-k's launch plan (int8_matmul_nk.cu) from the shapes and x's type.
    `mma`: the tensor-core form, for bf16 x at 2 to 8 rows (and more, 8 a
    pass): a warp's tile is 16 rows of the table (`tile_rows`), x's rows
    the 8 columns of mma.sync's B operand. Else the fma form (fp32 x, or
    one row): tiles of 4 table rows, `rows` (1, 2, 4 or 8) rows of x a
    pass. `passes`: passes over the table (one at every m <= 8). `loads`:
    16-byte loads a lane makes of a tile, `smem` the bytes of x a block
    stages. `per_sm`: the blocks an SM holds (3 where the launch bounds
    leave 85 registers a thread, else 2, fewer where x's staging does not
    fit); `blocks`: one wave of them, at most one warp a tile."""
    mma = not fp32 and m >= 2
    rows = 8 if mma or m > 4 else 4 if m > 2 else m
    tile_rows = 16 if mma else 4
    loads = -(-k // (64 if mma else 128))
    smem = 8 * (64 * loads + 8) * 2 if mma else rows * 128 * loads * 4
    per_sm = min(3 if mma or rows <= 2 else 2, _SMEM_SM // (smem + 1024))
    tiles = -(-n // tile_rows)
    return dict(mma=mma, rows=rows, tile_rows=tile_rows, tiles=tiles,
                loads=loads, smem=smem, per_sm=per_sm,
                passes=-(-m // rows),
                blocks=max(1, min(per_sm * _SMS, -(-tiles // 8))))


@functools.lru_cache(maxsize=256)
def _qmv_nk_args(m: int, k: int, n: int, fp32: bool) -> tuple:
    """`qmv_nk_plan` as the C entry takes it, kept per shape (the decode
    calls it every step)."""
    plan = qmv_nk_plan(m, k, n, fp32)
    if plan["per_sm"] < 1:
        raise ValueError(f"int8_matmul_nk: K={k} does not fit a block")
    return int(plan["mma"]), plan["rows"], plan["blocks"]


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
    kernels.refuse_grad(name, x, scale)
    lead = x.shape[:-1]
    x2 = _aligned(x.reshape(-1, k))          # rows are read 16 bytes a time
    out = torch.empty(x2.shape[0], n, dtype=x.dtype, device=x.device)
    if x2.shape[0]:
        fn = getattr(kernels.lib(name), f"lvv_{name}")
        plan = (_qmv_nk_args(x2.shape[0], k, n, x.dtype == torch.float32)
                if nk else _qmv_args(x2.shape[0], k, n))
        err = fn(x2.data_ptr(), q.data_ptr(), scale.data_ptr(),
                 out.data_ptr(), x2.shape[0], k, n, _KINDS[x.dtype], *plan,
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
    carries copies of the same values). An untied lm_head stays float, and
    the decode then reads it, not "unembed_q" (as JAX's tree does)."""
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
