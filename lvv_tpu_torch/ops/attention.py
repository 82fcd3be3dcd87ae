"""Attention ops (counterpart of lvv_tpu/ops/attention.py).

Layouts follow the JAX package: q [B, Hq, Sq, D], k / v [B, Hkv, Sk, D] ->
[B, Hq, Sq, D]; the SAM rel-pos op takes the packed qkv projection
[B, S, 3C] and returns [B, S, C].

- `flash_attention` (K-e, bf16; and its fp32 form at head dims up to
  64, a kernel of its own), `relpos_attention` (K-c and K-d, one CUDA
  kernel for both, with the int8 p@v arm K-d8 under `pv_int8`),
  `relpos_attention_qk8` (K-g, int8 scores) and `flash_attention_relpos` /
  `flash_attention_relpos_fused` (K-h, head-split q, k, v with the caller's
  q·R tables), the window alternates `window_attention_fused` / `_fused2` /
  `_v3` / `_v4` / `_phased` with `window_bias_prep` (K-l, no model path
  runs them), `hpacked_prep` with `flash_attention_relpos_hpacked_prepped`
  (K-m, likewise), and the benchmark scripts' bisect kernels
  `window_attention_bisect` (B-1) and `window_attention_hmaj` (B-2) are
  the kernel wrappers: on a CUDA tensor they launch their kernel or raise,
  on a CPU tensor they compute their plain version.
- `attention_reference` (= `flash_attention_plain`) and each wrapper's
  `*_plain` are the plain PyTorch versions. `quantize_v`, `qk8_operands`,
  `fused_operands` and the window variants' row glue are glue that the JAX
  package computes outside its kernels too; the int8 p@v launches make
  their v operands on the card (`pv8_v_operands` is the PyTorch version,
  `pv8_v_launch` those kernels alone) and take `pv8_plan`'s schedule; K-g
  makes `qk8_operands`' operands with its prep kernel (`qk8_prep`, held to
  them; `qk8_attention_plain` is the attention on given operands); K-h's
  float forms take `kh_float_plan`'s table placement.
- `attention` keeps the JAX dispatch: the flash kernel once the kv sequence
  reaches 1024, without bias, and causal only for sq == sk; the reference
  otherwise. `decode_attention` is the reference over the cache, as in JAX.
- Where autograd needs a gradient (`kernels.wants_grad`), `flash_attention`
  runs through `ops.autograd.FlashAttentionFn` (the kernel forward,
  `attention_reference` recomputed for the backward, as JAX's
  `_flash_diff_bwd`); every other kernel raises there (`kernels.refuse_grad`:
  the JAX package has no VJP for them either).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from .. import kernels
from .quant import quantize_rows

_NEG_INF = -1e30
_LOG2E = math.log2(math.e)
_LANE = 128              # one head's augmented depth in K-g


# The int8 p@v kernels (K-d8, K-h's int8 arms) share pv8_sm90.cuh's core;
# the wrapper makes each launch's plan.
_SMEM_MAX = 232448          # dynamic shared memory a block may take (H100)
_PV8_RULES = ("any", "wide", "g64", "global")


def pv8_plan(kind: str, s: int, d: int, gh: int, gw: int) -> dict:
    """The plan of one int8 p@v launch (pv8_sm90.cuh) from the shapes alone:
    kind "kd8" (`relpos_attention`'s int8 arm, from packed qkv), "stream"
    or "fused" (K-h's). `rule`: how a score finds its bias columns, "g64"
    (a grid 64 wide: at compile time), "wide" (a grid at least 64 wide and
    a multiple of 8, as K-h's 80x80: two grid rows a 64-key step at most,
    picked per 8-column block) or "any" (each lane steps its columns), all
    three with the block's rows of the tables in shared memory as fp32,
    the width rows `ldw` floats apart (and, under "wide", extended by a
    step past gw); "global" reads the caller's bf16 tables where they lie
    (K-h's grids whose rows do not fit beside two stages). `step`: keys a
    step of the score product; `rows`: q rows a block, 128 (two consumer
    warpgroups, 168 registers a thread: 128-key steps under "g64")
    or 64 (one, 255 registers: head dim 128, "global"). `stages`: the
    ring's, as many (up to 4) as fit; `smem`: the block's bytes."""
    dq = 128 if kind == "fused" else d
    rows = 64 if d == 128 else 128

    def pitch(n):    # float2 reads of kw pairs: 8 times an odd number
        return n if n % 2 else ((n + 7) // 8 | 1) * 8

    def tables(ldw):
        return rows * ((0 if kind == "fused" else gh | 1) + ldw) * 4

    def smem(n, tab):
        q_bytes = dq // 64 * rows * 128
        stage = dq // 64 * 128 * 128 + d * 128  # K panels, int8 V tile
        return ((q_bytes + n * stage + tab + 7) // 8 * 8 + (2 * n + 1) * 8
                + 1024)

    def stages(tab):
        return next((n for n in (4, 3, 2) if smem(n, tab) <= _SMEM_MAX), 0)

    step = 64 if d == 64 else 32
    if kind == "kd8":
        g64 = d == 64 and gw == 64 and gh % 8 == 0
        rule, ldw = ("g64", 72) if g64 else ("any", gw if gw % 2 else gw + 2)
        step = 128 if g64 else step
    elif kind == "fused" and gw == 64 and stages(tables(72)):
        rule, ldw, step = "g64", 72, 128
    elif (kind == "stream" and d == 64 and gw % 8 == 0 and gw >= 64
          and stages(tables(pitch(gw + step)))):
        rule, ldw = "wide", pitch(gw + step)
    elif kind == "stream" and d == 64 and stages(tables(pitch(gw))):
        rule, ldw = "any", pitch(gw)
    else:
        rule, ldw, step, rows = "global", 0, 32, 64
    tab = 0 if rule == "global" else tables(ldw)
    n = stages(tab)
    return dict(rule=rule, step=step, rows=rows, ldw=ldw, stages=n,
                smem=smem(n, tab))


def _pv8_plan_args(kind: str, s: int, d: int, gh: int, gw: int):
    plan = pv8_plan(kind, s, d, gh, gw)
    return (_PV8_RULES.index(plan["rule"]), plan["ldw"], plan["step"],
            plan["rows"], plan["stages"])


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    if n_rep == 1:
        return k
    b, h, s, d = k.shape
    return k[:, :, None].expand(b, h, n_rep, s, d).reshape(b, h * n_rep, s, d)


def _keep(q, sk: int, causal: bool, kv_len: Optional[torch.Tensor]):
    """Which keys each query may see, [B or 1, 1, Sq, Sk]: causal with the
    sk - sq offset, keys below the row's kv_len; None where all are."""
    sq, keep = q.shape[2], None
    ki = torch.arange(sk, device=q.device)
    if causal:
        qi = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        keep = (ki[None, :] <= qi)[None, None]
    if kv_len is not None:
        row = (ki[None, :] < kv_len.to(q.device)[:, None])[:, None, None, :]
        keep = row if keep is None else keep & row
    return keep


def attention_reference(q, k, v, *, causal: bool = False,
                        kv_len: Optional[torch.Tensor] = None,
                        bias: Optional[torch.Tensor] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Plain attention with fp32 logits and softmax; the CPU path and the
    oracle of the flash kernel."""
    n_rep = q.shape[1] // k.shape[1]
    k, v = _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        logits = logits + bias.float()
    keep = _keep(q, k.shape[2], causal, kv_len)
    if keep is not None:
        logits = logits.masked_fill(~keep, _NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.matmul(probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


flash_attention_plain = attention_reference

_SMS = 132               # the H100's streaming multiprocessors
_FLASH_BQ = 128          # q rows a block of the flash kernel
_SPLIT_MIN_KV = 512      # keys a kv split holds at least
_SPLIT_COST = 0.02       # each split's partials cost ~2% of the kernel


def flash_splits(b: int, hq: int, sq: int, sk: int) -> int:
    """How many kv splits the bf16 flash kernel runs, from the shapes alone
    (so results repeat run to run): 1 where the q tiles (128 rows), heads
    and batch give a block per SM; otherwise the count n (each split at
    least 512 keys) that minimises the waves of blocks per unit of work,
    ceil(blocks·n / SMs) / n, times 1 + 2% per split for the partials'
    round trip (ties: fewer)."""
    blocks = -(-sq // _FLASH_BQ) * hq * b
    most = max(1, sk // _SPLIT_MIN_KV)
    if blocks >= _SMS:
        return 1
    return min(range(1, most + 1), key=lambda n: (
        -(-blocks * n // _SMS) / n * (1 + _SPLIT_COST * n), n))


_F32_ROWS, _F32_WARPS = 16, 7   # the fp32 form's rows a warp, warps a block
_F32_KEYS = 32                  # the fp32 form's keys a tile
_F32_MIN_TILES = 4              # kv tiles a split of the fp32 form holds


def flash_f32_plan(b: int, hq: int, sq: int, sk: int, d: int) -> dict:
    """The fp32 form's launch (flash_attention_f32.cu) from the shapes
    alone: each warp owns a row tile of 16 q rows; a block holds the fewest
    warps, at most 7, that even out the row tiles over the fewest blocks
    (`rows` q rows a block, `q_blocks` a head); `keys` a kv tile, `dp` the
    head dim padded to a multiple of 8; `splits` of the kv axis, enough for
    two blocks on each SM where the q blocks, heads and batch give fewer
    (each split at least 4 tiles), cut as `flash_attention_split_plain`
    cuts it; `blocks` in the grid. The kernel derives `rows` and `keys` by
    the same rule."""
    dp = -(-d // 8) * 8
    row_tiles = -(-sq // _F32_ROWS)
    q_blocks = -(-row_tiles // _F32_WARPS)
    warps = -(-row_tiles // q_blocks)
    blocks = q_blocks * hq * b
    most = max(1, -(-sk // _F32_KEYS) // _F32_MIN_TILES)
    splits = 1 if blocks >= 2 * _SMS else min(most, -(-2 * _SMS // blocks))
    return dict(dp=dp, keys=_F32_KEYS, rows=_F32_ROWS * warps,
                q_blocks=q_blocks, splits=splits, blocks=blocks * splits)


def flash_attention_split_plain(q, k, v, *, n_split: int,
                                causal: bool = False,
                                kv_len: Optional[torch.Tensor] = None,
                                scale: Optional[float] = None,
                                block_k: Optional[int] = None
                                ) -> torch.Tensor:
    """The flash kernel's split-kv arithmetic in plain PyTorch (for the
    tests): the kv axis cut where the kernel cuts it (whole tiles of
    `block_k` keys, by default the bf16 form's, the same number in each
    split), per split the base-2 softmax state of each row (m, l and o =
    p·v with p rounded to v's dtype, unnormalised), then the combine:
    weights 2^(m - M) over the splits that hold one of the row's keys, out
    = sum w·o / max(sum w·l, 1e-30)."""
    n_rep = q.shape[1] // k.shape[1]
    k, v = _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    sk = k.shape[2]
    s2 = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (
        scale * _LOG2E)
    keep = _keep(q, sk, causal, kv_len)
    if keep is None:
        keep = torch.ones_like(s2, dtype=torch.bool)
    s2 = s2.masked_fill(~keep, _NEG_INF)
    bn = block_k or (64 if q.shape[-1] > 128 else 128)   # kv tile
    step = -(-(-(-sk // bn)) // n_split) * bn
    parts = []
    for c0 in range(0, sk, step):      # a split past sk holds no key
        sl = slice(c0, c0 + step)
        m = s2[..., sl].amax(-1, keepdim=True)
        p = torch.exp2(s2[..., sl] - m)
        has = keep[..., sl].any(-1, keepdim=True)
        l = torch.where(has, p.sum(-1, keepdim=True), torch.zeros_like(m))
        o = torch.matmul(p.to(v.dtype).float(), v[:, :, sl].float())
        parts.append((m, l, o))
    big = torch.stack([torch.where(l > 0, m, torch.full_like(m, _NEG_INF))
                       for m, l, _ in parts]).amax(0)
    num, den = 0.0, 0.0
    for m, l, o in parts:
        w = torch.where(l > 0, torch.exp2(m - big), torch.zeros_like(m))
        num = num + w * o
        den = den + w * l
    return (num / torch.clamp_min(den, 1e-30)).to(q.dtype)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 x rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero, by bit operations: what the fp32 form's cvt.rna.tf32.f32
    gives."""
    i = x.float().contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def flash_attention_tf32_plain(q, k, v, *, passes: int = 3,
                               causal: bool = False,
                               kv_len: Optional[torch.Tensor] = None,
                               scale: Optional[float] = None
                               ) -> torch.Tensor:
    """The fp32 form's arithmetic in plain PyTorch (for the tests): q scaled
    by scale·log2 e, the scores and p·v as products of TF32 operands summed
    in fp32, the softmax in base 2. passes=3 is 3xTF32, the kernel's: each
    operand x = big + small (big = `tf32_round(x)`, small =
    `tf32_round(x - big)`) and each product big·big + big·small +
    small·big. passes=1 is a single TF32 pass, big·big alone: the trap that
    the kernel's 1e-5 bound must see."""
    if passes not in (1, 3):
        raise ValueError(f"passes must be 1 or 3, not {passes}")
    n_rep = q.shape[1] // k.shape[1]
    k, v = _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])

    def product(a, b):
        ab, bb = tf32_round(a), tf32_round(b)
        if passes == 1:
            return ab @ bb
        return (tf32_round(a - ab) @ bb + ab @ tf32_round(b - bb)) + ab @ bb
    s2 = product(q.float() * (scale * _LOG2E), k.float().transpose(-1, -2))
    keep = _keep(q, k.shape[2], causal, kv_len)
    if keep is not None:
        s2 = s2.masked_fill(~keep, _NEG_INF)
    p = torch.exp2(s2 - s2.amax(-1, keepdim=True))
    return (product(p, v.float()) / p.sum(-1, keepdim=True)).to(q.dtype)


def flash_attention(q, k, v, *, causal: bool = False,
                    kv_len: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Kernel K-e: flash attention forward (causal with the sk - sq offset,
    per-batch kv_len, GQA by head index; the kv axis split across blocks
    as `flash_splits` says): bf16 q, k, v at head dim 64, 112, 128 or 256,
    or, in its fp32 form, fp32 q, k, v at any head dim up to 64."""
    if kernels.wants_grad(q, k, v):
        from .autograd import FlashAttentionFn
        return FlashAttentionFn.apply(q, k, v, causal, kv_len, scale)
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, causal=causal, kv_len=kv_len,
                                     scale=scale)
    if q.dtype == torch.float32:
        return _flash_f32(q, k, v, causal, kv_len, scale)
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if (k.shape != (b, hkv, sk, d) or v.shape != k.shape or hq % hkv
            or d not in (64, 112, 128, 256)):
        raise ValueError(f"flash_attention: unsupported shapes q {tuple(q.shape)}"
                         f" k {tuple(k.shape)} v {tuple(v.shape)}")
    ops = (q, k, v)
    if any(t.dtype != torch.bfloat16 or t.device != q.device for t in ops):
        raise ValueError("flash_attention: q, k, v must be bf16 on one device")
    kernels.refuse_grad("flash_attention", *ops)
    # TMA reads the views where they lie: unit stride on D, 16-byte aligned
    # base and strides (size-1 axes aside)
    ops = tuple(t if t.stride(-1) == 1 and t.data_ptr() % 16 == 0
                and all(st > 0 and st % 8 == 0
                        for st, n in zip(t.stride()[:3], t.shape) if n > 1)
                else t.contiguous() for t in ops)
    if kv_len is not None:
        kv_len = kv_len.to(device=q.device, dtype=torch.int32).contiguous()
        if kv_len.shape != (b,):
            raise ValueError("flash_attention: kv_len must be [B]")
    # written token-major so the caller's head merge is a free view
    out = torch.empty(b, sq, hq, d, dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    n_split = flash_splits(b, hq, sq, sk)
    part_o = part_ml = None
    if n_split > 1:
        part_o = torch.empty(n_split * b * hq * sq * d, dtype=torch.float32,
                             device=q.device)
        part_ml = torch.empty(n_split * b * hq * sq * 2,
                              dtype=torch.float32, device=q.device)
    # a size-1 axis may carry any stride; TMA wants a multiple of 16 bytes
    strides = (ctypes.c_longlong * 12)(*(
        st if n > 1 else 8 for t in (*ops, out)
        for st, n in zip(t.stride()[:3], t.shape)))
    fn = kernels.lib("flash_attention").lvv_flash_attention
    err = fn(*(t.data_ptr() for t in ops),
             None if kv_len is None else kv_len.data_ptr(), out.data_ptr(),
             None if part_o is None else part_o.data_ptr(),
             None if part_ml is None else part_ml.data_ptr(),
             b, hq, hkv, sq, sk, d, int(causal), n_split,
             ctypes.c_float(scale), ctypes.cast(strides, ctypes.c_void_p),
             torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check(err, "flash_attention")
    kernels.launches["flash_attention"] += 1
    return out


def _flash_f32(q, k, v, causal: bool, kv_len, scale) -> torch.Tensor:
    """K-e's fp32 form (kernels/csrc/flash_attention_f32.cu): what
    `_flash_kernel` computes on fp32 inputs, s, p and the accumulator in
    fp32, head dim up to 64 (`_flash_padded` pads such heads to 64), its
    products in 3xTF32 on the tensor cores (`flash_attention_tf32_plain`
    is that arithmetic in PyTorch), launched as `flash_f32_plan` says."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if (k.shape != (b, hkv, sk, d) or v.shape != k.shape or hq % hkv
            or not 1 <= d <= 64):
        raise ValueError("flash_attention: unsupported fp32 shapes q "
                         f"{tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} (head dim 1-64)")
    ops = (q, k, v)
    if any(t.dtype != torch.float32 or t.device != q.device for t in ops):
        raise ValueError("flash_attention: fp32 q, k, v must be fp32 on "
                         "one device")
    kernels.refuse_grad("flash_attention", *ops)
    ops = tuple(t if t.stride(-1) == 1 else t.contiguous() for t in ops)
    if kv_len is not None:
        kv_len = kv_len.to(device=q.device, dtype=torch.int32).contiguous()
        if kv_len.shape != (b,):
            raise ValueError("flash_attention: kv_len must be [B]")
    out = torch.empty(b, sq, hq, d, dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    n_split = flash_f32_plan(b, hq, sq, sk, d)["splits"]
    part_o = part_ml = None
    if n_split > 1:
        part_o = torch.empty(n_split * b * hq * sq * d, dtype=torch.float32,
                             device=q.device)
        part_ml = torch.empty(n_split * b * hq * sq * 2,
                              dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 12)(*(
        st for t in (*ops, out) for st in t.stride()[:3]))
    fn = kernels.lib("flash_attention_f32").lvv_flash_attention_f32
    err = fn(*(t.data_ptr() for t in ops),
             None if kv_len is None else kv_len.data_ptr(), out.data_ptr(),
             None if part_o is None else part_o.data_ptr(),
             None if part_ml is None else part_ml.data_ptr(),
             b, hq, hkv, sq, sk, d, int(causal), n_split,
             ctypes.c_float(scale), ctypes.cast(strides, ctypes.c_void_p),
             torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check(err, "flash_attention[fp32]")
    kernels.launches["flash_attention[fp32]"] += 1
    return out


def attention(q, k, v, *, causal: bool = False,
              kv_len: Optional[torch.Tensor] = None,
              bias: Optional[torch.Tensor] = None,
              scale: Optional[float] = None) -> torch.Tensor:
    """Multi-head attention with the JAX package's dispatch rule."""
    if (bias is None and k.shape[2] >= 1024
            and (not causal or q.shape[2] == k.shape[2])):
        return flash_attention(q, k, v, causal=causal, kv_len=kv_len,
                               scale=scale)
    return attention_reference(q, k, v, causal=causal, kv_len=kv_len,
                               bias=bias, scale=scale)


def decode_attention(q, k_cache, v_cache, cache_len, *, scale=None):
    """Single-token attention over the KV cache (plain, as in JAX: it is
    bandwidth-bound over the cache)."""
    return attention_reference(q, k_cache, v_cache, kv_len=cache_len,
                               scale=scale)


def relpos_bias(q, rel_h, rel_w, grid_w: int) -> torch.Tensor:
    """Decomposed rel-pos bias [B, H, S, S] from q [B, H, S, d] (unscaled)
    and the resized tables rel_h [gh, gh, d], rel_w [gw, gw, d]."""
    b, heads, s, d = q.shape
    gh = s // grid_w
    qr = q.float().reshape(b, heads, gh, grid_w, d)
    bias_h = torch.einsum("bnhwc,hkc->bnhwk", qr, rel_h.float())
    bias_w = torch.einsum("bnhwc,wkc->bnhwk", qr, rel_w.float())
    bias = bias_h[..., :, None] + bias_w[..., None, :]
    return bias.reshape(b, heads, s, s)


def _split_qkv(qkv, heads: int):
    b, s, c3 = qkv.shape
    d = c3 // 3 // heads
    return qkv.reshape(b, s, 3, heads, d).permute(2, 0, 3, 1, 4)


def quantize_v(v: torch.Tensor, seq_dim: int):
    """v -> (int8 v, fp32 scales): one scale per channel of each (view,
    head), the maximum over the sequence axis `seq_dim` / 127 floored at
    1e-8 (K-d8's v, as attention.py quantizes it outside its kernel)."""
    vf = v.float()
    sv = torch.clamp_min(vf.abs().amax(dim=seq_dim, keepdim=True) / 127.0,
                         1e-8)
    v8 = torch.clamp(torch.round(vf / sv), -127, 127).to(torch.int8)
    return v8, sv


@functools.lru_cache(maxsize=None)
def pv8_kv_perm(n: int, device=None) -> torch.Tensor:
    """The kv order of the int8 p·v kernels' v operand (n a multiple of
    16): position 16·i + σ holds kv column 16·i + 2·(σ // 4) + σ % 2 +
    8·(σ % 4 // 2), the column whose p the kernel puts in k-slot σ of the
    s8 wgmma's register A operand (its score accumulators hold columns 2t,
    2t + 1, 8 + 2t, 9 + 2t of each 16 in lane t, the A operand wants
    4t .. 4t + 3; pv8_sm90.cuh). p8 @ v8 over the permuted kv axis is the
    same integer."""
    i = torch.arange(n, device=device)
    j = i % 16
    return i - j + 2 * (j // 4) + j % 2 + 8 * (j % 4 // 2)


def pv8_v_operands(v: torch.Tensor, seq_dim: int):
    """The int8 p·v kernels' v operands from v [B, H, S, d] (seq_dim 2) or
    [B, S, H, d] (seq_dim 1): (v8t [B, H, d, s_pad] int8, `quantize_v`'s v8
    transposed (kv is the contraction axis of p·v), zero-padded to whole
    64-column tiles and its kv axis in `pv8_kv_perm`'s order; sv [B, H, d]
    fp32)."""
    v8, sv = quantize_v(v, seq_dim)
    if seq_dim == 1:
        v8, sv = v8.permute(0, 2, 3, 1), sv[:, 0]
    else:
        v8, sv = v8.transpose(-1, -2), sv[:, :, 0]
    s = v8.shape[-1]
    s_pad = _pad_to(s, 64)
    v8t = torch.nn.functional.pad(v8, (0, s_pad - s))
    return v8t[..., pv8_kv_perm(s_pad, v.device)], sv.contiguous()


def pv8_v_launch(v: torch.Tensor):
    """`pv8_v_operands(v, 2)` computed by the kernels that the int8 p@v
    launches run first (v [B, H, S, d] bf16 on the card, d 64 or 128, the
    last axis contiguous): bit-equal to it. Returns (v8t, sv)."""
    b, heads, s, d = v.shape
    if (not v.is_cuda or v.dtype != torch.bfloat16 or d not in (64, 128)
            or v.stride(-1) != 1 or v.data_ptr() % 16
            or any(st % 8 for st in v.stride()[:3])):
        raise ValueError(f"pv8_v_launch: unsupported v {tuple(v.shape)}")
    kernels.refuse_grad("pv8_v_launch", v)
    v8t, sv, amax = _pv8_buffers(b, heads, d, s, v.device)
    strides = (ctypes.c_longlong * 3)(*v.stride()[:3])
    fn = kernels.lib("flash_attention_relpos").lvv_pv8_quantize_v
    err = fn(v.data_ptr(), ctypes.cast(strides, ctypes.c_void_p), b, heads, s,
             d, v8t.shape[-1], amax.data_ptr(), v8t.data_ptr(), sv.data_ptr(),
             torch.cuda.current_stream(v.device).cuda_stream)
    kernels.check(err, "pv8_v_launch")
    return v8t, sv


def _pv8_attention(q, k, v, bias, *, scale: float, group: int):
    """K-d8's function on head-split q, k, v [B, H, S, d] and the fp32 bias
    [B, H, S, S]: `_kh_online`'s int8 arm in base 2 over kv groups of
    `group` columns."""
    def scores(c0, c1):
        return (torch.matmul(q.float(), k[:, :, c0:c1].float().transpose(
            -1, -2)) * scale + bias[..., c0:c1]) * _LOG2E
    return _kh_online(scores, v, quantize_v(v, 2), kv_end=q.shape[2],
                      group=group, exp=torch.exp2).to(q.dtype)


def relpos_attention_plain(qkv, rel_h, rel_w, *, heads: int, scale: float,
                           pv_int8: bool = False,
                           pv_group: int = 1024) -> torch.Tensor:
    """softmax(scale·q·kᵀ + q·Rh[qh,kh] + q·Rw[qw,kw]) v from packed qkv
    [B, S, 3C], with the [S, S] bias materialised; returns [B, S, C]. With
    pv_int8, K-d8's int8 p@v (`_pv8_attention`)."""
    q, k, v = _split_qkv(qkv, heads)
    bias = relpos_bias(q, rel_h, rel_w, rel_w.shape[0])
    if pv_int8:
        out = _pv8_attention(q, k, v, bias, scale=scale, group=pv_group)
    else:
        out = attention_reference(q, k, v, bias=bias, scale=scale)
    b, _, s, d = out.shape
    return out.transpose(1, 2).reshape(b, s, heads * d)


def relpos_attention(qkv, rel_h, rel_w, *, heads: int, scale: float,
                     pv_int8: bool = False,
                     pv_group: int = 1024) -> torch.Tensor:
    """Kernels K-c / K-d: SAM attention with the decomposed rel-pos bias,
    from packed qkv [B, S, 3C] (S = gh·gw tokens, row-major) and the
    resized tables rel_h [gh, gh, d], rel_w [gw, gw, d]; returns [B, S, C].
    With pv_int8 the int8 p@v arm K-d8: p quantized per row of each group
    of pv_group kv columns (a multiple of 64), v per channel."""
    if not qkv.is_cuda:
        return relpos_attention_plain(qkv, rel_h, rel_w, heads=heads,
                                      scale=scale, pv_int8=pv_int8,
                                      pv_group=pv_group)
    b, s, c3 = qkv.shape
    d = c3 // 3 // heads
    gh, gw = rel_h.shape[0], rel_w.shape[0]
    if (c3 != 3 * heads * d or d not in (64, 128) or gh * gw != s
            or gh > 64 or gw > 128 or rel_h.shape != (gh, gh, d)
            or rel_w.shape != (gw, gw, d)
            or (pv_int8 and (pv_group <= 0 or pv_group % 64))):
        raise ValueError(f"relpos_attention: unsupported qkv {tuple(qkv.shape)}"
                         f" rel_h {tuple(rel_h.shape)} rel_w "
                         f"{tuple(rel_w.shape)} heads={heads} "
                         f"pv_group={pv_group}")
    ops = [t.contiguous() for t in (qkv, rel_h, rel_w)]
    if any(t.dtype != torch.bfloat16 or t.device != qkv.device for t in ops):
        raise ValueError("relpos_attention: operands must be bf16 on one "
                         "device")
    return _relpos_launch(*ops, heads=heads, scale=scale,
                          pv_group=pv_group if pv_int8 else 0)


def _pv8_buffers(b: int, heads: int, d: int, s: int, device):
    """Room for the int8 p@v kernels' v operands (v8t, sv) and the amax
    scratch of their quantization."""
    return (torch.empty(b, heads, d, _pad_to(s, 64), dtype=torch.int8,
                        device=device),
            torch.empty(b, heads, d, device=device),
            torch.empty(b, heads, d, dtype=torch.int32, device=device))


def _relpos_launch(qkv, rel_h, rel_w, *, heads: int, scale: float,
                   pv_group: int = 0, pv8=None) -> torch.Tensor:
    """Launch relpos_attention.cu on operands `relpos_attention` checked
    (contiguous bf16). pv_group > 0 takes the int8 p@v arm: on pv8 =
    (v8t, sv) of `pv8_v_operands` where given, else on v8t and sv that the
    launch first makes from qkv's v on the card (bit-equal)."""
    b, s, c3 = qkv.shape
    d = c3 // 3 // heads
    gh, gw = rel_h.shape[0], rel_w.shape[0]
    kernels.refuse_grad("relpos_attention", qkv, rel_h, rel_w)
    v8t = sv = amax = None
    if pv_group:
        v8t, sv, amax = (_pv8_buffers(b, heads, d, s, qkv.device)
                         if pv8 is None else (*pv8, None))
    name = f"relpos_attention{'_pv8' if pv_group else ''}[{gh}x{gw}]"
    out = torch.empty(b, s, heads * d, dtype=qkv.dtype, device=qkv.device)
    fn = kernels.lib("relpos_attention").lvv_relpos_attention
    err = fn(qkv.data_ptr(), rel_h.data_ptr(), rel_w.data_ptr(),
             *(None if t is None else t.data_ptr() for t in (v8t, sv, amax)),
             out.data_ptr(), b, s, heads, d, gh, gw,
             s if v8t is None else v8t.shape[-1], pv_group,
             *(_pv8_plan_args("kd8", s, d, gh, gw) if pv_group
               else (0,) * 5), ctypes.c_float(scale),
             torch.cuda.current_stream(qkv.device).cuda_stream)
    kernels.check(err, "relpos_attention")
    kernels.launches[name] += 1
    return out


def qk8_operands(qkv, rel_h, rel_w, *, heads: int, scale: float):
    """K-g's operands from packed qkv [B, S, 3C] (the JAX wrapper's glue,
    attention.py:827-878, in plain PyTorch). Per (token, head):
    q_aug = [q·scale·log2e | q·Rh·log2e | 0] and k_aug = [k | onehot(kh) |
    0], each 128 wide and rounded to qkv's dtype, quantized to int8 with
    one scale each; the scales and qrw = q·Rw·log2e are rounded to qkv's
    dtype as JAX stashes them in its lanes. Returns (q8, k8 [B, S, H, 128]
    int8, sq, sk [B, S, H] fp32, qrw [B, S, H, gw] fp32)."""
    b, s, c3 = qkv.shape
    c = c3 // 3
    d = c // heads
    gh, gw = rel_h.shape[0], rel_w.shape[0]
    cd = qkv.dtype
    qr, kr = (qkv[..., i * c:(i + 1) * c].reshape(b, s, heads, d)
              for i in range(2))
    q5 = qr.float().reshape(b, gh, gw, heads, d)
    q_rh = torch.einsum("bGwnc,Gkc->bGwnk", q5, rel_h.float()).reshape(
        b, s, heads, gh)
    q_rw = torch.einsum("bGwnc,wkc->bGwnk", q5, rel_w.float()).reshape(
        b, s, heads, gw)
    pad = torch.zeros(b, s, heads, _LANE - d - gh, device=qkv.device)
    q_aug = torch.cat([qr.float() * (scale * _LOG2E), q_rh * _LOG2E, pad],
                      -1).to(cd)
    onehot = (torch.arange(gh, device=qkv.device)[None, :]
              == (torch.arange(s, device=qkv.device) // gw)[:, None])
    k_aug = torch.cat([kr, onehot.to(cd)[None, :, None, :].expand(
        b, s, heads, gh), pad.to(cd)], -1)
    q8, sq = quantize_rows(q_aug)
    k8, sk = quantize_rows(k_aug)
    return (q8, k8, sq[..., 0].to(cd).float(), sk[..., 0].to(cd).float(),
            (q_rw * _LOG2E).to(cd).float())


def relpos_attention_qk8_plain(qkv, rel_h, rel_w, *, heads: int,
                               scale: float) -> torch.Tensor:
    """K-g's function: `qk8_operands`, then `qk8_attention_plain`. Returns
    [B, S, C]."""
    return qk8_attention_plain(qkv, qk8_operands(qkv, rel_h, rel_w,
                                                 heads=heads, scale=scale),
                               heads=heads)


def qk8_attention_plain(qkv, ops, *, heads: int) -> torch.Tensor:
    """K-g's attention on its operands ops = (q8, k8, sq, sk, qrw) in
    `qk8_operands`' layout: scores (z·sq)·sk + qrw[q, k mod gw] (z summed
    exactly: 128 products of |x| <= 127 stay below 2^24, so fp32 sums are
    exact), base-2 softmax, p rounded to qkv's dtype for p@v, v read from
    qkv [B, S, 3C]; one view at a time. Returns [B, S, C]."""
    b, s, c3 = qkv.shape
    c = c3 // 3
    d = c // heads
    q8, k8, sq, sk, qrw = ops
    gw = qrw.shape[-1]
    cols = torch.arange(s, device=qkv.device) % gw
    out = torch.empty(b, s, c, dtype=qkv.dtype, device=qkv.device)
    for i in range(b):
        z = torch.matmul(q8[i].transpose(0, 1).float(),
                         k8[i].permute(1, 2, 0).float())      # [H, S, S]
        sc = (z * sq[i].t()[..., None]) * sk[i].t()[:, None, :]
        sc = sc + qrw[i].transpose(0, 1)[..., cols]
        p = torch.exp2(sc - sc.amax(-1, keepdim=True))
        l = p.sum(-1, keepdim=True)
        v = qkv[i, :, 2 * c:].reshape(s, heads, d).transpose(0, 1).float()
        o = torch.matmul(p.to(qkv.dtype).float(), v) / l
        out[i] = o.transpose(0, 1).reshape(s, c).to(qkv.dtype)
    return out


def _qk8_check(fn: str, qkv, rel_h, rel_w, heads: int):
    b, s, c3 = qkv.shape
    d = c3 // 3 // heads
    gh, gw = rel_h.shape[0], rel_w.shape[0]
    if (c3 != 3 * heads * d or d != 64 or gh * gw != s or d + gh > _LANE
            or gw > _LANE or rel_h.shape != (gh, gh, d)
            or rel_w.shape != (gw, gw, d)):
        raise ValueError(f"{fn}: unsupported qkv {tuple(qkv.shape)} rel_h "
                         f"{tuple(rel_h.shape)} rel_w {tuple(rel_w.shape)} "
                         f"heads={heads}")
    if any(t.dtype != torch.bfloat16 or t.device != qkv.device
           for t in (qkv, rel_h, rel_w)):
        raise ValueError(f"{fn}: operands must be bf16 on one device")
    return [t.contiguous() for t in (qkv, rel_h, rel_w)]


def qk8_prep(qkv, rel_h, rel_w, *, heads: int, scale: float):
    """K-g's operands made by its prep kernel on the card (the launch that
    `relpos_attention_qk8` runs first): (q8, k8 [B, S, H, 128] int8, sq [B,
    S, H] fp32, skT [B, H, s_pad] fp32 (sk transposed, S padded to 128, not
    written past S), qrw [B, S, H, gw] bf16). k8 and sk are bit-equal to
    `qk8_operands` on the card; q8, sq and qrw take q·Rh and q·Rw as sums
    in another order than cuBLAS's."""
    if not qkv.is_cuda:
        raise ValueError("qk8_prep: the prep kernel runs on the card")
    qkv, rel_h, rel_w = _qk8_check("qk8_prep", qkv, rel_h, rel_w, heads)
    kernels.refuse_grad("qk8_prep", qkv, rel_h, rel_w)
    b, s, _ = qkv.shape
    gh, gw = rel_h.shape[0], rel_w.shape[0]
    ops = _qk8_buffers(b, s, heads, gw, qkv.device)
    err = kernels.lib("relpos_attention_qk8").lvv_qk8_prep(
        qkv.data_ptr(), rel_h.data_ptr(), rel_w.data_ptr(),
        *(t.data_ptr() for t in ops), b, s, heads, gh, gw, ops[3].shape[-1],
        ctypes.c_float(scale * _LOG2E),
        torch.cuda.current_stream(qkv.device).cuda_stream)
    kernels.check(err, "qk8_prep")
    return ops


def qk8_prep_operands(ops, s: int):
    """`qk8_prep`'s outputs in `qk8_operands`' layout and types (sk [B, S,
    H] from skT, qrw as fp32)."""
    q8, k8, sq, skt, qrw = ops
    return q8, k8, sq, skt[..., :s].transpose(1, 2), qrw.float()


def _qk8_buffers(b: int, s: int, heads: int, gw: int, device):
    """Room for K-g's prep outputs (see `qk8_prep`)."""
    i8 = dict(dtype=torch.int8, device=device)
    return (torch.empty(b, s, heads, _LANE, **i8),
            torch.empty(b, s, heads, _LANE, **i8),
            torch.empty(b, s, heads, device=device),
            torch.empty(b, heads, _pad_to(s, 128), device=device),
            torch.empty(b, s, heads, gw, dtype=torch.bfloat16, device=device))


def qk8_attend(qkv, ops, *, heads: int, grid_w: int) -> torch.Tensor:
    """K-g's attention launch alone on the prep's operands `ops` (those of
    `qk8_prep`), v read from qkv [B, S, 3C] (contiguous bf16 on the card).
    Returns [B, S, C]."""
    b, s, c3 = qkv.shape
    kernels.refuse_grad("qk8_attend", qkv, *ops)
    out = torch.empty(b, s, c3 // 3, dtype=qkv.dtype, device=qkv.device)
    err = kernels.lib("relpos_attention_qk8").lvv_qk8_attention(
        *(t.data_ptr() for t in ops), qkv.data_ptr(), out.data_ptr(), b, s,
        heads, grid_w, ops[3].shape[-1],
        torch.cuda.current_stream(qkv.device).cuda_stream)
    kernels.check(err, "qk8_attend")
    return out


def relpos_attention_qk8(qkv, rel_h, rel_w, *, heads: int,
                         scale: float) -> torch.Tensor:
    """Kernel K-g: SAM global attention with int8 q_aug·k_augᵀ scores (the
    height bias inside the product, depth 128) and bf16 p@v, from packed
    qkv [B, S, 3C] (head dim 64, d + gh <= 128, gw <= 128); returns
    [B, S, C]. On the card one call runs the prep kernel (`qk8_prep`: the
    operands of `qk8_operands`) and then the attention kernel."""
    if not qkv.is_cuda:
        return relpos_attention_qk8_plain(qkv, rel_h, rel_w, heads=heads,
                                          scale=scale)
    qkv, rel_h, rel_w = _qk8_check("relpos_attention_qk8", qkv, rel_h, rel_w,
                                   heads)
    kernels.refuse_grad("relpos_attention_qk8", qkv, rel_h, rel_w)
    b, s, c3 = qkv.shape
    gh, gw = rel_h.shape[0], rel_w.shape[0]
    ops = _qk8_buffers(b, s, heads, gw, qkv.device)
    out = torch.empty(b, s, c3 // 3, dtype=qkv.dtype, device=qkv.device)
    fn = kernels.lib("relpos_attention_qk8").lvv_relpos_attention_qk8
    err = fn(qkv.data_ptr(), rel_h.data_ptr(), rel_w.data_ptr(),
             *(t.data_ptr() for t in ops), out.data_ptr(), b, s, heads, gh,
             gw, ops[3].shape[-1], ctypes.c_float(scale * _LOG2E),
             torch.cuda.current_stream(qkv.device).cuda_stream)
    kernels.check(err, "relpos_attention_qk8")
    kernels.launches[f"relpos_attention_qk8[{gh}x{gw}]"] += 1
    return out


# --------------------------------------------------------------- K-h ------
# Head-split rel-pos attention (JAX: `flash_attention_relpos` and
# `flash_attention_relpos_fused`): q, k, v [B, H, S, d] with S = gh·gw and
# the caller's q·Rh / q·Rw tables q_rh [B, H, S, gh], q_rw [B, H, S, gw].


def _pad_to(x: int, m: int) -> int:
    return -(-x // m) * m


def _fused_ok(s: int, d: int, gh: int, grid_w: int, block_q: int,
              block_k: int) -> bool:
    """JAX's test for the fused-bias form (attention.py:424-425)."""
    return (s > 512 and s % block_q == 0 and s % block_k == 0
            and block_k % grid_w == 0 and d + gh <= _LANE)


def kh_tiles(s: int, block_q: int, block_k: int):
    """JAX's block arithmetic for the streaming and small forms
    (attention.py:434-438) -> (s_pad, kv tile, kv extent). The kernel walks
    s_pad // tile whole kv tiles and masks columns past S, so keys at or
    past tile·(s_pad // tile) are never read (at a 40x40 grid with tiles of
    4096 / 1024, S = 1600 pads to 1664 and only keys below 1024 count)."""
    block_k = min(block_k, _pad_to(s, _LANE))
    block_q = min(block_q, _pad_to(s, _LANE))
    s_pad = _pad_to(s, max(block_q, block_k))
    block_k = min(block_k, s_pad)
    return s_pad, block_k, min(s, s_pad // block_k * block_k)


def kh_form(s: int, d: int, grid_w: int, block_q: int, block_k: int,
            fused: bool = True):
    """The form of K-h's kernel that `flash_attention_relpos` launches on
    the card -> (form, kv extent, kv tile), by the JAX wrapper's dispatch
    (attention.py:424-438): "fused" where the fused test holds; the small
    form where S pads to 512 or less, "small" (the resident whole-row
    kernel, its bias on the tensor cores) for S <= 256 with both grid sides
    at most 16, else "small2" (two passes over kv); else "stream" with
    `kh_tiles`' kv extent."""
    gh = s // grid_w
    if fused and _fused_ok(s, d, gh, grid_w, block_q, block_k):
        return "fused", s, block_k
    s_pad, tile, kv_end = kh_tiles(s, block_q, block_k)
    if s_pad <= 512:
        resident = s <= 256 and gh <= 16 and grid_w <= 16
        return ("small" if resident else "small2"), s, tile
    return "stream", kv_end, tile


def _kh_tables_fit(s: int, gh: int, grid_w: int) -> bool:
    """The grids K-h's wrapper takes, one rule for every arm: the first
    kernel's bound, a 64-row slice of both tables at odd pitches in 160 KB.
    The kernels read tables that do not fit shared memory from global
    memory (`pv8_plan`'s rule "global", `kh_float_plan`'s "global"), so the
    bound only keeps the support set."""
    return 64 * 4 * ((gh | 1) + (grid_w | 1)) <= 160 * 1024


def kh_float_plan(form: str, s: int, d: int, gh: int, gw: int,
                  kv_end: int) -> dict:
    """Where K-h's float forms (`kh_stream_sm90`, forms "stream", "fused",
    "small2") keep the bias tables, from the shapes alone: "smem" (the
    block's 128 rows of both tables as fp32 at the kernel's pitches, and a
    column table of kv // gw and kv % gw in 8 bits each, beside q and two
    stages of K / V tiles) where that fits and both sides are below 256,
    or where the tiles are two whole grid rows (80 wide at head dim 64, the
    fused form 64 wide: no column table); else "global" (the caller's bf16
    rows read where they lie, each lane stepping its columns), which the
    small2 form never needs (S <= 512). `tile`: keys a kv tile; `smem`:
    the block's bytes."""
    fused = form == "fused"
    dq = 128 if fused else d
    rowtile = ((form == "stream" and d == 64 and gw == 80 and kv_end % 80 == 0)
               or (fused and gw == 64 and kv_end % 128 == 0))

    def total(bn, ldh, ldw, n_col):  # flash_attention_relpos.cu `kh_tail`
        tab_off = dq // 64 * 128 * 128 + 2 * (dq // 64 + d // 64) * bn * 128
        bw = (tab_off + (0 if fused else 128 * ldh * 4) + 7) // 8 * 8
        return (bw + 128 * ldw * 4 + n_col * 2 + 7) // 8 * 8 + 64 + 1024

    bn = 2 * gw if rowtile else 128 if d == 64 and form != "small2" else 64
    ldw = gw if gw % 2 else (-(-gw // 8) | 1) * 8
    smem = total(bn, gh | 1, ldw, 0 if rowtile else _pad_to(kv_end, bn))
    if rowtile or (gh < 256 and gw < 256 and smem <= _SMEM_MAX):
        return dict(tables="smem", tile=bn, smem=smem)
    # 64-key tiles: the global reads' registers leave no room for 128
    return dict(tables="global", tile=64, smem=total(64, 0, 0, 0))


def _grid_cols(s: int, grid_w: int, device):
    cols = torch.arange(s, device=device)
    return cols // grid_w, cols % grid_w


def _kh_online(scores, v, pv8, *, kv_end: int, group: int, exp):
    """The TPU kernels' online softmax over kv [0, kv_end) in tiles of
    `group` columns: scores(c0, c1) -> fp32 logits [..., Sq, c1 - c0] in the
    domain of `exp` (torch.exp or torch.exp2), v [..., S, d]. Float arm: p
    (against the running maximum) rounded to v's dtype for p@v. With
    pv8 = (v8, sv) from `quantize_v`: p quantized per row of each tile
    against the tile's own maximum, int8 p@v summed exactly (products of
    |x| <= 127 stay exact in fp32 below 2^24). Returns fp32 [..., Sq, d]."""
    m = l = acc = None
    for c0 in range(0, kv_end, group):
        c1 = min(c0 + group, kv_end)
        sc = scores(c0, c1)
        smax = sc.amax(-1)
        if m is None:
            m = torch.full_like(smax, _NEG_INF)
            l = torch.zeros_like(smax)
            acc = torch.zeros(*smax.shape, v.shape[-1], device=v.device)
        m_new = torch.maximum(m, smax)
        p = exp(sc - m_new[..., None])
        alpha = exp(m - m_new)
        l = alpha * l + p.sum(-1)
        if pv8 is not None:
            v8, sv = pv8
            exact = (torch.float32 if (c1 - c0) * 127 * 127 < 2 ** 24
                     else torch.float64)
            sp = torch.clamp_min(exp(smax - m_new), 1e-30)
            p8 = torch.round(p * (127.0 / sp)[..., None])
            z = torch.matmul(p8.to(exact), v8[..., c0:c1, :].to(exact))
            pv = (z.float() * (sp * (1.0 / 127.0))[..., None]) * sv
        else:
            pv = torch.matmul(p.to(v.dtype).float(), v[..., c0:c1, :].float())
        acc = acc * alpha[..., None] + pv
        m = m_new
    return acc / torch.clamp_min(l, 1e-30)[..., None]


def flash_attention_relpos_plain(q, k, v, q_rh, q_rw, *, scale: float,
                                 grid_w: int, block_q: int = 1024,
                                 block_k: int = 1024, quant8: bool = False,
                                 fused: bool = True) -> torch.Tensor:
    """K-h's function with the JAX wrapper's dispatch, one view at a time
    (no [S, S] array exists for all views at once): the fused form where
    its test holds; all kv in one softmax with p normalised before it is
    rounded for p@v where S pads to 512 or less (no int8 arm there, as in
    JAX); else the streaming form over kv tiles of `kh_tiles`, base e, with
    the int8 p@v arm under quant8 (v per (view, head, channel), p per row of
    each kv tile). Logits (q·kᵀ·scale + q_rh[kv // w]) + q_rw[kv % w] in
    fp32. Returns [B, H, S, d] in q's dtype."""
    b, heads, s, d = q.shape
    gh = s // grid_w
    if fused and _fused_ok(s, d, gh, grid_w, block_q, block_k):
        return flash_attention_relpos_fused_plain(
            q, k, v, q_rh, q_rw, scale=scale, grid_w=grid_w, block_q=block_q,
            block_k=block_k, quant8=quant8)
    s_pad, tile, kv_end = kh_tiles(s, block_q, block_k)
    kh, kw = _grid_cols(s, grid_w, q.device)
    v8, sv = quantize_v(v, 2) if quant8 and s_pad > 512 else (None, None)
    out = torch.empty_like(q)
    for i in range(b):
        qf = q[i].float()
        rh, rw = q_rh[i].float(), q_rw[i].float()

        def scores(c0, c1):
            return ((torch.matmul(qf, k[i, :, c0:c1].float().transpose(-1, -2))
                     * scale + rh[..., kh[c0:c1]]) + rw[..., kw[c0:c1]])

        if s_pad <= 512:
            sc = scores(0, s)
            p = torch.exp(sc - sc.amax(-1, keepdim=True))
            p = p / p.sum(-1, keepdim=True)
            o = torch.matmul(p.to(v.dtype).float(), v[i].float())
        else:
            o = _kh_online(scores, v[i], None if v8 is None else
                           (v8[i], sv[i]), kv_end=kv_end, group=tile,
                           exp=torch.exp)
        out[i] = o.to(q.dtype)
    return out


def fused_operands(q, k, q_rh, q_rw, *, scale: float, grid_w: int):
    """The fused form's operands (the JAX wrapper's glue, attention.py:
    630-640, in plain PyTorch), each rounded to q's dtype:
    q_aug = [q·scale·log2e | q_rh·log2e | 0], k_aug = [k | onehot(kh) | 0]
    (zero-padded to 128 columns, which changes no product), and
    qrw = q_rw·log2e."""
    b, heads, s, d = q.shape
    gh = s // grid_w
    pad = torch.zeros(b, heads, s, _LANE - d - gh, device=q.device)
    q_aug = torch.cat([q.float() * (scale * _LOG2E), q_rh.float() * _LOG2E,
                       pad], -1).to(q.dtype)
    onehot = (torch.arange(gh, device=q.device)[None, :]
              == (torch.arange(s, device=q.device) // grid_w)[:, None])
    k_aug = torch.cat([k, onehot.to(k.dtype).expand(b, heads, s, gh),
                       pad.to(k.dtype)], -1)
    return q_aug, k_aug, (q_rw.float() * _LOG2E).to(q.dtype)


def flash_attention_relpos_fused_plain(q, k, v, q_rh, q_rw, *, scale: float,
                                       grid_w: int, block_q: int = 2048,
                                       block_k: int = 1024,
                                       quant8: bool = False) -> torch.Tensor:
    """The fused form's function (S a multiple of block_q and block_k,
    grid_w | block_k, d + gh <= 128): logits q_aug·k_augᵀ + qrw[kv % w] in
    base 2, online over kv tiles of block_k, p rounded to v's dtype for p@v
    or, under quant8, the int8 p@v arm as in the streaming form; one view at
    a time. Returns [B, H, S, d] in q's dtype."""
    b, heads, s, d = q.shape
    if not _fused_ok(s, d, s // grid_w, grid_w, block_q, block_k):
        raise ValueError(f"flash_attention_relpos_fused: S={s}, d={d}, "
                         f"grid_w={grid_w}, blocks {block_q}/{block_k} are "
                         "not the fused form's")
    q_aug, k_aug, qrw = fused_operands(q, k, q_rh, q_rw, scale=scale,
                                       grid_w=grid_w)
    kw = torch.arange(s, device=q.device) % grid_w
    v8, sv = quantize_v(v, 2) if quant8 else (None, None)
    out = torch.empty_like(q)
    for i in range(b):
        qa, rw = q_aug[i].float(), qrw[i].float()

        def scores(c0, c1):
            return (torch.matmul(qa, k_aug[i, :, c0:c1].float().transpose(
                -1, -2)) + rw[..., kw[c0:c1]])

        o = _kh_online(scores, v[i], None if v8 is None else (v8[i], sv[i]),
                       kv_end=s, group=block_k, exp=torch.exp2)
        out[i] = o.to(q.dtype)
    return out


# kernel modes of flash_attention_relpos.cu
_KH_MODES = {"stream": 0, "fused": 1, "small": 2, "small2": 3}


def _kh_launch(mode: int, name: str, q, k, v, qrh, qrw, *, scale: float,
               grid_w: int, d: int, kv_end: int, group: int, pv8=None):
    """Launch K-h's kernel in `mode` on [B, H, S, *] operands (q / k of
    depth d, or 128 in the fused mode) and tables read through their
    strides; group > 0 takes the int8 p@v arm on pv8 = (v8t, sv) of
    `pv8_v_operands` where given, else on v8t and sv that the launch first
    makes from v on the card (bit-equal). Returns [B, H, S, d] (written
    token-major, so the caller's head merge is a free view)."""
    b, heads, s, _ = q.shape
    gh = s // grid_w
    kernels.refuse_grad(name, q, k, v, qrh, qrw)
    ops = [t if t.stride(-1) == 1 and t.data_ptr() % 16 == 0
           and all(st % 8 == 0 for st in t.stride()[:3]) else t.contiguous()
           for t in (q, k, v)]
    tables = [None if t is None else t if t.stride(-1) == 1
              else t.contiguous() for t in (qrh, qrw)]
    v8t = sv = amax = None
    if group:
        v8t, sv, amax = (_pv8_buffers(b, heads, d, s, q.device)
                         if pv8 is None else (*pv8, None))
    out = torch.empty(b, s, heads, d, dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    strides = (ctypes.c_longlong * 18)(*(
        st for t in (*ops, out) for st in t.stride()[:3]),
        *(st for t in tables
          for st in ((0, 0, 0) if t is None else t.stride()[:3])))
    form = [f for f, m in _KH_MODES.items() if m == mode][0]
    if group:
        plan = _pv8_plan_args(form, s, d, gh, grid_w)
    else:     # the float arm: rule 3 reads the tables where they lie
        glob = form != "small" and kh_float_plan(
            form, s, d, gh, grid_w, kv_end)["tables"] == "global"
        plan = (3 if glob else 0, 0, 0, 0, 0)
    fn = kernels.lib("flash_attention_relpos").lvv_flash_attention_relpos
    err = fn(*(t.data_ptr() for t in ops),
             *(None if t is None else t.data_ptr() for t in tables),
             *(None if t is None else t.data_ptr() for t in (v8t, sv, amax)),
             out.data_ptr(), ctypes.cast(strides, ctypes.c_void_p), b, heads,
             s, d, gh,
             grid_w, kv_end, group, 0 if v8t is None else v8t.shape[-1],
             mode, *plan, ctypes.c_float(scale),
             torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check(err, "flash_attention_relpos")
    kernels.launches[name] += 1
    return out


def _kh_check(fn: str, q, k, v, tables, grid_w: int):
    b, heads, s, d = q.shape
    gh = s // grid_w if grid_w > 0 else 0
    ok = (d in (64, 128) and grid_w > 0 and gh * grid_w == s
          and k.shape == q.shape and v.shape == q.shape
          and tables[0].shape == (b, heads, s, gh)
          and tables[1].shape == (b, heads, s, grid_w)
          and _kh_tables_fit(s, gh, grid_w))
    if not ok:
        raise ValueError(f"{fn}: unsupported q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} tables "
                         f"{[tuple(t.shape) for t in tables]} "
                         f"grid_w={grid_w}")
    if any(t.dtype != torch.bfloat16 or t.device != q.device
           for t in (q, k, v, *tables)):
        raise ValueError(f"{fn}: operands must be bf16 on one device")


def flash_attention_relpos(q, k, v, q_rh, q_rw, *, scale: float,
                           grid_w: int, block_q: int = 1024,
                           block_k: int = 1024, quant8: bool = False,
                           fused: bool = True) -> torch.Tensor:
    """Kernel K-h: SAM attention with the decomposed rel-pos bias on
    head-split q, k, v [B, H, S, d] (S = gh·grid_w, d 64 or 128) and the
    caller's tables q_rh [B, H, S, gh], q_rw [B, H, S, grid_w], never
    materialising [S, S]. The JAX wrapper's dispatch and block arithmetic:
    the fused form (`flash_attention_relpos_fused`) where its test holds,
    the small form where S pads to 512 or less, else the streaming form
    with kv extent and int8 group from `kh_tiles`. Returns [B, H, S, d]."""
    if not q.is_cuda:
        return flash_attention_relpos_plain(
            q, k, v, q_rh, q_rw, scale=scale, grid_w=grid_w, block_q=block_q,
            block_k=block_k, quant8=quant8, fused=fused)
    b, heads, s, d = q.shape
    _kh_check("flash_attention_relpos", q, k, v, (q_rh, q_rw), grid_w)
    gh = s // grid_w
    if fused and _fused_ok(s, d, gh, grid_w, block_q, block_k):
        return flash_attention_relpos_fused(
            q, k, v, q_rh, q_rw, scale=scale, grid_w=grid_w, block_q=block_q,
            block_k=block_k, quant8=quant8)
    form, kv_end, tile = kh_form(s, d, grid_w, block_q, block_k,
                                 fused=False)
    if form != "stream":
        return _kh_launch(_KH_MODES[form],
                          f"flash_attention_relpos_mh[{gh}x{grid_w}]", q, k,
                          v, q_rh, q_rw, scale=scale, grid_w=grid_w, d=d,
                          kv_end=s, group=0)
    if quant8 and tile % 64:
        raise ValueError(f"flash_attention_relpos: int8 group {tile} is not "
                         "a multiple of 64")
    name = "flash_attention_relpos" + ("_pv8" if quant8 else "")
    return _kh_launch(_KH_MODES["stream"], f"{name}[{gh}x{grid_w}]", q, k, v,
                      q_rh, q_rw, scale=scale, grid_w=grid_w, d=d,
                      kv_end=kv_end, group=tile if quant8 else 0)


def flash_attention_relpos_fused(q, k, v, q_rh, q_rw, *, scale: float,
                                 grid_w: int, block_q: int = 2048,
                                 block_k: int = 1024,
                                 quant8: bool = False) -> torch.Tensor:
    """Kernel K-h, fused form: the operands of `fused_operands` (the height
    bias inside a depth-128 score product, base 2) and a width-bias table,
    int8 p@v per kv tile of block_k under quant8. Head dim 64."""
    if not q.is_cuda:
        return flash_attention_relpos_fused_plain(
            q, k, v, q_rh, q_rw, scale=scale, grid_w=grid_w, block_q=block_q,
            block_k=block_k, quant8=quant8)
    b, heads, s, d = q.shape
    _kh_check("flash_attention_relpos_fused", q, k, v, (q_rh, q_rw), grid_w)
    gh = s // grid_w
    if d != 64 or not _fused_ok(s, d, gh, grid_w, block_q, block_k):
        raise ValueError(f"flash_attention_relpos_fused: S={s}, d={d}, "
                         f"grid_w={grid_w}, blocks {block_q}/{block_k} are "
                         "not the fused form's")
    if quant8 and block_k % 64:
        raise ValueError(f"flash_attention_relpos_fused: int8 group "
                         f"{block_k} is not a multiple of 64")
    q_aug, k_aug, qrw = fused_operands(q, k, q_rh, q_rw, scale=scale,
                                       grid_w=grid_w)
    name = "flash_attention_relpos_fused" + ("_pv8" if quant8 else "")
    return _kh_launch(_KH_MODES["fused"], f"{name}[{gh}x{grid_w}]", q_aug,
                      k_aug, v, None, qrw, scale=scale, grid_w=grid_w, d=d,
                      kv_end=s, group=block_k if quant8 else 0)


# --------------------------------------------------------------- K-l ------
# SAM window attention over precomputed q·R bias rows: the five window
# alternates of the JAX package (`window_attention_fused`, `_fused2`, `_v3`,
# `_v4` with its prep kernel, `_phased`). All compute
#   softmax₂(q·k·scale·log2e + rh[q, kv // win] + rw[q, kv % win]) v
# over one window's S = win² keys, with p divided by its row sum and then
# rounded to qkv's dtype for p@v; they differ in where q·scale·log2e is
# rounded (before the product in fused / fused2, after it elsewhere) and in
# how their glue makes and lays out the bias rows rh, rw (each wrapper's
# glue below keeps JAX's roundings). One CUDA kernel,
# `window_attention_rows.cu`, runs all five on the rows where they lie.


def _kpad(win: int) -> int:
    """JAX's bias-row width max(8, ceil(win / 8)·8)."""
    return max(8, _pad_to(win, 8))


def _window_shape(fn: str, qkv, rel_h, rel_w, heads: int, win: int):
    b, s, c3 = qkv.shape
    c = c3 // 3
    hd = c // heads if heads > 0 else 0
    if (s != win * win or c3 != 3 * c or hd * heads != c
            or rel_h.shape != (win, win, hd) or rel_w.shape != (win, win, hd)):
        raise ValueError(f"{fn}: qkv {tuple(qkv.shape)} rel_h "
                         f"{tuple(rel_h.shape)} rel_w {tuple(rel_w.shape)} "
                         f"are not {win}x{win} windows of {heads} heads")
    return b, s, c, hd


def _log2e_table(rel, dtype):
    """rel·log2e rounded to `dtype`: the per-coordinate table of JAX's prep
    kernels (attention.py:1516-1520, :1404-1414) without the kron."""
    return (rel.float() * _LOG2E).to(dtype)


def _rows_fp32(qkv, rel_h, rel_w, heads: int, win: int):
    """fused / fused2 glue (attention.py:1207-1217, :1296-1306): fp32 q
    times the fp32 tables rel·log2e, rounded to qkv's dtype; [B, H, S, win]
    each (fp32 matmuls: TF32 off)."""
    b, s, c, hd = _window_shape("window_attention", qkv, rel_h, rel_w,
                                heads, win)
    q = qkv[..., :c].float().reshape(b, win, win, heads, hd)
    return tuple(torch.einsum(eq, q, r.float() * _LOG2E).reshape(
        b, heads, s, win).to(qkv.dtype) for eq, r in (
            ("bxyhd,xkd->bhxyk", rel_h), ("bxyhd,ykd->bhxyk", rel_w)))


def _rows_grouped(qkv, rel_h, rel_w, heads: int, win: int):
    """v3 / phased glue (attention.py:1849-1865, :1739-1748): q times the
    tables rounded to qkv's dtype, summed in fp32, times log2e, rounded to
    qkv's dtype and zero-padded to `_kpad` columns; [B, H, S, kpad] each."""
    b, s, c, hd = _window_shape("window_attention", qkv, rel_h, rel_w,
                                heads, win)
    q = qkv[..., :c].float().reshape(b, win, win, heads, hd)
    pad = _kpad(win) - win
    return tuple(torch.nn.functional.pad(
        torch.einsum(eq, q, r.to(qkv.dtype).float()).reshape(
            b, heads, s, win) * _LOG2E, (0, pad)).to(qkv.dtype)
        for eq, r in (("bxyhd,xkd->bhxyk", rel_h),
                      ("bxyhd,ykd->bhxyk", rel_w)))


def window_bias_prep_plain(qkv, rel_h, rel_w, *, heads: int, win: int):
    """`window_bias_prep`'s function: (qrh, qrw) [B, S, H·kp] with
    qrh[t, h·kp + k] = q[t, h]·bf16(rel_h[t // win, k]·log2e) summed in fp32
    and rounded to qkv's dtype (qrw: rel_w[t % win]); columns k >= win are
    zero."""
    b, s, c, hd = _window_shape("window_bias_prep", qkv, rel_h, rel_w, heads,
                                win)
    q = qkv[..., :c].float().reshape(b, win, win, heads, hd)
    pad = _kpad(win) - win
    return tuple(torch.nn.functional.pad(
        torch.einsum(eq, q, _log2e_table(r, qkv.dtype).float()),
        (0, pad)).to(qkv.dtype).reshape(b, s, heads * (win + pad))
        for eq, r in (("bxyhd,xkd->bxyhk", rel_h),
                      ("bxyhd,ykd->bxyhk", rel_w)))


# kernel modes of qr_prep.cu
_QR_ROWS, _QR_QK, _QR_V = 0, 1, 2


def _qr_prep_launch(mode: int, qkv, tab_h, tab_w, outs, *, heads: int,
                    gh: int, gw: int, width: int, cs: float = 0.0):
    b, s, c3 = qkv.shape
    kernels.refuse_grad("qr_prep", qkv, tab_h, tab_w)
    fn = kernels.lib("qr_prep").lvv_qr_prep
    err = fn(qkv.data_ptr(), *(None if t is None else t.data_ptr()
                               for t in (tab_h, tab_w)),
             outs[0].data_ptr(), None if len(outs) < 2 else outs[1].data_ptr(),
             b, s, heads, c3 // 3 // heads, gh, gw, width, mode,
             ctypes.c_float(cs),
             torch.cuda.current_stream(qkv.device).cuda_stream)
    kernels.check(err, "qr_prep")
    kernels.launches[f"qr_prep[{('rows', 'qk', 'v')[mode]}]"] += 1


def _bf16_on_one_device(fn: str, *ts):
    if any(t.dtype != torch.bfloat16 or t.device != ts[0].device for t in ts):
        raise ValueError(f"{fn}: operands must be bf16 on one device")


def window_bias_prep(qkv, rel_h, rel_w, *, heads: int, win: int):
    """Kernel K-l's prep (`qr_prep.cu`, mode rows; JAX `_window_bias_prep`):
    the grouped q·R bias rows (qrh, qrw) [B, S, H·kp] of packed qkv
    [B, S, 3C] (S = win², kp = max(8, ceil(win / 8)·8)), scaled by log2e;
    head dim 64 or 128, win <= 16 (a block holds a whole window, as K-l's
    row kernels do: S <= 256)."""
    if not qkv.is_cuda:
        return window_bias_prep_plain(qkv, rel_h, rel_w, heads=heads, win=win)
    b, s, c, hd = _window_shape("window_bias_prep", qkv, rel_h, rel_w, heads,
                                win)
    if hd not in (64, 128) or win > 16:
        raise ValueError(f"window_bias_prep: head dim {hd}, window {win} "
                         "(the kernel takes d 64 / 128, win <= 16)")
    _bf16_on_one_device("window_bias_prep", qkv, rel_h, rel_w)
    qkv = qkv.contiguous()
    kp = _kpad(win)
    outs = [torch.empty(b, s, heads * kp, dtype=qkv.dtype, device=qkv.device)
            for _ in range(2)]
    # the kernel makes the tables rel·log2e itself
    _qr_prep_launch(_QR_ROWS, qkv, rel_h.contiguous(), rel_w.contiguous(),
                    outs, heads=heads, gh=win, gw=win, width=kp)
    return tuple(outs)


def _window_rows_plain(qkv, rh, rw, *, heads: int, win: int, scale: float,
                       prescale: bool):
    """The five bodies' function on bias rows rh, rw [B, H, S, >= win]."""
    b, s, c3 = qkv.shape
    q, k, v = _split_qkv(qkv, heads)
    cs = torch.tensor(scale * _LOG2E, dtype=torch.float32).item()
    kt = k.float().transpose(-1, -2)
    if prescale:
        st = torch.matmul((q.float() * cs).to(qkv.dtype).float(), kt)
    else:
        st = torch.matmul(q.float(), kt) * cs
    kh, kw = _grid_cols(s, win, qkv.device)
    st = st + (rh[..., :win].float()[..., kh] + rw[..., :win].float()[..., kw])
    p = torch.exp2(st - st.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    out = torch.matmul(p.to(qkv.dtype).float(), v.float()).to(qkv.dtype)
    return out.transpose(1, 2).reshape(b, s, c3 // 3)


# kernel modes of window_attention_rows.cu
_WIN_MODES = {"rows_post": 0, "rows_pre": 1, "dots_qk": 2, "dots_qk_pv": 3,
              "softmax": 4, "bias2": 5, "hmaj": 6}


def _row_view(t):
    """t itself when its rows can be read 16 bytes at a time (unit stride
    over the last dim, 8-element strides, 16-byte aligned), else a copy."""
    if (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(st % 8 == 0 for st in t.stride()[:-1])):
        return t
    return t.contiguous()


def _unit_cols(t):
    """t itself when its last dim has unit stride (the kernel reads table
    entries one at a time), else a copy."""
    return t if t.stride(-1) == 1 else t.contiguous()


def _win_launch(name: str, mode: str, q, out, *, cs: float, heads: int = 0,
                k=None, v=None, win: int = 0, rh=None, rw=None, eh=None,
                ew=None):
    """One launch of window_attention_rows.cu, counted as `name`. Every mode
    but `hmaj`: q is qkv [B, S, 3C] and out [B, S, C], both contiguous;
    `hmaj`: q, k, v, out [B, H, S, d] views. rh / rw [B, H, S, cols]
    views."""
    kernels.refuse_grad(f"window_attention_rows[{name}]", q, k, v, rh, rw,
                        eh, ew)
    if mode == "hmaj":
        b, heads, s, d = q.shape
        views = (q, k, v, out)
    else:
        b, s, c3 = q.shape
        d, views = c3 // 3 // heads, ()
    tabs = [t for t in (rh, rw) if t is not None]
    strides = (ctypes.c_longlong * 18)(
        *([st for t in views for st in t.stride()[:3]] or [0] * 12),
        *(st for t in tabs for st in t.stride()[:3]),
        *([0] * (6 - 3 * len(tabs))))
    fn = kernels.lib("window_attention_rows").lvv_window_attention_rows
    err = fn(*(None if t is None else t.data_ptr()
               for t in (q, k, v, out, rh, rw, eh, ew)),
             ctypes.cast(strides, ctypes.c_void_p), b, s, heads, d, win,
             _WIN_MODES[mode], ctypes.c_float(cs),
             torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check(err, "window_attention_rows")
    kernels.launches[f"window_attention_rows[{name}]"] += 1


def _window_rows_launch(kind: str, qkv, rh, rw, *, heads: int, win: int,
                        scale: float, prescale: bool):
    b, s, c3 = qkv.shape
    hd = c3 // 3 // heads
    if hd not in (64, 128) or s > 256:
        raise ValueError(f"window_attention_{kind}: head dim {hd}, window "
                         f"{win} (the kernel takes d 64 / 128, S <= 256)")
    _bf16_on_one_device(f"window_attention_{kind}", qkv, rh, rw)
    qkv = qkv.contiguous()
    out = torch.empty(b, s, c3 // 3, dtype=qkv.dtype, device=qkv.device)
    _win_launch(kind, "rows_pre" if prescale else "rows_post", qkv, out,
                heads=heads, cs=scale * _LOG2E, win=win, rh=_unit_cols(rh),
                rw=_unit_cols(rw))
    return out


def _window_attention(kind: str, qkv, rel_h, rel_w, *, scale: float,
                      heads: int, win: int, plain: bool = False,
                      wchunk: int = 1, gwin: int = 1,
                      bias_mode: str = "edot", batched: bool = False):
    """One of the five variants: JAX's asserts as ValueErrors, its glue,
    then the kernel (CUDA tensor, not `plain`) or the plain version. wchunk,
    gwin, bias_mode and batched pick TPU schedules of one function."""
    fn = f"window_attention_{kind}"
    b, s, c, hd = _window_shape(fn, qkv, rel_h, rel_w, heads, win)
    if ((kind == "fused" and (hd + 2 * win > _LANE or wchunk <= 0
                              or b % wchunk))
            or (kind == "phased" and (gwin <= 0 or b % gwin))
            or bias_mode not in ("edot", "bcast")):
        raise ValueError(f"{fn}: head dim {hd}, window {win}, {b} windows, "
                         f"wchunk={wchunk}, gwin={gwin}, "
                         f"bias_mode={bias_mode!r}")
    plain = plain or not qkv.is_cuda
    rh, rw = _window_glue(kind, qkv, rel_h, rel_w, heads, win, plain)
    args = dict(heads=heads, win=win, scale=scale,
                prescale=kind in ("fused", "fused2"))
    if plain:
        return _window_rows_plain(qkv, rh, rw, **args)
    return _window_rows_launch(kind, qkv, rh, rw, **args)


def _window_glue(kind: str, qkv, rel_h, rel_w, heads: int, win: int,
                 plain: bool):
    """A variant's bias rows (rh, rw) [B, H, S, >= win] as its JAX glue
    makes and lays them out (v4: through its prep kernel unless plain)."""
    b, s, _ = qkv.shape
    if kind in ("fused", "fused2"):
        rh, rw = _rows_fp32(qkv, rel_h, rel_w, heads, win)
        if kind == "fused2":                  # JAX's qrhw [B, H, S, 2·win]
            rhw = torch.cat([rh, rw], -1)
            rh, rw = rhw[..., :win], rhw[..., win:]
        return rh, rw
    if kind == "v4":
        prep = window_bias_prep_plain if plain else window_bias_prep
        return tuple(t.view(b, s, heads, -1).transpose(1, 2) for t in prep(
            qkv, rel_h, rel_w, heads=heads, win=win))
    return _rows_grouped(qkv, rel_h, rel_w, heads, win)


def window_attention_fused(qkv, rel_h, rel_w, *, scale: float, heads: int,
                           win: int, wchunk: int = 1) -> torch.Tensor:
    """Kernel K-l (`_window_fused_kernel`): window attention over packed
    qkv [B, S, 3C] (S = win², row-major window tokens) and the tables
    rel_h / rel_w [win, win, hd], with q·scale·log2e rounded before the
    product and fp32-glue bias rows; needs hd + 2·win <= 128 and
    B % wchunk == 0. Returns [B, S, C]."""
    return _window_attention("fused", qkv, rel_h, rel_w, scale=scale,
                             heads=heads, win=win, wchunk=wchunk)


def window_attention_fused2(qkv, rel_h, rel_w, *, scale: float, heads: int,
                            win: int) -> torch.Tensor:
    """Kernel K-l (`_window_fused2_kernel`): the fused variant's function,
    its bias rows in one [B, H, S, 2·win] tensor."""
    return _window_attention("fused2", qkv, rel_h, rel_w, scale=scale,
                             heads=heads, win=win)


def window_attention_v3(qkv, rel_h, rel_w, *, scale: float, heads: int,
                        win: int, bias_mode: str = "edot") -> torch.Tensor:
    """Kernel K-l (`_window_v3_kernel`): (q·k)·scale·log2e plus grouped-dot
    bias rows [B, H, S, kp]; bias_mode "edot" / "bcast" compute the same
    function."""
    return _window_attention("v3", qkv, rel_h, rel_w, scale=scale,
                             heads=heads, win=win, bias_mode=bias_mode)


def window_attention_v4(qkv, rel_h, rel_w, *, scale: float, heads: int,
                        win: int) -> torch.Tensor:
    """Kernel K-l (`_window_v4_kernel` after `_wbias_prep_kernel`): v3's
    function over `window_bias_prep`'s token-major rows [B, S, H·kp]."""
    return _window_attention("v4", qkv, rel_h, rel_w, scale=scale,
                             heads=heads, win=win)


def window_attention_phased(qkv, rel_h, rel_w, *, scale: float, heads: int,
                            win: int, gwin: int = 1,
                            batched: bool = False) -> torch.Tensor:
    """Kernel K-l (`_window_phased_kernel`): v3's function (gathered-table
    glue); gwin (B % gwin == 0) and batched do not change it."""
    return _window_attention("phased", qkv, rel_h, rel_w, scale=scale,
                             heads=heads, win=win, gwin=gwin,
                             batched=batched)


def window_attention_fused_plain(qkv, rel_h, rel_w, **kw):
    return _window_attention("fused", qkv, rel_h, rel_w, plain=True, **kw)


def window_attention_fused2_plain(qkv, rel_h, rel_w, **kw):
    return _window_attention("fused2", qkv, rel_h, rel_w, plain=True, **kw)


def window_attention_v3_plain(qkv, rel_h, rel_w, **kw):
    return _window_attention("v3", qkv, rel_h, rel_w, plain=True, **kw)


def window_attention_v4_plain(qkv, rel_h, rel_w, **kw):
    return _window_attention("v4", qkv, rel_h, rel_w, plain=True, **kw)


def window_attention_phased_plain(qkv, rel_h, rel_w, **kw):
    return _window_attention("phased", qkv, rel_h, rel_w, plain=True, **kw)


# ------------------------------------------------------------ B-1, B-2 ----
# The cost-bisect kernels of two benchmark scripts of the JAX package, which
# time the parts of SAM's window attention one by one (`main.make(variant)`
# in benchmarks/winattn_bisect2.py, `main.make_hmaj(batched)` in
# benchmarks/winattn_bisect3.py). Per (window, head), with s = (q·k in
# fp32)·scale: `dots_qk` keeps bf16(s[:, :d]·1e-3), `dots_qk_pv` takes
# bf16(bf16(s·1e-3) @ v), `softmax` bf16(bf16(p) @ v) with p = exp(s − max)
# / Σ in base e, `bias2` first adds qrh @ eh + qrw @ ew (dense [16, S]
# expanders: products, not a gather); B-2 is `softmax` on head-major q, k,
# v. They are modes of `window_attention_rows.cu`; no model path runs them.

BISECT_VARIANTS = ("dots_qk", "dots_qk_pv", "softmax", "bias2")
_EXP_K = 16                # depth of bias2's expander products


def _bisect_heads(variant: str, q, k, v, qrh, qrw, eh, ew, *, scale: float):
    """The bisect function on q, k, v [B, H, S, d] -> [B, H, S, d] in q's
    dtype (bias2: qrh, qrw [B, H, S, 16], eh, ew [16, S])."""
    st = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if variant == "bias2":
        st = st + torch.matmul(qrh.float(), eh.float())
        st = st + torch.matmul(qrw.float(), ew.float())
    if variant == "dots_qk":
        return (st[..., :q.shape[-1]] * 1e-3).to(q.dtype)
    if variant == "dots_qk_pv":
        p = st * 1e-3
    else:
        p = torch.exp(st - st.amax(-1, keepdim=True))
        p = p / p.sum(-1, keepdim=True)
    return torch.matmul(p.to(v.dtype).float(), v.float()).to(q.dtype)


def _bisect_shape(variant: str, qkv, heads: int, qrh, qrw, eh, ew):
    b, s, c3 = qkv.shape
    c = c3 // 3
    d = c // heads if heads > 0 else 0
    ok = (variant in BISECT_VARIANTS and d > 0 and c3 == 3 * c
          and d * heads == c)
    if variant == "dots_qk":
        ok = ok and s >= d
    if variant == "bias2":
        ok = ok and all(t is not None for t in (qrh, qrw, eh, ew)) and (
            qrh.shape == qrw.shape == (b, heads, s, _EXP_K)
            and eh.shape == ew.shape == (_EXP_K, s))
    if not ok:
        tables = [None if t is None else tuple(t.shape)
                  for t in (qrh, qrw, eh, ew)]
        raise ValueError(f"window_attention_bisect[{variant}]: qkv "
                         f"{tuple(qkv.shape)}, {heads} heads, tables {tables}")
    return b, s, c, d


def window_attention_bisect_plain(qkv, *, variant: str, heads: int,
                                  scale: float, qrh=None, qrw=None, eh=None,
                                  ew=None) -> torch.Tensor:
    """`window_attention_bisect`'s function in plain PyTorch."""
    b, s, c, _ = _bisect_shape(variant, qkv, heads, qrh, qrw, eh, ew)
    q, k, v = _split_qkv(qkv, heads)
    out = _bisect_heads(variant, q, k, v, qrh, qrw, eh, ew, scale=scale)
    return out.transpose(1, 2).reshape(b, s, c)


def window_attention_bisect(qkv, *, variant: str, heads: int, scale: float,
                            qrh=None, qrw=None, eh=None,
                            ew=None) -> torch.Tensor:
    """Kernel B-1 (benchmarks/winattn_bisect2.py::main.make(variant)): one
    of the bisect variants over packed qkv [B, S, 3C] (S <= 256 tokens a
    window, head dim 64; dots_qk needs S >= 64) -> [B, S, C]. bias2 also
    takes the expander rows qrh, qrw [B, H, S, 16] and the expanders eh, ew
    [16, S]."""
    b, s, c, d = _bisect_shape(variant, qkv, heads, qrh, qrw, eh, ew)
    if not qkv.is_cuda:
        return window_attention_bisect_plain(qkv, variant=variant,
                                             heads=heads, scale=scale,
                                             qrh=qrh, qrw=qrw, eh=eh, ew=ew)
    if d != 64 or s > 256:
        raise ValueError(f"window_attention_bisect[{variant}]: head dim {d}, "
                         f"{s} tokens (the kernel takes d 64, S <= 256)")
    tables = [t for t in (qrh, qrw, eh, ew) if t is not None]
    _bf16_on_one_device(f"window_attention_bisect[{variant}]", qkv, *tables)
    qkv = qkv.contiguous()
    out = torch.empty(b, s, c, dtype=qkv.dtype, device=qkv.device)
    bias = {}
    if variant == "bias2":
        bias = dict(rh=_unit_cols(qrh), rw=_unit_cols(qrw),
                    eh=eh.contiguous(), ew=ew.contiguous())
    _win_launch(variant, variant, qkv, out, heads=heads, cs=scale, **bias)
    return out


def _hmaj_shape(q, k, v):
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"window_attention_hmaj: q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} are not one "
                         f"[B, H, S, d] shape")


def window_attention_hmaj_plain(q, k, v, *, scale: float) -> torch.Tensor:
    """`window_attention_hmaj`'s function in plain PyTorch."""
    _hmaj_shape(q, k, v)
    return _bisect_heads("softmax", q, k, v, None, None, None, None,
                         scale=scale)


def window_attention_hmaj(q, k, v, *, scale: float) -> torch.Tensor:
    """Kernel B-2 (benchmarks/winattn_bisect3.py::main.make_hmaj(batched)):
    window attention on head-major q, k, v [B, H, S, d] (three tensors, no
    bias): softmax in base e, p divided by its row sum and rounded before
    p@v; -> [B, H, S, d]. The script's two schedules (`batched`: one
    batched product over the heads, or a loop over them) compute this one
    function. S <= 256, head dim 64."""
    _hmaj_shape(q, k, v)
    if not q.is_cuda:
        return window_attention_hmaj_plain(q, k, v, scale=scale)
    b, heads, s, d = q.shape
    if d != 64 or s > 256:
        raise ValueError(f"window_attention_hmaj: head dim {d}, {s} tokens "
                         f"(the kernel takes d 64, S <= 256)")
    _bf16_on_one_device("window_attention_hmaj", q, k, v)
    out = torch.empty(b, heads, s, d, dtype=q.dtype, device=q.device)
    q, k, v = (_row_view(t) for t in (q, k, v))
    _win_launch("hmaj", "hmaj", q, out, k=k, v=v, cs=scale)
    return out


# --------------------------------------------------------------- K-m ------
# The head-packed global attention with Pallas-built operands (JAX:
# `hpacked_prep_pallas` and `flash_attention_relpos_hpacked_prepped`): each
# head's 128-lane block of q_aug = [bf16(q·scale·log2e) | q·Rh | 0], k_aug =
# [k | onehot(kh) | 0] and v_aug = [v | q·Rw | 0], with q·R = q times the
# table bf16(rel·log2e) summed in fp32 and rounded, then K-h's fused form on
# strided views of those blocks (v_aug's lanes d .. d + gw are the width
# table of the query rows).


def _hpacked_shape(fn: str, qkv, rel_h, rel_w, heads: int, grid_w: int):
    b, s, c3 = qkv.shape
    c = c3 // 3
    d = c // heads if heads > 0 else 0
    gh = s // grid_w if grid_w > 0 else 0
    if (c3 != 3 * c or d * heads != c or gh * grid_w != s
            or rel_h.shape != (gh, gh, d) or rel_w.shape != (grid_w, grid_w, d)
            or gh > _LANE - d or grid_w > _LANE - d):
        raise ValueError(f"{fn}: qkv {tuple(qkv.shape)} rel_h "
                         f"{tuple(rel_h.shape)} rel_w {tuple(rel_w.shape)} "
                         f"heads={heads} grid_w={grid_w} (needs gh, gw <= "
                         "128 - d)")
    return b, s, c, d, gh


_PREP_MODES = ("qk", "v")


def hpacked_prep_plain(qkv, rel_h, rel_w, *, heads: int, grid_w: int,
                       scale: float, modes=_PREP_MODES):
    """`hpacked_prep`'s function: (q_aug, k_aug) for mode "qk", (v_aug,)
    for mode "v", each [B, S, H·128] in qkv's dtype."""
    b, s, c, d, gh = _hpacked_shape("hpacked_prep", qkv, rel_h, rel_w, heads,
                                    grid_w)
    pad, cd = _LANE - d, qkv.dtype
    q, k, v = (qkv[..., i * c:(i + 1) * c].reshape(b, s, heads, d)
               for i in range(3))
    q5 = q.float().reshape(b, gh, grid_w, heads, d)
    F = torch.nn.functional
    out = []
    if "qk" in modes:
        qrh = torch.einsum("bGwnc,Gkc->bGwnk", q5,
                           _log2e_table(rel_h, cd).float())
        cs = torch.tensor(scale * _LOG2E, dtype=torch.float32).item()
        out.append(torch.cat([(q.float() * cs).to(cd), F.pad(
            qrh, (0, pad - gh)).to(cd).reshape(b, s, heads, pad)], -1))
        onehot = (torch.arange(pad, device=qkv.device)[None, :]
                  == (torch.arange(s, device=qkv.device) // grid_w)[:, None])
        out.append(torch.cat([k, onehot.to(cd)[None, :, None, :].expand(
            b, s, heads, pad)], -1))
    if "v" in modes:
        qrw = torch.einsum("bGwnc,wkc->bGwnk", q5,
                           _log2e_table(rel_w, cd).float())
        out.append(torch.cat([v, F.pad(qrw, (0, pad - grid_w)).to(cd).reshape(
            b, s, heads, pad)], -1))
    return tuple(t.reshape(b, s, heads * _LANE) for t in out)


def hpacked_prep(qkv, rel_h, rel_w, *, heads: int, grid_w: int, scale: float,
                 modes=_PREP_MODES):
    """Kernel K-m's prep (`qr_prep.cu`, modes qk and v; JAX
    `hpacked_prep_pallas`): (q_aug, k_aug) and / or (v_aug,) of packed qkv
    [B, S, 3C] over a gh x grid_w grid, [B, S, H·128] each; head dim 64,
    gh and grid_w <= 64."""
    if not qkv.is_cuda:
        return hpacked_prep_plain(qkv, rel_h, rel_w, heads=heads,
                                  grid_w=grid_w, scale=scale, modes=modes)
    b, s, c, d, gh = _hpacked_shape("hpacked_prep", qkv, rel_h, rel_w, heads,
                                    grid_w)
    if d != 64:
        raise ValueError(f"hpacked_prep: head dim {d} (the kernel takes 64)")
    _bf16_on_one_device("hpacked_prep", qkv, rel_h, rel_w)
    qkv = qkv.contiguous()
    out = []
    for mode in modes:
        outs = [torch.empty(b, s, heads * _LANE, dtype=qkv.dtype,
                            device=qkv.device)
                for _ in range(2 if mode == "qk" else 1)]
        # the kernel makes its table rel·log2e itself
        tabs = [r.contiguous() if m == mode else None
                for r, m in ((rel_h, "qk"), (rel_w, "v"))]
        _qr_prep_launch({"qk": _QR_QK, "v": _QR_V}[mode], qkv, *tabs, outs,
                        heads=heads, gh=gh, gw=grid_w, width=_LANE - d,
                        cs=scale * _LOG2E)
        out += outs
    return tuple(out)


def _prepped_check(fn: str, qkv, rel_h, rel_w, heads: int, grid_w: int,
                   block_q: int, block_k: int):
    b, s, c, d, gh = _hpacked_shape(fn, qkv, rel_h, rel_w, heads, grid_w)
    if (block_q <= 0 or block_k <= 0 or s % block_q or s % block_k
            or block_k % grid_w):
        raise ValueError(f"{fn}: S={s}, blocks {block_q}/{block_k}, "
                         f"grid_w={grid_w} (JAX's asserts, attention.py:"
                         "974-975)")
    return b, s, c, d, gh


def flash_attention_relpos_hpacked_prepped_plain(
        qkv, rel_h, rel_w, *, scale: float, grid_w: int, heads: int,
        block_q: int = 4096, block_k: int = 1024) -> torch.Tensor:
    """K-m's function: `hpacked_prep_plain`'s operands, logits q_aug·k_augᵀ
    + qrw[q, kv % gw] (qrw = v_aug's lanes d .. d + gw) in base 2, online
    over kv tiles of block_k with p rounded to qkv's dtype for p@v, one view
    at a time. Returns [B, S, C]."""
    b, s, c, d, gh = _prepped_check(
        "flash_attention_relpos_hpacked_prepped", qkv, rel_h, rel_w, heads,
        grid_w, block_q, block_k)
    qa, ka, va = (t.view(b, s, heads, _LANE).transpose(1, 2)
                  for t in hpacked_prep_plain(qkv, rel_h, rel_w, heads=heads,
                                              grid_w=grid_w, scale=scale))
    kw = torch.arange(s, device=qkv.device) % grid_w
    out = torch.empty(b, s, heads, d, dtype=qkv.dtype, device=qkv.device)
    for i in range(b):
        qf, qrw = qa[i].float(), va[i, ..., d:d + grid_w].float()

        def scores(c0, c1):
            return (torch.matmul(qf, ka[i, :, c0:c1].float().transpose(-1, -2))
                    + qrw[..., kw[c0:c1]])

        o = _kh_online(scores, va[i, ..., :d], None, kv_end=s, group=block_k,
                       exp=torch.exp2)
        out[i] = o.transpose(0, 1).to(qkv.dtype)
    return out.reshape(b, s, c)


def flash_attention_relpos_hpacked_prepped(
        qkv, rel_h, rel_w, *, scale: float, grid_w: int, heads: int,
        block_q: int = 4096, block_k: int = 1024) -> torch.Tensor:
    """Kernel K-m: SAM global attention from packed qkv [B, S, 3C] (head
    dim 64, S = gh·grid_w, d + gh <= 128, grid_w <= 64, S a multiple of
    block_q and block_k, grid_w | block_k): `hpacked_prep`'s lane blocks,
    then K-h's fused form on strided views of them. Returns [B, S, C]."""
    if not qkv.is_cuda:
        return flash_attention_relpos_hpacked_prepped_plain(
            qkv, rel_h, rel_w, scale=scale, grid_w=grid_w, heads=heads,
            block_q=block_q, block_k=block_k)
    b, s, c, d, gh = _prepped_check(
        "flash_attention_relpos_hpacked_prepped", qkv, rel_h, rel_w, heads,
        grid_w, block_q, block_k)
    if d != 64:
        raise ValueError(f"flash_attention_relpos_hpacked_prepped: head dim "
                         f"{d} (the kernel takes 64)")
    qa, ka, va = (t.view(b, s, heads, _LANE).transpose(1, 2)
                  for t in hpacked_prep(qkv, rel_h, rel_w, heads=heads,
                                        grid_w=grid_w, scale=scale))
    out = _kh_launch(_KH_MODES["fused"],
                     f"flash_attention_relpos_hpacked_prepped[{gh}x{grid_w}]",
                     qa, ka, va[..., :d], None, va[..., d:d + grid_w],
                     scale=scale, grid_w=grid_w, d=d, kv_end=s, group=0)
    return out.transpose(1, 2).reshape(b, s, c)
