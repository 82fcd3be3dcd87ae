"""Packed int8 single-token decode (counterpart of
lvv_tpu/models/decode_fused.py).

`pack_decode_params` packs a port QwenModel once at serving-prep time:
q|k|v -> one int8 [H, 1152] product and gate|up -> one [H, 2F], each
projection quantized on its own (its exact per-column scales) and then
concatenated, LoRA folded into the float kernel before quantization, and
the tied table quantized per row for the unembed. `fused_decode_step` runs
one greedy step over the pack: 4 int8 products a layer through kernel K-j
and the unembed through kernel K-k. The arithmetic is the JAX decode's:

    dense(v, p) = ((v @ q) * s) in the model dtype, then + b
    carry       = last prefill logits in the model dtype
    next token  = argmax over those logits (first index on a tie)

Norms, RoPE, the in-place cache update and the attention over the cache are
the ops the port's Qwen decode uses; each residual add that a norm follows
is taken by that norm's launch (kernel K-a's add form, `add_norm_fast`).
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from ..config import LLMConfig
from ..ops import quant
from ..ops.attention import decode_attention
from ..ops.fused_mlp import add_norm_fast, norm_fast
from .qwen import KVCache, apply_rope, greedy_loop


def _eff_kernel(dense) -> torch.Tensor:
    """A Dense module -> its effective float32 kernel (LoRA folded:
    W + (A @ B) * alpha / r)."""
    w = dense.kernel.float()
    if dense.lora_rank:
        w = w + dense.lora_a.float() @ dense.lora_b.float() * dense.scaling
    return w


def _q(dense) -> Dict:
    return dict(zip(("q", "s"), quant.quantize_weight(_eff_kernel(dense))))


def _qcat(denses, biases: bool = True) -> Dict:
    """Quantize each projection separately (exact unfused scales), then
    concatenate along the output axis."""
    qs = [_q(d) for d in denses]
    out = {"q": torch.cat([p["q"] for p in qs], dim=1).contiguous(),
           "s": torch.cat([p["s"] for p in qs])}
    if biases and all(d.bias is not None for d in denses):
        out["b"] = torch.cat([d.bias.float() for d in denses])
    return out


@torch.no_grad()
def pack_decode_params(llm) -> Dict:
    """One-time pack of a port QwenModel into the fused decode layout. The
    norm scales and the embedding table are the module's own tensors."""
    cfg: LLMConfig = llm.cfg
    if not cfg.tie_word_embeddings:
        raise ValueError("the packed decode needs tied word embeddings (its "
                         "unembed is the quantized embedding table)")
    out: Dict = {"layers": []}
    for i in range(cfg.num_layers):
        layer = getattr(llm, f"layer_{i}")
        at, mlp = layer.attn, layer.mlp
        out["layers"].append({
            "ln1": layer.input_ln.scale,
            "ln2": layer.post_attn_ln.scale,
            "qkv": _qcat([at.q_proj, at.k_proj, at.v_proj]),
            "o": _q(at.o_proj),
            "gateup": _qcat([mlp.gate_proj, mlp.up_proj], biases=False),
            "down": _q(mlp.down_proj),
        })
    out["final_ln"] = llm.final_ln.scale
    out["embed"] = llm.embed_tokens.embedding
    out["unembed"] = quant.quantize_rows_table(llm.embed_tokens.embedding)
    return out


def _dense(v, p, dtype, bias: bool = False):
    y = quant.quantized_matmul(v.to(dtype), p["q"], p["s"])
    return y + p["b"].to(dtype) if bias else y


def fused_decode_step(cfg: LLMConfig, dtype, packed: Dict, token_ids,
                      cache: KVCache) -> torch.Tensor:
    """One greedy step over the pack: [B] ids -> logits [B, V] in `dtype`;
    writes row `cache.length` of every layer's cache and advances it."""
    b = token_ids.shape[0]
    d, nq, nkv = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    f, eps = cfg.intermediate_size, cfg.rms_norm_eps
    x = packed["embed"][token_ids][:, None].to(dtype)            # [B, 1, H]
    pos = cache.length[:, None].long()
    idx = cache.length.long()
    rows = torch.arange(b, device=x.device)
    delta = None        # the previous layer's MLP output, not yet added
    for i, lp in enumerate(packed["layers"]):
        if delta is None:
            xl = norm_fast(x, lp["ln1"], eps=eps, rms=True)
        else:
            x, xl = add_norm_fast(x, delta, lp["ln1"], eps=eps, rms=True)
        qkv = _dense(xl, lp["qkv"], dtype, bias=True)        # [B, 1, 1152]
        q = qkv[..., : nq * d].reshape(b, 1, nq, d).transpose(1, 2)
        k = qkv[..., nq * d: (nq + nkv) * d].reshape(b, 1, nkv, d).transpose(
            1, 2)
        v = qkv[..., (nq + nkv) * d:].reshape(b, 1, nkv, d).transpose(1, 2)
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
        kc, vc = cache.k[i], cache.v[i]
        kc[rows, :, idx] = k[:, :, 0]
        vc[rows, :, idx] = v[:, :, 0]
        o = decode_attention(q, kc, vc, cache.length + 1)
        x, xl = add_norm_fast(
            x, _dense(o.transpose(1, 2).reshape(b, 1, nq * d), lp["o"], dtype),
            lp["ln2"], eps=eps, rms=True)
        gu = _dense(xl, lp["gateup"], dtype)                      # [B, 1, 2F]
        delta = _dense(F.silu(gu[..., :f]) * gu[..., f:], lp["down"], dtype)
    x = (norm_fast(x, packed["final_ln"], eps=eps, rms=True) if delta is None
         else add_norm_fast(x, delta, packed["final_ln"], eps=eps,
                            rms=True)[1])
    uq = packed["unembed"]
    logits = quant.quantized_matmul_nk(x.to(dtype), uq["q"], uq["s"])
    cache.length = cache.length + 1
    return logits[:, -1]


def fused_decode_loop(cfg: LLMConfig, dtype, packed: Dict, last_logits,
                      cache: KVCache, *, max_new_tokens: int, eos_id: int,
                      pick=None):
    """Decode loop over fused_decode_step from the last prefill logits
    (carried in `dtype`) -> (tokens [B, N] int32, lengths [B] int32); each
    token is `pick(logits)`, greedy by default (greedy_loop)."""
    return greedy_loop(
        lambda ids: fused_decode_step(cfg, dtype, packed, ids, cache),
        last_logits.to(dtype), max_new_tokens=max_new_tokens, eos_id=eos_id,
        pick=pick)
