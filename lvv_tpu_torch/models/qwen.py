"""Qwen2.5-family causal decoder with LoRA and a KV cache (counterpart of
lvv_tpu/models/qwen.py).

RMSNorm, SwiGLU, RoPE (theta 1e6, neox half split), q/k/v biases, GQA
(14 query / 2 kv heads at 0.5B) and a tied unembedding whose table carries
4 extra rows for the multimodal special tokens (or, with
`tie_word_embeddings=False`, an untied `lm_head` Dense over the same
vocabulary). The model takes
`inputs_embeds` so the VQA stack can splice its prefix in. Prefill runs the
flash kernel (K-e, causal with kv_len) on the card; single-token decode
attends over the cache on the plain path, as in the JAX package.

Each residual add that a norm follows (the attention's add before
`post_attn_ln`, the MLP's add before the next layer's `input_ln` or
`final_ln`) runs in that norm's launch, K-a's add form: a layer hands its
MLP output on unsummed (`QwenLayer.forward_pending`).

`forward(..., params=tree)` runs the stack over a weight-only int8 tree
from `ops.quant.quantize_llm_params` (the unfused serving decode): every
projection through kernel K-j and the tied unembed through kernel K-k,
while norms, biases, LoRA and the embedding gather stay the module's.

The KV cache is updated in place (prefill writes rows [0, S), each decode
step writes row `length` of every sequence); the JAX package returns a new
cache instead.

Training runs `forward` over the whole sequence with `seq_len` and no
cache, building an autograd graph (the causal flash kernel through its
Function on the card); with `remat` each layer's activations are
recomputed in the backward (`torch.utils.checkpoint`, JAX's nn.remat).
`cross_entropy_loss` is the masked mean of the next-token loss.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import LLMConfig
from ..ops import quant
from ..ops.attention import attention, decode_attention
from .layers import Dense, RMSNorm, new_param


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x [B, H, S, D], positions [B, S] -> rotated x (neox half split)."""
    d = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                          device=x.device) / d))
    ang = positions[:, None, :, None].float() * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


@dataclass
class KVCache:
    k: List[torch.Tensor]   # per layer [B, Hkv, Smax, D]
    v: List[torch.Tensor]
    length: torch.Tensor    # [B] filled length


def init_cache(cfg: LLMConfig, batch: int, max_len: int, *, dtype,
               device) -> KVCache:
    shape = (batch, cfg.num_kv_heads, max_len, cfg.head_dim)
    return KVCache(
        k=[torch.zeros(shape, dtype=dtype, device=device)
           for _ in range(cfg.num_layers)],
        v=[torch.zeros(shape, dtype=dtype, device=device)
           for _ in range(cfg.num_layers)],
        length=torch.zeros(batch, dtype=torch.int32, device=device))


class QwenAttention(nn.Module):
    def __init__(self, cfg: LLMConfig, lora_rank: int, lora_alpha: float, *,
                 dtype, device):
        super().__init__()
        c = self.cfg = cfg
        kw = dict(lora_rank=lora_rank, lora_alpha=lora_alpha, dtype=dtype,
                  device=device)
        h = c.hidden_size
        self.q_proj = Dense(h, c.num_heads * c.head_dim, **kw)
        self.k_proj = Dense(h, c.num_kv_heads * c.head_dim, **kw)
        self.v_proj = Dense(h, c.num_kv_heads * c.head_dim, **kw)
        self.o_proj = Dense(c.num_heads * c.head_dim, h, use_bias=False,
                            **kw)

    def forward(self, x, positions, seq_len=None, cache=None,
                layer_idx: int = 0, p=None):
        c = self.cfg
        b, s, _ = x.shape
        p = p or {}

        def split(y, heads):
            return y.view(b, s, heads, c.head_dim).transpose(1, 2)

        q = apply_rope(split(self.q_proj(x, p.get("q_proj")), c.num_heads),
                       positions, c.rope_theta)
        k = apply_rope(split(self.k_proj(x, p.get("k_proj")), c.num_kv_heads),
                       positions, c.rope_theta)
        v = split(self.v_proj(x, p.get("v_proj")), c.num_kv_heads)
        if cache is None or s > 1:
            if cache is not None:
                # prefill: write the (right-padded) block at offset 0; padded
                # rows sit past cache.length and decode overwrites them
                cache.k[layer_idx][:, :, :s] = k
                cache.v[layer_idx][:, :, :s] = v
            o = attention(q, k, v, causal=True, kv_len=seq_len)
        else:
            idx = cache.length.long()
            rows = torch.arange(b, device=x.device)
            kc, vc = cache.k[layer_idx], cache.v[layer_idx]
            kc[rows, :, idx] = k[:, :, 0]
            vc[rows, :, idx] = v[:, :, 0]
            o = decode_attention(q, kc, vc, cache.length + 1)
        return self.o_proj(o.transpose(1, 2).reshape(b, s, -1),
                           p.get("o_proj"))


class QwenMLP(nn.Module):
    def __init__(self, cfg: LLMConfig, *, dtype, device):
        super().__init__()
        kw = dict(use_bias=False, dtype=dtype, device=device)
        self.gate_proj = Dense(cfg.hidden_size, cfg.intermediate_size, **kw)
        self.up_proj = Dense(cfg.hidden_size, cfg.intermediate_size, **kw)
        self.down_proj = Dense(cfg.intermediate_size, cfg.hidden_size, **kw)

    def forward(self, x, p=None):
        p = p or {}
        return self.down_proj(F.silu(self.gate_proj(x, p.get("gate_proj")))
                              * self.up_proj(x, p.get("up_proj")),
                              p.get("down_proj"))


class QwenLayer(nn.Module):
    def __init__(self, cfg: LLMConfig, lora_rank: int, lora_alpha: float, *,
                 dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.input_ln = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, **kw)
        self.attn = QwenAttention(cfg, lora_rank, lora_alpha, **kw)
        self.post_attn_ln = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, **kw)
        self.mlp = QwenMLP(cfg, **kw)

    def forward_pending(self, x, delta, positions, seq_len=None, cache=None,
                        layer_idx: int = 0, p=None):
        """The layer on x + delta (delta: the previous layer's MLP output,
        or None), its own MLP output left unsummed: returns (h, mlp) with
        the layer's output h + mlp. Each add runs in the launch of the norm
        that follows it."""
        p = p or {}
        if delta is None:
            xl = self.input_ln(x)
        else:
            x, xl = self.input_ln.add(x, delta)
        x, xl = self.post_attn_ln.add(x, self.attn(
            xl, positions, seq_len, cache, layer_idx, p.get("attn")))
        return x, self.mlp(xl, p.get("mlp"))

    def forward(self, x, positions, seq_len=None, cache=None,
                layer_idx: int = 0, p=None):
        h, mlp = self.forward_pending(x, None, positions, seq_len, cache,
                                      layer_idx, p)
        return h + mlp


class QwenModel(nn.Module):
    """Decoder stack over inputs_embeds -> logits."""

    def __init__(self, cfg: LLMConfig, lora_rank: int = 0,
                 lora_alpha: float = 1.0, extra_tokens: int = 0,
                 remat: bool = False, *, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.cfg = cfg
        self.remat = remat
        self.embed_tokens = nn.Module()
        self.embed_tokens.embedding = new_param(
            (cfg.vocab_size + extra_tokens, cfg.hidden_size),
            ("normal", 0.02), **kw)
        for i in range(cfg.num_layers):
            setattr(self, f"layer_{i}", QwenLayer(cfg, lora_rank, lora_alpha,
                                                  **kw))
        self.final_ln = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, **kw)
        if not cfg.tie_word_embeddings:
            self.lm_head = Dense(cfg.hidden_size,
                                 cfg.vocab_size + extra_tokens,
                                 use_bias=False, **kw)

    def embed(self, input_ids):
        return self.embed_tokens.embedding[input_ids]

    def unembed(self, hidden, table_q=None):
        """Tied unembedding; with `table_q` ({"q": int8 [V, H], "s": f32
        [V]}) through kernel K-k, the table read as stored. An untied model
        runs its float lm_head and ignores `table_q`, as JAX does."""
        if not self.cfg.tie_word_embeddings:
            return self.lm_head(hidden)
        if table_q is not None:
            return quant.quantized_matmul_nk(hidden, table_q["q"],
                                             table_q["s"])
        return hidden @ self.embed_tokens.embedding.t()

    def forward(self, inputs_embeds, positions=None, seq_len=None,
                cache: Optional[KVCache] = None, last_pos=None,
                params: Optional[dict] = None):
        """-> logits [B, S, V] (or [B, 1, V] at `last_pos`); with a cache
        also updates it (prefill when S > 1, one decode step when S == 1).
        `params`: an int8 tree from `quantize_llm_params` to run over."""
        params = params or {}
        b, s, _ = inputs_embeds.shape
        if positions is None:
            positions = torch.arange(s, device=inputs_embeds.device)[
                None].expand(b, s)
        x = inputs_embeds.to(self.embed_tokens.embedding.dtype)
        delta = None
        remat = self.remat and cache is None and torch.is_grad_enabled()
        for i in range(self.cfg.num_layers):
            layer = getattr(self, f"layer_{i}").forward_pending
            if remat:
                x, delta = checkpoint(layer, x, delta, positions, seq_len,
                                      None, i, None, use_reentrant=False)
            else:
                x, delta = layer(x, delta, positions, seq_len, cache, i,
                                 params.get(f"layer_{i}"))
        x = self.final_ln(x) if delta is None else self.final_ln.add(
            x, delta)[1]
        if last_pos is not None:
            # only the last real position feeds the first decode step: gather
            # before the unembedding so [B, S, V] logits never exist
            idx = last_pos.long()[:, None, None].expand(b, 1, x.shape[-1])
            x = torch.gather(x, 1, idx)
        logits = self.unembed(x, params.get("unembed_q"))
        if cache is not None:
            if s > 1:
                if seq_len is None:
                    raise ValueError("prefill needs seq_len")
                cache.length = seq_len.to(torch.int32)
            else:
                cache.length = cache.length + 1
        return logits


def cross_entropy_loss(logits, labels, ignore_index: int = -100):
    """Masked next-token cross entropy (JAX qwen.py:261-271): log_softmax in
    fp32, the mean over positions whose label is not `ignore_index`.
    Returns (loss, count) with count = max(number of such positions, 1)."""
    mask = labels != ignore_index
    safe = torch.where(mask, labels, torch.zeros_like(labels)).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    count = mask.sum().clamp_min(1)
    return (nll * mask).sum() / count, count


def greedy_loop(step, last_logits, *, max_new_tokens: int, eos_id: int,
                pick=None):
    """The decode loop: `step(ids [B]) -> logits [B, V]` advances the cache
    by one token. Runs all `max_new_tokens` steps, as the JAX package's scan
    does: a sequence that has emitted eos keeps emitting eos. Returns
    (tokens [B, N] int32, lengths [B] int32), the length counting the tokens
    before the first eos. Each token is `pick(logits)` ([B] int32), by
    default the greedy argmax, which takes the first index on a tie, as
    jnp.argmax does."""
    logits = last_logits
    done = torch.zeros(logits.shape[0], dtype=torch.bool,
                       device=logits.device)
    tokens = []
    for _ in range(max_new_tokens):
        nxt = (pick(logits) if pick else
               torch.argmax(logits, dim=-1).to(torch.int32))
        nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
        logits = step(nxt.long())
        done = done | (nxt == eos_id)
        tokens.append(nxt)
    tokens = torch.stack(tokens, dim=1)
    lengths = torch.cumprod((tokens != eos_id).to(torch.int32), dim=1).sum(1)
    return tokens, lengths.to(torch.int32)
