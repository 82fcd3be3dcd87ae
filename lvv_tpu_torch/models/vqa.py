"""End-to-end VQA model: LiDAR BEV + 6 cameras + question -> answer
(counterpart of lvv_tpu/models/vqa.py).

    prefix   = [<vision_start>, V·s, <vision_end>, <lidar_start>, L·s,
                <lidar_end>]                      (s = prefix_scale, 0.2)
    sequence = prefix ++ prompt

`greedy_generate` encodes the prefix, prefills the LLM with the prefix and
the prompt, then decodes greedily through the KV cache. The decode loop is a
Python loop that runs all `max_new_tokens` steps, as the JAX package's scan
does, with the same done / eos / lengths rule.

Serving: `prepare_serving_params` (weight-only int8 Qwen tree) and
`prepare_serving_params_fused` (the packed int8 decode) make a
`params_decode` for greedy_generate. Prefill always reads the float weights;
the decode then reads its weight matrices only from the int8 tree or the
pack, through kernels K-j and K-k on the card.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config import ModelConfig
from .deepencoder import build_deepencoder
from .layers import init_parameters, resolve_device
from .qwen import KVCache, QwenModel, greedy_loop, init_cache
from .vat import VATLiDAR, VATVision, VisionAdapter

# special-token order matches config.LLMConfig.special_tokens
VISION_START, VISION_END, LIDAR_START, LIDAR_END = range(4)


def sam_grid_side(cfg: ModelConfig) -> int:
    """Token-grid side after SAM's patcher and the two stride-2 VARY convs
    (16 at the default config)."""
    return cfg.sam.img_size // cfg.sam.patch_size // 4


def _prefix_len(cfg: ModelConfig) -> int:
    n_tokens = cfg.adapter.num_views * sam_grid_side(cfg) ** 2
    n_v = n_tokens // cfg.vat_vision.compression_factor
    return n_v + cfg.vat_lidar.n_queries + 4


class VQAModel(nn.Module):
    """The full stack. Parameters are drawn from `seed` with flax's
    initialisers (or loaded with `load_state_dict` from
    `convert.from_jax_params`). Runs on the card unless `device` says
    otherwise; without a card and without a device it raises."""

    def __init__(self, cfg: ModelConfig, dtype=torch.bfloat16, device=None,
                 llm_lora_rank: int = 0, llm_lora_alpha: float = 1.0,
                 clip_lora_rank: int = 0, clip_lora_alpha: float = 1.0,
                 seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        kw = dict(dtype=dtype, device=device)
        self.cfg = cfg
        self.dtype = dtype
        self.deepencoder = build_deepencoder(
            cfg, clip_lora_rank=clip_lora_rank,
            clip_lora_alpha=clip_lora_alpha, **kw)
        self.adapter = VisionAdapter(cfg.adapter.d_model,
                                     cfg.adapter.num_views, **kw)
        vv = cfg.vat_vision
        self.vat_vision = VATVision(
            vv.d_in, vv.d_model,
            cfg.adapter.num_views * sam_grid_side(cfg) ** 2,
            vv.compression_factor, vv.n_blocks, vv.n_heads, vv.mlp_ratio,
            vv.per_view_queries, **kw)
        vl = cfg.vat_lidar
        self.vat_lidar = VATLiDAR(cfg.bev_channels, vl.d_model, vl.n_queries,
                                  vl.n_blocks, vl.n_heads, vl.mlp_ratio,
                                  vl.pe_hidden, vl.dw_kernel, **kw)
        self.llm = QwenModel(cfg.llm, llm_lora_rank, llm_lora_alpha,
                             extra_tokens=len(cfg.llm.special_tokens), **kw)
        init_parameters(self, seed)

    @property
    def device(self) -> torch.device:
        return self.llm.embed_tokens.embedding.device

    def special_embed(self, which: int) -> torch.Tensor:
        """Embedding row [D] of a multimodal special token."""
        return self.llm.embed_tokens.embedding[self.cfg.llm.vocab_size + which]

    def encode_prefix(self, bev, images, view_valid, use_vision=True,
                      use_lidar=True) -> torch.Tensor:
        """-> prefix embeddings [B, P, D]. The modality toggles zero their
        part of the prefix and keep its shape."""
        c = self.cfg
        b = bev.shape[0]
        kw = dict(dtype=self.dtype, device=self.device)
        scale = torch.tensor(c.prefix_scale, **kw)   # rounded, as in JAX
        view_tokens = self.deepencoder.encode_views(images, view_valid)
        kv = self.adapter(view_tokens)
        v_prefix = self.vat_vision(kv) * scale
        l_prefix = self.vat_lidar(bev) * scale
        v_prefix = v_prefix * torch.as_tensor(use_vision, **kw)
        l_prefix = l_prefix * torch.as_tensor(use_lidar, **kw)

        def tok(which):
            return self.special_embed(which)[None, None].expand(
                b, 1, c.llm.hidden_size)

        return torch.cat([tok(VISION_START), v_prefix, tok(VISION_END),
                          tok(LIDAR_START), l_prefix, tok(LIDAR_END)], dim=1)

    def prefill(self, bev, images, view_valid, prompt_ids, prompt_len,
                cache: KVCache, use_vision=True, use_lidar=True):
        """Encode the prefix, then prefill -> last logits [B, V]."""
        prefix = self.encode_prefix(bev, images, view_valid, use_vision,
                                    use_lidar)
        return self.prefill_from_prefix(prefix, prompt_ids, prompt_len, cache)

    def prefill_from_prefix(self, prefix, prompt_ids, prompt_len,
                            cache: KVCache):
        """Prefill from an encoded prefix [B, P, D] -> last logits [B, V]
        (at each sequence's last real position); fills `cache`."""
        embeds = torch.cat([prefix.to(self.dtype), self.llm.embed(prompt_ids)],
                           dim=1)
        seq_len = prefix.shape[1] + prompt_len
        logits = self.llm(embeds, seq_len=seq_len, cache=cache,
                          last_pos=seq_len - 1)
        return logits[:, 0]

    def decode_step(self, token_ids, cache: KVCache, params=None):
        """One step: [B] ids -> logits [B, V]; advances `cache`. `params`:
        an int8 Qwen tree (`prepare_serving_params(...)["llm"]`)."""
        emb = self.llm.embed(token_ids[:, None])
        logits = self.llm(emb, positions=cache.length[:, None].long(),
                          cache=cache, params=params)
        return logits[:, -1]


def prepare_serving_params(model: VQAModel):
    """Serving transform for the decode: {"llm": the weight-only int8 tree
    of the Qwen projections and the tied unembed} (ops.quant.
    quantize_llm_params). Prefill keeps reading the model's float weights."""
    from ..ops.quant import quantize_llm_params
    return {"llm": quantize_llm_params(model.llm)}


def prepare_serving_params_fused(model: VQAModel):
    """The packed decode (models/decode_fused.py): {"_fused_decode": pack},
    4 int8 products a layer instead of 7, LoRA folded in before
    quantization. The decode reads nothing else."""
    from .decode_fused import pack_decode_params
    return {"_fused_decode": pack_decode_params(model.llm)}


def _decode_loop(model: VQAModel, params_decode, last_logits,
                 cache: KVCache, *, max_new_tokens: int, eos_id: int):
    """Greedy decode from the last prefill logits and the filled cache ->
    (tokens [B, N], lengths [B]): over the pack when `params_decode` carries
    "_fused_decode", else over its int8 tree ("llm") or the float model."""
    if params_decode and "_fused_decode" in params_decode:
        from .decode_fused import fused_decode_loop
        return fused_decode_loop(
            model.cfg.llm, model.dtype, params_decode["_fused_decode"],
            last_logits, cache, max_new_tokens=max_new_tokens, eos_id=eos_id)
    tree = (params_decode or {}).get("llm")
    return greedy_loop(lambda ids: model.decode_step(ids, cache, tree),
                       last_logits, max_new_tokens=max_new_tokens,
                       eos_id=eos_id)


@torch.inference_mode()
def greedy_generate(model: VQAModel, bev, images, view_valid, prompt_ids,
                    prompt_len, *, max_new_tokens: int, eos_id: int,
                    max_cache: Optional[int] = None, params_decode=None):
    """Greedy answer generation on the model's device.
    Returns (tokens [B, N] int32, lengths [B] int32): a sequence stops at its
    first eos (later tokens are eos), and its length counts the tokens
    before it. `params_decode` (from prepare_serving_params or
    prepare_serving_params_fused) swaps what the decode loop reads."""
    dev = model.device
    bev, images, view_valid, prompt_ids, prompt_len = (
        torch.as_tensor(t, device=dev)
        for t in (bev, images, view_valid, prompt_ids, prompt_len))
    b = prompt_ids.shape[0]
    max_cache = max_cache or (_prefix_len(model.cfg) + prompt_ids.shape[1]
                              + max_new_tokens + 8)
    cache = init_cache(model.cfg.llm, b, max_cache, dtype=model.dtype,
                       device=dev)
    logits = model.prefill(bev, images, view_valid, prompt_ids.long(),
                           prompt_len.to(torch.int32), cache)
    return _decode_loop(model, params_decode, logits, cache,
                        max_new_tokens=max_new_tokens, eos_id=eos_id)
