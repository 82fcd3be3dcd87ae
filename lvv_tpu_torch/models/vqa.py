"""End-to-end VQA model: LiDAR BEV + 6 cameras + question -> answer
(counterpart of lvv_tpu/models/vqa.py).

    prefix   = [<vision_start>, V·s, <vision_end>, <lidar_start>, L·s,
                <lidar_end>]                      (s = prefix_scale, 0.2)
    sequence = prefix ++ prompt

`greedy_generate` encodes the prefix, prefills the LLM with the prefix and
the prompt, then decodes greedily through the KV cache. The decode loop is a
Python loop that runs all `max_new_tokens` steps, as the JAX package's scan
does, with the same done / eos / lengths rule. The rest of the JAX
package's generate family sits beside it: `greedy_generate_multi` (G
batches, uint8 frames preprocessed per group), `encode_prefix_fn`,
`generate_from_prefix`, `pipelined_serving_step` and `sample_generate`
(temperature / top-k / top-p over Gumbel noise from a torch.Generator).

Training: `VQAModel.forward(batch, deterministic)` is JAX's
`VQAModel.__call__`: prefix ++ text through the LLM, the next-token loss
over the answer -> (loss, logits [B, P+T, V], count). The generation entry
points run under `torch.inference_mode()`.

Serving: `prepare_serving_params` (weight-only int8 Qwen tree) and
`prepare_serving_params_fused` (the packed int8 decode) make a
`params_decode` for greedy_generate. Prefill always reads the float weights;
the decode then reads its weight matrices only from the int8 tree or the
pack, through kernels K-j and K-k on the card.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from ..config import ModelConfig
from .deepencoder import build_deepencoder
from .layers import init_parameters, resolve_device
from .qwen import (KVCache, QwenModel, cross_entropy_loss, greedy_loop,
                   init_cache)
from .vat import VATLiDAR, VATVision, VisionAdapter

# special-token order matches config.LLMConfig.special_tokens
VISION_START, VISION_END, LIDAR_START, LIDAR_END = range(4)


class VQABatch(NamedTuple):
    """One batch of tensors (made by `data.collate.Collator`)."""
    bev: torch.Tensor          # [B, C, H, W] float
    images: torch.Tensor       # [B, 6, 3, S, S] float in [-1, 1]
    view_valid: torch.Tensor   # [B, 6] bool
    text_ids: torch.Tensor     # [B, T] int32, prompt ++ answer, right-padded
    text_len: torch.Tensor     # [B] int32
    labels: torch.Tensor       # [B, T] int32, -100 outside the answer
    use_vision: torch.Tensor   # [] bool modality toggles
    use_lidar: torch.Tensor

    def to(self, device, non_blocking: bool = False) -> "VQABatch":
        """Every field on `device`."""
        return VQABatch(*(torch.as_tensor(t).to(device,
                                                non_blocking=non_blocking)
                          for t in self))


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
        # dropout as JAX's VQAModel passes it: the adapter's alone (the
        # VATs' configured rates are not handed on there either)
        self.adapter = VisionAdapter(cfg.adapter.d_model,
                                     cfg.adapter.num_views,
                                     cfg.adapter.dropout, **kw)
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
                             extra_tokens=len(cfg.llm.special_tokens),
                             remat=cfg.remat, **kw)
        init_parameters(self, seed)

    @property
    def device(self) -> torch.device:
        return self.llm.embed_tokens.embedding.device

    def special_embed(self, which: int) -> torch.Tensor:
        """Embedding row [D] of a multimodal special token."""
        return self.llm.embed_tokens.embedding[self.cfg.llm.vocab_size + which]

    def encode_prefix(self, bev, images, view_valid, use_vision=True,
                      use_lidar=True, deterministic: bool = True,
                      generator=None) -> torch.Tensor:
        """-> prefix embeddings [B, P, D]. The modality toggles zero their
        part of the prefix and keep its shape; `deterministic` False turns
        on dropout, drawn from `generator`."""
        c = self.cfg
        b = bev.shape[0]
        kw = dict(dtype=self.dtype, device=self.device)
        scale = torch.tensor(c.prefix_scale, **kw)   # rounded, as in JAX
        view_tokens = self.deepencoder.encode_views(images, view_valid)
        kv = self.adapter(view_tokens, deterministic, generator)
        v_prefix = self.vat_vision(kv, deterministic, generator) * scale
        l_prefix = self.vat_lidar(bev, deterministic, generator) * scale
        v_prefix = v_prefix * torch.as_tensor(use_vision, **kw)
        l_prefix = l_prefix * torch.as_tensor(use_lidar, **kw)

        def tok(which):
            return self.special_embed(which)[None, None].expand(
                b, 1, c.llm.hidden_size)

        return torch.cat([tok(VISION_START), v_prefix, tok(VISION_END),
                          tok(LIDAR_START), l_prefix, tok(LIDAR_END)], dim=1)

    def forward(self, batch: VQABatch, deterministic: bool = True,
                generator=None):
        """Training / validation forward (JAX `VQAModel.__call__`) on a
        batch on the model's device -> (loss, logits [B, P+T, V], count):
        the next-token loss over the answer tokens (labels -100 elsewhere,
        the prefix included)."""
        prefix = self.encode_prefix(batch.bev, batch.images,
                                    batch.view_valid, batch.use_vision,
                                    batch.use_lidar, deterministic, generator)
        embeds = torch.cat([prefix, self.llm.embed(batch.text_ids.long())],
                           dim=1)
        b, p = prefix.shape[:2]
        logits = self.llm(embeds, seq_len=p + batch.text_len)
        labels = torch.cat([torch.full((b, p), -100, dtype=torch.long,
                                       device=self.device),
                            batch.labels.long()], dim=1)
        loss, count = cross_entropy_loss(logits[:, :-1], labels[:, 1:])
        return loss, logits, count

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
                 cache: KVCache, *, max_new_tokens: int, eos_id: int,
                 pick=None):
    """Decode from the last prefill logits and the filled cache -> (tokens
    [B, N], lengths [B]): over the pack when `params_decode` carries
    "_fused_decode", else over its int8 tree ("llm") or the float model.
    Each token is `pick(logits)`, greedy by default (greedy_loop)."""
    if params_decode and "_fused_decode" in params_decode:
        from .decode_fused import fused_decode_loop
        return fused_decode_loop(
            model.cfg.llm, model.dtype, params_decode["_fused_decode"],
            last_logits, cache, max_new_tokens=max_new_tokens, eos_id=eos_id,
            pick=pick)
    tree = (params_decode or {}).get("llm")
    return greedy_loop(lambda ids: model.decode_step(ids, cache, tree),
                       last_logits, max_new_tokens=max_new_tokens,
                       eos_id=eos_id, pick=pick)


def _on(model: VQAModel, *ts):
    return (torch.as_tensor(t, device=model.device) for t in ts)


def _cache_len(prefix_len: int, prompt_ids, max_new_tokens: int,
               max_cache: Optional[int]) -> int:
    """KV-cache length: the prefix, the prompt, the answer and 8 spare."""
    return max_cache or (prefix_len + prompt_ids.shape[-1] + max_new_tokens
                         + 8)


def _generate(model: VQAModel, bev, images, view_valid, prompt_ids,
              prompt_len, *, cache_len: int, max_new_tokens: int,
              eos_id: int, params_decode, pick=None, use_vision=True,
              use_lidar=True):
    """Encode, prefill and decode one batch of device tensors."""
    cache = init_cache(model.cfg.llm, prompt_ids.shape[0], cache_len,
                       dtype=model.dtype, device=model.device)
    logits = model.prefill(bev, images, view_valid, prompt_ids.long(),
                           prompt_len.to(torch.int32), cache, use_vision,
                           use_lidar)
    return _decode_loop(model, params_decode, logits, cache,
                        max_new_tokens=max_new_tokens, eos_id=eos_id,
                        pick=pick)


@torch.inference_mode()
def greedy_generate(model: VQAModel, bev, images, view_valid, prompt_ids,
                    prompt_len, *, max_new_tokens: int, eos_id: int,
                    max_cache: Optional[int] = None, params_decode=None,
                    use_vision=True, use_lidar=True):
    """Greedy answer generation on the model's device.
    Returns (tokens [B, N] int32, lengths [B] int32): a sequence stops at its
    first eos (later tokens are eos), and its length counts the tokens
    before it. `params_decode` (from prepare_serving_params or
    prepare_serving_params_fused) swaps what the decode loop reads.
    `use_vision` / `use_lidar` False zero that part of the prefix
    (`encode_prefix`'s toggles)."""
    args = tuple(_on(model, bev, images, view_valid, prompt_ids, prompt_len))
    return _generate(model, *args, cache_len=_cache_len(
        _prefix_len(model.cfg), args[3], max_new_tokens, max_cache),
        max_new_tokens=max_new_tokens, eos_id=eos_id,
        params_decode=params_decode, use_vision=use_vision,
        use_lidar=use_lidar)


@torch.inference_mode()
def greedy_generate_multi(model: VQAModel, bev, images, view_valid,
                          prompt_ids, prompt_len, *, max_new_tokens: int,
                          eos_id: int, max_cache: Optional[int] = None,
                          params_decode=None):
    """Greedy answers for G batches: every input carries a leading group
    axis (bev [G, B, C, H, W], images [G, B, 6, 3, S, S] float or raw
    uint8 frames [G, B, 6, H, W, 3], view_valid [G, B, 6], prompt_ids
    [G, B, T], prompt_len [G, B]). Returns (tokens [G, B, N], lengths
    [G, B]), each group's equal to a greedy_generate of that group.

    The groups run one after the other in a Python loop, each with a fresh
    cache; uint8 frames are preprocessed (`ops.image.preprocess_views`) one
    group at a time, so the float images of one group only exist at once,
    and bev is cast to float32 per group, as the JAX package does. JAX scans
    the groups inside one resident device program; here each group is
    issued from the host like a separate greedy_generate."""
    from ..ops.image import preprocess_views
    bev, images, view_valid, prompt_ids, prompt_len = _on(
        model, bev, images, view_valid, prompt_ids, prompt_len)
    cache_len = _cache_len(_prefix_len(model.cfg), prompt_ids,
                           max_new_tokens, max_cache)
    size = model.cfg.sam.img_size
    tokens, lengths = [], []
    for g in range(prompt_ids.shape[0]):
        img = images[g]
        if img.dtype == torch.uint8:
            img = preprocess_views(img.flatten(0, 1), size).unflatten(
                0, img.shape[:2])
        toks, lens = _generate(model, bev[g].float(), img, view_valid[g],
                               prompt_ids[g], prompt_len[g],
                               cache_len=cache_len,
                               max_new_tokens=max_new_tokens, eos_id=eos_id,
                               params_decode=params_decode)
        tokens.append(toks)
        lengths.append(lens)
    return torch.stack(tokens), torch.stack(lengths)


def encode_prefix_fn(model: VQAModel):
    """The prefix encoder as a function of the sensors alone:
    (bev, images, view_valid) -> prefix embeddings [B, P, D] on the model's
    device, for a serving layer that encodes a frame once and asks it
    several questions (generate_from_prefix)."""
    @torch.inference_mode()
    def encode(bev, images, view_valid):
        return model.encode_prefix(*_on(model, bev, images, view_valid))
    return encode


@torch.inference_mode()
def generate_from_prefix(model: VQAModel, prefix, prompt_ids, prompt_len, *,
                         max_new_tokens: int, eos_id: int,
                         max_cache: Optional[int] = None,
                         params_decode=None):
    """Greedy answers from an encoded prefix [B, P, D]: prefill the prompt
    after it, then decode; the cache is sized from P. Token-identical to
    greedy_generate when the prefix is encode_prefix's."""
    prefix, prompt_ids, prompt_len = _on(model, prefix, prompt_ids,
                                         prompt_len)
    cache = init_cache(model.cfg.llm, prompt_ids.shape[0], _cache_len(
        prefix.shape[1], prompt_ids, max_new_tokens, max_cache),
        dtype=model.dtype, device=model.device)
    logits = model.prefill_from_prefix(prefix, prompt_ids.long(),
                                       prompt_len.to(torch.int32), cache)
    return _decode_loop(model, params_decode, logits, cache,
                        max_new_tokens=max_new_tokens, eos_id=eos_id)


@torch.inference_mode()
def pipelined_serving_step(model: VQAModel, prefix_prev, prompt_ids,
                           prompt_len, bev_next, images_next,
                           view_valid_next, *, max_new_tokens: int,
                           eos_id: int, max_cache: Optional[int] = None,
                           params_decode=None):
    """One stage of a serving pipeline: answer the batch whose prefix is
    already encoded, then encode the next batch's sensors. Returns (tokens,
    lengths, prefix_next). Steady state:

        prefix = encode_prefix_fn(model)(bev0, img0, vv0)
        for batch in stream:
            toks, lens, prefix = pipelined_serving_step(
                model, prefix, prompts, plens, batch.bev, batch.images,
                batch.view_valid, ...)

    The two halves run one after the other on one stream (JAX puts them in
    one program for XLA to interleave)."""
    tokens, lengths = generate_from_prefix(
        model, prefix_prev, prompt_ids, prompt_len,
        max_new_tokens=max_new_tokens, eos_id=eos_id, max_cache=max_cache,
        params_decode=params_decode)
    prefix_next = encode_prefix_fn(model)(bev_next, images_next,
                                          view_valid_next)
    return tokens, lengths, prefix_next


# ---------------------------------------------------------------- sampling

def _filter_logits(logits, temperature: float, top_k: int,
                   top_p: float) -> torch.Tensor:
    """JAX's `_sample_token` up to its draw: fp32 logits / max(temperature,
    1e-5); with top_k > 0, logits under the k-th largest set to -1e30; with
    top_p < 1, logits under the cutoff set to -1e30, where the cutoff is
    the logit (in descending order) at the count of cumulative
    probabilities under top_p."""
    logits = logits.float() / max(temperature, 1e-5)
    if top_k > 0:
        kth = torch.sort(logits, dim=-1).values[:, -top_k][:, None]
        logits = torch.where(logits < kth, -1e30, logits)
    if top_p < 1.0:
        desc = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(desc, dim=-1), dim=-1)
        idx = (cum < top_p).sum(-1, dtype=torch.int64)
        # JAX reads past the end as NaN, which keeps every logit; so does
        # the last (smallest) one
        cutoff = desc.gather(-1, idx.clamp(max=desc.shape[-1] - 1)[:, None])
        logits = torch.where(logits < cutoff, -1e30, logits)
    return logits


def _gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel noise -log(-log(u)), u uniform in [tiny, 1), as
    jax.random.gumbel draws it (from the generator's own stream)."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))


def _sample_token(logits, temperature: float, top_k: int, top_p: float, *,
                  gumbel: torch.Tensor) -> torch.Tensor:
    """Temperature, top-k and nucleus sampling over [B, V] logits given the
    Gumbel noise [B, V]: argmax(noise + filtered logits), the pick of
    jax.random.categorical. -> [B] int32."""
    return torch.argmax(gumbel + _filter_logits(logits, temperature, top_k,
                                                top_p), dim=-1).to(torch.int32)


@torch.inference_mode()
def sample_generate(model: VQAModel, generator: torch.Generator, bev, images,
                    view_valid, prompt_ids, prompt_len, *,
                    max_new_tokens: int, eos_id: int,
                    temperature: float = 0.7, top_k: int = 50,
                    top_p: float = 0.9, max_cache: Optional[int] = None,
                    params_decode=None):
    """Sampled answers on the model's device: each step draws Gumbel noise
    from `generator` (a torch.Generator on the model's device) and picks
    `_sample_token`; the rest (the eos / lengths rule, `params_decode`) is
    greedy_generate's. torch cannot draw jax.random's numbers, so the
    tokens equal JAX's only given the same noise."""
    args = tuple(_on(model, bev, images, view_valid, prompt_ids, prompt_len))

    def pick(lg):
        return _sample_token(lg, temperature, top_k, top_p, gumbel=_gumbel(
            lg.shape, generator, model.device))
    return _generate(model, *args, cache_len=_cache_len(
        _prefix_len(model.cfg), args[3], max_new_tokens, max_cache),
        max_new_tokens=max_new_tokens, eos_id=eos_id,
        params_decode=params_decode, pick=pick)
