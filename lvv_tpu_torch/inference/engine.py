"""InferenceEngine: question + LiDAR BEV + cameras -> answer text
(counterpart of lvv_tpu/inference/engine.py).

One canonical assembly (the training layout, `data.collate.Collator`) for
training and inference; a batch is one `greedy_generate` call.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..data.collate import Collator
from ..models.vqa import VQAModel, greedy_generate, prepare_serving_params


class InferenceEngine:
    def __init__(self, model: VQAModel, tokenizer, max_prompt: int = 128,
                 max_new_tokens: int = 96, quantize_llm: bool = False):
        """`quantize_llm`: the decode reads the weight-only int8 tree
        (`prepare_serving_params`); prefill keeps the float weights."""
        self.model = model
        self.params_decode = (prepare_serving_params(model) if quantize_llm
                              else None)
        self.tokenizer = tokenizer
        self.max_prompt = max_prompt
        self.max_new_tokens = max_new_tokens
        cfg = model.cfg
        self.collator = Collator(
            tokenizer, max_prompt, 0, cfg.sam.img_size,
            (cfg.bev_channels,) + tuple(cfg.bev_hw), device=model.device)

    def generate_batch(self, questions: Sequence[str],
                       bevs: Sequence[np.ndarray],
                       cam_paths: Optional[Sequence[Sequence[str]]] = None,
                       use_vision: bool = True,
                       use_lidar: bool = True) -> List[str]:
        """Answers to `questions`, one BEV [C, H, W] each (and camera paths,
        else no valid view); `use_vision` / `use_lidar` False zero that part
        of the prefix."""
        samples = [{"question": q, "answer": None, "bev": bev,
                    "cam_paths": cam_paths[i] if cam_paths else [None] * 6}
                   for i, (q, bev) in enumerate(zip(questions, bevs))]
        batch = self.collator(samples, use_vision, use_lidar)
        toks, lens = greedy_generate(
            self.model, batch.bev, batch.images, batch.view_valid,
            batch.text_ids, batch.text_len,
            max_new_tokens=self.max_new_tokens, eos_id=self.tokenizer.eos_id,
            params_decode=self.params_decode, use_vision=use_vision,
            use_lidar=use_lidar)
        toks, lens = toks.cpu().tolist(), lens.cpu().tolist()
        return [self.tokenizer.decode(t[:n]) for t, n in zip(toks, lens)]

    def generate(self, question: str, bev: np.ndarray,
                 cam_paths: Optional[Sequence[str]] = None, **kw) -> str:
        return self.generate_batch([question], [bev],
                                   [cam_paths] if cam_paths else None,
                                   **kw)[0]
