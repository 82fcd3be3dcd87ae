"""Collation: QA rows -> fixed-shape batches (counterpart of
lvv_tpu/data/collate.py).

The prompt is chat-templated per question; prompt and answer tokens are
packed contiguously per sample (prompt ++ answer ++ eos) into one
right-padded text block, with labels -100 outside the answer. Camera jpgs
decode on the host (PIL, imported at call time) to uint8, then resize, pad
and normalise on the collator's device (`ops.image.preprocess_views`).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..models.vqa import VQABatch
from .tokenizer import format_prompt


def pack_text(tokenizer, question: str, answer: Optional[str],
              max_prompt: int, max_answer: int):
    """-> (ids [T], labels [T], length, prompt length) with T = max_prompt
    + max_answer + 1. The prompt is cut from the left (the question's tail
    stays), the answer from the right, then eos."""
    prompt_text = getattr(tokenizer, "apply_chat_template",
                          format_prompt)(question)
    p_ids = tokenizer.encode(prompt_text)[-max_prompt:]
    a_ids = []
    if answer is not None:
        a_ids = tokenizer.encode(answer)[:max_answer] + [tokenizer.eos_id]
    t = max_prompt + max_answer + 1
    ids = np.full((t,), tokenizer.pad_id, np.int32)
    labels = np.full((t,), -100, np.int32)
    n_p, n_a = len(p_ids), len(a_ids)
    ids[:n_p] = p_ids
    ids[n_p:n_p + n_a] = a_ids
    labels[n_p:n_p + n_a] = a_ids
    return ids, labels, n_p + n_a, n_p


def load_views_u8(cam_paths: Sequence[Optional[str]], size_hw=None):
    """Decode up to 6 jpgs -> (uint8 [6, H, W, 3], valid [6]). A missing or
    unreadable path gives zeros and an invalid view."""
    from PIL import Image
    imgs, valid = [], []
    shape = None
    for p in cam_paths:
        if p is None:
            imgs.append(None)
            valid.append(False)
            continue
        try:
            im = Image.open(p).convert("RGB")
            if size_hw is not None:
                im = im.resize((size_hw[1], size_hw[0]))
            arr = np.asarray(im, np.uint8)
            shape = arr.shape
            imgs.append(arr)
            valid.append(True)
        except Exception:   # unreadable image: an invalid view
            imgs.append(None)
            valid.append(False)
    if shape is None:
        shape = tuple(size_hw or (900, 1600)) + (3,)
    out = np.zeros((len(cam_paths),) + tuple(shape), np.uint8)
    for i, a in enumerate(imgs):
        if a is not None:
            out[i] = a
    return out, np.asarray(valid, bool)


class Collator:
    """Samples {question, answer | None, bev [C, H, W], cam_paths} ->
    VQABatch of tensors on `device` (default: the CPU)."""

    def __init__(self, tokenizer, max_prompt: int, max_answer: int,
                 image_size: int, bev_shape, load_images: bool = True,
                 device=None):
        self.tokenizer = tokenizer
        self.max_prompt = max_prompt
        self.max_answer = max_answer
        self.image_size = image_size
        self.bev_shape = tuple(bev_shape)   # (C, H, W)
        self.load_images = load_images
        self.device = torch.device(device or "cpu")

    def __call__(self, samples: List[dict],
                 use_vision: bool = True, use_lidar: bool = True) -> VQABatch:
        from ..ops.image import preprocess_views

        b = len(samples)
        t = self.max_prompt + self.max_answer + 1
        ids = np.zeros((b, t), np.int32)
        labels = np.full((b, t), -100, np.int32)
        lens = np.zeros((b,), np.int32)
        bev = np.zeros((b,) + self.bev_shape, np.float32)
        views = np.zeros((b, 6, 3, self.image_size, self.image_size),
                         np.float32)
        valid = np.zeros((b, 6), bool)

        for i, s in enumerate(samples):
            ids[i], labels[i], lens[i], _ = pack_text(
                self.tokenizer, s["question"], s.get("answer"),
                self.max_prompt, self.max_answer)
            sb = s["bev"]
            c, h, w = [min(a, b_) for a, b_ in zip(sb.shape, self.bev_shape)]
            bev[i, :c, :h, :w] = sb[:c, :h, :w]
            if self.load_images and any(p for p in s.get("cam_paths", [])):
                u8, v = load_views_u8(s["cam_paths"])
                views[i] = preprocess_views(
                    torch.as_tensor(u8, device=self.device),
                    self.image_size).cpu().numpy()
                valid[i] = v

        def put(x):
            return torch.as_tensor(x, device=self.device)
        return VQABatch(
            bev=put(bev), images=put(views), view_valid=put(valid),
            text_ids=put(ids), text_len=put(lens), labels=put(labels),
            use_vision=put(use_vision), use_lidar=put(use_lidar))
