"""Data of the port (counterpart of the VQA part of lvv_tpu/data): the
tokenizers and the collator, the QA dataset over precomputed BEV features
with its split and sampler, the devkit-free nuScenes table reader and the
batch prefetcher, and the LiDAR sweep reader (`load_points`)."""
from .collate import Collator, load_views_u8, pack_text
from .dataset import (CAM_VIEWS, DeterministicSampler, MixedNuDataset,
                      index_bev_features, load_qa_rows, make_nusc_handle,
                      split_rows)
from .points import load_points
from .prefetch import Prefetcher
from .tokenizer import (CHAT_SYSTEM, ByteTokenizer, HFTokenizer, Tokenizer,
                        format_prompt, load_tokenizer)

__all__ = ["Collator", "load_views_u8", "pack_text", "CHAT_SYSTEM",
           "ByteTokenizer", "HFTokenizer", "Tokenizer", "format_prompt",
           "load_tokenizer", "CAM_VIEWS", "DeterministicSampler",
           "MixedNuDataset", "index_bev_features", "load_qa_rows",
           "make_nusc_handle", "split_rows", "Prefetcher", "load_points"]
