"""Text and batching of the port (counterpart of the VQA part of
lvv_tpu/data): the tokenizers and the collator."""
from .collate import Collator, load_views_u8, pack_text
from .tokenizer import (CHAT_SYSTEM, ByteTokenizer, HFTokenizer, Tokenizer,
                        format_prompt, load_tokenizer)

__all__ = ["Collator", "load_views_u8", "pack_text", "CHAT_SYSTEM",
           "ByteTokenizer", "HFTokenizer", "Tokenizer", "format_prompt",
           "load_tokenizer"]
