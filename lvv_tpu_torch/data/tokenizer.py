"""Tokenizer protocol, the canonical prompt and the offline byte tokenizer
(counterpart of lvv_tpu/data/tokenizer.py).

- `load_tokenizer(path_or_none, special_tokens)` uses transformers when the
  tokenizer files exist locally (nothing is downloaded), else falls back to
- `ByteTokenizer`, a dependency-free byte-level tokenizer with the same
  interface (ids 0..255 = bytes, then the specials, then eos and pad; not
  vocabulary-compatible with Qwen: for plumbing and tests).
"""
from __future__ import annotations

from typing import List, Protocol, Sequence


class Tokenizer(Protocol):
    eos_id: int
    pad_id: int

    def encode(self, text: str) -> List[int]: ...
    def decode(self, ids: Sequence[int]) -> str: ...
    def special_id(self, token: str) -> int: ...


CHAT_SYSTEM = ("You are a helpful driving-scene assistant. Answer using the "
               "LiDAR and camera context.")


def format_prompt(question: str) -> str:
    """The canonical chat-format prompt (a system and a user turn, then the
    assistant's turn opened); a tokenizer's own template is used instead
    where it has one."""
    return (f"<|im_start|>system\n{CHAT_SYSTEM}<|im_end|>\n"
            f"<|im_start|>user\n{question}<|im_end|>\n"
            f"<|im_start|>assistant\n")


class ByteTokenizer:
    """Byte-level fallback tokenizer (offline)."""

    def __init__(self, special_tokens: Sequence[str] = ()):
        self.specials = {t: 256 + i for i, t in enumerate(special_tokens)}
        self.eos_id = 256 + len(self.specials)
        self.pad_id = self.eos_id + 1
        self.vocab_size = self.pad_id + 1

    def encode(self, text: str) -> List[int]:
        return list(text.encode("utf-8"))

    def decode(self, ids: Sequence[int]) -> str:
        return bytes(i for i in ids if 0 <= i < 256).decode(
            "utf-8", errors="replace")

    def special_id(self, token: str) -> int:
        return self.specials[token]


class HFTokenizer:
    """transformers-backed tokenizer over local files only."""

    def __init__(self, path: str, special_tokens: Sequence[str] = ()):
        from transformers import AutoTokenizer
        self.tk = AutoTokenizer.from_pretrained(path, local_files_only=True)
        if special_tokens:
            self.tk.add_special_tokens(
                {"additional_special_tokens": list(special_tokens)})
        self.eos_id = self.tk.eos_token_id
        self.pad_id = (self.tk.pad_token_id
                       if self.tk.pad_token_id is not None else self.eos_id)

    def encode(self, text: str):
        return self.tk.encode(text, add_special_tokens=False)

    def decode(self, ids):
        return self.tk.decode(list(ids), skip_special_tokens=True)

    def special_id(self, token: str) -> int:
        return self.tk.convert_tokens_to_ids(token)

    def apply_chat_template(self, question: str) -> str:
        msgs = [{"role": "system", "content": CHAT_SYSTEM},
                {"role": "user", "content": question}]
        return self.tk.apply_chat_template(msgs, tokenize=False,
                                           add_generation_prompt=True)


def load_tokenizer(path_or_none, special_tokens: Sequence[str] = ()):
    """HFTokenizer over `path_or_none` when it loads, else ByteTokenizer."""
    if path_or_none:
        try:
            return HFTokenizer(path_or_none, special_tokens)
        except Exception:   # no transformers, or no usable local files
            pass
    return ByteTokenizer(special_tokens)
