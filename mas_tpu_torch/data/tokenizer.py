"""Text tokenizers, as ``mas_tpu/data/tokenizer.py`` (declared again here
because the port cannot import ``mas_tpu`` without jax):

  * ``HashWordTokenizer``, a dependency-free, deterministic
    lowercase-word-hash tokenizer into a fixed vocab;
  * ``HFTokenizerAdapter``, any ``transformers`` tokenizer behind the same
    ``(captions) -> [B, text_length] int32`` interface, loaded from a
    local path; ``transformers`` is imported only by ``from_pretrained``.

Token ids start at 1; id 0 is the pad that the model remaps per position.
"""

from __future__ import annotations

import hashlib
from typing import Sequence

import numpy as np


class HashWordTokenizer:
    """captions -> [B, text_length] int32; id 0 = pad."""

    def __init__(self, vocab_size: int = 16384, text_length: int = 128):
        if vocab_size <= 1:
            raise ValueError("vocab_size must be > 1")
        self.vocab_size = vocab_size
        self.text_length = text_length

    def _word_id(self, word: str) -> int:
        h = hashlib.blake2s(word.lower().encode("utf-8"),
                            digest_size=4).digest()
        return 1 + int.from_bytes(h, "little") % (self.vocab_size - 1)

    def __call__(self, captions: Sequence[str]) -> np.ndarray:
        out = np.zeros((len(captions), self.text_length), np.int32)
        for i, caption in enumerate(captions):
            words = str(caption).split()[: self.text_length]
            for j, w in enumerate(words):
                out[i, j] = self._word_id(w)
        return out


class HFTokenizerAdapter:
    """A HuggingFace tokenizer behind the ``HashWordTokenizer`` interface:
    ids shifted by +1 so 0 stays the pad, truncated to ``text_length``."""

    def __init__(self, tokenizer, text_length: int = 128):
        self.tokenizer = tokenizer
        self.text_length = text_length

    @classmethod
    def from_pretrained(cls, path: str, text_length: int = 128):
        from transformers import AutoTokenizer

        return cls(AutoTokenizer.from_pretrained(path),
                   text_length=text_length)

    def __call__(self, captions: Sequence[str]) -> np.ndarray:
        out = np.zeros((len(captions), self.text_length), np.int32)
        for i, caption in enumerate(captions):
            ids = self.tokenizer.encode(str(caption),
                                        add_special_tokens=False)
            ids = [t + 1 for t in ids][: self.text_length]
            out[i, : len(ids)] = ids
        return out
