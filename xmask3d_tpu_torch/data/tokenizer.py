"""Deterministic stand-in CLIP tokenizer (host-side): own copy of the
`HashTokenizer` path of `xmask3d_tpu/data/tokenizer.py`. Same contract as
CLIP's BPE tokenizer (sot/eot ids, fixed-length int32 rows); it serves
randomly initialised text towers, not pretrained CLIP weights."""

from __future__ import annotations

import hashlib
from typing import List, Sequence, Union

import numpy as np


class HashTokenizer:
    """Maps each whitespace word to a stable id in [3, vocab)."""

    def __init__(self, vocab_size: int = 49408, context_length: int = 77):
        self.vocab_size = vocab_size
        self.context_length = context_length
        self.sot = vocab_size - 2
        self.eot = vocab_size - 1

    def encode(self, text: str) -> List[int]:
        ids = []
        for w in " ".join(text.strip().split()).lower().split(" "):
            if w:
                h = int(hashlib.md5(w.encode()).hexdigest(), 16)
                ids.append(3 + h % (self.vocab_size - 5))
        return ids

    def __call__(self, texts: Union[str, Sequence[str]]) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        out = np.zeros((len(texts), self.context_length), np.int32)
        for i, text in enumerate(texts):
            toks = [self.sot] + self.encode(text) + [self.eot]
            toks = toks[: self.context_length]
            if len(toks) == self.context_length:
                toks[-1] = self.eot
            out[i, : len(toks)] = toks
        return out


def build_tokenizer(vocab_path: str = "", vocab_size: int = 49408,
                    context_length: int = 77) -> HashTokenizer:
    if vocab_path:
        raise NotImplementedError(
            "the CLIP BPE tokenizer is not ported yet; only the hash "
            "tokenizer (empty `clip_bpe_vocab`) is available"
        )
    return HashTokenizer(vocab_size, context_length)
