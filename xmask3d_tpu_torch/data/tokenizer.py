"""CLIP text tokenizers (host-side): own copy of `xmask3d_tpu/data/tokenizer.py`.

* `CLIPBPETokenizer(vocab_path)`: CLIP's byte-level BPE, reading the gzip'd
  `bpe_simple_vocab_16e6.txt.gz` merges file (not shipped in this repo).
* `HashTokenizer`: a deterministic stand-in when no merges file is
  configured. Same contract (sot/eot ids, fixed-length int32 rows); it serves
  randomly initialised text towers, not pretrained CLIP weights.
"""

from __future__ import annotations

import gzip
import hashlib
from functools import lru_cache
from typing import List, Sequence, Union

import numpy as np


@lru_cache()
def bytes_to_unicode():
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(2 ** 8):
        if b not in bs:
            bs.append(b)
            cs.append(2 ** 8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word):
    return set(zip(word[:-1], word[1:]))


def _clean(text: str) -> str:
    return " ".join(text.strip().split())


def _pad_rows(rows: List[List[int]], context_length: int, eot: int) -> np.ndarray:
    """sot + ids + eot per row, cut to the context (eot kept last), zero-padded."""
    out = np.zeros((len(rows), context_length), np.int32)
    for i, toks in enumerate(rows):
        toks = toks[:context_length]
        if len(toks) == context_length:
            toks[-1] = eot
        out[i, : len(toks)] = toks
    return out


class CLIPBPETokenizer:
    """CLIP's byte-level BPE (vocab size 49408, context 77)."""

    def __init__(self, vocab_path: str, context_length: int = 77):
        import regex as re

        self.context_length = context_length
        self.byte_encoder = bytes_to_unicode()
        with gzip.open(vocab_path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")
        merges = [tuple(m.split()) for m in merges[1 : 49152 - 256 - 2 + 1]]
        vocab = list(bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        vocab += ["".join(m) for m in merges]
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = dict(zip(vocab, range(len(vocab))))
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {"<|startoftext|>": "<|startoftext|>", "<|endoftext|>": "<|endoftext|>"}
        self.pat = re.compile(
            r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"
            r"[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+",
            re.IGNORECASE,
        )
        self.sot = self.encoder["<|startoftext|>"]
        self.eot = self.encoder["<|endoftext|>"]

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for token in self.pat.findall(_clean(text).lower()):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return ids

    def __call__(self, texts: Union[str, Sequence[str]]) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        return _pad_rows([[self.sot] + self.encode(t) + [self.eot] for t in texts],
                         self.context_length, self.eot)


class HashTokenizer:
    """Maps each whitespace word to a stable id in [3, vocab)."""

    def __init__(self, vocab_size: int = 49408, context_length: int = 77):
        self.vocab_size = vocab_size
        self.context_length = context_length
        self.sot = vocab_size - 2
        self.eot = vocab_size - 1

    def encode(self, text: str) -> List[int]:
        ids = []
        for w in _clean(text).lower().split(" "):
            if w:
                h = int(hashlib.md5(w.encode()).hexdigest(), 16)
                ids.append(3 + h % (self.vocab_size - 5))
        return ids

    def __call__(self, texts: Union[str, Sequence[str]]) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        return _pad_rows([[self.sot] + self.encode(t) + [self.eot] for t in texts],
                         self.context_length, self.eot)


def build_tokenizer(vocab_path: str = "", vocab_size: int = 49408, context_length: int = 77):
    """The BPE tokenizer on a merges file, else the hash stand-in."""
    if vocab_path:
        return CLIPBPETokenizer(vocab_path, context_length)
    return HashTokenizer(vocab_size, context_length)


def require_real_tokenizer(tokenizer, allow_hash: bool = False) -> None:
    """Refuse a real dataset on the hash stand-in, whose ids would be garbage
    to pretrained CLIP weights, unless `allow_hash` (from-scratch runs)."""
    if isinstance(tokenizer, HashTokenizer) and not allow_hash:
        raise RuntimeError(
            "refusing to run a real dataset with the HashTokenizer fallback: "
            "no CLIP BPE vocab configured (set `clip_bpe_vocab` to the "
            "bpe_simple_vocab_16e6.txt.gz path). Pass --allow_hash_tokenizer "
            "to override (from-scratch runs only)."
        )
