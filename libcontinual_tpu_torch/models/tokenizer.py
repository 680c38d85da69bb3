"""CLIP BPE tokenizer (a copy of ``libcontinual_tpu/models/tokenizer.py``).

The merge table (``bpe_simple_vocab_16e6.txt.gz``, a public OpenAI asset) is
the one vendored beside the JAX package, read by its path in the repository
(``libcontinual_tpu/assets/``) as a data file, not imported;
``CLIP_BPE_VOCAB`` overrides the path. Without any vocab file, a
deterministic byte-level fallback tokenizer keeps the CLIP stack functional
for tests and synthetic class names. The split pattern uses the ``regex``
module's unicode classes where it is installed and the ASCII classes of
``re`` otherwise; the two agree on ASCII text.
"""

from __future__ import annotations

import gzip
import html
import os
from functools import lru_cache
from typing import List, Optional

import numpy as np

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def default_vocab_paths() -> list:
    # read CLIP_BPE_VOCAB at call time, not import time, so tests and runners
    # can set it after this module is imported
    return [
        os.environ.get("CLIP_BPE_VOCAB", ""),
        os.path.join(REPO_ROOT, "libcontinual_tpu", "assets", "bpe_simple_vocab_16e6.txt.gz"),
    ]

CONTEXT_LENGTH = 77
VOCAB_SIZE = 49408


@lru_cache()
def bytes_to_unicode():
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def basic_clean(text: str) -> str:
    return html.unescape(html.unescape(text)).strip()


def whitespace_clean(text: str) -> str:
    import re

    return re.sub(r"\s+", " ", text).strip()


class SimpleTokenizer:
    def __init__(self, bpe_path: Optional[str] = None):
        import re

        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        path = bpe_path
        if path is None:
            for p in default_vocab_paths():
                if p and os.path.exists(p):
                    path = p
                    break
        self._bpe_available = path is not None and os.path.exists(path or "")
        if self._bpe_available:
            merges = gzip.open(path).read().decode("utf-8").split("\n")
            merges = merges[1 : 49152 - 256 - 2 + 1]
            merges = [tuple(m.split()) for m in merges]
            vocab = list(bytes_to_unicode().values())
            vocab = vocab + [v + "</w>" for v in vocab]
            for m in merges:
                vocab.append("".join(m))
            vocab.extend(["<|startoftext|>", "<|endoftext|>"])
            self.encoder = dict(zip(vocab, range(len(vocab))))
            self.bpe_ranks = dict(zip(merges, range(len(merges))))
            self.cache = {
                "<|startoftext|>": "<|startoftext|>",
                "<|endoftext|>": "<|endoftext|>",
            }
        else:
            self.encoder = {"<|startoftext|>": VOCAB_SIZE - 2, "<|endoftext|>": VOCAB_SIZE - 1}
        # the CLIP tokenizer's pattern uses \p{L}/\p{N} unicode classes (the
        # third-party `regex` module); fall back to the ASCII classes when
        # `regex` is absent: accented class names then tokenize differently
        try:
            import regex as _rx

            self.pat = _rx.compile(
                r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
                _rx.IGNORECASE,
            )
        except ImportError:
            self.pat = re.compile(
                r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+""",
                re.IGNORECASE,
            )

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
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                    new_word.extend(word[i:j])
                    i = j
                except ValueError:
                    new_word.extend(word[i:])
                    break
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
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
        text = whitespace_clean(basic_clean(text)).lower()
        if not self._bpe_available:
            # byte-level fallback: deterministic, collision-free for ASCII
            return [min(b + 256, VOCAB_SIZE - 3) for b in text.encode("utf-8")][:70]
        bpe_tokens: List[int] = []
        for token in self.pat.findall(text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            bpe_tokens.extend(
                self.encoder[t] for t in self.bpe(token).split(" ")
            )
        return bpe_tokens


_TOKENIZER: Optional[SimpleTokenizer] = None


def tokenize(texts, context_length: int = CONTEXT_LENGTH) -> np.ndarray:
    """Texts -> (N, 77) int32 token matrix."""
    global _TOKENIZER
    if _TOKENIZER is None:
        _TOKENIZER = SimpleTokenizer()
    if isinstance(texts, str):
        texts = [texts]
    sot = _TOKENIZER.encoder["<|startoftext|>"]
    eot = _TOKENIZER.encoder["<|endoftext|>"]
    out = np.zeros((len(texts), context_length), np.int32)
    for i, t in enumerate(texts):
        toks = [sot] + _TOKENIZER.encode(t)[: context_length - 2] + [eot]
        out[i, : len(toks)] = toks
    return out
