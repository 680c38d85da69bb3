"""The port's CLIP tokenizer against the JAX package's: the same (N, 77)
token matrix for prompts with class names, punctuation, HTML entities,
capitals and a prompt past the 77-token context; the vocabulary read from
the file the JAX package vendors."""

from __future__ import annotations

import numpy as np

from libcontinual_tpu.models import tokenizer as jtok
from libcontinual_tpu_torch.models import tokenizer as ttok

PROMPTS = (
    [f"a photo of a class {c}." for c in (0, 7, 42, 99)]
    + ["a good photo of a class 3", "A PHOTO of a Golden Retriever!", "rock &amp; roll &lt;3",
       "it's a dog's life -- isn't it?", "  spaced    out\tprompt  ", "",
       "word " * 80]
)


def test_tokenize_equals_jax():
    got, want = ttok.tokenize(PROMPTS), jtok.tokenize(PROMPTS)
    assert got.shape == want.shape == (len(PROMPTS), 77) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    long = got[-1]
    assert long[0] == 49406 and long[-1] == 49407  # cut to the context, EOT kept last


def test_reads_the_vendored_vocabulary():
    path = ttok.default_vocab_paths()[1]
    assert path == jtok.default_vocab_paths()[1]
    tok = ttok.SimpleTokenizer()
    assert tok._bpe_available and len(tok.encoder) == 49408
    assert tok.encode("a photo of a cat") == jtok.SimpleTokenizer().encode("a photo of a cat")


def test_re_fallback_agrees_on_ascii(monkeypatch):
    """Without the ``regex`` module (the card's machine has none) the ASCII
    pattern of ``re`` gives the same tokens for ASCII prompts."""
    with_regex = ttok.SimpleTokenizer()
    monkeypatch.setitem(__import__("sys").modules, "regex", None)
    plain_re = ttok.SimpleTokenizer()
    assert plain_re.pat.__class__.__module__ == "re"
    for p in PROMPTS:
        assert plain_re.encode(p) == with_regex.encode(p), p
