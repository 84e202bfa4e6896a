"""ref: python/paddle/dataset/imdb.py — sentiment classification.
word_dict() -> {word: idx}; train(word_idx)/test(word_idx) yield
(word-id list, 0/1 label)."""
from __future__ import annotations

import re

from . import _text_synth


def tokenize(pattern=None):
    """ref: imdb.py tokenize — yields token lists (synthetic corpus)."""
    for s in _text_synth.sentences(200, seed=10):
        yield s


def build_dict(pattern=None, cutoff=0):
    """ref: imdb.py:60 — frequency-sorted word dict with <unk> last."""
    freq = {}
    for ws in tokenize(pattern):
        for w in ws:
            freq[w] = freq.get(w, 0) + 1
    freq = {w: c for w, c in freq.items() if c > cutoff}
    ordered = sorted(freq.items(), key=lambda kv: (-kv[1], kv[0]))
    word_idx = {w: i for i, (w, _) in enumerate(ordered)}
    word_idx["<unk>"] = len(word_idx)
    return word_idx


def word_dict():
    return build_dict()


def _reader(word_idx, seed):
    unk = word_idx.get("<unk>", len(word_idx) - 1)

    def reader():
        for label in (0, 1):
            for ws in _text_synth.sentences(100, seed=seed + label,
                                            sentiment=label):
                yield [word_idx.get(w, unk) for w in ws], label

    return reader


def train(word_idx):
    return _reader(word_idx, seed=20)


def test(word_idx):
    return _reader(word_idx, seed=40)
