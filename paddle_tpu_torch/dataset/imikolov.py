"""ref: python/paddle/dataset/imikolov.py — PTB-style language modeling.
build_dict() -> word dict with <s>/<e>/<unk>; train/test yield n-grams
(DataType.NGRAM) or (src, trg) sequences (DataType.SEQ)."""
from __future__ import annotations

from . import _text_synth


class DataType:
    NGRAM = 1
    SEQ = 2


def build_dict(min_word_freq=0):
    freq = {}
    for ws in _text_synth.sentences(300, seed=30):
        for w in ws:
            freq[w] = freq.get(w, 0) + 1
    freq = {w: c for w, c in freq.items() if c >= min_word_freq}
    ordered = sorted(freq.items(), key=lambda kv: (-kv[1], kv[0]))
    word_idx = {w: i for i, (w, _) in enumerate(ordered)}
    word_idx["<unk>"] = len(word_idx)
    word_idx.setdefault("<s>", len(word_idx))
    word_idx.setdefault("<e>", len(word_idx))
    return word_idx


def _reader(word_idx, n, data_type, seed):
    s_id = word_idx["<s>"]
    e_id = word_idx["<e>"]
    unk = word_idx["<unk>"]

    def reader():
        for ws in _text_synth.sentences(150, seed=seed):
            ids = [s_id] + [word_idx.get(w, unk) for w in ws] + [e_id]
            if data_type == DataType.NGRAM:
                if len(ids) >= n:
                    for i in range(n, len(ids) + 1):
                        yield tuple(ids[i - n:i])
            else:
                yield ids[:-1], ids[1:]

    return reader


def train(word_idx, n, data_type=DataType.NGRAM):
    return _reader(word_idx, n, data_type, seed=31)


def test(word_idx, n, data_type=DataType.NGRAM):
    return _reader(word_idx, n, data_type, seed=32)
