"""ref: python/paddle/dataset/wmt14.py — FR->EN translation pairs.
train(dict_size)/test(dict_size) yield (src_ids, trg_ids, trg_next_ids).
The <s>/<e>/<unk> convention matches the reference."""
from __future__ import annotations

import numpy as np

from . import _text_synth

START = "<s>"
END = "<e>"
UNK = "<unk>"
UNK_IDX = 2


def _dicts(dict_size):
    words = _text_synth.vocab()[: max(0, dict_size - 3)]
    vocab = [START, END, UNK] + words
    d = {w: i for i, w in enumerate(vocab)}
    return d, d  # synthetic corpus shares src/trg vocab


def get_dict(dict_size, reverse=False):
    src, trg = _dicts(dict_size)
    if reverse:
        return ({v: k for k, v in src.items()},
                {v: k for k, v in trg.items()})
    return src, trg


def _reader(dict_size, seed, n):
    src_d, trg_d = _dicts(dict_size)

    def ids(ws, d):
        return [d.get(w, UNK_IDX) for w in ws]

    def reader():
        for ws in _text_synth.sentences(n, seed=seed):
            src = ids(ws, src_d)
            trg = ids(list(reversed(ws)), trg_d)  # synthetic "translation"
            yield (src, [src_d[START]] + trg, trg + [src_d[END]])

    return reader


def train(dict_size):
    return _reader(dict_size, seed=50, n=300)


def test(dict_size):
    return _reader(dict_size, seed=51, n=60)
