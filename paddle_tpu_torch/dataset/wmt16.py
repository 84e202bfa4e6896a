"""ref: python/paddle/dataset/wmt16.py — BPE-ish translation loaders with
selectable src/trg language. train/test/validation yield
(src_ids, trg_ids, trg_next_ids); get_dict(lang, dict_size)."""
from __future__ import annotations

from . import _text_synth
from .wmt14 import END, START, UNK, UNK_IDX, _dicts


def get_dict(lang, dict_size, reverse=False):
    d, _ = _dicts(dict_size)
    if reverse:
        return {v: k for k, v in d.items()}
    return d


def fetch():
    pass  # download hook in the reference; data here is synthetic


def _reader(src_dict_size, trg_dict_size, seed, n):
    src_d, _ = _dicts(src_dict_size)
    trg_d, _ = _dicts(trg_dict_size)

    def reader():
        for ws in _text_synth.sentences(n, seed=seed):
            src = [src_d.get(w, UNK_IDX) for w in ws]
            trg = [trg_d.get(w, UNK_IDX) for w in reversed(ws)]
            yield (src, [trg_d[START]] + trg, trg + [trg_d[END]])

    return reader


def train(src_dict_size, trg_dict_size, src_lang="en"):
    return _reader(src_dict_size, trg_dict_size, seed=52, n=300)


def test(src_dict_size, trg_dict_size, src_lang="en"):
    return _reader(src_dict_size, trg_dict_size, seed=53, n=60)


def validation(src_dict_size, trg_dict_size, src_lang="en"):
    return _reader(src_dict_size, trg_dict_size, seed=54, n=60)
