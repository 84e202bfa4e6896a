"""ref: python/paddle/dataset/conll05.py — semantic role labeling.
get_dict() -> (word_dict, verb_dict, label_dict); test() yields the 9-slot
SRL sample (word, ctx_n2..ctx_p2, verb, mark, labels)."""
from __future__ import annotations

import numpy as np

from . import _text_synth

_LABELS = ["B-A0", "I-A0", "B-A1", "I-A1", "B-V", "O"]
_VERBS = ["watch", "love", "hate", "see"]

UNK_IDX = 0


def get_dict():
    words = ["<unk>"] + _text_synth.vocab()
    word_dict = {w: i for i, w in enumerate(words)}
    verb_dict = {v: i for i, v in enumerate(_VERBS)}
    label_dict = {l: i for i, l in enumerate(_LABELS)}
    return word_dict, verb_dict, label_dict


def get_embedding():
    """ref: conll05.py get_embedding — pretrained word vectors; here a
    seeded matrix shaped [len(word_dict), 32]."""
    word_dict, _, _ = get_dict()
    rng = np.random.RandomState(9)
    return rng.randn(len(word_dict), 32).astype(np.float32)


def test():
    word_dict, verb_dict, label_dict = get_dict()

    def reader():
        rng = np.random.RandomState(11)
        for ws in _text_synth.sentences(60, seed=12, min_len=5):
            n = len(ws)
            widx = [word_dict.get(w, UNK_IDX) for w in ws]
            vpos = int(rng.randint(n))
            verb = _VERBS[rng.randint(len(_VERBS))]
            mark = [1 if i == vpos else 0 for i in range(n)]
            labels = [label_dict["B-V"] if i == vpos else label_dict["O"]
                      for i in range(n)]
            ctx = {}
            for off, name in ((-2, "n2"), (-1, "n1"), (0, "0"),
                              (1, "p1"), (2, "p2")):
                p = min(max(vpos + off, 0), n - 1)
                ctx[name] = [widx[p]] * n
            yield (widx, ctx["n2"], ctx["n1"], ctx["0"], ctx["p1"],
                   ctx["p2"], [verb_dict[verb]] * n, mark, labels)

    return reader
