"""Shared deterministic synthetic text corpus for the NLP dataset loaders
(imdb/imikolov/wmt). A fixed vocabulary + a seeded Zipf-ish sampler gives
stable dictionaries and sentences across processes."""
from __future__ import annotations

import numpy as np

_WORDS = [
    "the", "a", "of", "to", "and", "in", "it", "is", "this", "that",
    "movie", "film", "story", "plot", "actor", "scene", "great", "bad",
    "good", "terrible", "wonderful", "boring", "love", "hate", "time",
    "character", "music", "ending", "script", "director", "watch", "see",
    "one", "two", "best", "worst", "funny", "sad", "long", "short",
]


def vocab():
    return list(_WORDS)


def sentences(n, seed, min_len=4, max_len=12, sentiment=None):
    """n synthetic sentences; sentiment=0/1 biases negative/positive words
    so classifiers can actually learn."""
    rng = np.random.RandomState(seed)
    pos = ["great", "good", "wonderful", "love", "best", "funny"]
    neg = ["bad", "terrible", "boring", "hate", "worst", "sad"]
    out = []
    for _ in range(n):
        ln = rng.randint(min_len, max_len + 1)
        ws = [_WORDS[min(int(rng.zipf(1.5)) - 1, len(_WORDS) - 1)]
              for _ in range(ln)]
        if sentiment is not None:
            bank = pos if sentiment == 1 else neg
            for _ in range(max(1, ln // 3)):
                ws[rng.randint(ln)] = bank[rng.randint(len(bank))]
        out.append(ws)
    return out
