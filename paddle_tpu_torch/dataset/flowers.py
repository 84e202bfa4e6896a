"""ref: python/paddle/dataset/flowers.py — 102-category flowers.
train()/test()/valid() yield (3*32*32 float image in [0,1], int label)."""
from __future__ import annotations

import numpy as np

_N_CLASSES = 102


def _reader(seed, n):
    def reader():
        rng = np.random.RandomState(seed)
        labels = rng.randint(0, _N_CLASSES, n)
        base = rng.rand(_N_CLASSES, 3, 32, 32).astype(np.float32)
        for i in range(n):
            img = np.clip(base[labels[i]] * 0.75
                          + rng.rand(3, 32, 32) * 0.25, 0, 1)
            yield img.reshape(-1).astype(np.float32), int(labels[i])

    return reader


def train(mapper=None, buffered_size=1024, use_xmap=True, cycle=False):
    return _reader(13, 400)


def test(mapper=None, buffered_size=1024, use_xmap=True, cycle=False):
    return _reader(14, 100)


def valid(mapper=None, buffered_size=1024, use_xmap=True):
    return _reader(15, 100)
