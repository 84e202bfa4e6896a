"""ref: python/paddle/dataset/voc2012.py — segmentation pairs.
train()/test()/val() yield (3xHxW float image, HxW int label mask)."""
from __future__ import annotations

import numpy as np

_N_CLASSES = 21
_HW = 32


def _reader(seed, n):
    def reader():
        rng = np.random.RandomState(seed)
        for _ in range(n):
            img = rng.rand(3, _HW, _HW).astype(np.float32)
            # blocky masks: a class rectangle on background
            mask = np.zeros((_HW, _HW), np.int64)
            c = rng.randint(1, _N_CLASSES)
            y0, x0 = rng.randint(0, _HW // 2, 2)
            mask[y0:y0 + _HW // 2, x0:x0 + _HW // 2] = c
            yield img, mask

    return reader


def train():
    return _reader(16, 120)


def test():
    return _reader(17, 40)


def val():
    return _reader(18, 40)
