"""ref: python/paddle/dataset/mnist.py — train()/test() yield
(784-float image scaled to [-1, 1], int label). Backed by
vision.datasets.MNIST (real IDX files when given, synthetic otherwise)."""
from __future__ import annotations

import numpy as np


def _reader(mode):
    from ..vision.datasets import MNIST
    ds = MNIST(mode=mode)

    def reader():
        for i in range(len(ds)):
            img = ds.images[i].astype(np.float32).reshape(-1)
            img = img / 127.5 - 1.0
            yield img, int(ds.labels[i])

    return reader


def train():
    return _reader("train")


def test():
    return _reader("test")
