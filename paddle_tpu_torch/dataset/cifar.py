"""ref: python/paddle/dataset/cifar.py — train10/test10/train100/test100
yield (3072-float image scaled to [0,1], int label). Backed by
vision.datasets.Cifar10/100 (tar.gz archives when given, synthetic
otherwise)."""
from __future__ import annotations

import numpy as np


def _reader(cls, mode):
    ds = cls(mode=mode)  # parse the archive once, not per epoch

    def reader():
        for i in range(len(ds)):
            img = ds.images[i].astype(np.float32).reshape(-1) / 255.0
            yield img, int(ds.labels[i])

    return reader


def train10():
    from ..vision.datasets import Cifar10
    return _reader(Cifar10, "train")


def test10():
    from ..vision.datasets import Cifar10
    return _reader(Cifar10, "test")


def train100():
    from ..vision.datasets import Cifar100
    return _reader(Cifar100, "train")


def test100():
    from ..vision.datasets import Cifar100
    return _reader(Cifar100, "test")
