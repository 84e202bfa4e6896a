"""ref: python/paddle/dataset/uci_housing.py — 13-feature Boston housing
regression. train()/test() yield (features[13] float32, [price])."""
from __future__ import annotations

import numpy as np

feature_names = [
    "CRIM", "ZN", "INDUS", "CHAS", "NOX", "RM", "AGE", "DIS", "RAD", "TAX",
    "PTRATIO", "B", "LSTAT",
]

_N_TRAIN, _N_TEST = 404, 102


def _make(n, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 13).astype(np.float32)
    w = np.linspace(-2.0, 2.0, 13).astype(np.float32)
    y = (x @ w + 3.0 + rng.randn(n).astype(np.float32) * 0.1)
    return x, y[:, None]


def feature_range(maximums, minimums):
    pass  # plotting helper in the reference; intentionally a no-op


def train():
    x, y = _make(_N_TRAIN, 0)

    def reader():
        for i in range(len(x)):
            yield x[i], y[i]

    return reader


def test():
    x, y = _make(_N_TEST, 1)

    def reader():
        for i in range(len(x)):
            yield x[i], y[i]

    return reader
