"""`LayerNorm`, the counterpart of `paddle_tpu/nn/layer/norm.py`'s: the
normalisation over the trailing `normalized_shape` dims with weight one
and bias zero at init, and the reference's default epsilon 1e-5 (BERT's
embedding and MLM norms pass its config's 1e-12; its encoder norms keep
the default)."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class LayerNorm(nn.Module):
    def __init__(self, normalized_shape, epsilon=1e-5):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(normalized_shape)
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(self.normalized_shape))
        self.bias = nn.Parameter(torch.zeros(self.normalized_shape))

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight, self.bias,
                            self.epsilon)


__all__ = ["LayerNorm"]
