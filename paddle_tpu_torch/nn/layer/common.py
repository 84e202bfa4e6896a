"""Common layers of the port: `Linear`, `Embedding`, `Dropout` — the
counterparts of `paddle_tpu/nn/layer/common.py` as `torch.nn.Module`s.

The layouts are the reference's: `Linear.weight` is `[in, out]` and is
applied as `x @ W + b` (Xavier-uniform init, bias zero). Initialisation
draws from an explicit CPU `torch.Generator` (`init_generator`), and the
layers are built on the CPU; a model moves them to its device. Dropout
draws its mask from `Dropout.generator` (None: torch's default generator
of the input's device), the stand-in for the reference's global key;
`transformer.set_dropout_generator` points every dropout under a module
at one generator.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


class Linear(nn.Module):
    """y = x @ weight + bias, weight [in_features, out_features]."""

    def __init__(self, in_features, out_features, *, init_generator=None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        bound = math.sqrt(6.0 / (in_features + out_features))
        self.weight = nn.Parameter(torch.empty(in_features, out_features)
                                   .uniform_(-bound, bound,
                                             generator=init_generator))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x):
        y = torch.addmm(self.bias, x.reshape(-1, self.in_features),
                        self.weight)
        return y.reshape(*x.shape[:-1], self.out_features)


class Embedding(nn.Module):
    """A lookup table [num_embeddings, embedding_dim], initialised
    normal(0, std) (the reference's default std is 1.0; BERT passes 0.02
    through its weight_attr). The padding_idx row starts at zero and gets
    no gradient."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None, *,
                 std=1.0, init_generator=None):
        super().__init__()
        if padding_idx is not None and padding_idx < 0:
            padding_idx += num_embeddings
        self.padding_idx = padding_idx
        w = torch.empty(num_embeddings, embedding_dim).normal_(
            0.0, std, generator=init_generator)
        if padding_idx is not None:
            w[padding_idx] = 0.0
        self.weight = nn.Parameter(w)

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self.padding_idx)


class Dropout(nn.Module):
    """The reference's dropout: in training, keep each element (or each
    slice along `axis`) with probability 1 - p, scaled by 1 / (1 - p) in
    the "upscale_in_train" mode; in eval, the identity (or x * (1 - p) in
    the "downscale_in_infer" mode). The mask draws from `generator`."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train",
                 generator=None):
        super().__init__()
        self.p, self.axis, self.mode = p, axis, mode
        self.generator = generator

    def forward(self, x):
        p = self.p
        if not self.training or p == 0.0:
            return x if self.mode == "upscale_in_train" or self.training \
                else x * (1.0 - p)
        if p == 1.0:
            return torch.zeros_like(x)
        shape = list(x.shape)
        if self.axis is not None:
            axes = self.axis if isinstance(self.axis, (list, tuple)) \
                else [self.axis]
            shape = [s if i in axes else 1 for i, s in enumerate(shape)]
        keep = torch.empty(shape, dtype=x.dtype, device=x.device) \
            .bernoulli_(1.0 - p, generator=self.generator).bool()
        if self.mode == "upscale_in_train":
            return torch.where(keep, x / (1.0 - p), 0.0)
        return torch.where(keep, x, 0.0)


__all__ = ["Linear", "Embedding", "Dropout"]
