"""Common layers: the port of `paddle_tpu/nn/layer/common.py` as `Layer`s
— `Linear`, `Embedding`, the dropouts, `Flatten` / `Unflatten`,
`Upsample*`, `Pad1D/2D/3D`, `ZeroPad2D`, `CosineSimilarity`,
`PairwiseDistance`, `Bilinear`, `PixelShuffle` / `PixelUnshuffle`,
`Unfold`, `Identity` — with the reference's signatures, defaults and
parameter names.

The layouts are the reference's: `Linear.weight` is `[in, out]`, applied
as `x @ W + b` (Xavier-uniform init, bias zero); `Embedding.weight` is
`[num, dim]`, normal(0, 1) with the padding row zeroed (and given no
gradient). Parameters go to the default device and draw from the port's
generator there; the keyword `init_generator=` (the models' way) draws
from that generator on its device instead, and `Embedding`'s `std=` sets
the init's deviation (BERT passes 0.02 where the reference passes it
through `weight_attr`). Dropout draws its mask from `Dropout.generator`
(None: the port's generator of the input's device);
`transformer.set_dropout_generator` points every dropout under a layer
at one generator.
"""
from __future__ import annotations

import math

import torch

from ... import ops
from .. import initializer as I
from .layers import Layer


class Identity(Layer):
    def forward(self, x):
        return x


class Linear(Layer):
    """y = x @ weight + bias, weight [in_features, out_features]."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None, *, init_generator=None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.weight = self.create_parameter(
            (in_features, out_features), attr=weight_attr,
            default_initializer=I.XavierUniform(), generator=init_generator)
        self.bias = self.create_parameter(
            (out_features,), attr=bias_attr, is_bias=True,
            generator=init_generator)

    def forward(self, x):
        return ops.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return f"in_features={self.in_features}, " \
            f"out_features={self.out_features}"


class Embedding(Layer):
    """A lookup table [num_embeddings, embedding_dim]. The padding_idx row
    starts at zero and gets no gradient."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None, *, std=1.0,
                 init_generator=None):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        if padding_idx is not None and padding_idx < 0:
            padding_idx += num_embeddings
        self.padding_idx = padding_idx
        self.weight = self.create_parameter(
            (num_embeddings, embedding_dim), attr=weight_attr,
            default_initializer=I.Normal(0.0, std), generator=init_generator)
        if padding_idx is not None:
            with torch.no_grad():
                self.weight[padding_idx] = 0.0

    def forward(self, x):
        return ops.embedding(x, self.weight, padding_idx=self.padding_idx)

    def extra_repr(self):
        return f"{self.num_embeddings}, {self.embedding_dim}"


class Dropout(Layer):
    """The reference's dropout: in training, keep each element (or each
    slice along `axis`) with probability 1 - p, scaled by 1 / (1 - p) in
    the "upscale_in_train" mode; in eval, the identity (or x * (1 - p) in
    the "downscale_in_infer" mode)."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None,
                 *, generator=None):
        super().__init__()
        self.p, self.axis, self.mode = p, axis, mode
        self.generator = generator

    def forward(self, x):
        return ops.dropout(x, p=self.p, training=self.training,
                           mode=self.mode, axis=self.axis,
                           generator=self.generator)

    def extra_repr(self):
        return f"p={self.p}"


class Dropout2D(Layer):
    def __init__(self, p=0.5, data_format="NCHW", name=None, *,
                 generator=None):
        super().__init__()
        self.p, self.data_format = p, data_format
        self.generator = generator

    def forward(self, x):
        return ops.dropout2d(x, p=self.p, training=self.training,
                             data_format=self.data_format,
                             generator=self.generator)


class Dropout3D(Dropout2D):
    def __init__(self, p=0.5, data_format="NCDHW", name=None, *,
                 generator=None):
        super().__init__(p, data_format, name, generator=generator)


class AlphaDropout(Layer):
    def __init__(self, p=0.5, name=None, *, generator=None):
        super().__init__()
        self.p = p
        self.generator = generator

    def forward(self, x):
        return ops.alpha_dropout(x, p=self.p, training=self.training,
                                 generator=self.generator)


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis, self.stop_axis = start_axis, stop_axis

    def forward(self, x):
        return ops.flatten(x, self.start_axis, self.stop_axis)


class Unflatten(Layer):
    def __init__(self, axis, shape, name=None):
        super().__init__()
        self.axis, self.shape = axis, shape

    def forward(self, x):
        new_shape = list(x.shape)
        new_shape[self.axis:self.axis + 1] = list(self.shape)
        return ops.reshape(x, new_shape)


class Upsample(Layer):
    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, align_mode=0, data_format="NCHW",
                 name=None):
        super().__init__()
        self.size, self.scale_factor = size, scale_factor
        self.mode, self.align_corners = mode, align_corners
        self.data_format = data_format

    def forward(self, x):
        return ops.interpolate(x, size=self.size,
                               scale_factor=self.scale_factor,
                               mode=self.mode,
                               align_corners=self.align_corners,
                               data_format=self.data_format)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "nearest", False, 0,
                         data_format)


class UpsamplingBilinear2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "bilinear", True, 0,
                         data_format)


class _PadNd(Layer):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.padding, self.mode, self.value = padding, mode, value
        self.data_format = data_format

    def forward(self, x):
        return ops.pad(x, self.padding, mode=self.mode, value=self.value,
                       data_format=self.data_format)


class Pad1D(_PadNd):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCL", name=None):
        super().__init__(padding, mode, value, data_format)


class Pad2D(_PadNd):
    pass


class Pad3D(_PadNd):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCDHW", name=None):
        super().__init__(padding, mode, value, data_format)


class ZeroPad2D(Pad2D):
    def __init__(self, padding, data_format="NCHW", name=None):
        super().__init__(padding, "constant", 0.0, data_format)


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis, self.eps = axis, eps

    def forward(self, x1, x2):
        return ops.cosine_similarity(x1, x2, axis=self.axis, eps=self.eps)


class PairwiseDistance(Layer):
    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__()
        self.p, self.epsilon, self.keepdim = p, epsilon, keepdim

    def forward(self, x, y):
        return ops.pairwise_distance(x, y, self.p, self.epsilon,
                                     self.keepdim)


class Bilinear(Layer):
    """out[b, o] = x1[b] · W[o] · x2[b] + bias[0, o]; W [out, in1, in2]."""

    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None):
        super().__init__()
        bound = 1 / math.sqrt(in1_features)
        self.weight = self.create_parameter(
            (out_features, in1_features, in2_features), attr=weight_attr,
            default_initializer=I.Uniform(-bound, bound))
        self.bias = self.create_parameter((1, out_features), attr=bias_attr,
                                          is_bias=True)

    def forward(self, x1, x2):
        out = ops.einsum("bi,oij,bj->bo", x1, self.weight, x2)
        return out + self.bias if self.bias is not None else out


class PixelShuffle(Layer):
    def __init__(self, upscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.upscale_factor = upscale_factor

    def forward(self, x):
        return ops.pixel_shuffle(x, self.upscale_factor)


class PixelUnshuffle(Layer):
    def __init__(self, downscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.downscale_factor = downscale_factor

    def forward(self, x):
        return ops.pixel_unshuffle(x, self.downscale_factor)


class Unfold(Layer):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1,
                 name=None):
        super().__init__()
        self.kernel_sizes, self.strides = kernel_sizes, strides
        self.paddings, self.dilations = paddings, dilations

    def forward(self, x):
        return ops.unfold(x, self.kernel_sizes, self.strides, self.paddings,
                          self.dilations)


__all__ = ["Identity", "Linear", "Embedding", "Dropout", "Dropout2D",
           "Dropout3D", "AlphaDropout", "Flatten", "Unflatten", "Upsample",
           "UpsamplingNearest2D", "UpsamplingBilinear2D", "Pad1D", "Pad2D",
           "Pad3D", "ZeroPad2D", "CosineSimilarity", "PairwiseDistance",
           "Bilinear", "PixelShuffle", "PixelUnshuffle", "Unfold"]
