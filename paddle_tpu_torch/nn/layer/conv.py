"""Convolution layers: the port of `paddle_tpu/nn/layer/conv.py`.
Weights [out, in / groups, *k] (transposed: [in, out / groups, *k]) drawn
from normal(0, √(2 / fan_in)) with fan_in = in / groups · ∏k, as the
reference's default; bias zero. `padding` and `data_format` take the
reference's forms (see `ops.nn_ops`); `padding_mode` is accepted and
ignored, as there."""
from __future__ import annotations

import numpy as np

from ... import ops
from .. import initializer as I
from .layers import Layer


def _ntuple(v, n):
    return tuple(v) if isinstance(v, (list, tuple)) else (v,) * n


class _ConvNd(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, nsp,
                 stride=1, padding=0, dilation=1, groups=1, transpose=False,
                 output_padding=0, padding_mode="zeros", weight_attr=None,
                 bias_attr=None, data_format="NCHW"):
        super().__init__()
        self.in_channels, self.out_channels = in_channels, out_channels
        self.kernel_size = _ntuple(kernel_size, nsp)
        self.stride, self.padding = stride, padding
        self.dilation, self.groups = dilation, groups
        self.output_padding = output_padding
        self.padding_mode = padding_mode
        self.data_format = data_format
        self._nsp = nsp
        if transpose:
            w_shape = (in_channels, out_channels // groups) + self.kernel_size
        else:
            w_shape = (out_channels, in_channels // groups) + self.kernel_size
        fan_in = (in_channels // groups) * int(np.prod(self.kernel_size))
        self.weight = self.create_parameter(
            w_shape, attr=weight_attr,
            default_initializer=I.Normal(0.0, (2.0 / fan_in) ** 0.5))
        self.bias = self.create_parameter((out_channels,), attr=bias_attr,
                                          is_bias=True)

    def extra_repr(self):
        return (f"{self.in_channels}, {self.out_channels}, "
                f"kernel_size={self.kernel_size}, stride={self.stride}")


class _Conv(_ConvNd):
    _op = None

    def forward(self, x):
        return self._op(x, self.weight, self.bias, self.stride, self.padding,
                        self.dilation, self.groups, self.data_format)


class _ConvT(_ConvNd):
    _op = None

    def forward(self, x):
        return self._op(x, self.weight, self.bias, self.stride, self.padding,
                        self.output_padding, self.dilation, self.groups,
                        self.data_format)


class Conv1D(_Conv):
    _op = staticmethod(ops.conv1d)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL"):
        super().__init__(in_channels, out_channels, kernel_size, 1, stride,
                         padding, dilation, groups, False, 0, padding_mode,
                         weight_attr, bias_attr, data_format)


class Conv2D(_Conv):
    _op = staticmethod(ops.conv2d)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__(in_channels, out_channels, kernel_size, 2, stride,
                         padding, dilation, groups, False, 0, padding_mode,
                         weight_attr, bias_attr, data_format)


class Conv3D(_Conv):
    _op = staticmethod(ops.conv3d)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCDHW"):
        super().__init__(in_channels, out_channels, kernel_size, 3, stride,
                         padding, dilation, groups, False, 0, padding_mode,
                         weight_attr, bias_attr, data_format)


class Conv1DTranspose(_ConvT):
    _op = staticmethod(ops.conv1d_transpose)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCL"):
        super().__init__(in_channels, out_channels, kernel_size, 1, stride,
                         padding, dilation, groups, True, output_padding,
                         "zeros", weight_attr, bias_attr, data_format)


class Conv2DTranspose(_ConvT):
    _op = staticmethod(ops.conv2d_transpose)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__(in_channels, out_channels, kernel_size, 2, stride,
                         padding, dilation, groups, True, output_padding,
                         "zeros", weight_attr, bias_attr, data_format)


class Conv3DTranspose(_ConvT):
    _op = staticmethod(ops.conv3d_transpose)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCDHW"):
        super().__init__(in_channels, out_channels, kernel_size, 3, stride,
                         padding, dilation, groups, True, output_padding,
                         "zeros", weight_attr, bias_attr, data_format)


__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose"]
