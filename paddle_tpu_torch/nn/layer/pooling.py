"""Pooling layers: the port of `paddle_tpu/nn/layer/pooling.py` (the ops'
semantics: -inf padding for max, `exclusive` averages by default)."""
from __future__ import annotations

from ... import ops
from .layers import Layer


class _Pool(Layer):
    def __init__(self, kernel_size=None, stride=None, padding=0,
                 ceil_mode=False, data_format="NCHW", name=None, **kw):
        super().__init__()
        self.kernel_size, self.stride = kernel_size, stride
        self.padding, self.ceil_mode = padding, ceil_mode
        self.data_format = data_format
        self._kw = kw


class MaxPool1D(_Pool):
    def forward(self, x):
        return ops.max_pool1d(x, self.kernel_size, self.stride, self.padding,
                              self.ceil_mode)


class MaxPool2D(_Pool):
    def forward(self, x):
        return ops.max_pool2d(x, self.kernel_size, self.stride, self.padding,
                              self.ceil_mode, self.data_format)


class MaxPool3D(_Pool):
    def __init__(self, kernel_size=None, stride=None, padding=0,
                 ceil_mode=False, data_format="NCDHW", name=None, **kw):
        super().__init__(kernel_size, stride, padding, ceil_mode,
                         data_format, name, **kw)

    def forward(self, x):
        return ops.max_pool3d(x, self.kernel_size, self.stride, self.padding,
                              self.ceil_mode, self.data_format)


class AvgPool1D(_Pool):
    def forward(self, x):
        return ops.avg_pool1d(x, self.kernel_size, self.stride, self.padding,
                              self._kw.get("exclusive", True),
                              self.ceil_mode)


class AvgPool2D(_Pool):
    def forward(self, x):
        return ops.avg_pool2d(x, self.kernel_size, self.stride, self.padding,
                              self.ceil_mode, self._kw.get("exclusive", True),
                              None, self.data_format)


class AvgPool3D(_Pool):
    def __init__(self, kernel_size=None, stride=None, padding=0,
                 ceil_mode=False, data_format="NCDHW", name=None, **kw):
        super().__init__(kernel_size, stride, padding, ceil_mode,
                         data_format, name, **kw)

    def forward(self, x):
        return ops.avg_pool3d(x, self.kernel_size, self.stride, self.padding,
                              self.ceil_mode, self._kw.get("exclusive", True),
                              self.data_format)


class AdaptiveAvgPool1D(Layer):
    def __init__(self, output_size, name=None):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return ops.adaptive_avg_pool1d(x, self.output_size)


class AdaptiveAvgPool2D(Layer):
    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__()
        self.output_size, self.data_format = output_size, data_format

    def forward(self, x):
        return ops.adaptive_avg_pool2d(x, self.output_size, self.data_format)


class AdaptiveAvgPool3D(Layer):
    def __init__(self, output_size, data_format="NCDHW", name=None):
        super().__init__()
        self.output_size, self.data_format = output_size, data_format

    def forward(self, x):
        return ops.adaptive_avg_pool3d(x, self.output_size, self.data_format)


class AdaptiveMaxPool1D(Layer):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return ops.adaptive_max_pool1d(x, self.output_size)


class AdaptiveMaxPool2D(Layer):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return ops.adaptive_max_pool2d(x, self.output_size)


__all__ = ["MaxPool1D", "MaxPool2D", "MaxPool3D", "AvgPool1D", "AvgPool2D",
           "AvgPool3D", "AdaptiveAvgPool1D", "AdaptiveAvgPool2D",
           "AdaptiveAvgPool3D", "AdaptiveMaxPool1D", "AdaptiveMaxPool2D"]
