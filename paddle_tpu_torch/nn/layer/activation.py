"""Activation layers: the port of `paddle_tpu/nn/layer/activation.py`
(each a `Layer` over the op of its name, positional arguments mapping
onto the op's keywords in order), with `PReLU` (a learnt slope, one or
one per channel, init 0.25) and `Maxout`."""
from __future__ import annotations

from ... import ops
from .. import initializer as I
from .layers import Layer


def _make(name, op_name=None, **defaults):
    op = getattr(ops, op_name or name.lower())

    class _Act(Layer):
        def __init__(self, *args, **kwargs):
            super().__init__()
            kw = dict(defaults)
            for k, v in zip(defaults, args):
                kw[k] = v
            for k in kwargs:
                if k in kw:
                    kw[k] = kwargs[k]
            self._kw = kw

        def forward(self, x):
            return op(x, **self._kw)

    _Act.__name__ = name
    _Act.__qualname__ = name
    return _Act


ReLU = _make("ReLU")
ReLU6 = _make("ReLU6")
ELU = _make("ELU", alpha=1.0)
SELU = _make("SELU")
CELU = _make("CELU", alpha=1.0)
GELU = _make("GELU", approximate=False)
Sigmoid = _make("Sigmoid")
LogSigmoid = _make("LogSigmoid", "log_sigmoid")
Hardsigmoid = _make("Hardsigmoid")
Hardswish = _make("Hardswish")
Hardtanh = _make("Hardtanh", min=-1.0, max=1.0)
Swish = _make("Swish")
Silu = _make("Silu")
Mish = _make("Mish")
Softplus = _make("Softplus", beta=1.0, threshold=20.0)
Softsign = _make("Softsign")
Softshrink = _make("Softshrink", threshold=0.5)
Hardshrink = _make("Hardshrink", threshold=0.5)
Tanhshrink = _make("Tanhshrink")
ThresholdedReLU = _make("ThresholdedReLU", "thresholded_relu", threshold=1.0)
Tanh = _make("Tanh")
LeakyReLU = _make("LeakyReLU", "leaky_relu", negative_slope=0.01)
Softmax = _make("Softmax", axis=-1)
LogSoftmax = _make("LogSoftmax", "log_softmax", axis=-1)
GLU = _make("GLU", axis=-1)


class PReLU(Layer):
    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None):
        super().__init__()
        self.weight = self.create_parameter(
            (num_parameters,), attr=weight_attr,
            default_initializer=I.Constant(init))

    def forward(self, x):
        return ops.prelu(x, self.weight)


class Maxout(Layer):
    def __init__(self, groups, axis=1, name=None):
        super().__init__()
        self.groups, self.axis = groups, axis

    def forward(self, x):
        return ops.maxout(x, self.groups, self.axis)


__all__ = ["ReLU", "ReLU6", "ELU", "SELU", "CELU", "GELU", "Sigmoid",
           "LogSigmoid", "Hardsigmoid", "Hardswish", "Hardtanh", "Swish",
           "Silu", "Mish", "Softplus", "Softsign", "Softshrink",
           "Hardshrink", "Tanhshrink", "ThresholdedReLU", "Tanh",
           "LeakyReLU", "Softmax", "LogSoftmax", "GLU", "PReLU", "Maxout"]
