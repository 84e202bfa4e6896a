"""Weight initializers: the port of `paddle_tpu/nn/initializer/`.

Each initializer is a callable `(shape, dtype=None, device=None,
generator=None) -> tensor` on `device` (None: the default device)
drawing from `generator` (None: the port's seeded generator of that
device, `core.rng`). The bits are torch's; the arithmetic is the
reference's:

  * `Uniform(low, high)`, `Normal(mean, std)`, `TruncatedNormal(mean,
    std)` (cut at ±2 standard deviations), `Constant(value)`;
  * fans (`_fans`): a 2-D weight is [fan_in, fan_out] (Linear's [in,
    out]); a conv weight [out, in, *k] has fan_in = in · ∏k and fan_out =
    out · ∏k; a 1-D one its length for both;
  * `XavierUniform` bound gain · √(6 / (fan_in + fan_out)),
    `XavierNormal` std gain · √(2 / (fan_in + fan_out)),
    `KaimingUniform` bound √(2 / (1 + a²)) · √(3 / fan_in),
    `KaimingNormal` std √(2 / (1 + a²)) / √fan_in;
  * `Assign(value)`, `Orthogonal(gain)`, `Dirac(groups)`, `Bilinear()`
    (the upsampling kernel of a transposed conv), and
    `set_global_initializer`.
"""
from __future__ import annotations

import math
import sys

import numpy as np
import torch

from ..core import dtype as dtype_mod
from ..core import rng
from ..device import resolve_device


class Initializer:
    def __call__(self, shape, dtype=None, device=None, generator=None):
        dev = resolve_device(device) if generator is None \
            else (torch.device(device) if device is not None
                  else generator.device)
        g = generator if generator is not None else rng.generator(dev)
        t = torch.empty(tuple(int(s) for s in shape),
                        dtype=dtype_mod.convert_dtype(dtype), device=dev)
        with torch.no_grad():
            return self._fill(t, g)

    def _fill(self, t, g):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def _fill(self, t, g):
        return t.fill_(self.value)


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def _fill(self, t, g):
        return t.uniform_(self.low, self.high, generator=g)


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def _fill(self, t, g):
        return t.normal_(self.mean, self.std, generator=g)


class TruncatedNormal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def _fill(self, t, g):
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=g)
        return t.mul_(self.std).add_(self.mean)


def _fans(shape):
    shape = tuple(shape)
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    rf = int(np.prod(shape[2:]))  # conv kernels [out, in, *k]
    return shape[1] * rf, shape[0] * rf


class _Xavier(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def _fan(self, shape):
        fi, fo = _fans(shape)
        return (self.fan_in if self.fan_in is not None else fi,
                self.fan_out if self.fan_out is not None else fo)


class XavierUniform(_Xavier):
    def limit(self, shape):
        fi, fo = self._fan(shape)
        return self.gain * math.sqrt(6.0 / (fi + fo))

    def _fill(self, t, g):
        lim = self.limit(t.shape)
        return t.uniform_(-lim, lim, generator=g)


class XavierNormal(_Xavier):
    def std(self, shape):
        fi, fo = self._fan(shape)
        return self.gain * math.sqrt(2.0 / (fi + fo))

    def _fill(self, t, g):
        return t.normal_(0.0, self.std(t.shape), generator=g)


class _Kaiming(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope

    def _gain_fan(self, shape):
        fi, _ = _fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        return math.sqrt(2.0 / (1 + self.negative_slope ** 2)), fi


class KaimingUniform(_Kaiming):
    def limit(self, shape):
        gain, fi = self._gain_fan(shape)
        return gain * math.sqrt(3.0 / fi)

    def _fill(self, t, g):
        lim = self.limit(t.shape)
        return t.uniform_(-lim, lim, generator=g)


class KaimingNormal(_Kaiming):
    def std(self, shape):
        gain, fi = self._gain_fan(shape)
        return gain / math.sqrt(fi)

    def _fill(self, t, g):
        return t.normal_(0.0, self.std(t.shape), generator=g)


class Assign(Initializer):
    def __init__(self, value):
        self.value = value

    def _fill(self, t, g):
        v = self.value
        v = v.detach() if torch.is_tensor(v) else torch.as_tensor(
            np.asarray(v))
        return t.copy_(v.reshape(t.shape))


class Orthogonal(Initializer):
    def __init__(self, gain=1.0):
        self.gain = gain

    def _fill(self, t, g):
        rows = t.shape[0] if t.dim() else 1
        cols = int(np.prod(t.shape[1:])) if t.dim() > 1 else 1
        flat = torch.empty(max(rows, cols), min(rows, cols),
                           dtype=torch.float32, device=t.device) \
            .normal_(generator=g)
        q, r = torch.linalg.qr(flat)
        q = q * torch.sign(torch.diagonal(r))
        q = q.T if rows < cols else q
        return t.copy_(self.gain * q[:rows, :cols].reshape(t.shape))


class Dirac(Initializer):
    def __init__(self, groups=1):
        self.groups = groups

    def _fill(self, t, g):
        t.zero_()
        oc, ic = t.shape[0], t.shape[1]
        mid = tuple(s // 2 for s in t.shape[2:])
        for grp in range(self.groups):
            for i in range(min(oc // self.groups, ic)):
                t[(grp * (oc // self.groups) + i, i) + mid] = 1.0
        return t


class Bilinear(Initializer):
    """The bilinear upsampling kernel of a 4-D transposed-conv weight
    (ref: fluid BilinearInitializer)."""

    def _fill(self, t, g):
        if t.dim() != 4:
            raise ValueError("Bilinear initializer expects a 4-D weight")
        _, _, h, w = t.shape
        f = np.ceil(w / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        val = (1 - np.abs(xs / f - c)) * (1 - np.abs(ys / f - c))
        return t.copy_(torch.as_tensor(val, dtype=t.dtype).expand(t.shape))


# fluid-era aliases
ConstantInitializer = Constant
UniformInitializer = Uniform
NormalInitializer = Normal
TruncatedNormalInitializer = TruncatedNormal
XavierInitializer = XavierUniform
MSRAInitializer = KaimingNormal
NumpyArrayInitializer = Assign


def calculate_gain(nonlinearity, param=None):
    gains = {"sigmoid": 1.0, "linear": 1.0, "conv1d": 1.0, "conv2d": 1.0,
             "conv3d": 1.0, "tanh": 5.0 / 3, "relu": math.sqrt(2.0),
             "leaky_relu": math.sqrt(2.0 / (1 + (param or 0.01) ** 2)),
             "selu": 3.0 / 4}
    return gains[nonlinearity]


_global_initializer = {"weight": None, "bias": None}


def set_global_initializer(weight_init, bias_init=None):
    """The default initializer of parameters created afterwards."""
    _global_initializer["weight"] = weight_init
    _global_initializer["bias"] = bias_init


__all__ = ["Initializer", "Constant", "Uniform", "Normal", "TruncatedNormal",
           "XavierUniform", "XavierNormal", "KaimingUniform",
           "KaimingNormal", "Assign", "Orthogonal", "Dirac", "Bilinear",
           "ConstantInitializer", "UniformInitializer", "NormalInitializer",
           "TruncatedNormalInitializer", "XavierInitializer",
           "MSRAInitializer", "NumpyArrayInitializer", "calculate_gain",
           "set_global_initializer"]

# the reference's initializer submodule paths are aliases of this module
assign = constant = kaiming = normal = uniform = xavier = \
    sys.modules[__name__]
