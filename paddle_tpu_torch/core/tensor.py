"""Tensors: the port of `paddle_tpu/core/tensor.py`.

The port's tensor is `torch.Tensor` itself — no wrapper class and no
method patched onto torch's — and Paddle's tensor functions are module
functions of the port (`reshape(x, shape)`, `cast(x, dtype)`, ...).
`stop_gradient` becomes `requires_grad`, negated, at the API's edges:
`to_tensor(stop_gradient=...)` and `Parameter` creation.

`to_tensor(data, dtype=None, place=None, stop_gradient=True)` copies
`data` (a number, list, numpy array or tensor) onto `place` (None: the
default device, `device.resolve_device`); float64 numpy data with no
dtype becomes float32, the reference's rule (`core/tensor.py:30-31`).

`Parameter` is `torch.nn.Parameter`; `make_parameter` gives one the
reference's fields as attributes — `trainable`, `regularizer`,
`optimize_attr` ({"learning_rate": scale}), `need_clip`,
`is_distributed`, which the port's optimizers and clips read — and its
name as `param_name` (torch's `Tensor.name` cannot be set).
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from . import dtype as dtype_mod

Parameter = torch.nn.Parameter
Tensor = torch.Tensor


def _as_tensor(data, dtype=None):
    if torch.is_tensor(data):
        t = data.detach()
        return t if dtype is None else t.to(dtype_mod.convert_dtype(dtype))
    arr = np.asarray(data)
    if dtype is None and arr.dtype == np.float64:
        arr = arr.astype(np.float32)  # paddle default: fp32
    t = torch.from_numpy(np.ascontiguousarray(arr))
    return t if dtype is None else t.to(dtype_mod.convert_dtype(dtype))


def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    """paddle.to_tensor: a new tensor on `place` (None: the default
    device) that requires a gradient when `stop_gradient` is False."""
    dev = resolve_device(place)
    t = _as_tensor(data, dtype).to(dev, copy=True)
    if not stop_gradient:
        t.requires_grad_(True)
    return t


def is_tensor(x) -> bool:
    return torch.is_tensor(x)


def make_parameter(value, name=None, trainable=True, regularizer=None,
                   learning_rate=1.0, need_clip=True):
    """A torch.nn.Parameter holding `value`, with the reference's
    Parameter fields as attributes; `trainable` False stops its
    gradient."""
    p = torch.nn.Parameter(value.detach(), requires_grad=bool(trainable))
    p.param_name = name
    p.trainable = bool(trainable)
    p.regularizer = regularizer
    p.optimize_attr = {"learning_rate": learning_rate}
    p.need_clip = need_clip
    p.is_distributed = False
    return p


__all__ = ["Tensor", "Parameter", "to_tensor", "is_tensor",
           "make_parameter"]
