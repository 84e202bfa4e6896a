"""paddle.incubate.complex of the port (the reference's
`paddle_tpu/incubate/complex.py`, Paddle's
python/paddle/incubate/complex/tensor/): a ComplexVariable is a tensor
of a complex dtype; real inputs are cast to complex64 and every op is
torch's."""
from __future__ import annotations

import torch

__all__ = [
    "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "kron", "trace", "sum", "matmul", "reshape",
    "transpose",
]


def _c(x):
    t = torch.as_tensor(x)
    return t if t.is_complex() else t.to(torch.complex64)


def elementwise_add(x, y, axis=-1, name=None):
    return _c(x) + _c(y)


def elementwise_sub(x, y, axis=-1, name=None):
    return _c(x) - _c(y)


def elementwise_mul(x, y, axis=-1, name=None):
    return _c(x) * _c(y)


def elementwise_div(x, y, axis=-1, name=None):
    return _c(x) / _c(y)


def kron(x, y, name=None):
    return torch.kron(_c(x), _c(y))


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, name=None):
    a, b = _c(x), _c(y)
    if transpose_x:
        a = a.transpose(-1, -2)
    if transpose_y:
        b = b.transpose(-1, -2)
    return alpha * (a @ b)


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return torch.diagonal(_c(x), offset, axis1, axis2).sum(-1)


def sum(x, axis=None, keepdim=False, name=None):  # noqa: A001
    a = _c(x)
    if axis is None:
        return a.sum()
    return a.sum(dim=axis, keepdim=keepdim)


def reshape(x, shape, inplace=False, name=None):
    return _c(x).reshape(tuple(shape))


def transpose(x, perm, name=None):
    return _c(x).permute(*perm)
