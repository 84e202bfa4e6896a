"""Creation ops: the port of `paddle_tpu/ops/creation.py`. The ops with
no tensor input put their result on the default device
(`device.resolve_device`: the card, or the CPU after
`set_device("cpu")`) in the default float dtype unless a dtype is given;
the `*_like` ops follow their input."""
from __future__ import annotations

import torch

from ..core import dtype as dtype_mod
from ..core.tensor import to_tensor
from ..device import resolve_device


def _shape(shape):
    if torch.is_tensor(shape):
        shape = shape.tolist()
    if isinstance(shape, int):
        return (shape,)
    return tuple(int(s) for s in shape)


def _dt(dtype):
    return dtype_mod.convert_dtype(dtype)


def _opt_dt(dtype):
    return None if dtype is None else dtype_mod.convert_dtype(dtype)


def zeros(shape, dtype=None):
    return torch.zeros(_shape(shape), dtype=_dt(dtype),
                       device=resolve_device())


def ones(shape, dtype=None):
    return torch.ones(_shape(shape), dtype=_dt(dtype),
                      device=resolve_device())


def full(shape, fill_value, dtype=None):
    if dtype is None and isinstance(fill_value, bool):
        dtype = "bool"
    elif dtype is None and isinstance(fill_value, int):
        dtype = "int64"
    return torch.full(_shape(shape), fill_value, dtype=_dt(dtype),
                      device=resolve_device())


def zeros_like(x, dtype=None):
    return torch.zeros_like(x, dtype=_opt_dt(dtype))


def ones_like(x, dtype=None):
    return torch.ones_like(x, dtype=_opt_dt(dtype))


def full_like(x, fill_value, dtype=None):
    return torch.full_like(x, fill_value, dtype=_opt_dt(dtype))


def arange(start=0, end=None, step=1, dtype=None):
    if end is None:
        start, end = 0, start
    return torch.arange(start, end, step, dtype=_opt_dt(dtype),
                        device=resolve_device())


def linspace(start, stop, num, dtype=None):
    return torch.linspace(start, stop, int(num), dtype=_dt(dtype),
                          device=resolve_device())


def logspace(start, stop, num, base=10.0, dtype=None):
    return torch.logspace(start, stop, int(num), base=base,
                          dtype=_dt(dtype), device=resolve_device())


def eye(num_rows, num_columns=None, dtype=None):
    return torch.eye(num_rows, num_columns if num_columns is not None
                     else num_rows, dtype=_dt(dtype),
                     device=resolve_device())


def tril(x, diagonal=0):
    return torch.tril(x, diagonal)


def triu(x, diagonal=0):
    return torch.triu(x, diagonal)


def diag(x, offset=0, padding_value=0):
    d = torch.diag(x, offset)
    if x.dim() == 1 and padding_value != 0:
        on = torch.ones_like(x, dtype=torch.bool)
        return torch.where(torch.diag(on, offset), d, padding_value)
    return d


def diagflat(x, offset=0):
    return torch.diagflat(x, offset)


def diag_embed(x, offset=0, dim1=-2, dim2=-1):
    return torch.diag_embed(x, offset, dim1, dim2)


def meshgrid(*xs):
    xs = xs[0] if len(xs) == 1 and isinstance(xs[0], (list, tuple)) else xs
    return tuple(torch.meshgrid(*xs, indexing="ij"))


def assign(x):
    return x.clone() if torch.is_tensor(x) else to_tensor(x)


def clone(x):
    return x.clone()


def empty(shape, dtype=None):
    return zeros(shape, dtype)


def empty_like(x, dtype=None):
    return torch.zeros_like(x, dtype=_opt_dt(dtype))


def complex_(real, imag):
    return torch.complex(real, imag)


__all__ = ["zeros", "ones", "full", "zeros_like", "ones_like", "full_like",
           "arange", "linspace", "logspace", "eye", "tril", "triu", "diag",
           "diagflat", "diag_embed", "meshgrid", "assign", "clone", "empty",
           "empty_like", "complex_"]
