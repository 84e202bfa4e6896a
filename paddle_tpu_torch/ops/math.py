"""Elementwise math, reductions, cumulative ops, comparisons and logic:
the port of `paddle_tpu/ops/math.py` as module functions over
`torch.Tensor`, with Paddle's signatures (`axis`, `keepdim`, lists of
axes) and the reference's semantics:

  * `std` / `var` are unbiased by default (`unbiased=True`);
  * `mean` of an integer tensor is taken in the default float dtype;
  * `cumsum` / `cumprod` / `cummax` / `cummin` with no axis run over the
    flattened tensor; `cummax` / `cummin` give the values only, as the
    reference does;
  * `floor_divide` floors, `remainder` takes the divisor's sign;
  * `equal_all` / `allclose` give a 0-d bool tensor.
Either operand of a binary op may be a Python number.
"""
from __future__ import annotations

import builtins

import torch

from ..core import dtype as dtype_mod


def _axis(axis):
    """None, an int, or a tuple of ints."""
    if axis is None:
        return None
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


def _all_dims(x, axis):
    a = _axis(axis)
    if a is None:
        return tuple(range(x.dim()))
    return a if isinstance(a, tuple) else (a,)


def _tensor(x, like):
    return x if torch.is_tensor(x) else torch.as_tensor(x, device=like.device)


# ---------------------------------------------------------------- binary ----

def add(x, y):
    return x + y


def subtract(x, y):
    return x - y


def multiply(x, y):
    return x * y


def divide(x, y):
    if torch.is_tensor(x):
        return torch.true_divide(x, y)
    return torch.true_divide(_tensor(x, y), y)


def floor_divide(x, y):
    if not torch.is_tensor(x):
        x = _tensor(x, y)
    return torch.div(x, y, rounding_mode="floor")


def remainder(x, y):
    return x % y


mod = remainder
floor_mod = remainder


def pow(x, y):  # noqa: A001
    return x ** y


def maximum(x, y):
    return torch.maximum(_tensor(x, y), _tensor(y, x))


def minimum(x, y):
    return torch.minimum(_tensor(x, y), _tensor(y, x))


def fmax(x, y):
    return torch.fmax(_tensor(x, y), _tensor(y, x))


def fmin(x, y):
    return torch.fmin(_tensor(x, y), _tensor(y, x))


def atan2(x, y):
    return torch.atan2(x, y)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None):
    return x * scale + bias if bias_after_scale else (x + bias) * scale


def add_n(xs):
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return out


def lerp(x, y, weight):
    return x + weight * (y - x)


# ----------------------------------------------------------------- unary ----

exp = torch.exp
expm1 = torch.expm1
log = torch.log
log2 = torch.log2
log10 = torch.log10
log1p = torch.log1p
sqrt = torch.sqrt
rsqrt = torch.rsqrt
abs = torch.abs  # noqa: A001
square = torch.square
reciprocal = torch.reciprocal
sin = torch.sin
cos = torch.cos
tan = torch.tan
asin = torch.asin
acos = torch.acos
atan = torch.atan
sinh = torch.sinh
cosh = torch.cosh
tanh = torch.tanh
asinh = torch.asinh
acosh = torch.acosh
atanh = torch.atanh
erf = torch.erf
erfinv = torch.erfinv
ceil = torch.ceil
floor = torch.floor
round = torch.round  # noqa: A001  (half to even, as jnp.round)
trunc = torch.trunc
sign = torch.sign
neg = torch.neg
digamma = torch.digamma
lgamma = torch.lgamma
isnan = torch.isnan
isinf = torch.isinf
isfinite = torch.isfinite


def clip(x, min=None, max=None):  # noqa: A002
    return torch.clamp(x, min, max)


def increment(x, value=1.0):
    return x + value


def logical_and(x, y):
    return torch.logical_and(x, _tensor(y, x))


def logical_or(x, y):
    return torch.logical_or(x, _tensor(y, x))


def logical_xor(x, y):
    return torch.logical_xor(x, _tensor(y, x))


def logical_not(x):
    return torch.logical_not(x)


def bitwise_and(x, y):
    return torch.bitwise_and(x, y)


def bitwise_or(x, y):
    return torch.bitwise_or(x, y)


def bitwise_xor(x, y):
    return torch.bitwise_xor(x, y)


def bitwise_not(x):
    return torch.bitwise_not(x)


# ----------------------------------------------------------- comparisons ----

def equal(x, y):
    return torch.eq(x, y)


def not_equal(x, y):
    return torch.ne(x, y)


def less_than(x, y):
    return torch.lt(x, y)


def less_equal(x, y):
    return torch.le(x, y)


def greater_than(x, y):
    return torch.gt(x, y)


def greater_equal(x, y):
    return torch.ge(x, y)


def equal_all(x, y):
    same = x.shape == y.shape and builtins.bool(torch.equal(x, y))
    return torch.tensor(same, device=x.device)


def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False):
    return torch.tensor(torch.allclose(x, y, rtol, atol, equal_nan),
                        device=x.device)


def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False):
    return torch.isclose(x, y, rtol, atol, equal_nan)


def is_complex(x):
    return x.dtype.is_complex


def is_floating_point(x):
    return x.dtype.is_floating_point


def is_integer(x):
    return dtype_mod.is_integer(x.dtype)


# ------------------------------------------------------------ reductions ----

def sum(x, axis=None, dtype=None, keepdim=False):  # noqa: A001
    dt = None if dtype is None else dtype_mod.convert_dtype(dtype)
    if x.dtype == torch.bool and dt is None:
        dt = torch.int64
    return torch.sum(x, dim=_axis(axis), keepdim=keepdim, dtype=dt)


def mean(x, axis=None, keepdim=False):
    if not (x.dtype.is_floating_point or x.dtype.is_complex):
        x = x.to(dtype_mod.convert_dtype(None))
    return torch.mean(x, dim=_axis(axis), keepdim=keepdim)


def max(x, axis=None, keepdim=False):  # noqa: A001
    return torch.amax(x, dim=_all_dims(x, axis), keepdim=keepdim)


def min(x, axis=None, keepdim=False):  # noqa: A001
    return torch.amin(x, dim=_all_dims(x, axis), keepdim=keepdim)


def prod(x, axis=None, keepdim=False, dtype=None):
    if dtype is not None:
        x = x.to(dtype_mod.convert_dtype(dtype))
    if x.dim() == 0 or (axis is None and not keepdim):
        return torch.prod(x)
    for d in sorted((d % x.dim() for d in _all_dims(x, axis)),
                    reverse=True):
        x = torch.prod(x, dim=d, keepdim=keepdim)
    return x


def all(x, axis=None, keepdim=False):  # noqa: A001
    return torch.all(x.bool(), dim=_all_dims(x, axis), keepdim=keepdim)


def any(x, axis=None, keepdim=False):  # noqa: A001
    return torch.any(x.bool(), dim=_all_dims(x, axis), keepdim=keepdim)


def logsumexp(x, axis=None, keepdim=False):
    return torch.logsumexp(x, dim=_all_dims(x, axis), keepdim=keepdim)


def std(x, axis=None, unbiased=True, keepdim=False):
    return torch.std(x, dim=_axis(axis), correction=1 if unbiased else 0,
                     keepdim=keepdim)


def var(x, axis=None, unbiased=True, keepdim=False):
    return torch.var(x, dim=_axis(axis), correction=1 if unbiased else 0,
                     keepdim=keepdim)


def count_nonzero(x, axis=None, keepdim=False):
    dims = _all_dims(x, axis)
    out = torch.count_nonzero(x, dim=dims)
    if keepdim:
        for d in sorted(d % x.dim() for d in dims):
            out = out.unsqueeze(d)
    return out


def _flat_axis(x, axis):
    return (x.reshape(-1), 0) if axis is None else (x, int(axis))


def cumsum(x, axis=None, dtype=None):
    x, axis = _flat_axis(x, axis)
    return torch.cumsum(x, dim=axis, dtype=None if dtype is None
                        else dtype_mod.convert_dtype(dtype))


def cumprod(x, dim=None, dtype=None):
    x, dim = _flat_axis(x, dim)
    return torch.cumprod(x, dim=dim, dtype=None if dtype is None
                         else dtype_mod.convert_dtype(dtype))


def cummax(x, axis=None):
    x, axis = _flat_axis(x, axis)
    return torch.cummax(x, dim=axis).values


def cummin(x, axis=None):
    x, axis = _flat_axis(x, axis)
    return torch.cummin(x, dim=axis).values


def trace(x, offset=0, axis1=0, axis2=1):
    return torch.diagonal(x, offset, axis1, axis2).sum(-1)


def kron(x, y):
    return torch.kron(x, y)


def nan_to_num(x, nan=0.0, posinf=None, neginf=None):
    return torch.nan_to_num(x, nan, posinf, neginf)


def nan_to_num_(x, nan=0.0, posinf=None, neginf=None):
    """The reference's `nan_to_num_` (`paddle_tpu/ops/math.py:377`): the
    same values as `nan_to_num`, a new tensor that carries no gradient."""
    return torch.nan_to_num(x.detach(), nan, posinf, neginf)


__all__ = [
    "add", "subtract", "multiply", "divide", "floor_divide", "remainder",
    "mod", "floor_mod", "pow", "maximum", "minimum", "fmax", "fmin",
    "atan2", "scale", "add_n", "lerp", "exp", "expm1", "log", "log2",
    "log10", "log1p", "sqrt", "rsqrt", "abs", "square", "reciprocal", "sin",
    "cos", "tan", "asin", "acos", "atan", "sinh", "cosh", "tanh", "asinh",
    "acosh", "atanh", "erf", "erfinv", "ceil", "floor", "round", "trunc",
    "sign", "neg", "digamma", "lgamma", "isnan", "isinf", "isfinite",
    "clip", "increment", "logical_and", "logical_or", "logical_xor",
    "logical_not", "bitwise_and", "bitwise_or", "bitwise_xor",
    "bitwise_not", "equal", "not_equal", "less_than", "less_equal",
    "greater_than", "greater_equal", "equal_all", "allclose", "isclose",
    "is_complex", "is_floating_point", "is_integer", "sum", "mean", "max",
    "min", "prod", "all", "any", "logsumexp", "std", "var",
    "count_nonzero", "cumsum", "cumprod", "cummax", "cummin", "trace",
    "kron", "nan_to_num", "nan_to_num_"]
