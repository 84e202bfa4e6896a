"""The fluid-era top-level names that the Paddle 2.0 namespace keeps (the
port of `paddle_tpu/compat.py`): `elementwise_*`, `reduce_*`, small
tensor ops (`addcmul`, `multiplex`, `tensordot`, `broadcast_shape`,
`crop_tensor`), the shape queries (`numel`, `rank`, `shape`, `is_empty`,
`has_inf`, `has_nan`), `set_printoptions`, `in_dynamic_mode`, the
dygraph toggles, the CUDA rng-state names and the legacy type aliases
(`VarBase`, `LoDTensor`, ...). Each is a thin alias over the port's ops:
no kernel of its own. The shape queries return tensors on their input's
device.

`get_cuda_rng_state()` / `set_cuda_rng_state(state)` read and write the
port's generator states (`core.rng`), a list with one entry of every
generator; `set_printoptions` sets torch's and numpy's print options.
"""
from __future__ import annotations

import numpy as np
import torch

from . import ops
from .core.tensor import Tensor


# ---- the elementwise_* names ----
def elementwise_add(x, y, axis=-1, name=None):
    return ops.add(x, y)


def elementwise_sub(x, y, axis=-1, name=None):
    return ops.subtract(x, y)


def elementwise_mul(x, y, axis=-1, name=None):
    return ops.multiply(x, y)


def elementwise_div(x, y, axis=-1, name=None):
    return ops.divide(x, y)


def elementwise_mod(x, y, axis=-1, name=None):
    return ops.mod(x, y)


def elementwise_pow(x, y, axis=-1, name=None):
    return ops.pow(x, y)


def elementwise_floordiv(x, y, axis=-1, name=None):
    return ops.floor_divide(x, y)


def elementwise_max(x, y, axis=-1, name=None):
    return ops.maximum(x, y)


def elementwise_min(x, y, axis=-1, name=None):
    return ops.minimum(x, y)


# ---- the reduce_* names ----
def reduce_sum(input, dim=None, keep_dim=False, name=None):  # noqa: A002
    return ops.sum(input, axis=dim, keepdim=keep_dim)


def reduce_mean(input, dim=None, keep_dim=False, name=None):  # noqa: A002
    return ops.mean(input, axis=dim, keepdim=keep_dim)


def reduce_max(input, dim=None, keep_dim=False, name=None):  # noqa: A002
    return ops.max(input, axis=dim, keepdim=keep_dim)


def reduce_min(input, dim=None, keep_dim=False, name=None):  # noqa: A002
    return ops.min(input, axis=dim, keepdim=keep_dim)


def reduce_prod(input, dim=None, keep_dim=False, name=None):  # noqa: A002
    return ops.prod(input, axis=dim, keepdim=keep_dim)


def reduce_all(input, dim=None, keep_dim=False, name=None):  # noqa: A002
    return ops.all(input, axis=dim, keepdim=keep_dim)


def reduce_any(input, dim=None, keep_dim=False, name=None):  # noqa: A002
    return ops.any(input, axis=dim, keepdim=keep_dim)


# ---- small tensor ops ----
def addcmul(input, tensor1, tensor2, value=1.0, name=None):  # noqa: A002
    return ops.add(input, ops.multiply(ops.multiply(tensor1, tensor2),
                                       value))


def multiplex(inputs, index, name=None):
    """Row b of the output is row b of inputs[index[b]]."""
    stacked = torch.stack(list(inputs), dim=0)  # [n, batch, ...]
    idx = index if torch.is_tensor(index) else torch.as_tensor(
        np.asarray(index))
    flat = idx.reshape(-1).to(device=stacked.device, dtype=torch.int64)
    return stacked[flat, torch.arange(stacked.shape[1],
                                      device=stacked.device)]


def tensordot(x, y, axes=2, name=None):
    if torch.is_tensor(axes):
        axes = axes.tolist()
    return torch.tensordot(x, y, dims=axes)


def broadcast_shape(x_shape, y_shape):
    return list(np.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


def crop_tensor(x, shape=None, offsets=None, name=None):
    return ops.crop(x, shape, offsets)


def numel(x, name=None):
    return torch.tensor(x.numel(), dtype=torch.int64, device=x.device)


def rank(input, name=None):  # noqa: A002
    return torch.tensor(input.dim(), dtype=torch.int32, device=input.device)


def shape(input, name=None):  # noqa: A002
    return torch.tensor(list(input.shape), dtype=torch.int32,
                        device=input.device)


def is_empty(x, name=None):
    return torch.tensor(x.numel() == 0, device=x.device)


def has_inf(x, name=None):
    return ops.any(ops.isinf(x))


def has_nan(x, name=None):
    return ops.any(ops.isnan(x))


def get_tensor_from_selected_rows(x, name=None):
    return x


def set_printoptions(precision=None, threshold=None, edgeitems=None,
                     sci_mode=None, linewidth=None):
    kw = {"precision": precision, "threshold": threshold,
          "edgeitems": edgeitems, "linewidth": linewidth}
    kw = {k: v for k, v in kw.items() if v is not None}
    torch.set_printoptions(sci_mode=sci_mode, **kw)
    if sci_mode is not None:
        kw["suppress"] = not sci_mode
    np.set_printoptions(**kw)


# ---- the legacy type aliases ----
VarBase = Tensor
LoDTensor = Tensor
LoDTensorArray = list
ComplexVariable = Tensor
ComplexTensor = Tensor


def in_dynamic_mode():
    """The 2.0 spelling of in_dygraph_mode."""
    from .core.mode import in_dygraph_mode
    return in_dygraph_mode()


def reverse(x, axis):
    """fluid.layers.reverse: flip along `axis`."""
    return ops.flip(x, axis)


# ---- the dygraph toggles ----
def enable_dygraph(place=None):
    from .core.mode import disable_static
    disable_static()


def disable_dygraph():
    from .core.mode import enable_static
    enable_static()


# ---- the CUDA rng-state names over the port's generators ----
def get_cuda_rng_state():
    from .core import rng
    return [rng.get_rng_state()]


def set_cuda_rng_state(state):
    from .core import rng
    if state:
        rng.set_rng_state(state[0])


def get_cudnn_version():
    from .device import get_cudnn_version as version
    return version()


def monkey_patch_math_varbase():  # pragma: no cover - nothing to patch:
    pass                          # the tensor is torch's


def monkey_patch_variable():  # pragma: no cover
    pass


# a star-import exports the legacy names only (not np, torch, ops, Tensor)
__all__ = [_n for _n in list(globals())
           if not _n.startswith("_")
           and _n not in ("np", "torch", "ops", "Tensor", "annotations")]
