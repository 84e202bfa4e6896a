"""fluid.core — the 1.x C++-core attribute surface (the port of
`paddle_tpu/fluid/core.py`; ref: python/paddle/fluid/__init__.py:71).

Reference-era user code reaches the compiled core directly
(`fluid.core.CPUPlace()`, `fluid.core.Scope()`, `fluid.core.LoDTensor`).
There is no separate C++ tensor type here: a LoDTensor and a VarBase are
the framework tensor (`torch.Tensor`; LoD is retired for padding and
masks), and a Scope is the static Executor's name -> value mapping.
"""
from __future__ import annotations

import torch

from ..core.tensor import Tensor  # noqa: F401
from ..device import (  # noqa: F401
    CPUPlace, CUDAPinnedPlace, CUDAPlace, Place, TPUPlace, XPUPlace)
from ..static.executor import Scope  # noqa: F401

LoDTensor = Tensor
LoDTensorArray = list
VarBase = Tensor
_Scope = Scope

NPUPlace = TPUPlace  # accepted, mapped to the accelerator place
IPUPlace = TPUPlace
MLUPlace = TPUPlace


def is_compiled_with_cuda():
    return torch.cuda.is_available()


def is_compiled_with_xpu():
    return False


def is_compiled_with_npu():
    return False


def is_compiled_with_rocm():
    return False


def get_cuda_device_count():
    return torch.cuda.device_count()


def _cuda_synchronize(place=None):
    """Block until the card's queued work is done (ref:
    core._cuda_synchronize): `torch.cuda.synchronize` on the place's
    card; a no-op only for a CPU place."""
    if isinstance(place, CPUPlace):
        return
    torch.cuda.synchronize(None if place is None else place.torch_device())


def globals():  # noqa: A001 — reference name (core.globals() flag registry)
    from . import _FLAGS
    return dict(_FLAGS)


def set_num_threads(n):
    torch.set_num_threads(int(n))
