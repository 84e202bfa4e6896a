"""`paddle.framework` of the port: `save` / `load` and the async
checkpoint writer (`framework.io`), and the framework-level names the
reference's `paddle_tpu/framework/__init__.py` gathers (places, the
default dtype, `seed`, `ParamAttr`, `grad` / `no_grad`, `LayerList`,
`DataParallel`, `VarBase`, `ComplexVariable` and `random`, the rng
module)."""
from __future__ import annotations

from ..autograd import grad, no_grad  # noqa: F401
from ..core.dtype import get_default_dtype, set_default_dtype  # noqa: F401
from ..core.mode import in_dygraph_mode  # noqa: F401
from ..core.param_attr import ParamAttr  # noqa: F401
from ..core.rng import seed  # noqa: F401
from ..device import (CPUPlace, CUDAPinnedPlace, CUDAPlace,  # noqa: F401
                      TPUPlace)
from . import io  # noqa: F401
from .io import async_save, load, save, wait_save  # noqa: F401
from ..compat import ComplexVariable, VarBase  # noqa: F401,E402
from ..core import rng as random  # noqa: F401,E402,A004
from ..distributed.parallel import DataParallel  # noqa: F401,E402
from ..nn.layer.layers import LayerList  # noqa: F401,E402

__all__ = ["io", "save", "load", "async_save", "wait_save", "grad",
           "no_grad", "get_default_dtype", "set_default_dtype",
           "in_dygraph_mode", "ParamAttr", "seed", "CPUPlace", "CUDAPlace",
           "CUDAPinnedPlace", "TPUPlace", "DataParallel", "LayerList",
           "VarBase", "ComplexVariable", "random"]
