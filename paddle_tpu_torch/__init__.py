"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu.

The JAX package `paddle_tpu` stays the reference; this package carries
the same functions in PyTorch, slice by slice, and replaces each Pallas
TPU kernel on a ported path with a CUDA C++ kernel written for Hopper
(`csrc/`, built at first use by `ops/kernels.py`).

Slice 1 is the default serving path of `PagedGenerationServer` for a
GPT-2-layout decoder: the weight bridge (`models.gpt2`), the paged KV
pool (`inference.kv_cache`, `inference.kv_quant`), the paged attention
ops and their kernels (`ops.attention`, `ops.kernels`), the decoder
programs (`nn.decode`), the sampler (`sampling`: per-request sampling
and penalties on the reference's PRNG streams) and the server core
(`inference.serving`). Slice 2 is GPT-2 training: the functional
loss (`models.gpt2.build_train_step`), flash attention with its
autograd rule and kernels (`ops.flash_attention`), the loss
(`ops.loss`) and AdamW (`optimizer`). Slices 3-15 add BERT/ERNIE,
long-context training, the Hopper kernels, sampling, the prefix cache,
decode graphs, W8A16, speculation and the seq2seq Transformer. Slice 16
is offline generation: `GPT2.generate` (the dense fixed-cache program of
`models.gpt2_decode`, one CUDA graph per program on the card, and the
paged engine), `models.gpt2.export_generator` and `jit.load` (the
port's own artifact), and the dense `inference.GenerationServer`.
Slice 17 is fault-tolerant, observable serving: `reliability` (fault
plans, the recovery policy, the session journal), `observability`
(metrics, tracing, the flight recorder, the capture tracker, the ops
endpoint) and `utils.watchdog`, with their hooks in both servers.
Slice 18 is the serving front door (`frontend`). Slice 19 is parallel
training over torch.distributed, one process a rank: `parallel` (the
mesh, differentiable collectives, ring / zigzag / Ulysses sequence
parallelism, the pipeline schedules, MoE), `distributed` (collectives,
DataParallel, spawn, the sharded checkpoint) and `models.gpt2_hybrid` /
`models.gpt2_pipeline`.

Slice 23 is the Paddle 2.0 eager API: `import paddle_tpu_torch as
paddle` gives the reference's top-level names — dtypes, places and
`set_device` / `get_device`, `seed` and the rng state, `to_tensor`,
`Parameter`, `ParamAttr`, the autograd API (`grad`, `no_grad`, ...),
every op of `ops` (`paddle.reshape(x, shape)`, ...), and the namespaces
`nn` (Layer, the layers, `functional`, `initializer`, `utils`), `amp`,
`optimizer`, `linalg`, `tensor` and `autograd`. The tensor is
`torch.Tensor`; `loss.backward()` is torch's. `nn`, `ops`, `amp` and the
op names bind lazily (PEP 562), so processes that import the package for
its serving path (the fleet's spawned workers) do not pay for them.

Slice 24 is the Paddle 2.0 API, part 2: `paddle.Model` (`hapi`: fit /
evaluate / predict / save / load, the callbacks, `flops`, `summary`),
`io` (datasets, samplers, the DataLoader and its worker processes over
the native byte queue of `csrc/native_runtime.cpp`, built by g++ at
first use), `metric`, `save` / `load` (`framework.io`, reading the
reference's files too), control flow (`cond`, `while_loop`, ...), the
fluid-era layers with the beam-search decoder (`nn.layer.legacy`),
`distribution`, `regularizer` and the compat names (`compat`:
`elementwise_*`, `reduce_*`, `rank`, `shape`, ...). They bind lazily
too.

Slice 25 adds the fluid-era functional ops (`nn.functional.sequence`,
`legacy`, `detection`, the fused transformer ops) and `vision` (the
model zoo, `vision.ops`, the numpy transforms and the datasets), which
binds lazily as well.

Slice 27 is the static graph and deployment: `static` (a Program
recorded from torch calls on its Variables, replayed by the Executor
through the port's kernels; `enable_static`, `paddle.data` and
`nn.Input`), `jit.to_static`, `jit.save` / `jit.load` of any layer (an
exported program with the weights in the reference's npz) and
`inference.create_predictor` (one CUDA graph a set of input shapes).

Then `fluid`, the 1.x namespace over the static graph (its module
docstring has the map), with `create_parameter`, `create_global_var`
and `fill_constant` at the top as the reference binds them; and
float16 in the flash kernels (`ops.kernels`).

This package imports `torch` and numpy only — never `jax` and nothing
of `paddle_tpu`. Entry points run on CUDA unless the caller passes
`device="cpu"` or calls `set_device("cpu")` (see
`device.resolve_device`).
"""
import importlib as _importlib

from .autograd import (enable_grad, grad, is_grad_enabled,  # noqa: F401
                       no_grad, set_grad_enabled)
from .core.dtype import (  # noqa: F401
    bfloat16, bool_, complex64, complex128, float16, float32, float64,
    get_default_dtype, int8, int16, int32, int64, set_default_dtype, uint8,
)
from .core.mode import (disable_static, enable_static,  # noqa: F401
                        in_dygraph_mode, in_static_mode)
from .core.param_attr import ParamAttr  # noqa: F401
from .core.rng import get_rng_state, seed, set_rng_state  # noqa: F401
from .core.tensor import (Parameter, Tensor, is_tensor,  # noqa: F401
                          to_tensor)
from .device import (  # noqa: F401
    CPUPlace, CUDAPinnedPlace, CUDAPlace, TPUPlace, XPUPlace, get_device,
    is_compiled_with_cuda, is_compiled_with_tpu, is_compiled_with_xpu,
    resolve_device, set_device,
)

_LAZY_MODULES = ("nn", "ops", "amp", "optimizer", "linalg", "tensor",
                 "models", "inference", "jit", "distributed", "parallel",
                 "io", "metric", "hapi", "framework", "distribution",
                 "regularizer", "compat", "callbacks", "vision", "utils",
                 "dataset", "reader", "text", "slim", "incubate", "onnx",
                 "version", "sysconfig", "static", "fluid")
# name -> (module, attribute): the high-level API's names
_LAZY_NAMES = {"Model": ("hapi.model", "Model"),
               "save": ("framework.io", "save"),
               "load": ("framework.io", "load"),
               "flops": ("hapi.static_flops", "flops"),
               "summary": ("hapi.model_summary", "summary"),
               "L1Decay": ("regularizer", "L1Decay"),
               "L2Decay": ("regularizer", "L2Decay"),
               "DataParallel": ("distributed.parallel", "DataParallel"),
               "batch": ("reader", "batch"),
               "data": ("static.program", "data"),
               "create_parameter": ("fluid.layers", "create_parameter"),
               "create_global_var": ("fluid.layers", "create_global_var"),
               "fill_constant": ("fluid.layers", "fill_constant"),
               "commit": ("version", "commit"),
               "full_version": ("version", "full_version"),
               "__version__": ("version", "full_version")}


def __getattr__(name):
    # PEP 562: the heavy namespaces and the op names bind at first use
    if name in _LAZY_MODULES:
        path = "hapi.callbacks" if name == "callbacks" else name
        mod = _importlib.import_module("." + path, __name__)
        globals()[name] = mod
        return mod
    if name in _LAZY_NAMES:
        path, attr = _LAZY_NAMES[name]
        obj = getattr(_importlib.import_module("." + path, __name__), attr)
        globals()[name] = obj
        return obj
    compat = _importlib.import_module(".compat", __name__)
    if name in compat.__all__:
        globals()[name] = getattr(compat, name)
        return globals()[name]
    ops = _importlib.import_module(".ops", __name__)
    if name in ops.__all__ or name in ("abs_", "max_", "min_", "sum_"):
        globals()[name] = getattr(ops, name)
        return globals()[name]
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["resolve_device", "set_device", "get_device", "seed",
           "get_rng_state", "set_rng_state", "to_tensor", "is_tensor",
           "Tensor", "Parameter", "ParamAttr", "grad", "no_grad",
           "enable_grad", "set_grad_enabled", "is_grad_enabled",
           "enable_static", "disable_static", "in_dygraph_mode",
           "in_static_mode", "static", "data",
           "CPUPlace", "CUDAPlace", "CUDAPinnedPlace", "TPUPlace",
           "XPUPlace", "is_compiled_with_cuda", "is_compiled_with_tpu",
           "is_compiled_with_xpu", "float16", "bfloat16", "float32",
           "float64", "int8", "int16", "int32", "int64", "uint8", "bool_",
           "complex64", "complex128", "set_default_dtype",
           "get_default_dtype", "summary", "Model", "save", "load",
           "flops", "L1Decay", "L2Decay"]
