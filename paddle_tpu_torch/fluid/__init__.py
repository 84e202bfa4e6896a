"""fluid 1.x compatibility namespace: the port of `paddle_tpu/fluid/`.

Reference-era user code (`import paddle.fluid as fluid`) maps here: the
Program/Executor APIs of the port's static graph, the fluid.layers
functional set, fluid.dygraph (guard, the 1.x layer classes, amp_guard /
AmpScaler), contrib (mixed_precision.decorate, the decoders, slim) — all
over the port's implementations, no module of its own computing apart
from the 1.x adapters (LoD builders, the MultiSlot datasets, PyReader).

The modules and what they hold:
  * `core` — places, Scope, the LoDTensor / VarBase aliases of the
    tensor, `_cuda_synchronize` over `torch.cuda.synchronize`;
  * `layers` (with `layers_legacy`, `layers_legacy2`; `fluid.layers.utils`
    resolves as a module path) — `static.nn`'s builders, the op library,
    the fluid-era functional ops, the decay layers, the decoders, the
    metric and detection tails;
  * `nets`, `reader` (`PyReader`), `dataloader`, `transpiler`,
    `layer_helper`, `dygraph`, `contrib`, `compat1x`, `dataset_feed`.

The CPU twins hold each to `paddle_tpu.fluid` on the same numpy inputs,
with weights carried across by `nn.layer.layers.load_reference_state`
(eager layers) or `static.set_program_state` (a Program's Scope).
"""
from __future__ import annotations

from ..core.param_attr import ParamAttr  # noqa: F401
from ..core.tensor import Tensor  # noqa: F401
from ..device import (  # noqa: F401
    CPUPlace, CUDAPinnedPlace, CUDAPlace, TPUPlace, XPUPlace)
from ..static import (  # noqa: F401
    BuildStrategy, CompiledProgram, ExecutionStrategy, Executor,
    ParallelExecutor, Program, WeightNormParamAttr, data,
    default_main_program, default_startup_program, global_scope,
    gradients, load_program_state, name_scope, program_guard, scope_guard,
    set_program_state,
)
from ..static.program import Variable, append_backward  # noqa: F401
from ..static.executor import Scope  # noqa: F401
from .. import nn as _nn  # noqa: F401
from .. import optimizer as _optimizer_mod
from ..nn import initializer  # noqa: F401
from ..nn import clip  # noqa: F401
from .. import regularizer  # noqa: F401
from . import contrib  # noqa: F401
from .reader import PyReader  # noqa: F401

# register fluid.layers.utils as an importable module path: fluid.layers
# is a module (not a package), but the reference exposes
# `from paddle.fluid.layers.utils import map_structure` — the sys.modules
# pre-registration makes that import resolve
import sys as _sys  # noqa: E402

from . import layers_utils as _layers_utils  # noqa: E402

_sys.modules[__name__ + ".layers.utils"] = _layers_utils
from . import layers as _layers_mod  # noqa: E402

_layers_mod.utils = _layers_utils
from . import core  # noqa: F401
from . import dygraph  # noqa: F401
from . import layers  # noqa: F401
from . import nets  # noqa: F401
from ..io import DataLoader  # noqa: F401
from ..core.mode import in_dygraph_mode  # noqa: F401

# module-level attribute surface of the 1.x package (ref:
# python/paddle/fluid/__init__.py:34-95 — fluid.core, fluid.profiler,
# fluid.unique_name, the LoDTensor/Tensor aliases, dygraph toggles...):
# real 1.x user code reaches these as attributes, most outside __all__.
from ..core import unique_name  # noqa: F401
from ..utils import profiler  # noqa: F401
from ..core import rng as generator  # noqa: F401
from . import dataset_feed as dataset  # noqa: F401  (fluid.dataset is the
# DatasetFactory module, NOT the paddle.dataset readers package)
from .. import framework  # noqa: F401
from .. import incubate  # noqa: F401
from .. import metric as metrics  # noqa: F401
from ..static import executor  # noqa: F401
from ..framework.io import load, save  # noqa: F401
from ..ops import one_hot  # noqa: F401
from .core import (  # noqa: F401
    LoDTensor, LoDTensorArray, VarBase, _cuda_synchronize, _Scope)
from .compat1x import (  # noqa: F401
    DataFeeder, DistributeTranspiler, DistributeTranspilerConfig,
    WeightedAverage, create_lod_tensor, create_random_int_lodtensor,
    memory_optimize, release_memory)
from .dygraph import (  # noqa: F401
    disable_dygraph, enable_dygraph, load_dygraph, save_dygraph)

enable_imperative = enable_dygraph
disable_imperative = disable_dygraph

# dygraph layer classes the reference star-imports to fluid top level
# (ref: fluid/__init__.py:86 `from .dygraph.nn import *`)
from .dygraph import (  # noqa: E402,F401
    BatchNorm, BilinearTensorProduct, Conv2D, Conv2DTranspose, Conv3D,
    Conv3DTranspose, Dropout, Embedding, Flatten, GroupNorm, GRUUnit,
    InstanceNorm, Layer, LayerNorm, Linear, NCE, Pool2D, PRelu,
    SpectralNorm, TreeConv)
from ..compat import ComplexVariable  # noqa: E402,F401
from ..static import (  # noqa: E402,F401
    cpu_places, cuda_pinned_places, cuda_places, device_guard)
from ..nn.initializer import set_global_initializer  # noqa: E402,F401
from ..utils import require_version  # noqa: E402,F401
from .core import is_compiled_with_cuda, is_compiled_with_xpu  # noqa: E402,F401
from ..distributed import fleet  # noqa: E402,F401
from ..incubate import data_generator  # noqa: E402,F401
from .dataset_feed import (  # noqa: E402,F401
    DataFeedDesc, DatasetFactory, InMemoryDataset, QueueDataset)
from . import dataset_feed as data_feed_desc  # noqa: E402,F401


class backward:  # fluid.backward (ref: fluid/backward.py)
    from ..static import gradients
    from ..static.program import append_backward
    gradients = staticmethod(gradients)
    append_backward = staticmethod(append_backward)


class compiler:  # fluid.compiler (ref: fluid/compiler.py)
    CompiledProgram = CompiledProgram
    BuildStrategy = BuildStrategy
    ExecutionStrategy = ExecutionStrategy


class parallel_executor:  # fluid.parallel_executor
    ParallelExecutor = ParallelExecutor
    BuildStrategy = BuildStrategy
    ExecutionStrategy = ExecutionStrategy


class trainer_desc:
    """Trainer pipeline descriptors (ref: fluid/trainer_desc.py). In the
    reference these serialize configs for the C++ MultiTrainer; here the
    Executor's replay of the Program is the trainer, so they are plain
    config records consumed by Executor.train_from_dataset."""

    class TrainerDesc:
        def __init__(self):
            self.config = {}

        def _set_fetch_var_and_info(self, fetch_vars, fetch_info,
                                    print_period):
            self.config.update(fetch_vars=fetch_vars,
                               fetch_info=fetch_info,
                               print_period=print_period)

        def _set_debug(self, debug):
            self.config["debug"] = debug

        def _set_thread(self, thread_num):
            self.config["thread_num"] = thread_num

    class MultiTrainer(TrainerDesc):
        pass

    class DistMultiTrainer(TrainerDesc):
        pass

    class PipelineTrainer(TrainerDesc):
        pass

    class HeterXpuTrainer(TrainerDesc):
        pass

    class HeterBoxWorker(TrainerDesc):
        pass


class evaluator:
    """ref: fluid/evaluator.py — deprecated there in favor of
    fluid.metrics; delegated accordingly."""

    class Evaluator:
        def __init__(self, name, **kwargs):
            import warnings
            warnings.warn(
                "fluid.evaluator is deprecated; use fluid.metrics",
                stacklevel=2)
            self.metrics = []
            self.helper = None
            self.name = name

    ChunkEvaluator = None  # bound below


class distribute_lookup_table:
    """ref: fluid/distribute_lookup_table.py — locate the distributed
    (parameter-server) embedding table in a Program."""

    @staticmethod
    def find_distributed_lookup_table(program):
        from ..static.program import Program
        if not isinstance(program, Program):
            raise TypeError("program must be a Program")
        # PS sparse embeddings live in distributed.ps SparseTable, outside
        # the Program's op list
        return None


class _ChunkEvaluator:
    """Accumulating chunk F1 over batches (delegates to
    metric.chunk_eval semantics)."""

    def __init__(self, **kwargs):
        self.kwargs = kwargs
        self.reset()

    def reset(self):
        self.num_infer = self.num_label = self.num_correct = 0

    def update(self, num_infer_chunks, num_label_chunks,
               num_correct_chunks):
        self.num_infer += int(num_infer_chunks)
        self.num_label += int(num_label_chunks)
        self.num_correct += int(num_correct_chunks)
        return self.eval()

    def eval(self):
        p = self.num_correct / self.num_infer if self.num_infer else 0.0
        r = self.num_correct / self.num_label if self.num_label else 0.0
        f1 = 2 * p * r / (p + r) if p + r else 0.0
        return p, r, f1


evaluator.ChunkEvaluator = _ChunkEvaluator


# trainer descriptor classes are also reference top-level names
TrainerDesc = trainer_desc.TrainerDesc
MultiTrainer = trainer_desc.MultiTrainer
DistMultiTrainer = trainer_desc.DistMultiTrainer
PipelineTrainer = trainer_desc.PipelineTrainer
HeterXpuTrainer = trainer_desc.HeterXpuTrainer
HeterBoxWorker = trainer_desc.HeterBoxWorker

from torch import Generator  # noqa: E402,F401


class PSDispatcher:
    """Assign variables to parameter-server endpoints (ref:
    transpiler/ps_dispatcher.py). Used standalone by PS-lite table
    placement; the program transpiler itself is superseded (see
    DistributeTranspiler)."""

    def __init__(self, pserver_endpoints):
        self._eps = list(pserver_endpoints)
        self._step = 0

    @property
    def eps(self):
        return self._eps

    def reset(self):
        self._step = 0

    def dispatch(self, varlist):
        raise NotImplementedError


class HashName(PSDispatcher):
    """Stable name-hash placement (ref: ps_dispatcher.py:49)."""

    def _hash_block(self, block_str, total):
        import hashlib
        # md5 not python hash(): placement must agree across processes
        # regardless of PYTHONHASHSEED
        return int(hashlib.md5(str(block_str).encode()).hexdigest(),
                   16) % total

    def dispatch(self, varlist):
        return [self._eps[self._hash_block(getattr(v, "name", v),
                                           len(self._eps))]
                for v in varlist]


class RoundRobin(PSDispatcher):
    """Cyclic placement (ref: ps_dispatcher.py:91)."""

    def dispatch(self, varlist):
        out = []
        for _v in varlist:
            out.append(self._eps[self._step % len(self._eps)])
            self._step += 1
        return out


class learning_rate_decay:
    """fluid.layers.learning_rate_decay module surface at the 1.x
    top-level name (the decay schedules themselves live in
    layers_legacy and map onto optimizer.lr schedulers)."""
    from .layers_legacy import (
        cosine_decay, exponential_decay, inverse_time_decay, noam_decay,
        natural_exp_decay, piecewise_decay, polynomial_decay)
    cosine_decay = staticmethod(cosine_decay)
    exponential_decay = staticmethod(exponential_decay)
    inverse_time_decay = staticmethod(inverse_time_decay)
    noam_decay = staticmethod(noam_decay)
    natural_exp_decay = staticmethod(natural_exp_decay)
    piecewise_decay = staticmethod(piecewise_decay)
    polynomial_decay = staticmethod(polynomial_decay)


def load_op_library(lib_filename):
    """The reference-era .so op kernels speak Paddle's C++ op registry,
    which the port does not have: its custom kernels are CUDA C++ built by
    nvcc into a library with a plain C interface and bound with ctypes
    (`paddle_tpu_torch/csrc`, `ops/kernels.py`), with a
    `torch.autograd.Function` or a `torch.library.custom_op` around them.
    Raising shim, same form as the ONNX drop (SURVEY §2 #39)."""
    raise NotImplementedError(
        "load_op_library loads reference-era .so op kernels, which speak "
        "Paddle's C++ op registry. Write the kernel as CUDA C++ with a "
        "plain C interface bound by ctypes (see paddle_tpu_torch/csrc and "
        "ops/kernels.py) and wrap it in a torch.library.custom_op.")


class average:  # fluid.average module surface (ref: fluid/average.py)
    WeightedAverage = WeightedAverage


class transpiler:  # fluid.transpiler (ref: fluid/transpiler/__init__.py)
    DistributeTranspiler = DistributeTranspiler
    DistributeTranspilerConfig = DistributeTranspilerConfig
    memory_optimize = staticmethod(memory_optimize)
    release_memory = staticmethod(release_memory)


class install_check:  # fluid.install_check (ref: fluid/install_check.py)
    from .compat1x import run_check
    run_check = staticmethod(run_check)


def monkey_patch_variable():
    """The tensor is torch.Tensor, whose operators need no patching; kept
    callable for 1.x code that invokes it explicitly."""


def monkey_patch_varbase():
    pass


def _fluid_optimizer(cls):
    """`cls` taking the 1.x constructor spellings too: `parameter_list`
    for `parameters` and `regularization` for `weight_decay` (1.x dygraph
    code builds `AdamOptimizer(lr, parameter_list=model.parameters())`).
    The reference binds the 2.0 classes as they are."""
    class Fluid(cls):
        def __init__(self, learning_rate=0.001, parameter_list=None,
                     regularization=None, **kw):
            if parameter_list is not None:
                kw.setdefault("parameters", parameter_list)
            if regularization is not None:
                kw.setdefault("weight_decay", regularization)
            super().__init__(learning_rate=learning_rate, **kw)

    Fluid.__name__ = Fluid.__qualname__ = cls.__name__
    return Fluid


class optimizer:  # fluid.optimizer.* (classes with fluid-era ctor names)
    SGD = SGDOptimizer = _fluid_optimizer(_optimizer_mod.SGD)
    Momentum = MomentumOptimizer = _fluid_optimizer(_optimizer_mod.Momentum)
    Adam = AdamOptimizer = _fluid_optimizer(_optimizer_mod.Adam)
    Adamax = AdamaxOptimizer = _fluid_optimizer(_optimizer_mod.Adamax)
    Adagrad = AdagradOptimizer = _fluid_optimizer(_optimizer_mod.Adagrad)
    RMSProp = RMSPropOptimizer = _fluid_optimizer(_optimizer_mod.RMSProp)
    Lamb = LambOptimizer = _fluid_optimizer(_optimizer_mod.Lamb)


def embedding(*a, **kw):
    from ..static import nn as static_nn
    return static_nn.embedding(*a, **kw)


class io:
    @staticmethod
    def save_params(executor, dirname, main_program=None, filename=None):
        import os

        from ..framework.io import save as fsave
        from ..static import global_scope
        from ..static.program import default_main_program
        os.makedirs(dirname, exist_ok=True)
        prog = main_program or default_main_program()
        scope = global_scope()
        state = {}
        for v in prog.global_block().vars.values():
            if v.persistable and scope.find_var(v.name) is not None:
                state[v.name] = scope.find_var(v.name)
        fsave(state, os.path.join(dirname, filename or "params.pd"))

    @staticmethod
    def load_params(executor, dirname, main_program=None, filename=None):
        import os

        from ..framework.io import load as fload
        from ..static import global_scope
        state = fload(os.path.join(dirname, filename or "params.pd"))
        scope = global_scope()
        for name, t in state.items():
            scope.set(name, t)

    # persist/restore whole train states + servable artifacts (ref:
    # fluid/io.py save/load/save_inference_model/load_inference_model)
    @staticmethod
    def save(obj, path, **kw):
        from ..framework.io import save as fsave
        return fsave(obj, path, **kw)

    @staticmethod
    def load(path, **kw):
        from ..framework.io import load as fload
        return fload(path, **kw)

    @staticmethod
    def load_program_state(model_path, var_list=None):
        from ..static import load_program_state as f
        return f(model_path, var_list)

    @staticmethod
    def set_program_state(program, state_dict):
        from ..static import set_program_state as f
        return f(program, state_dict)

    @staticmethod
    def save_inference_model(dirname, feeded_var_names, target_vars,
                             executor, main_program=None, **kw):
        """1.x signature: feed names + fetch vars + a directory."""
        import os

        from ..static.io import save_inference_model as f
        from ..static.program import default_main_program
        prog = main_program or default_main_program()
        feeds = [prog.global_block().var(n) if isinstance(n, str) else n
                 for n in feeded_var_names]
        return f(os.path.join(dirname, "model"), feeds,
                 list(target_vars), executor, program=prog)

    @staticmethod
    def load_inference_model(dirname, executor, **kw):
        import os

        from ..static.io import load_inference_model as f
        return f(os.path.join(dirname, "model"), executor, **kw)


# ---- GFlags surface (ref: fluid/framework.py:5670 set_flags/get_flags).
# The C++ core's gflags become a host-side registry here.
_FLAGS = {
    "FLAGS_eager_delete_tensor_gb": 0.0,
    "FLAGS_fraction_of_gpu_memory_to_use": 0.92,
    "FLAGS_cudnn_deterministic": False,
    "FLAGS_check_nan_inf": False,
    "FLAGS_use_pinned_memory": True,
}


def set_flags(flags):
    if not isinstance(flags, dict):
        raise TypeError("flags in set_flags should be a dict")
    for key, value in flags.items():
        if key not in _FLAGS:
            raise ValueError(
                f"Flag {key} cannot set its value through this function.")
        _FLAGS[key] = value


def get_flags(flags):
    if isinstance(flags, str):
        flags = [flags]
    if not isinstance(flags, (list, tuple)):
        raise TypeError("flags in get_flags should be a list, tuple or str")
    out = {}
    for key in flags:
        if key not in _FLAGS:
            raise ValueError(f"Flag {key} is not public.")
        out[key] = _FLAGS[key]
    return out
