"""paddle.static: the static graph, the port of `paddle_tpu/static/`
(ref: python/paddle/static/, fluid/framework.py, executor.py).

The design, in three parts:

  * Capture (`program.py`). `data` and the `nn` layer functions give
    `Variable`s, `torch.Tensor` subclasses over meta tensors; every torch
    call that takes one is recorded into the current Program as one
    `OpNode` (the torch callable and its arguments, Variables as holes),
    its output shape inferred by the same call on meta tensors. The
    port's flash attention is a registered op (`torch.ops.
    paddle_tpu_torch.flash_attn`), so a Program records one node for it.
  * Replay (`executor.py`). `Executor.run` calls the recorded callables
    on real tensors on its device — the port's kernels launch as they do
    eagerly — takes the gradients of each minimized loss with
    `torch.autograd.grad`, and applies the optimizers' functional
    updates to the Scope's persistables in place.
  * The artifact (`io.py`). `save_inference_model` exports the replay of
    the forward with `torch.export` into `jit.save`'s artifact pair;
    `load_inference_model` runs it with no Program rebuilt.

Besides: `CompiledProgram` / `BuildStrategy` / `ExecutionStrategy` /
`ParallelExecutor` (the Executor runs a Program as it is: they wrap it),
`cpu_places` / `cuda_places` (the CUDA devices) / `cuda_pinned_places`,
`device_guard`, `Print`, `WeightNormParamAttr`, `gradients`, `py_func`,
`save` / `load` / `load_program_state` / `set_program_state` over
`paddle.save` / `load`, `create_global_var` and `create_parameter`.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..core.mode import in_dygraph_mode, in_static_mode  # noqa: F401
from . import nn  # noqa: F401
from .executor import Executor, Scope, global_scope, scope_guard  # noqa: F401
from .io import (LoadedProgram, load_inference_model,  # noqa: F401
                 save_inference_model)
from .program import (  # noqa: F401
    InputSpec, Program, Variable, append_backward, data,
    default_main_program, default_startup_program, name_scope,
    program_guard,
)


class CompiledProgram:
    """A Program for `Executor.run` (ref: fluid/compiler.py
    CompiledProgram): the Executor replays the Program as it is."""

    def __init__(self, program, build_strategy=None):
        self._program = program

    def with_data_parallel(self, loss_name=None, **kw):
        return self


class BuildStrategy:
    pass


class ExecutionStrategy:
    pass


class ParallelExecutor(CompiledProgram):
    """The 1.x multi-device executor (ref: fluid/parallel_executor.py): a
    CompiledProgram of `main_program`; one device runs it."""

    def __init__(self, use_cuda=False, loss_name=None, main_program=None,
                 share_vars_from=None, **kw):
        super().__init__(main_program or default_main_program())


def cpu_places(device_count=None):
    from ..device import CPUPlace
    return [CPUPlace() for _ in range(device_count or 1)]


def cuda_places(device_ids=None):
    """The CUDA devices' places (all visible cards by default)."""
    from ..device import CUDAPlace
    ids = device_ids if device_ids is not None \
        else range(torch.cuda.device_count())
    return [CUDAPlace(i) for i in ids]


def cuda_pinned_places(device_count=None):
    """Page-locked host places (ref: framework.py cuda_pinned_places)."""
    from ..device import CUDAPinnedPlace
    return [CUDAPinnedPlace() for _ in range(device_count or 1)]


@contextlib.contextmanager
def device_guard(device=None):
    """Pin the ops created in the block to a device (ref: framework.py
    device_guard): recorded on the Program; the Executor runs a Program
    on its own device."""
    prog = default_main_program()
    prev = getattr(prog, "_current_device", None)
    prog._current_device = device
    try:
        yield
    finally:
        prog._current_device = prev


def Print(input, first_n=-1, message=None, summarize=20,  # noqa: A002, N802
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_lod=False,
          print_phase="both"):
    """The debug print op (ref: fluid/layers/control_flow.py Print): an
    eager tensor prints at once; a Variable passes through (its value
    exists only when the Executor runs)."""
    if torch.is_tensor(input) and not isinstance(input, Variable):
        print((message or "")  # cli-print: the Print op's contract
              + str(input.detach().cpu().reshape(-1)[:summarize].numpy()))
    return input


class WeightNormParamAttr:
    """A param attr asking for weight normalization (ref:
    fluid/param_attr.py WeightNormParamAttr)."""

    def __init__(self, dim=None, name=None, initializer=None,
                 learning_rate=1.0, regularizer=None, trainable=True,
                 do_model_average=False, need_clip=True):
        self.dim = dim
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.need_clip = need_clip


def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    """d(targets)/d(inputs) (ref: fluid/backward.py gradients): marks the
    target as the Program's loss; the `<name>@GRAD` Variables returned
    are computed when the Executor replays the Program."""
    from .program import _grad_var
    tgt = targets[0] if isinstance(targets, (list, tuple)) else targets
    prog = default_main_program()
    prog._loss = tgt
    ins = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    return [_grad_var(prog, v) for v in ins]


py_func = nn.py_func


def _program_state(program):
    """The persistables' values of a Program, from the global Scope."""
    scope = global_scope()
    state = {}
    for v in program.global_block().vars.values():
        if v.persistable:
            val = scope.find_var(v.name)
            if val is not None:
                state[v.name] = val.detach().cpu().numpy() \
                    if val.dtype != torch.bfloat16 else val.detach().cpu()
    return state


def save(program, model_path, protocol=4, **kw):
    """Persist every persistable of the Program (ref: fluid/io.py save)."""
    from ..framework.io import save as _save
    _save(_program_state(program), model_path + ".pdparams")


def load(program, model_path, executor=None, var_list=None):
    from ..framework.io import load as _load
    state = _load(model_path + ".pdparams")
    set_program_state(program, state)
    return state


def load_program_state(model_path, var_list=None):
    from ..framework.io import load as _load
    return _load(model_path + ".pdparams")


def set_program_state(program, state_dict):
    """Write {name: array or tensor} into the global Scope, on each
    persistable's current device (else the default one), as copies: the
    Executor updates the Scope's tensors in place, and the caller's
    arrays (possibly read-only views) must not change with them."""
    from ..device import resolve_device
    scope = global_scope()
    for name, val in state_dict.items():
        cur = scope.find_var(name)
        dev = cur.device if cur is not None else resolve_device(None)
        t = val if torch.is_tensor(val) else torch.from_numpy(np.array(val))
        scope.set(name, t.detach().to(dev, copy=True))
    program._version += 1


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    """A parameter of the current Program (ref: fluid/layers/tensor.py
    create_parameter)."""
    return nn.create_parameter(shape, dtype, name, attr, is_bias,
                               default_initializer)


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    """A global variable of the current Program filled with `value` by
    the startup Program (ref: fluid/layers/tensor.py create_global_var)."""
    from ..core import unique_name
    from ..nn import initializer as I
    v = default_main_program().global_block().create_parameter(
        tuple(shape), dtype, name=name or unique_name.generate("global_var"),
        initializer=I.Constant(value), trainable=False)
    v.persistable = True
    return v


__all__ = ["Program", "Variable", "append_backward", "data",
           "default_main_program", "default_startup_program", "global_scope",
           "name_scope", "program_guard", "InputSpec", "Executor", "Scope",
           "scope_guard", "nn", "load_inference_model",
           "save_inference_model", "LoadedProgram", "CompiledProgram",
           "BuildStrategy", "ExecutionStrategy", "ParallelExecutor",
           "cpu_places", "cuda_places", "cuda_pinned_places",
           "device_guard", "Print", "WeightNormParamAttr", "gradients",
           "py_func", "save", "load", "load_program_state",
           "set_program_state", "create_parameter", "create_global_var",
           "in_dygraph_mode", "in_static_mode"]
