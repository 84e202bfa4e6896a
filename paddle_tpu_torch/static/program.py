"""Program / Block / Variable: the static graph, the port of
`paddle_tpu/static/program.py`.

Capture. A `Variable` is a `torch.Tensor` subclass over a tensor on the
`meta` device (shape and dtype, no data). Its `__torch_function__` sees
every torch call that takes one — a method, an operator, a
`torch.nn.functional` function, a registered op such as
`torch.ops.paddle_tpu_torch.flash_attn` — and hands it to the capture
hook (`core.mode`), `_append_op`, which appends one `OpNode`: the torch
callable itself and its argument tree with the Variables as holes. The
output's shape and dtype come from running the same call on `meta`
tensors (PyTorch's counterpart of the reference's `jax.eval_shape`);
constant tensors in the arguments are read as meta tensors for it. A call
whose result holds no tensor (`x.shape`, `x.dtype`, `x.dim()`) is
answered at once and not recorded. When shape inference fails, the op is
recorded with a float32 scalar output and a warning, as the reference
does.

A dim declared None (or -1) in `data` gets the reference's placeholder
1 for shape inference; Python code that reads a shape while the Program
is built bakes that 1 in, as it does in the reference. `Variable.device`
is the default device (`device.resolve_device`), so factory calls such
as `torch.arange(n, device=x.device)` make real constants; the Executor
moves constants to the device it runs on.

`append_backward` / `_minimize` mark the loss (and the optimizer); the
gradients and the update happen when the Executor replays the Program
(`static/executor.py`). `Program.clone()` gets a fresh uid: the
Executor's cache keys on it.
"""
from __future__ import annotations

import contextlib
import itertools
import warnings

import torch
from torch.utils import _pytree as pytree

from ..core import dtype as dtype_mod
from ..core import mode, unique_name


class Variable(torch.Tensor):
    """A tensor of a Program: its name, its shape and dtype (a meta
    tensor), and the reference's fields (`persistable`, `is_data`,
    `stop_gradient`, `trainable`, `initializer`, `optimize_attr`,
    `regularizer`, `need_clip`). `desc_shape` is the declared shape, with
    None where a dim is free."""

    @staticmethod
    def __new__(cls, block, name, shape, dtype, persistable=False,
                is_data=False, stop_gradient=True, initializer=None,
                trainable=False, meta=None):
        if meta is None:
            dims = [1 if s is None or int(s) < 0 else int(s) for s in shape]
            meta = torch.empty(dims, dtype=dtype_mod.convert_dtype(dtype),
                               device="meta")
        v = torch.Tensor._make_subclass(cls, meta, False)
        v.block = block
        v._vname = name
        v.desc_shape = [None if s is None or int(s) < 0 else int(s)
                        for s in shape]
        v.persistable = persistable
        v.is_data = is_data
        v.stop_gradient = stop_gradient
        v.initializer = initializer
        v.trainable = trainable
        v.op = None  # the producing OpNode
        v.optimize_attr = {"learning_rate": 1.0}
        v.regularizer = None
        v.need_clip = True
        v.grad_var = None  # set by append_backward / gradients
        return v

    def __init__(self, *args, **kwargs):
        super().__init__()

    name = property(lambda self: self._vname)

    @property
    def device(self):
        from ..device import resolve_device
        return resolve_device(None)

    def __hash__(self):
        return id(self)

    def __repr__(self):
        kind = "data" if self.is_data else ("param" if self.persistable
                                            else "tmp")
        return f"Variable({self.name}, shape={self.desc_shape}, {kind})"

    __str__ = __repr__

    def astype(self, dtype):
        return self.to(dtype_mod.convert_dtype(dtype))

    cast = astype

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        return mode.static_hook()(func, args, kwargs or {})


class OpNode:
    """One recorded call: `fn(*args, **kwargs)` with `leaves` the
    flattened arguments, each ("var", Variable) or ("const", value);
    `out_leaves` the result's flattened leaves, each ("var", Variable)
    or ("const", value)."""

    __slots__ = ("type", "fn", "leaves", "treedef", "out_leaves",
                 "out_treedef")

    def __init__(self, type_, fn, leaves, treedef, out_leaves, out_treedef):
        self.type = type_
        self.fn = fn
        self.leaves = leaves
        self.treedef = treedef
        self.out_leaves = out_leaves
        self.out_treedef = out_treedef

    @property
    def out_vars(self):
        return [v for kind, v in self.out_leaves if kind == "var"]


class Block:
    def __init__(self, program, idx=0):
        self.program = program
        self.idx = idx
        self.vars = {}
        self.ops = []

    def create_var(self, name=None, shape=(), dtype="float32", **kw):
        name = name or unique_name.generate("tmp")
        v = Variable(self, name, shape, dtype, **kw)
        self.vars[name] = v
        return v

    def create_parameter(self, shape, dtype, name=None, initializer=None,
                         trainable=True, **kw):
        name = name or unique_name.generate("param")
        v = Variable(self, name, shape, dtype, persistable=True,
                     stop_gradient=not trainable, initializer=initializer,
                     trainable=trainable)
        self.vars[name] = v
        # the init runs in the startup program (the reference's
        # initializer appends an init op to startup)
        default_startup_program().initializers.append((v, initializer))
        return v

    def var(self, name):
        return self.vars[name]

    def all_parameters(self):
        return [v for v in self.vars.values()
                if v.persistable and v.trainable]


_program_uid = itertools.count()


class Program:
    def __init__(self):
        self.blocks = [Block(self, 0)]
        self.random_seed = 0
        self.initializers = []  # startup only: [(Variable, initializer)]
        self._loss = None
        self._optimizers = []  # [(optimizer, loss Variable, [params])]
        self._version = 0
        # the Executor's cache keys on this, not id(): ids of collected
        # Programs are reused
        self._uid = next(_program_uid)

    def global_block(self):
        return self.blocks[0]

    def current_block(self):
        return self.blocks[-1]

    def all_parameters(self):
        return self.global_block().all_parameters()

    def data_vars(self):
        return [v for v in self.global_block().vars.values() if v.is_data]

    def list_vars(self):
        return list(self.global_block().vars.values())

    def clone(self, for_test=False):
        """A Program sharing this one's ops; for_test drops the optimizers.
        It is another executable, so it gets its own uid."""
        p = Program.__new__(Program)
        p.__dict__.update(self.__dict__)
        if for_test:
            p._optimizers = []
        p._uid = next(_program_uid)
        return p

    def __repr__(self):
        ops = "\n".join(f"  {op.type} -> {[v.name for v in op.out_vars]}"
                        for op in self.global_block().ops)
        return f"Program(\n{ops}\n)"


_default_main = Program()
_default_startup = Program()


def default_main_program() -> Program:
    return _default_main


def default_startup_program() -> Program:
    return _default_startup


@contextlib.contextmanager
def program_guard(main_program, startup_program=None):
    global _default_main, _default_startup
    old_main, old_startup = _default_main, _default_startup
    _default_main = main_program
    if startup_program is not None:
        _default_startup = startup_program
    try:
        yield
    finally:
        _default_main, _default_startup = old_main, old_startup


@contextlib.contextmanager
def name_scope(prefix):
    with unique_name.guard(prefix):
        yield


def data(name, shape, dtype="float32", lod_level=0):
    """paddle.static.data: a feed placeholder of the current Program."""
    prog = default_main_program()
    v = Variable(prog.global_block(), name, shape, dtype, is_data=True)
    prog.global_block().vars[name] = v
    return v


class InputSpec:
    """The shape (None or -1 for a free dim) and dtype of an input."""

    def __init__(self, shape, dtype="float32", name=None):
        self.shape = tuple(shape)
        self.dtype = dtype_mod.convert_dtype(dtype)
        self.name = name

    @classmethod
    def from_tensor(cls, t, name=None):
        return cls(t.shape, t.dtype, name)

    def __repr__(self):
        return f"InputSpec(shape={self.shape}, dtype={self.dtype}, " \
               f"name={self.name})"


# ---------------------------------------------------------------------------
# the capture hook (registered into core.mode)
# ---------------------------------------------------------------------------

def _meta(x):
    if isinstance(x, Variable):
        return x.as_subclass(torch.Tensor)
    if isinstance(x, torch.Tensor):
        return x.detach().to("meta")
    if isinstance(x, torch.Generator):
        return None  # a meta run draws nothing
    return x


def _append_op(func, args, kwargs, infer=None, name=None):
    """Record `func(*args, **kwargs)` into the current Program (module
    docstring); a call whose result holds no tensor runs at once.
    `infer` (default: func) gives the outputs on meta inputs; `name`
    (default: func's) names the op and its outputs."""
    leaves, treedef = pytree.tree_flatten((args, kwargs))
    metas = [_meta(x) for x in leaves]
    infer_args, infer_kwargs = pytree.tree_unflatten(metas, treedef)
    failed = None
    try:
        with torch._C.DisableTorchFunctionSubclass():
            out = (infer or func)(*infer_args, **infer_kwargs)
    except Exception as e:  # noqa: BLE001 — any op may refuse meta inputs
        failed, out = e, torch.empty((), device="meta")
    out_flat, out_treedef = pytree.tree_flatten(out)
    if failed is None and not any(isinstance(o, torch.Tensor)
                                  for o in out_flat):
        return out
    if name is None:
        name = func.name() if isinstance(func, torch._ops.OpOverload) \
            else getattr(func, "__name__", None) or str(func)
    if not mode.in_static_mode():
        # a Program's Variable reached an op in dygraph mode: the guard
        # was entered without enabling static mode (the reference's
        # `apply_op` guard, paddle_tpu/ops/_registry.py:108-117)
        raise RuntimeError(
            f"op '{name}' received a static Program Variable while in "
            "dygraph mode; call paddle.enable_static() before building "
            "static programs (fluid-style code runs under static mode)")
    if failed is not None:
        warnings.warn(
            f"static shape inference failed for op '{name}' "
            f"({type(failed).__name__}: {str(failed)[:120]}); recording a "
            "float32 scalar output: layers sized from it will misbehave",
            stacklevel=3)
    prog = default_main_program()
    block = prog.current_block()
    spec = [("var", x) if isinstance(x, Variable) else ("const", x)
            for x in leaves]
    any_diff = any(isinstance(x, Variable) and not x.stop_gradient
                   for x in leaves)
    out_leaves, results = [], []
    for o in out_flat:
        if isinstance(o, torch.Tensor):
            vname = unique_name.generate(
                name.replace("::", "_").replace(".", "_"))
            v = Variable(block, vname, tuple(o.shape), o.dtype,
                         meta=o.detach().to("meta"))
            v.stop_gradient = not (any_diff and (o.is_floating_point()
                                                 or o.is_complex()))
            block.vars[vname] = v
            out_leaves.append(("var", v))
            results.append(v)
        else:
            out_leaves.append(("const", o))
            results.append(o)
    node = OpNode(name, func, spec, treedef, out_leaves, out_treedef)
    for v in node.out_vars:
        v.op = node
    block.ops.append(node)
    prog._version += 1
    return pytree.tree_unflatten(results, out_treedef)


def record(fn, args, kwargs=None, infer=None, name=None):
    """`fn(*args, **kwargs)`, recorded as ONE op of the current Program
    when an argument is a Variable (else called at once): a Python
    function over tensors — a `static.nn` layer function's compute, a
    `PyLayer`'s apply, a host function. Its shapes are read from the real
    inputs when the Executor replays it, so no shape is baked in; its
    output shapes come from calling it (or `infer`) on meta tensors."""
    kwargs = kwargs or {}
    if not has_variable(args, kwargs):
        return fn(*args, **kwargs)
    return _append_op(fn, tuple(args), kwargs, infer, name)


def has_variable(*trees):
    return any(isinstance(x, Variable)
               for x in pytree.tree_leaves(list(trees)))


mode.register_static_hook(_append_op)


# ---------------------------------------------------------------------------
# backward and minimize
# ---------------------------------------------------------------------------

def _grad_var(prog, v):
    g = Variable(prog.global_block(), v.name + "@GRAD", tuple(v.shape),
                 v.dtype)
    prog.global_block().vars[g.name] = g
    v.grad_var = g
    return g


def append_backward(loss, parameter_list=None, no_grad_set=None,
                    callbacks=None):
    """Mark `loss`; the gradients are computed when the Executor replays
    the Program (ref: python/paddle/fluid/backward.py append_backward).
    Returns [(param, its @GRAD Variable)]."""
    prog = default_main_program()
    prog._loss = loss
    params = parameter_list or prog.all_parameters()
    return [(p, _grad_var(prog, p)) for p in params]


def _minimize(optimizer, loss, parameter_list=None):
    prog = default_main_program()
    if parameter_list is not None:
        # the fluid API takes Variables or their names
        params = [prog.global_block().var(p) if isinstance(p, str) else p
                  for p in parameter_list]
    else:
        params = prog.all_parameters()
    pgs = append_backward(loss, params)
    prog._optimizers.append((optimizer, loss, params))
    return pgs


def global_scope():
    from . import executor
    return executor._global_scope


__all__ = ["Variable", "OpNode", "Block", "Program", "default_main_program",
           "default_startup_program", "program_guard", "name_scope", "data",
           "InputSpec", "append_backward", "global_scope", "record"]
