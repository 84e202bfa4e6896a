"""Autograd: the API of `paddle_tpu/core/autograd.py` and
`paddle_tpu/autograd.py` over torch's engine.

The reference records a tape of `jax.vjp` pullbacks; the port does not
carry that engine — torch's autograd is the tape. What is ported is the
user-facing API with Paddle's semantics:

  * `grad(outputs, inputs, grad_outputs=None, retain_graph=None,
    create_graph=False, allow_unused=False)` — the gradients as a list,
    writing no `.grad`; an input the outputs do not reach gives zeros
    unless `allow_unused` (then None), as the reference does; several
    outputs sum their gradients; `retain_graph` defaults to True (the
    reference runs its backward with the graph kept);
  * `backward(tensors, grad_tensors=None, retain_graph=False)`;
  * `no_grad` (context and decorator), `enable_grad`,
    `set_grad_enabled(flag)`, `is_grad_enabled()`;
  * `register_hook(tensor, hook)` — torch's tensor hook, returning a
    handle with `remove()`;
  * `PyLayer` / `PyLayerContext`: a custom op with a user backward, a thin
    layer over `torch.autograd.Function` (`apply`, `save_for_backward`,
    `saved_tensor()`).
"""
from __future__ import annotations

import torch

from .core import mode

no_grad = torch.no_grad
enable_grad = torch.enable_grad
set_grad_enabled = torch.set_grad_enabled
is_grad_enabled = torch.is_grad_enabled


def _list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, allow_unused=False):
    """paddle.grad: d(outputs)/d(inputs) as a list, one per input."""
    outs, ins = _list(outputs), _list(inputs)
    gos = _list(grad_outputs) if grad_outputs is not None \
        else [None] * len(outs)
    gos = [torch.ones_like(o) if g is None else g for o, g in zip(outs, gos)]
    retain = True if retain_graph is None else retain_graph
    res = torch.autograd.grad(outs, ins, gos, retain_graph=retain or
                              create_graph, create_graph=create_graph,
                              allow_unused=True)
    if allow_unused:
        return list(res)
    return [torch.zeros_like(i) if g is None else g
            for i, g in zip(ins, res)]


def backward(tensors, grad_tensors=None, retain_graph=False):
    """paddle.autograd.backward: accumulate the gradients of `tensors`
    into the leaves' `.grad`."""
    ts = _list(tensors)
    gs = _list(grad_tensors) if grad_tensors is not None else None
    torch.autograd.backward(ts, gs, retain_graph=retain_graph)


def register_hook(tensor, hook):
    """Call `hook(grad)` when `tensor`'s gradient is computed; a non-None
    return replaces the gradient."""
    return tensor.register_hook(hook)


class PyLayerContext:
    """What a PyLayer's forward and backward share: `save_for_backward`,
    `saved_tensor()` and free attributes."""

    def __init__(self, fn_ctx=None):
        self._fn_ctx = fn_ctx
        self._saved = ()

    def save_for_backward(self, *tensors):
        self._saved = tensors
        if self._fn_ctx is not None:
            self._fn_ctx.save_for_backward(*tensors)

    def saved_tensor(self):
        if self._fn_ctx is not None and self._fn_ctx.saved_tensors:
            return tuple(self._fn_ctx.saved_tensors)
        return self._saved

    @property
    def saved_tensors(self):
        return self.saved_tensor()


class PyLayerMeta(type):
    def __call__(cls, *args, **kwargs):
        raise RuntimeError("call PyLayer subclasses via .apply()")


class PyLayer(metaclass=PyLayerMeta):
    """A custom op with a user-defined backward (paddle.autograd.PyLayer):

        class Exp(PyLayer):
            @staticmethod
            def forward(ctx, x):
                y = ptt.exp(x)
                ctx.save_for_backward(y)
                return y

            @staticmethod
            def backward(ctx, dy):
                (y,) = ctx.saved_tensor()
                return dy * y

    `backward` returns one gradient per tensor argument of `forward`, in
    order. Runs as a `torch.autograd.Function`; given a static Program's
    Variables, `apply` records it as one op of the Program."""

    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *grad_outputs):
        raise NotImplementedError

    @classmethod
    def apply(cls, *args, **kwargs):
        fn = cls.__dict__.get("_function")
        if fn is None:
            fn = _function_of(cls)
            type.__setattr__(cls, "_function", fn)
        if mode.in_static_mode():
            # given a Variable, one recorded op of the current Program,
            # replayed (with its backward) by the Executor; else called
            from .static.program import record
            return record(fn.apply, (kwargs, *args), name=cls.__name__)
        return fn.apply(kwargs, *args)


def _function_of(cls):
    class _Fn(torch.autograd.Function):
        @staticmethod
        def forward(fn_ctx, kwargs, *args):
            ctx = PyLayerContext(fn_ctx)
            fn_ctx.pyl = ctx
            fn_ctx.tensor_pos = [i for i, a in enumerate(args)
                                 if torch.is_tensor(a)]
            fn_ctx.n_args = len(args)
            with torch.no_grad():
                return cls.forward(ctx, *args, **kwargs)

        @staticmethod
        def backward(fn_ctx, *grads):
            with torch.no_grad():
                gin = cls.backward(fn_ctx.pyl, *grads)
            gin = list(gin) if isinstance(gin, (tuple, list)) else [gin]
            out = [None] * fn_ctx.n_args
            for pos, g in zip(fn_ctx.tensor_pos, gin):
                out[pos] = g
            return (None, *out)

    _Fn.__name__ = cls.__name__
    return _Fn


LegacyPyLayer = PyLayer

__all__ = ["grad", "backward", "no_grad", "enable_grad", "set_grad_enabled",
           "is_grad_enabled", "register_hook", "PyLayer", "PyLayerContext",
           "LegacyPyLayer"]
