"""The execution mode, the port of `paddle_tpu/core/mode.py`: dygraph
(eager, the default, as in Paddle 2.0) or static.

In static mode `paddle.static.data` and the `static.nn` layer functions give
`static.Variable`s, and every torch call that takes one is recorded into
the current Program instead of running (`static/program.py`), through
the capture hook that `paddle_tpu_torch.static` registers here (it
cannot be imported here without a cycle). `Optimizer.minimize` reads the
mode to record the training step instead of taking it.
"""
from __future__ import annotations

_static_mode = False
# set by paddle_tpu_torch.static: fn(func, args, kwargs) -> outputs
_static_append_op_hook = None


def enable_static():
    global _static_mode
    _static_mode = True


def disable_static():
    global _static_mode
    _static_mode = False


def in_dygraph_mode() -> bool:
    return not _static_mode


def in_static_mode() -> bool:
    return _static_mode


def register_static_hook(hook):
    global _static_append_op_hook
    _static_append_op_hook = hook


def static_hook():
    return _static_append_op_hook


__all__ = ["enable_static", "disable_static", "in_dygraph_mode",
           "in_static_mode", "register_static_hook", "static_hook"]
