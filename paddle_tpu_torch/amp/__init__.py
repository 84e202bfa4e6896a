"""Automatic mixed precision: the port of `paddle_tpu/amp/__init__.py`.

`auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
level="O1", dtype="bfloat16")` sets a process-wide policy, as the
reference does (not `torch.autocast`, whose lists differ). The ops that
consult it — `matmul`, `mm`, `bmm`, `addmm`, `linear`, `conv1d/2d/3d`,
`einsum` and the attention of `nn.MultiHeadAttention`
("scaled_dot_product_attention") — run on their floating inputs cast to
the amp dtype when the policy names them, and cast a floating result of
that dtype back to float32, as the reference's `_amp_cast_fn` does
(`ops/_registry.py:54-77`):

  * O1: the ops of the white list (the reference's `WHITE_LIST` plus
    `custom_white_list`) not in the black list (`BLACK_LIST` plus
    `custom_black_list`);
  * O2: every consulting op not in the black list.

So under the default O1 the projections and the feed-forward products
compute in bfloat16 and attention in float32; attention computes in the
amp dtype under O2, or when "scaled_dot_product_attention" is in
`custom_white_list`.

`GradScaler` scales the loss only when the amp dtype is float16 (the
reference's rule: bfloat16 has float32's range, `:77-84`); `decorate`
casts the models' parameters to the amp dtype at O2.
"""
from __future__ import annotations

import contextlib

import torch

_amp_state = {"enable": False, "dtype": "bfloat16", "level": "O1",
              "custom_white_list": None, "custom_black_list": None}

# O1 default lists (ref: fluid/contrib/mixed_precision/fp16_lists.py)
WHITE_LIST = {"matmul", "mm", "bmm", "conv1d", "conv2d", "conv3d", "linear",
              "einsum", "addmm"}
BLACK_LIST = {"exp", "log", "mean", "sum", "softmax", "log_softmax",
              "cross_entropy", "softmax_with_cross_entropy", "layer_norm",
              "batch_norm", "norm", "cumsum", "logsumexp"}

_TORCH = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32}


def amp_enabled():
    return _amp_state["enable"]


def amp_dtype():
    return _amp_state["dtype"]


def amp_should_cast(opname):
    if not _amp_state["enable"]:
        return False
    white = WHITE_LIST | set(_amp_state["custom_white_list"] or ())
    black = BLACK_LIST | set(_amp_state["custom_black_list"] or ())
    if _amp_state["level"] == "O2":
        return opname not in black
    return opname in white and opname not in black


def cast_inputs(opname, *tensors):
    """(tensors, cast_back): the floating tensors cast to the amp dtype
    when `opname` is to run in it, and a function giving an op's result
    back in float32 (the identity when the op is not cast)."""
    if not amp_should_cast(opname):
        return tensors, _same
    dt = _TORCH[_amp_state["dtype"]]
    out = tuple(t.to(dt) if torch.is_tensor(t) and t.is_floating_point()
                else t for t in tensors)

    def back(y):
        return y.float() if torch.is_tensor(y) and y.dtype == dt else y
    return out, back


def _same(y):
    return y


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16"):
    if dtype not in _TORCH:
        raise ValueError(f"auto_cast: unsupported dtype {dtype!r}")
    prev = dict(_amp_state)
    _amp_state.update(enable=enable, dtype=dtype, level=level,
                      custom_white_list=custom_white_list,
                      custom_black_list=custom_black_list)
    try:
        yield
    finally:
        _amp_state.clear()
        _amp_state.update(prev)


amp_guard = auto_cast


def decorate(models, optimizers=None, level="O1", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """At O2, cast the models' floating parameters and buffers to
    `dtype` (ref: amp.decorate); returns models (and optimizers)."""
    single = not isinstance(models, (list, tuple))
    model_list = [models] if single else list(models)
    if level == "O2":
        for m in model_list:
            m.to(dtype=_TORCH[dtype])
    if optimizers is None:
        return models
    return models, optimizers


from .grad_scaler import GradScaler  # noqa: E402,F401

__all__ = ["auto_cast", "amp_guard", "decorate", "GradScaler",
           "WHITE_LIST", "BLACK_LIST", "amp_enabled", "amp_dtype",
           "amp_should_cast", "cast_inputs"]
